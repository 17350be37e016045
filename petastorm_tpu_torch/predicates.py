"""Row predicates pushed down to the reader's workers.

A copy of ``petastorm_tpu/predicates.py`` (:17-193): ``PredicateBase``,
``in_set`` (with its vectorized ``column_mask``), ``in_intersection``,
``in_lambda``, ``in_negate``, ``in_reduce`` and ``in_pseudorandom_split``.
The md5 bucketing of ``in_pseudorandom_split`` is the JAX package's to the
bit, so a split made by either package selects the same rows in the other.
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod
from typing import Callable, Iterable, List, Optional

import numpy as np


class PredicateBase(ABC):
    """A predicate pushed down to reader workers: rows failing
    ``do_include`` never leave the worker."""

    @abstractmethod
    def get_fields(self) -> List[str]:
        """Field names the predicate needs to evaluate."""

    @abstractmethod
    def do_include(self, values: dict) -> bool:
        """Decide inclusion given a dict of the requested field values."""


class in_set(PredicateBase):
    """True if the field value is in the given set."""

    def __init__(self, inclusion_values: Iterable, predicate_field: str):
        self._inclusion_values = set(inclusion_values)
        self._predicate_field = predicate_field

    def get_fields(self):
        return [self._predicate_field]

    def do_include(self, values):
        return values[self._predicate_field] in self._inclusion_values

    def column_mask(self, columns) -> Optional[np.ndarray]:
        """Vectorized membership over a decoded numpy column (the columnar
        readers' ``predicate_row_mask`` hook): one ``np.isin`` instead of a
        per-row dict build + set probe. Returns ``None`` — caller falls
        back to per-row ``do_include`` — whenever numpy elementwise
        equality could disagree with Python's ``in``: object columns,
        mixed-kind value sets, NaN members (set membership is
        identity-based), and any int/float pairing whose float64
        promotion would round exact integers (int64 x uint64, members or
        64-bit columns beyond 2**53)."""
        column = columns.get(self._predicate_field)
        dtype = getattr(column, 'dtype', None)
        if dtype is None or dtype.kind not in 'biufUS':
            return None
        if getattr(column, 'ndim', 0) != 1:
            # a dense (n, *shape) array column would yield an elementwise
            # N-D mask ("any element matches" rows, duplicated indices at
            # the nonzero() callers) where the per-row path raises loudly
            # on the unhashable cell — keep that loud failure
            return None
        try:
            values = np.asarray(list(self._inclusion_values))
        except (ValueError, TypeError, OverflowError):
            return None
        ck, vk = dtype.kind, values.dtype.kind
        if ck in 'US':
            if vk != ck:
                return None
        elif ck in 'bui' and vk in 'bui':
            # int64 x uint64 promotes to float64 inside np.isin — 2**63
            # neighbors collide after rounding where Python's exact int
            # compare would not
            if np.result_type(dtype, values.dtype).kind not in 'bui':
                return None
        elif ck == 'f' and vk == 'f':
            if np.isnan(values).any():
                return None  # nan in {nan} is True (identity); ==nan isn't
        elif ck == 'f' and vk in 'bui':
            # integer members compare exactly against a float column only
            # when float64 represents each one exactly — proven by the
            # round trip (a magnitude test would itself round 2**53 + 1)
            promoted = values.astype(np.float64)
            if not bool(np.array_equal(promoted.astype(values.dtype),
                                       values)):
                return None
            values = promoted
        elif ck in 'ui' and vk == 'f':
            # np.isin promotes the COLUMN to float64: exact only for
            # <=32-bit integer columns (int64 values beyond 2**53 round)
            if dtype.itemsize > 4:
                return None
        else:
            return None
        return np.isin(column, values)


class in_intersection(PredicateBase):
    """True if a list-valued field intersects the given set."""

    def __init__(self, inclusion_values: Iterable, predicate_field: str):
        self._inclusion_values = set(inclusion_values)
        self._predicate_field = predicate_field

    def get_fields(self):
        return [self._predicate_field]

    def do_include(self, values):
        return not self._inclusion_values.isdisjoint(values[self._predicate_field])


class in_lambda(PredicateBase):
    """Custom predicate function, with optional mutable state."""

    def __init__(self, predicate_fields: List[str], predicate_func: Callable,
                 state=None):
        self._predicate_fields = list(predicate_fields)
        self._predicate_func = predicate_func
        self._state = state

    def get_fields(self):
        return self._predicate_fields

    def do_include(self, values):
        if self._state is not None:
            return self._predicate_func(values, self._state)
        return self._predicate_func(values)


class in_negate(PredicateBase):
    """Logical NOT of another predicate."""

    def __init__(self, predicate: PredicateBase):
        self._predicate = predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        return not self._predicate.do_include(values)


class in_reduce(PredicateBase):
    """Composition of predicates with a reduce function, e.g. ``all``/``any``."""

    def __init__(self, predicate_list: List[PredicateBase], reduce_func: Callable):
        self._predicate_list = list(predicate_list)
        self._reduce_func = reduce_func

    def get_fields(self):
        fields = []
        for p in self._predicate_list:
            fields.extend(p.get_fields())
        return sorted(set(fields))

    def do_include(self, values):
        return self._reduce_func([p.do_include(values) for p in self._predicate_list])


class in_pseudorandom_split(PredicateBase):
    """Deterministic hash-based train/val/test split.

    ``fraction_list`` partitions [0,1); a row is included when the md5-hash
    bucket of its ``predicate_field`` value falls into partition
    ``subset_index``. The same value always lands in the same subset, across
    processes and runs.
    """

    def __init__(self, fraction_list: List[float], subset_index: int, predicate_field: str):
        if not 0 <= subset_index < len(fraction_list):
            raise ValueError('subset_index {} out of range for {} fractions'.format(
                subset_index, len(fraction_list)))
        if sum(fraction_list) > 1.0 + 1e-9:
            raise ValueError('fractions must sum to <= 1.0')
        self._boundaries = np.cumsum([0.0] + list(fraction_list))
        self._subset_index = subset_index
        self._predicate_field = predicate_field

    def get_fields(self):
        return [self._predicate_field]

    def do_include(self, values):
        value = values[self._predicate_field]
        if isinstance(value, bytes):
            payload = value
        else:
            payload = str(value).encode('utf-8')
        bucket = int(hashlib.md5(payload).hexdigest(), 16) / float(1 << 128)
        return (self._boundaries[self._subset_index] <= bucket
                < self._boundaries[self._subset_index + 1])
