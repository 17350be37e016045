"""Value casts shared by the reader, its workers and the filters.

A copy of ``petastorm_tpu/utils.py`` ``parse_bool_string``,
``cast_partition_value`` and ``cast_string_to_type`` (:34-60).
"""

from __future__ import annotations

import numpy as np

_FALSY_STRINGS = frozenset(('false', '0', '', 'no'))


def parse_bool_string(value: str) -> bool:
    """A hive-partition-style boolean string (``bool('False')`` is True in
    Python, which would invert ``flag=False`` partitions)."""
    return value.strip().lower() not in _FALSY_STRINGS


def cast_partition_value(numpy_dtype, value: str):
    """A hive partition directory value (a string on disk) cast to the
    field's dtype; ``None`` (an undeclared column) keeps the string."""
    if numpy_dtype is None or numpy_dtype is str:
        return value
    if numpy_dtype is bytes:
        return value.encode('utf-8')
    dtype = np.dtype(numpy_dtype)
    if dtype.kind == 'b':
        return np.bool_(parse_bool_string(value))
    return dtype.type(value)


def cast_string_to_type(target_type, value: str):
    """A string cast to ``type(filter_value)`` for a filter comparison, with
    the boolean semantics of :func:`parse_bool_string`."""
    if target_type is bool:
        return parse_bool_string(value)
    return target_type(value)
