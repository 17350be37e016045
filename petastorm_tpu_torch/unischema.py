"""Unischema of the port: typed fields, row namedtuples, arrow storage
schema, JSON form and row encoding.

A copy of what the token, image and row paths need from
``petastorm_tpu/unischema.py`` (``UnischemaField`` :35-99,
``_NamedtupleCache`` :102-122, ``Unischema`` :125-204,
``match_unischema_fields`` :269, ``insert_explicit_nulls`` :279,
``encode_row`` :291). The JSON form is the JAX package's, so a schema written
by either package loads in the other.
"""

from __future__ import annotations

import json
import re
import threading
from collections import namedtuple
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import ScalarCodec, codec_from_json_dict

_DEFAULT_SCALAR_CODEC = ScalarCodec()


class UnischemaField:
    """One typed field: ``(name, numpy_dtype, shape, codec, nullable)``;
    ``None`` entries of ``shape`` are wildcards; ``codec=None`` stores the
    value natively."""

    __slots__ = ('name', 'numpy_dtype', 'shape', 'codec', 'nullable')

    def __init__(self, name: str, numpy_dtype, shape: Tuple = (),
                 codec=None, nullable: bool = False):
        self.name = name
        if isinstance(numpy_dtype, type) and issubclass(
                numpy_dtype, (str, bytes, np.str_, np.bytes_)):
            self.numpy_dtype = (str if issubclass(numpy_dtype,
                                                  (str, np.str_)) else bytes)
        else:
            self.numpy_dtype = np.dtype(numpy_dtype)
        self.shape = tuple(shape)
        self.codec = codec
        self.nullable = bool(nullable)

    def _key(self):
        dtype_key = (self.numpy_dtype if isinstance(self.numpy_dtype, type)
                     else self.numpy_dtype.str)
        return (self.name, dtype_key, self.shape, self.codec, self.nullable)

    def __eq__(self, other):
        return (isinstance(other, UnischemaField)
                and self._key() == other._key())

    def __hash__(self):
        return hash((self.name, self.shape, self.nullable))

    def __repr__(self):
        return 'UnischemaField({!r}, {}, {}, {}, nullable={})'.format(
            self.name, self.numpy_dtype, self.shape, self.codec,
            self.nullable)

    def to_json_dict(self) -> Dict[str, Any]:
        if isinstance(self.numpy_dtype, type):
            dtype_repr = {'py': self.numpy_dtype.__name__}
        else:
            dtype_repr = {'np': self.numpy_dtype.str}
        return {'name': self.name, 'dtype': dtype_repr,
                'shape': [s if s is not None else -1 for s in self.shape],
                'codec': (self.codec.to_json_dict()
                          if self.codec is not None else None),
                'nullable': self.nullable}

    @classmethod
    def from_json_dict(cls, d: Dict[str, Any]) -> 'UnischemaField':
        dtype_repr = d['dtype']
        if 'py' in dtype_repr:
            dtype = {'str': str, 'bytes': bytes}[dtype_repr['py']]
        else:
            dtype = np.dtype(dtype_repr['np'])
        shape = tuple(s if s >= 0 else None for s in d['shape'])
        codec = codec_from_json_dict(d['codec']) if d.get('codec') else None
        return cls(d['name'], dtype, shape, codec, d.get('nullable', False))


class _NamedtupleCache:
    """One namedtuple type per (schema name, field names), so rows of one
    schema always share a type, whichever thread asks first."""

    _store: Dict[str, Any] = {}
    _lock = threading.Lock()

    @classmethod
    def get(cls, parent_name: str, field_names: Iterable[str]):
        names = sorted(field_names)
        key = ' '.join([parent_name] + names)
        with cls._lock:
            cached = cls._store.get(key)
            if cached is None:
                cached = cls._store[key] = namedtuple(parent_name, names)
        return cached


class Unischema:
    """Fields by name (sorted), with views, row types and the arrow storage
    schema."""

    def __init__(self, name: str, fields: List[UnischemaField]):
        self._name = name
        self._fields = {f.name: f for f in sorted(fields,
                                                  key=lambda t: t.name)}
        for f in self._fields.values():
            setattr(self, f.name, f)

    @property
    def name(self) -> str:
        return self._name

    @property
    def fields(self) -> Dict[str, UnischemaField]:
        return self._fields

    def __repr__(self):
        return 'Unischema({}, [{}])'.format(
            self._name, ', '.join(repr(f) for f in self._fields.values()))

    def create_schema_view(self, fields) -> 'Unischema':
        """Sub-schema from ``UnischemaField``s and/or regex strings."""
        regexes = [f for f in fields if isinstance(f, str)]
        objs = [f for f in fields if isinstance(f, UnischemaField)]
        for f in objs:
            if self._fields.get(f.name) != f:
                raise ValueError('field {} does not belong to the schema {}'
                                 .format(f, self._name))
        matched = match_unischema_fields(self, regexes)
        view = {f.name: f for f in objs + matched}
        return Unischema('{}_view'.format(self._name), list(view.values()))

    def make_namedtuple(self, **values):
        """A row namedtuple (fields in name order); a scalar string field's
        value is cast to ``str``."""
        typed = {}
        for key, value in values.items():
            field = self._fields[key]
            is_str = (field.numpy_dtype is str
                      or (not isinstance(field.numpy_dtype, type)
                          and field.numpy_dtype.kind == 'U'))
            if (value is not None and field.shape == () and is_str
                    and not isinstance(value, str)):
                value = str(value)
            typed[key] = value
        return _NamedtupleCache.get(self._name, self._fields)(**typed)

    def make_batch_namedtuple(self, **columns):
        """A namedtuple of whole column arrays, uncast."""
        return _NamedtupleCache.get(self._name, self._fields)(**columns)

    def as_arrow_schema(self) -> pa.Schema:
        return pa.schema([
            pa.field(f.name, (f.codec or _DEFAULT_SCALAR_CODEC).arrow_type(f),
                     nullable=f.nullable)
            for f in self._fields.values()])

    def to_json(self) -> str:
        return json.dumps({'name': self._name,
                           'fields': [f.to_json_dict()
                                      for f in self._fields.values()]})

    @classmethod
    def from_json(cls, payload: str) -> 'Unischema':
        d = json.loads(payload)
        return cls(d['name'], [UnischemaField.from_json_dict(fd)
                               for fd in d['fields']])


def match_unischema_fields(schema: Unischema,
                           field_regexes: Iterable[str]
                           ) -> List[UnischemaField]:
    """Fields whose names fully match any of the patterns."""
    compiled = [re.compile(p) for p in field_regexes or ()]
    return [f for name, f in schema.fields.items()
            if any(c.fullmatch(name) for c in compiled)]


def insert_explicit_nulls(schema: Unischema, row: Dict[str, Any]) -> None:
    """``None`` for missing nullable fields; raise for missing others."""
    for name, field in schema.fields.items():
        if name not in row:
            if not field.nullable:
                raise ValueError('Field {!r} is not found in the row and is '
                                 'not nullable'.format(name))
            row[name] = None


def encode_row(schema: Unischema, row_dict: Dict[str, Any]
               ) -> Dict[str, Optional[Any]]:
    """Codec-encode one row dict into arrow-storable cell values."""
    if not isinstance(row_dict, dict):
        raise TypeError('row must be a dict, got {}'.format(type(row_dict)))
    row = dict(row_dict)
    extra = set(row) - set(schema.fields)
    if extra:
        raise ValueError('Following fields of row are not part of the '
                         'schema: {}'.format(extra))
    insert_explicit_nulls(schema, row)
    encoded = {}
    for name, field in schema.fields.items():
        value = row[name]
        if value is None:
            if not field.nullable:
                raise ValueError('Field {!r} is not nullable but got None'
                                 .format(name))
            encoded[name] = None
        else:
            codec = field.codec or _DEFAULT_SCALAR_CODEC
            encoded[name] = codec.encode(field, value)
    return encoded
