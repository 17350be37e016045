"""Value casts shared by the reader, its workers and the filters, and the
atomic write of the trace and metrics files.

A copy of ``petastorm_tpu/utils.py`` ``atomic_write`` (:16-31),
``parse_bool_string``, ``cast_partition_value`` and
``cast_string_to_type`` (:34-60).
"""

from __future__ import annotations

import os

import numpy as np

_FALSY_STRINGS = frozenset(('false', '0', '', 'no'))


def atomic_write(path: str, write_fn) -> str:
    """Write a text file atomically: ``write_fn(file)`` writes a sibling
    temporary file that replaces ``path`` only when it succeeded, so a
    crash never leaves a truncated trace or metrics file, nor clobbers the
    previous good one."""
    tmp = '{}.tmp.{}'.format(path, os.getpid())
    try:
        with open(tmp, 'w') as f:
            write_fn(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


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
