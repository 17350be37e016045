"""Read one row group and decode it column-wise: into NGram window chunks
or into a dict of column arrays.

The port's counterpart of the JAX package's columnar loads: the window path
(``readers/row_worker.py`` ``_load_window_columns`` / ``_form_window_chunk``
:232-254, row-drop partitions included) and the columnar reader's load
(``readers/columnar_worker.py``: ``ColumnarWorker.process`` / ``_load`` /
``_load_with_predicate`` / ``_apply_transform`` :420-565, the helpers
``_column_to_numpy`` :244-284, ``validate_predicate_fields`` and
``make_partition_columns`` :287-313, ``predicate_row_mask`` :383-399;
without its cache, quarantine and lineage branches). Each reads the row
group's columns with pyarrow and decodes each column in one shot with its
codec, or cell by cell through a decode hint's override
(``readers/piece_worker.py`` ``_decode_table`` :541-545); hive partition
columns are made from the piece's directory values.

Each load reads through its ``io`` argument, the worker's read layer
(:class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorker`: its file
handles, readahead and cache; a fresh handle a read and no cache when none
is given). A no-predicate columnar item caches its columns under the key
``'columnar'``; a whole-group item with a transform caches them after the
transform under ``'columnar_tx:<fingerprint>'`` (``columnar_worker.py``
:402-510), so a hit skips the decode and the transform; an NGram window
chunk caches its decoded columns under ``'ngram_cols'``
(``row_worker.py:239``). :func:`transform_fingerprint` (:352) names a
transform in its key.

Columns with a device-decode plan (``ops/decode.py``) are not decoded: each
travels as its raw ``(n, stride)`` uint8 grid, repacked from a host decode
where a chunk does not match the plan (``readers/piece_worker.py``
``_decode_table`` :515-535; ``supports_device_decode``,
``columnar_worker.py:410``).

A null-bearing numeric scalar column decodes as arrow gives it, a float
array with NaN at the nulls (float64 for an integer column), as the JAX
columnar and batch readers give it; the row reader asks for ``None`` cells
instead (``keep_none``).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import ScalarCodec, decode_cells
from petastorm_tpu_torch.etl.dataset_metadata import RowGroupPiece
from petastorm_tpu_torch.ngram import NGram, NGramWindowChunk
from petastorm_tpu_torch.ops.decode import raw_column_view, repack_to_raw
from petastorm_tpu_torch.readers.piece_worker import PLAIN_READS
from petastorm_tpu_torch.transform import (TransformSpec,
                                           apply_columnar_transform)
from petastorm_tpu_torch.unischema import Unischema
from petastorm_tpu_torch.utils import cast_partition_value

_SCALAR = ScalarCodec()


def _is_numeric(field) -> bool:
    return (not isinstance(field.numpy_dtype, type)
            and field.numpy_dtype.kind in 'iuf')


def decode_column(field, chunk: pa.Array, keep_none: bool = False,
                  override: Optional[Callable] = None) -> np.ndarray:
    """One column chunk decoded with the field's codec, or cell by cell
    with ``override`` (a decode hint's scaled decode). Without
    ``keep_none`` a numeric scalar column with nulls is arrow's NaN-holed
    float array; with it, an object array with ``None`` at the nulls."""
    if override is not None:
        return decode_cells(field, chunk, override)
    codec = field.codec or _SCALAR
    if (chunk.null_count and not keep_none and isinstance(codec, ScalarCodec)
            and _is_numeric(field)):
        return chunk.to_numpy(zero_copy_only=False)
    return codec.decode_column(field, chunk)


def decode_columns(table, schema: Unischema, keep_none: bool = False,
                   overrides: Optional[Dict[str, Callable]] = None,
                   plans=None) -> Dict[str, np.ndarray]:
    """Codec-decode every column of ``table`` that ``schema`` declares,
    through ``overrides[name]`` where a decode hint gives one; a column
    with a device-decode plan in ``plans`` comes out as its raw grid."""
    overrides = overrides or {}
    plans = plans or {}
    out = {}
    for name in table.column_names:
        if name not in schema.fields:
            continue
        plan = plans.get(name)
        if plan is not None:
            raw = raw_column_view(table.column(name), plan)
            if raw is None:
                raw = repack_to_raw(plan, decode_column(
                    schema.fields[name], table.column(name).combine_chunks()))
            out[name] = raw
            continue
        out[name] = decode_column(schema.fields[name],
                                  table.column(name).combine_chunks(),
                                  keep_none, overrides.get(name))
    return out


def stored_columns(names: List[str], piece: RowGroupPiece) -> List[str]:
    """The columns to read from the file: ``names`` less the partition keys
    (which live in directory names)."""
    keys = piece.partition_dict
    return [n for n in names if n not in keys]


def make_partition_columns(schema: Unischema, piece: RowGroupPiece, n: int,
                           names) -> Dict[str, np.ndarray]:
    """Columns of the piece's constant hive partition values for the keys
    in ``names``, typed by ``schema`` where it declares the key."""
    out = {}
    for key, value in piece.partition_dict.items():
        if key in names:
            field = schema.fields.get(key)
            typed = cast_partition_value(
                field.numpy_dtype if field is not None else None, value)
            if isinstance(typed, str):
                col = np.empty(n, dtype=object)
                col[:] = typed
            else:
                col = np.full(n, typed)
            out[key] = col
    return out


def read_columns(piece: RowGroupPiece, schema: Unischema,
                 names: List[str]) -> List[str]:
    """The columns :func:`load_columns` reads for ``names``."""
    return stored_columns([n for n in names if n in schema.fields], piece)


def load_columns(piece: RowGroupPiece, schema: Unischema, names: List[str],
                 keep_none: bool = False, overrides=None, plans=None,
                 io=PLAIN_READS) -> Dict[str, np.ndarray]:
    """The row group's columns ``names`` (those ``schema`` declares),
    decoded (raw where ``plans`` has a plan), with partition columns made
    for the partition keys among them."""
    names = [n for n in names if n in schema.fields]
    table = io.read(piece, stored_columns(names, piece))
    columns = decode_columns(table, schema, keep_none, overrides, plans)
    columns.update(make_partition_columns(schema, piece, table.num_rows,
                                          set(names)))
    return columns


def validate_predicate_fields(predicate, schema: Unischema) -> list:
    """The predicate's field names, checked against the full stored schema
    (a predicate may use fields outside the reader's view)."""
    fields = list(predicate.get_fields())
    unknown = set(fields) - set(schema.fields)
    if unknown:
        raise ValueError('Predicate uses unknown fields: {}'.format(
            sorted(unknown)))
    return fields


def predicate_row_mask(predicate, fields, cols, n: int) -> np.ndarray:
    """Boolean include-mask of ``predicate`` over decoded columns: one
    vectorized call where the predicate has a ``column_mask`` hook that
    accepts the columns, else ``do_include`` row by row."""
    column_mask = getattr(predicate, 'column_mask', None)
    if column_mask is not None:
        mask = column_mask(cols)
        if mask is not None:
            return np.asarray(mask, dtype=bool)
    return np.fromiter(
        (bool(predicate.do_include({f: cols[f][i] for f in fields}))
         for i in range(n)), dtype=bool, count=n)


def load_with_predicate(piece: RowGroupPiece, schema: Unischema,
                        names: List[str], predicate, keep_none: bool = False,
                        overrides=None, io=PLAIN_READS
                        ) -> Optional[Dict[str, np.ndarray]]:
    """Decode the predicate's columns first, then the other columns
    ``names`` only at the rows it keeps; None when it keeps none."""
    fields = validate_predicate_fields(predicate, schema)
    pred_table = io.read(piece, stored_columns(fields, piece))
    n = pred_table.num_rows
    pred_cols = decode_columns(pred_table, schema, keep_none, overrides)
    pred_cols.update(make_partition_columns(schema, piece, n, set(fields)))
    mask = predicate_row_mask(predicate, fields, pred_cols, n)
    if not mask.any():
        return None
    idx = np.nonzero(mask)[0]
    out = {f: pred_cols[f][idx] for f in fields if f in names}
    other = [f for f in names if f not in set(fields)]
    other_stored = stored_columns(other, piece)
    if other_stored:
        rest = io.read(piece, other_stored).take(pa.array(idx))
        out.update(decode_columns(rest, schema, keep_none, overrides))
    out.update(make_partition_columns(schema, piece, len(idx), set(other)))
    return out


def drop_partition_bounds(n: int, partition: int, num_partitions: int,
                          extend: int = 0):
    """``(lo, hi)`` of the rows that row-drop partition ``partition`` of
    ``num_partitions`` keeps of ``n``, extended by ``extend`` rows past its
    end (an NGram's ``length - 1`` continuation rows)."""
    bounds = np.linspace(0, n, num_partitions + 1, dtype=int)
    return int(bounds[partition]), min(int(bounds[partition + 1]) + extend,
                                       n)


def plan_window_chunk(item, schema: Unischema, ngram: NGram
                      ) -> Tuple[str, List[str]]:
    """``(cache key prefix, columns read)`` of :func:`load_window_chunk`."""
    return 'ngram_cols', read_columns(item.piece, schema,
                                      ngram.get_all_field_names())


def load_window_chunk(item, schema: Unischema, ngram: NGram,
                      overrides=None, io=PLAIN_READS
                      ) -> Optional[NGramWindowChunk]:
    """All valid windows of one work item's row group, or of its row-drop
    partition: a slice of the rows in file order, extended by ``length -
    1`` rows so that the windows across its end survive, taken before the
    timestamp sort. None when no window is valid."""
    columns = io.cached('ngram_cols', item.piece, lambda: load_columns(
        item.piece, schema, ngram.get_all_field_names(), overrides=overrides,
        io=io))
    partition, num_partitions = item.drop_partition
    if num_partitions > 1:
        n = len(next(iter(columns.values()))) if columns else 0
        lo, hi = drop_partition_bounds(n, partition, num_partitions,
                                       ngram.length - 1)
        if hi <= lo:
            return None
        columns = {k: v[lo:hi] for k, v in columns.items()}
    return ngram.form_windows_columnar(columns)


def columnar_cache_prefix(item, transform_key: Optional[str]) -> str:
    """The payload a no-predicate columnar item caches: its columns after
    the transform when it has one and reads the whole group, else its
    decoded columns."""
    if transform_key is not None and item.drop_partition[1] == 1:
        return 'columnar_tx:' + transform_key
    return 'columnar'


def plan_columnar(item, schema: Unischema, names: List[str],
                  transform_key: Optional[str] = None
                  ) -> Tuple[str, List[str]]:
    """``(cache key prefix, columns read)`` of :func:`load_columnar`."""
    return (columnar_cache_prefix(item, transform_key),
            read_columns(item.piece, schema, names))


def _row_count(columns) -> int:
    return len(next(iter(columns.values()))) if columns else 0


def load_columnar(item, schema: Unischema, names: List[str],
                  transform_spec: Optional[TransformSpec] = None,
                  transformed_schema: Optional[Unischema] = None,
                  overrides=None, plans=None, transform_key=None,
                  io=PLAIN_READS) -> Optional[Dict[str, np.ndarray]]:
    """One work item as a dict of decoded column arrays: the row group,
    its rows kept by the item's predicate, its row-drop partition, then
    ``transform_spec`` (its ``func`` sees the whole dict; the result keeps
    the transformed schema's fields). Columns planned in ``plans`` stay
    raw grids (the reader plans none under a predicate or a host
    transform). ``transform_key`` is the transform's
    :func:`transform_fingerprint`. None when no row is left."""
    partition, num_partitions = item.drop_partition
    if item.predicate is None and transform_spec is not None \
            and num_partitions == 1:
        def transformed():
            columns = load_columns(item.piece, schema, names,
                                   overrides=overrides, plans=plans, io=io)
            if not _row_count(columns):
                return columns
            return apply_columnar_transform(transform_spec,
                                            transformed_schema, columns)
        columns = io.cached(columnar_cache_prefix(item, transform_key),
                            item.piece, transformed)
        return columns if _row_count(columns) else None
    if item.predicate is not None:
        columns = load_with_predicate(item.piece, schema, names,
                                      item.predicate, overrides=overrides,
                                      io=io)
    else:
        columns = io.cached('columnar', item.piece, lambda: load_columns(
            item.piece, schema, names, overrides=overrides, plans=plans,
            io=io))
    n = _row_count(columns)
    if not n:
        return None
    if num_partitions > 1:
        lo, hi = drop_partition_bounds(n, partition, num_partitions)
        if hi <= lo:
            return None
        columns = {k: v[lo:hi] for k, v in columns.items()}
    if transform_spec is not None:
        columns = apply_columnar_transform(transform_spec,
                                           transformed_schema, columns)
    if not _row_count(columns):
        return None
    return columns


def _code_digest(code) -> str:
    """A code object's bytecode and constants (an edit of ``x*2`` to
    ``x*3`` changes only the constants), nested code objects by their own
    digest (their repr holds addresses)."""
    parts = [code.co_code.hex()]
    for const in code.co_consts:
        if hasattr(const, 'co_code'):
            parts.append(_code_digest(const))
        else:
            parts.append(repr(const))
    return '|'.join(parts)


def _stable_value_digest(value) -> str:
    """A value's identity, never truncated: an ndarray by the md5 of its
    bytes (``repr`` elides the middle of large arrays), through lists,
    tuples and dicts; anything else by ``repr``."""
    if isinstance(value, np.ndarray):
        h = hashlib.md5(np.ascontiguousarray(value).tobytes())
        return 'ndarray:{}:{}:{}'.format(value.dtype, value.shape,
                                         h.hexdigest())
    if isinstance(value, (list, tuple)):
        return '{}[{}]'.format(type(value).__name__,
                               ','.join(_stable_value_digest(v)
                                        for v in value))
    if isinstance(value, dict):
        return 'dict{{{}}}'.format(','.join(
            '{}:{}'.format(repr(k), _stable_value_digest(v))
            for k, v in sorted(value.items(), key=lambda kv: repr(kv[0]))))
    return repr(value)


def transform_fingerprint(spec: TransformSpec) -> str:
    """The identity of a transform in cache keys, as JAX's: the function's
    module, qualified name, code (bytecode, constants, defaults, closure
    values) and the spec's field edits. A closure over a mutable object
    whose repr does not change is not seen: name a fresh
    ``cache_location`` when such state changes."""
    func = spec.func
    parts = []
    if func is not None:
        code = getattr(func, '__code__', None)
        kwdefaults = getattr(func, '__kwdefaults__', None) or {}
        parts.extend([getattr(func, '__module__', ''),
                      getattr(func, '__qualname__', repr(func)),
                      _code_digest(code) if code is not None else '',
                      '|'.join(_stable_value_digest(v) for v in
                               (getattr(func, '__defaults__', None) or ())),
                      '|'.join('{}={}'.format(k, _stable_value_digest(v))
                               for k, v in sorted(kwdefaults.items()))])
        closure = getattr(func, '__closure__', None) or ()
        parts.extend(_stable_value_digest(getattr(cell, 'cell_contents', None))
                     for cell in closure)
    parts.append(repr([(f.name, str(f.numpy_dtype), f.shape)
                       for f in (spec.edit_fields or [])]))
    parts.append(repr(sorted(spec.removed_fields or [])))
    parts.append(repr(sorted(spec.selected_fields or [])))
    return hashlib.md5('|'.join(parts).encode()).hexdigest()[:16]
