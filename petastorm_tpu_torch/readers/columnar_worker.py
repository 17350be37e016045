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

Tolerant decode (``on_decode_error`` other than ``'raise'``; JAX
``columnar_worker.py:80-200, 440-520``): each column decodes the dense way
first; a codec column that raises decodes again cell by cell, each failing
cell goes into the item's
:class:`~petastorm_tpu_torch.readers.piece_worker.DecodeErrorSink`, and
the worker drops those rows from every column, making the columns the
retry left as object arrays dense again. Failures of the infrastructure
(``NEVER_QUARANTINE``) stay loud. Each load reports the source-row offsets
of what it returns through ``io.set_offsets`` (a symbolic ``('range', lo,
hi)`` on a clean read, an index array after a predicate or a drop, None
on a cache hit or after a transform that changed the row count), and a
failing columnar transform is quarantined whole
(:data:`~petastorm_tpu_torch.readers.piece_worker.QUARANTINED`).
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import (ScalarCodec, _is_fixed,
                                        decode_cells, split_binary_chunk)
from petastorm_tpu_torch.etl.dataset_metadata import RowGroupPiece
from petastorm_tpu_torch.lineage import NEVER_QUARANTINE
from petastorm_tpu_torch.ngram import NGram, NGramWindowChunk
from petastorm_tpu_torch.ops.decode import raw_column_view, repack_to_raw
from petastorm_tpu_torch.readers.piece_worker import PLAIN_READS, QUARANTINED
from petastorm_tpu_torch.transform import (TransformSpec,
                                           apply_columnar_transform)
from petastorm_tpu_torch.unischema import Unischema
from petastorm_tpu_torch.utils import cast_partition_value

_SCALAR = ScalarCodec()


def _is_numeric(field) -> bool:
    return (not isinstance(field.numpy_dtype, type)
            and field.numpy_dtype.kind in 'iuf')


def _codec_cells(field, chunk: pa.Array) -> bool:
    """A codec's binary cells: what the decode path counts cover."""
    return (field.codec is not None and len(chunk) > 0
            and (pa.types.is_binary(chunk.type)
                 or pa.types.is_large_binary(chunk.type)))


def decode_column_batched(field, chunk: pa.Array) -> Optional[np.ndarray]:
    """The whole-column path (JAX ``_decode_column_batched``): the codec's
    ``make_column_decoder`` on the chunk, or None to punt to the cell by
    cell path, which then owns the errors (a chunk that raises punts)."""
    make = getattr(field.codec, 'make_column_decoder', None)
    decode_chunk = make(field) if make is not None else None
    if decode_chunk is None:
        return None
    try:
        out = decode_chunk(chunk)
    except NEVER_QUARANTINE:
        raise
    except Exception:        # noqa: BLE001 - the cell path owns the error
        return None
    return out if out is not None and len(out) == len(chunk) else None


def decode_column(field, chunk: pa.Array, keep_none: bool = False,
                  override: Optional[Callable] = None,
                  counts: Optional[Dict[str, int]] = None) -> np.ndarray:
    """One column chunk decoded with the field's codec, or cell by cell
    with ``override`` (a decode hint's scaled decode). Without
    ``keep_none`` a numeric scalar column with nulls is arrow's NaN-holed
    float array; with it, an object array with ``None`` at the nulls.

    ``counts`` (``{'batched': n, 'percell': n}``) counts a codec's binary
    cells by the path that decodes them, where JAX draws the line
    (``columnar_worker.py:150-162``): a fixed-shape null-free column with
    no override takes the whole-column path
    (:func:`decode_column_batched`) when its codec has one and the chunk
    decodes through it; every other such column goes cell by cell."""
    if counts is not None and _codec_cells(field, chunk):
        if (override is None and _is_fixed(field)
                and chunk.null_count == 0):
            out = decode_column_batched(field, chunk)
            if out is not None:
                counts['batched'] += len(chunk)
                return out
        counts['percell'] += len(chunk)
    if override is not None:
        return decode_cells(field, chunk, override)
    codec = field.codec or _SCALAR
    if (chunk.null_count and not keep_none and isinstance(codec, ScalarCodec)
            and _is_numeric(field)):
        return chunk.to_numpy(zero_copy_only=False)
    return codec.decode_column(field, chunk)


def _cell_decoder(field, override: Optional[Callable]) -> Callable:
    """The one-cell decode of ``field`` (cells as uint8 views)."""
    if override is not None:
        return override
    make = getattr(field.codec, 'make_cell_decoder', None)
    if make is not None:
        return make(field)
    return lambda cell: field.codec.decode(field, cell.tobytes())


def decode_column_tolerant(field, chunk: pa.Array, keep_none: bool,
                           override: Optional[Callable],
                           on_cell_error: Callable,
                           counts: Optional[Dict[str, int]] = None
                           ) -> np.ndarray:
    """:func:`decode_column`, and where it raises on a codec column, the
    column again cell by cell: each failing cell is reported as
    ``on_cell_error(row, exc)`` and left ``None`` in an object array. A
    retry in which no cell fails re-raises the first error (the failure
    was not a cell's, e.g. a codec giving a wrong shape)."""
    try:
        return decode_column(field, chunk, keep_none, override, counts)
    except NEVER_QUARANTINE:
        raise
    except Exception:
        binary = (pa.types.is_binary(chunk.type)
                  or pa.types.is_large_binary(chunk.type))
        if field.codec is None or not binary:
            raise
        decode = _cell_decoder(field, override)
        offsets, data = split_binary_chunk(chunk)
        valid = (chunk.is_valid().to_numpy(zero_copy_only=False)
                 if chunk.null_count else None)
        out = np.empty(len(chunk), dtype=object)
        failed = False
        for i in range(len(chunk)):
            if valid is not None and not valid[i]:
                continue
            try:
                out[i] = decode(data[int(offsets[i]):int(offsets[i + 1])])
            except NEVER_QUARANTINE:
                raise
            except Exception as e:      # reported; the worker drops the row
                failed = True
                on_cell_error(i, e)
        if not failed:
            raise
        return out


def decode_columns(table, schema: Unischema, keep_none: bool = False,
                   overrides: Optional[Dict[str, Callable]] = None,
                   plans=None, sink=None, io=PLAIN_READS,
                   rows_path: bool = False) -> Dict[str, np.ndarray]:
    """Codec-decode every column of ``table`` that ``schema`` declares,
    through ``overrides[name]`` where a decode hint gives one; a column
    with a device-decode plan in ``plans`` comes out as its raw grid. With
    a ``sink`` (a ``DecodeErrorSink``) codec columns decode tolerantly
    (:func:`decode_column_tolerant`) and their failing cells go into it.

    The decode reports to ``io`` as JAX's ``_decode_table``
    (``piece_worker.py:554-562``): the cells by path
    (``rows_decoded_batched``, ``rows_decoded_percell``), the raw bytes of
    planned columns (``bytes_shipped_raw``), one ``decode`` latency
    observation and a ``decode_columns`` span. ``rows_path``: what JAX
    decodes row by row (``_decode_with_partitions``: the row reader's
    predicate and NGram loads), which counts no path and spans
    ``decode_rows``."""
    overrides = overrides or {}
    plans = plans or {}
    start = time.perf_counter()
    counts = None if rows_path else {'batched': 0, 'percell': 0}
    raw_bytes = 0
    out = {}
    for name in table.column_names:
        if name not in schema.fields:
            continue
        field = schema.fields[name]
        plan = plans.get(name)
        if plan is not None:
            raw = raw_column_view(table.column(name), plan)
            if raw is None:
                raw = repack_to_raw(plan, decode_column(
                    field, table.column(name).combine_chunks(),
                    counts=counts))
            out[name] = raw
            raw_bytes += raw.nbytes
            continue
        chunk = table.column(name).combine_chunks()
        if sink is None:
            out[name] = decode_column(field, chunk, keep_none,
                                      overrides.get(name), counts)
            continue
        errors_before = len(sink.errors)
        out[name] = decode_column_tolerant(
            field, chunk, keep_none, overrides.get(name),
            lambda row, exc, _name=name: sink.errors.append(
                (row, _name, exc)), counts)
        if (len(sink.errors) > errors_before and _is_fixed(field)
                and chunk.null_count == 0):
            # the dense decode would have given (n, *shape): make it so
            # again once the failing rows are dropped
            sink.dense_fields.add(name)
    if counts is not None:
        if counts['batched']:
            io.record_count('rows_decoded_batched', counts['batched'])
        if counts['percell']:
            io.record_count('rows_decoded_percell', counts['percell'])
    if raw_bytes:
        io.record_count('bytes_shipped_raw', raw_bytes)
    elapsed = time.perf_counter() - start
    io.record_latency('decode', elapsed)
    io.record_span('decode_rows' if rows_path else 'decode_columns',
                   'decode', start, elapsed)
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
                 io=PLAIN_READS, tolerant: bool = False,
                 rows_path: bool = False) -> Dict[str, np.ndarray]:
    """The row group's columns ``names`` (those ``schema`` declares),
    decoded (raw where ``plans`` has a plan), with partition columns made
    for the partition keys among them. ``tolerant``: under ``io``'s
    quarantine policy, rows whose cells fail to decode are dropped (an
    NGram load leaves it off: a hole would shift every window after it,
    so its failures quarantine the whole item). ``rows_path`` as
    :func:`decode_columns`'s."""
    names = [n for n in names if n in schema.fields]
    table = io.read(piece, stored_columns(names, piece))
    sink = io.error_sink() if tolerant else None
    columns = decode_columns(table, schema, keep_none, overrides, plans, sink,
                             io, rows_path)
    n = table.num_rows
    offsets = ('range', 0, n) if io.tracks_offsets else None
    if sink is not None and sink.errors:
        columns, offsets = io.apply_quarantine_drops(columns, sink, n)
        n = len(offsets)
    columns.update(make_partition_columns(schema, piece, n, set(names)))
    io.set_offsets(offsets)
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
                        overrides=None, io=PLAIN_READS,
                        rows_path: bool = False
                        ) -> Optional[Dict[str, np.ndarray]]:
    """Decode the predicate's columns first, then the other columns
    ``names`` only at the rows it keeps; None when it keeps none.
    ``rows_path`` as :func:`decode_columns`'s (the row reader's)."""
    fields = validate_predicate_fields(predicate, schema)
    pred_table = io.read(piece, stored_columns(fields, piece))
    n = pred_table.num_rows
    pred_cols = decode_columns(pred_table, schema, keep_none, overrides,
                               io=io, rows_path=rows_path)
    pred_cols.update(make_partition_columns(schema, piece, n, set(fields)))
    mask = predicate_row_mask(predicate, fields, pred_cols, n)
    if not mask.any():
        return None
    idx = np.nonzero(mask)[0]
    if io.tracks_offsets:
        io.set_offsets(idx.astype(np.int64))
    out = {f: pred_cols[f][idx] for f in fields if f in names}
    other = [f for f in names if f not in set(fields)]
    other_stored = stored_columns(other, piece)
    if other_stored:
        rest = io.read(piece, other_stored).take(pa.array(idx))
        out.update(decode_columns(rest, schema, keep_none, overrides, io=io,
                                  rows_path=rows_path))
    out.update(make_partition_columns(schema, piece, len(idx), set(other)))
    return out


def slice_offsets(offsets, lo: int, hi: int):
    """Source-row offsets after the payload slice ``[lo, hi)``."""
    if offsets is None:
        return None
    if isinstance(offsets, tuple):
        base = offsets[1]
        return ('range', base + int(lo), base + int(hi))
    return offsets[lo:hi]


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


def _timed_transform(transform_spec, transformed_schema, columns, io):
    """The columnar transform, reported to ``io`` as JAX's
    ``_apply_transform`` (``columnar_worker.py:555-565``): a ``decode``
    latency observation and a ``transform`` span."""
    start = time.perf_counter()
    out = apply_columnar_transform(transform_spec, transformed_schema,
                                   columns)
    elapsed = time.perf_counter() - start
    io.record_latency('decode', elapsed)
    io.record_span('transform', 'decode', start, elapsed)
    return out


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
    :func:`transform_fingerprint`. None when no row is left;
    ``QUARANTINED`` when the transform failed under a quarantine
    policy."""
    partition, num_partitions = item.drop_partition
    if item.predicate is None and transform_spec is not None \
            and num_partitions == 1:
        def transformed():
            columns = load_columns(item.piece, schema, names,
                                   overrides=overrides, plans=plans, io=io,
                                   tolerant=True)
            if not _row_count(columns):
                return columns
            return _timed_transform(transform_spec, transformed_schema,
                                    columns, io)
        columns = io.cached(columnar_cache_prefix(item, transform_key),
                            item.piece, transformed)
        # the transform may change the row count: the rows are opaque
        io.set_offsets(None)
        return columns if _row_count(columns) else None
    if item.predicate is not None:
        columns = load_with_predicate(item.piece, schema, names,
                                      item.predicate, overrides=overrides,
                                      io=io)
    else:
        columns = io.cached('columnar', item.piece, lambda: load_columns(
            item.piece, schema, names, overrides=overrides, plans=plans,
            io=io, tolerant=True))
    offsets = io.offsets
    n = _row_count(columns)
    if not n:
        return None
    if num_partitions > 1:
        lo, hi = drop_partition_bounds(n, partition, num_partitions)
        if hi <= lo:
            return None
        columns = {k: v[lo:hi] for k, v in columns.items()}
        offsets = slice_offsets(offsets, lo, hi)
        n = hi - lo
    if transform_spec is not None:
        try:
            columns = _timed_transform(transform_spec, transformed_schema,
                                       columns, io)
        except Exception as e:
            if not io.quarantine_item('transform', e, rows=n):
                raise
            return QUARANTINED
        if _row_count(columns) != n:
            offsets = None      # rows made or dropped: opaque
    io.set_offsets(offsets)
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
