"""Read one row group and decode it column-wise: into NGram window chunks
or into a dict of column arrays.

The port's counterpart of the JAX package's columnar loads: the window path
(``readers/row_worker.py`` ``_load_window_columns`` / ``_form_window_chunk``
:232-254, without row-drop partitions) and the columnar reader's load
(``readers/columnar_worker.py``: ``ColumnarWorker.process`` / ``_load`` /
``_load_with_predicate`` / ``_apply_transform`` :420-565, the helpers
``_column_to_numpy`` :244-284, ``validate_predicate_fields`` and
``make_partition_columns`` :287-313, ``predicate_row_mask`` :383-399;
without its cache, quarantine and lineage branches). Each reads the row
group's columns with pyarrow and decodes each column in one shot with its
codec; hive partition columns are made from the piece's directory values.

A null-bearing numeric scalar column decodes as arrow gives it, a float
array with NaN at the nulls (float64 for an integer column), as the JAX
columnar and batch readers give it; the row reader asks for ``None`` cells
instead (``keep_none``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import RowGroupPiece
from petastorm_tpu_torch.ngram import NGram, NGramWindowChunk
from petastorm_tpu_torch.transform import (TransformSpec,
                                           apply_columnar_transform)
from petastorm_tpu_torch.unischema import Unischema
from petastorm_tpu_torch.utils import cast_partition_value

_SCALAR = ScalarCodec()


def _is_numeric(field) -> bool:
    return (not isinstance(field.numpy_dtype, type)
            and field.numpy_dtype.kind in 'iuf')


def decode_column(field, chunk: pa.Array, keep_none: bool = False
                  ) -> np.ndarray:
    """One column chunk decoded with the field's codec. Without
    ``keep_none`` a numeric scalar column with nulls is arrow's NaN-holed
    float array; with it, an object array with ``None`` at the nulls."""
    codec = field.codec or _SCALAR
    if (chunk.null_count and not keep_none and isinstance(codec, ScalarCodec)
            and _is_numeric(field)):
        return chunk.to_numpy(zero_copy_only=False)
    return codec.decode_column(field, chunk)


def decode_columns(table, schema: Unischema,
                   keep_none: bool = False) -> Dict[str, np.ndarray]:
    """Codec-decode every column of ``table`` that ``schema`` declares."""
    return {name: decode_column(schema.fields[name],
                                table.column(name).combine_chunks(),
                                keep_none)
            for name in table.column_names if name in schema.fields}


def stored_columns(names: List[str], piece: RowGroupPiece) -> List[str]:
    """The columns to read from the file: ``names`` less the partition keys
    (which live in directory names)."""
    keys = piece.partition_dict
    return [n for n in names if n not in keys]


def read_row_group(piece: RowGroupPiece, columns: List[str]) -> pa.Table:
    return pq.ParquetFile(piece.path).read_row_group(piece.row_group,
                                                     columns=columns)


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


def load_columns(piece: RowGroupPiece, schema: Unischema, names: List[str],
                 keep_none: bool = False) -> Dict[str, np.ndarray]:
    """The row group's columns ``names`` (those ``schema`` declares),
    decoded, with partition columns made for the partition keys among
    them."""
    names = [n for n in names if n in schema.fields]
    table = read_row_group(piece, stored_columns(names, piece))
    columns = decode_columns(table, schema, keep_none)
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
                        names: List[str], predicate, keep_none: bool = False
                        ) -> Optional[Dict[str, np.ndarray]]:
    """Decode the predicate's columns first, then the other columns
    ``names`` only at the rows it keeps; None when it keeps none."""
    fields = validate_predicate_fields(predicate, schema)
    pred_table = read_row_group(piece, stored_columns(fields, piece))
    n = pred_table.num_rows
    pred_cols = decode_columns(pred_table, schema, keep_none)
    pred_cols.update(make_partition_columns(schema, piece, n, set(fields)))
    mask = predicate_row_mask(predicate, fields, pred_cols, n)
    if not mask.any():
        return None
    idx = np.nonzero(mask)[0]
    out = {f: pred_cols[f][idx] for f in fields if f in names}
    other = [f for f in names if f not in set(fields)]
    other_stored = stored_columns(other, piece)
    if other_stored:
        rest = read_row_group(piece, other_stored).take(pa.array(idx))
        out.update(decode_columns(rest, schema, keep_none))
    out.update(make_partition_columns(schema, piece, len(idx), set(other)))
    return out


def drop_partition_bounds(n: int, partition: int, num_partitions: int):
    """``(lo, hi)`` of the rows that row-drop partition ``partition`` of
    ``num_partitions`` keeps of ``n``."""
    bounds = np.linspace(0, n, num_partitions + 1, dtype=int)
    return int(bounds[partition]), int(bounds[partition + 1])


def load_window_chunk(item, schema: Unischema,
                      ngram: NGram) -> Optional[NGramWindowChunk]:
    """All valid windows of one row group (None when there are none)."""
    return ngram.form_windows_columnar(
        load_columns(item.piece, schema, ngram.get_all_field_names()))


def load_columnar(item, schema: Unischema, names: List[str],
                  transform_spec: Optional[TransformSpec] = None,
                  transformed_schema: Optional[Unischema] = None
                  ) -> Optional[Dict[str, np.ndarray]]:
    """One work item as a dict of decoded column arrays: the row group,
    its rows kept by the item's predicate, its row-drop partition, then
    ``transform_spec`` (its ``func`` sees the whole dict; the result keeps
    the transformed schema's fields). None when no row is left."""
    partition, num_partitions = item.drop_partition
    if item.predicate is not None:
        columns = load_with_predicate(item.piece, schema, names,
                                      item.predicate)
    else:
        columns = load_columns(item.piece, schema, names)
    n = len(next(iter(columns.values()))) if columns else 0
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
    if not columns or not len(next(iter(columns.values()))):
        return None
    return columns
