"""The batch reader's work: one row group of a plain Parquet store as an
arrow table, and the consumer's conversion of the table to numpy columns.

The port's counterpart of ``petastorm_tpu/readers/batch_worker.py``
(:22-206): ``BatchResultsReader`` (table → namedtuple of numpy columns:
list columns through :func:`~petastorm_tpu_torch.codecs.list_column_to_numpy`,
everything else as arrow's ``to_numpy`` gives it, so a null-bearing integer
column is float64 with NaN), and ``ArrowBatchWorker``'s load, predicate
(read first, the other columns only at its rows) and pandas transform.
Codec columns are not decoded: the batch reader reads columns as arrow
stores them. The batch reader has no row-drop partitions: every item reads
its whole row group, as in the JAX package, whose ``make_batch_reader``
fixes them at 1.

``TransformSpec.func`` receives a pandas DataFrame; a cell that is a numpy
array of more than one dimension is checked against the transformed
field's shape and raveled (arrow has no ndarray columns). pandas is
imported by ``pa.Table.to_pandas`` only when a transform runs. A
no-predicate item caches its table, before the transform, under the key
``'batch'`` (:75).

Lineage and quarantine (JAX ``batch_worker.py:70-100``): the loads report
the source-row offsets of the table through ``io``, and under a quarantine
policy a failing read or transform is quarantined with the whole item.
Stats: the transform gives a ``decode`` latency observation and a
``transform`` span; no codec cell is decoded, so no decode path is
counted, as in JAX.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import list_column_to_numpy
from petastorm_tpu_torch.readers.columnar_worker import (
    make_partition_columns, stored_columns, validate_predicate_fields)
from petastorm_tpu_torch.readers.piece_worker import PLAIN_READS, QUARANTINED
from petastorm_tpu_torch.unischema import Unischema


class BatchResultsReader:
    """Consumer side: an arrow table → a namedtuple of numpy column arrays
    over ``schema`` (the reader's transformed schema)."""

    def __init__(self, schema: Unischema):
        self._schema = schema

    def to_batch(self, table: pa.Table):
        result = {name: self._column_to_numpy(table.column(name), field)
                  for name, field in self._schema.fields.items()
                  if name in table.column_names}
        return self._schema.make_batch_namedtuple(**result)

    @staticmethod
    def _column_to_numpy(column: pa.ChunkedArray, field) -> np.ndarray:
        if pa.types.is_list(column.type) or pa.types.is_large_list(
                column.type):
            return list_column_to_numpy(column, field)
        return column.to_numpy(zero_copy_only=False)


def _append_partition_columns(table: pa.Table, piece, full_schema: Unischema,
                              names) -> pa.Table:
    """Hive partition columns for the keys among ``names`` that the table
    does not hold."""
    wanted = {k for k in names if k not in table.column_names}
    for key, col in make_partition_columns(full_schema, piece, table.num_rows,
                                           wanted).items():
        table = table.append_column(key, pa.array(col))
    return table


def plan_batch(item, schema: Unischema) -> Tuple[str, List[str]]:
    """``(cache key prefix, columns read)`` of :func:`load_batch_item`."""
    return 'batch', stored_columns(list(schema.fields), item.piece)


def _load_table(piece, schema: Unischema, full_schema: Unischema,
                io) -> pa.Table:
    table = io.read(piece, stored_columns(list(schema.fields), piece))
    if io.tracks_offsets:
        io.set_offsets(('range', 0, table.num_rows))
    return _append_partition_columns(table, piece, full_schema, schema.fields)


def _load_table_with_predicate(piece, schema: Unischema,
                               full_schema: Unischema,
                               predicate, io) -> Optional[pa.Table]:
    """Read the predicate's columns, keep the rows it includes (one
    ``do_include`` per row on Python values), then read only the other
    columns and take those rows of both."""
    fields = validate_predicate_fields(predicate, full_schema)
    pred_stored = io.read(piece, stored_columns(fields, piece))
    pred_table = _append_partition_columns(pred_stored, piece, full_schema,
                                           set(fields))
    values = {name: pred_table.column(name).to_pylist() for name in fields}
    mask = [predicate.do_include({f: values[f][i] for f in fields})
            for i in range(pred_table.num_rows)]
    if not any(mask):
        return None
    indices = np.nonzero(mask)[0]
    if io.tracks_offsets:
        io.set_offsets(indices.astype(np.int64))
    combined = pred_stored
    other = [n for n in schema.fields if n not in set(fields)]
    other_stored = stored_columns(other, piece)
    if other_stored:
        rest = io.read(piece, other_stored)
        for name in rest.column_names:
            combined = combined.append_column(name, rest.column(name))
    combined = _append_partition_columns(combined, piece, full_schema,
                                         schema.fields)
    ordered = [n for n in schema.fields if n in combined.column_names]
    return combined.select(ordered).take(pa.array(indices))


def load_batch_item(item, schema: Unischema, full_schema: Unischema,
                    transform_spec=None,
                    transformed_schema: Optional[Unischema] = None,
                    io=PLAIN_READS) -> Optional[pa.Table]:
    """One work item as an arrow table: the row group's columns of
    ``schema`` (the reader's view), its rows kept by the item's predicate,
    then ``transform_spec``. None when no row is left; ``QUARANTINED``
    when the transform failed under a quarantine policy."""
    if item.predicate is not None:
        table = _load_table_with_predicate(item.piece, schema, full_schema,
                                           item.predicate, io)
    else:
        table = io.cached('batch', item.piece, lambda: _load_table(
            item.piece, schema, full_schema, io))
    offsets = io.offsets
    if table is None or table.num_rows == 0:
        return None
    if transform_spec is not None:
        n = table.num_rows
        start = time.perf_counter()
        try:
            table = apply_pandas_transform(transform_spec, transformed_schema,
                                           table)
        except Exception as e:
            if not io.quarantine_item('transform', e, rows=n):
                raise
            return QUARANTINED
        finally:
            # JAX's batch worker reports every transform, failed or not
            # (``batch_worker.py:172-182``)
            elapsed = time.perf_counter() - start
            io.record_latency('decode', elapsed)
            io.record_span('transform', 'decode', start, elapsed)
        if table.num_rows != n:
            offsets = None      # rows made or dropped: opaque
    io.set_offsets(offsets)
    return table if table.num_rows else None


def apply_pandas_transform(transform_spec, transformed_schema: Unischema,
                           table: pa.Table) -> pa.Table:
    """``func`` over the table as a pandas DataFrame, kept to the
    transformed schema's fields, with >1-D array cells checked against
    their field's shape and raveled."""
    df = table.to_pandas()
    if transform_spec.func is not None:
        df = transform_spec.func(df)
    keep: List[str] = [n for n in transformed_schema.fields
                       if n in df.columns]
    df = df[keep]
    for name in keep:
        field = transformed_schema.fields[name]
        if (field.shape and len(df)
                and isinstance(df[name].iloc[0], np.ndarray)):
            expected = tuple(field.shape)
            df[name] = df[name].map(
                lambda a, _n=name: _check_shape_and_ravel(a, expected, _n))
    return pa.Table.from_pandas(df, preserve_index=False)


def _check_shape_and_ravel(array: np.ndarray, expected, name: str):
    if len(array.shape) != len(expected) or any(
            e is not None and a != e for a, e in zip(array.shape, expected)):
        raise ValueError(
            'Field {!r}: transformed value shape {} does not match schema '
            'shape {}'.format(name, array.shape, expected))
    return array.ravel()
