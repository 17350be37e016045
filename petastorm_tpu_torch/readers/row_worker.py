"""The row reader's work: one row group as a list of decoded row dicts, or
as a list of NGram window dicts.

The port's counterpart of ``petastorm_tpu/readers/row_worker.py``: the
column-wise row load (``_load_rows`` :300-322), the row predicate read
first and the other columns only at its rows (``_load_rows_with_predicate``
:324-357), the row-drop partition, extended by ``length - 1`` continuation
rows under an NGram (``_drop_partition`` :359-372), the per-row transform
(``_transform_rows`` / ``_apply_transform`` :374-409), hive partition values
cast into the rows (``_decode_with_partitions`` :284-295), and the NGram
row path (``process`` :144-168): an NGram item with a row predicate or a
transform loads the window universe as rows, drops its partition,
transforms each row and publishes ``form_ngram_dicts`` windows. A null cell
is ``None``, never a NaN-holed float. A hinted field decodes through its
override.

The stats: where JAX decodes rows one by one (the predicate load and the
NGram row path, ``_decode_with_partitions``), the port decodes column-wise
all the same but reports as JAX does: no decode path counts and a
``decode_rows`` span
(:func:`~petastorm_tpu_torch.readers.columnar_worker.decode_columns`'s
``rows_path``).

Lineage and quarantine (JAX ``row_worker.py:130-225, 315-400``): the row
load decodes tolerantly under ``on_decode_error`` (rows with a failing
cell are dropped); the NGram loads do not, so a corrupt NGram item is
quarantined whole. Under a quarantine policy a row whose transform raises
is dropped and recorded with its exact source offset. The loads report
their source-row offsets through ``io``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from petastorm_tpu_torch.etl.dataset_metadata import RowGroupPiece
from petastorm_tpu_torch.lineage import NEVER_QUARANTINE
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.readers.columnar_worker import (
    drop_partition_bounds, load_columns, load_with_predicate, read_columns,
    slice_offsets)
from petastorm_tpu_torch.readers.piece_worker import PLAIN_READS
from petastorm_tpu_torch.transform import TransformSpec, apply_row_transform
from petastorm_tpu_torch.unischema import Unischema


def _split_rows(columns: Optional[Dict], names: List[str]) -> List[Dict]:
    if not columns:
        return []
    keys = [n for n in names if n in columns]
    return [dict(zip(keys, values))
            for values in zip(*(columns[k] for k in keys))]


def load_rows(piece: RowGroupPiece, schema: Unischema, names: List[str],
              overrides=None, io=PLAIN_READS, tolerant: bool = True,
              rows_path: bool = False) -> List[Dict]:
    """The row group as row dicts, decoded column-wise and then split;
    ``tolerant`` and ``rows_path`` as :func:`load_columns`'s."""
    return _split_rows(load_columns(piece, schema, names, keep_none=True,
                                    overrides=overrides, io=io,
                                    tolerant=tolerant, rows_path=rows_path),
                       names)


def transform_rows(rows: List[Dict], offsets, transform_spec: TransformSpec,
                   transformed_schema: Unischema, io=PLAIN_READS):
    """``(rows, offsets)`` after ``transform_spec`` row by row. Under a
    quarantine policy of ``io`` a row whose transform raises is dropped
    and recorded with its source offset."""
    if not io.tolerant:
        return [apply_row_transform(transform_spec, transformed_schema, r)
                for r in rows], offsets
    out, kept = [], []
    range_base = offsets[1] if isinstance(offsets, tuple) else None
    for i, row in enumerate(rows):
        try:
            out.append(apply_row_transform(transform_spec,
                                           transformed_schema, row))
            kept.append(i)
        except NEVER_QUARANTINE:
            raise
        except Exception as e:          # the policy drops the row
            if offsets is None:
                off = None
            elif range_base is not None:
                off = range_base + i
            else:
                off = int(offsets[i])
            io.quarantine_event('transform', e, rows=1,
                                row_offsets=None if off is None else [off])
    if offsets is not None and len(kept) != len(rows):
        if isinstance(offsets, tuple):
            offsets = np.arange(offsets[1], offsets[2], dtype=np.int64)
        offsets = (offsets[np.asarray(kept, dtype=np.int64)]
                   if kept else offsets[:0])
    return out, offsets


def plan_rows(item, schema: Unischema, names: List[str]
              ) -> Tuple[str, List[str]]:
    """``(cache key prefix, columns read)`` of :func:`load_row_item`."""
    return 'rowgroup', read_columns(item.piece, schema, names)


def load_row_item(item, schema: Unischema, names: List[str],
                  transform_spec: Optional[TransformSpec] = None,
                  transformed_schema: Optional[Unischema] = None,
                  ngram: Optional[NGram] = None, overrides=None,
                  io=PLAIN_READS) -> List[Dict]:
    """One work item as row dicts: the row group, its rows kept by the
    item's predicate, its row-drop partition, then ``transform_spec`` row
    by row (the result keeps the transformed schema's fields). With
    ``ngram``, the windows of those rows as ``{offset: {field: value}}``;
    the row-drop partition then keeps ``length - 1`` rows past its end."""
    if item.predicate is not None:
        rows = _split_rows(load_with_predicate(item.piece, schema, names,
                                               item.predicate,
                                               keep_none=True,
                                               overrides=overrides, io=io,
                                               rows_path=True),
                           names)
    else:
        rows = io.cached('rowgroup', item.piece, lambda: load_rows(
            item.piece, schema, names, overrides, io,
            tolerant=ngram is None, rows_path=ngram is not None))
    offsets = io.offsets
    partition, num_partitions = item.drop_partition
    if num_partitions > 1:
        lo, hi = drop_partition_bounds(
            len(rows), partition, num_partitions,
            ngram.length - 1 if ngram is not None else 0)
        rows = rows[lo:hi]
        offsets = slice_offsets(offsets, lo, hi)
    if transform_spec is not None:
        rows, offsets = transform_rows(rows, offsets, transform_spec,
                                       transformed_schema, io)
    if ngram is not None:
        return ngram.form_ngram_dicts(rows, transformed_schema)
    io.set_offsets(offsets)
    return rows
