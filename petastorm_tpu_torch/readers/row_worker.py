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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from petastorm_tpu_torch.etl.dataset_metadata import RowGroupPiece
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.readers.columnar_worker import (
    drop_partition_bounds, load_columns, load_with_predicate, read_columns)
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
              overrides=None, io=PLAIN_READS) -> List[Dict]:
    """The row group as row dicts, decoded column-wise and then split."""
    return _split_rows(load_columns(piece, schema, names, keep_none=True,
                                    overrides=overrides, io=io), names)


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
                                               overrides=overrides, io=io),
                           names)
    else:
        rows = io.cached('rowgroup', item.piece, lambda: load_rows(
            item.piece, schema, names, overrides, io))
    partition, num_partitions = item.drop_partition
    if num_partitions > 1:
        lo, hi = drop_partition_bounds(
            len(rows), partition, num_partitions,
            ngram.length - 1 if ngram is not None else 0)
        rows = rows[lo:hi]
    if transform_spec is not None:
        rows = [apply_row_transform(transform_spec, transformed_schema, r)
                for r in rows]
    if ngram is not None:
        return ngram.form_ngram_dicts(rows, transformed_schema)
    return rows
