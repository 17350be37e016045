"""The row reader's work: one row group as a list of decoded row dicts.

The port's counterpart of ``petastorm_tpu/readers/row_worker.py``: the
column-wise row load (``_load_rows`` :300-322), the row predicate read
first and the other columns only at its rows (``_load_rows_with_predicate``
:324-357), the row-drop partition (``_drop_partition`` :359-372, without
NGram continuation rows: an NGram reader takes no predicate, transform or
row-drop partition in the port), the per-row transform (``_transform_rows``
/ ``_apply_transform`` :374-409) and hive partition values cast into the
rows (``_decode_with_partitions`` :284-295). A null cell is ``None``, never
a NaN-holed float.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from petastorm_tpu_torch.etl.dataset_metadata import RowGroupPiece
from petastorm_tpu_torch.readers.columnar_worker import (
    drop_partition_bounds, load_columns, load_with_predicate)
from petastorm_tpu_torch.transform import TransformSpec, apply_row_transform
from petastorm_tpu_torch.unischema import Unischema


def _split_rows(columns: Optional[Dict], names: List[str]) -> List[Dict]:
    if not columns:
        return []
    keys = [n for n in names if n in columns]
    return [dict(zip(keys, values))
            for values in zip(*(columns[k] for k in keys))]


def load_rows(piece: RowGroupPiece, schema: Unischema,
              names: List[str]) -> List[Dict]:
    """The row group as row dicts, decoded column-wise and then split."""
    return _split_rows(load_columns(piece, schema, names, keep_none=True),
                       names)


def load_row_item(item, schema: Unischema, names: List[str],
                  transform_spec: Optional[TransformSpec] = None,
                  transformed_schema: Optional[Unischema] = None
                  ) -> List[Dict]:
    """One work item as row dicts: the row group, its rows kept by the
    item's predicate, its row-drop partition, then ``transform_spec`` row
    by row (the result keeps the transformed schema's fields)."""
    if item.predicate is not None:
        rows = _split_rows(load_with_predicate(item.piece, schema, names,
                                               item.predicate,
                                               keep_none=True), names)
    else:
        rows = load_rows(item.piece, schema, names)
    partition, num_partitions = item.drop_partition
    if num_partitions > 1:
        lo, hi = drop_partition_bounds(len(rows), partition, num_partitions)
        rows = rows[lo:hi]
    if transform_spec is not None:
        rows = [apply_row_transform(transform_spec, transformed_schema, r)
                for r in rows]
    return rows
