"""Read one row group and decode it column-wise: into NGram window chunks,
into a dict of column arrays, or into row dicts.

The port's counterpart of the JAX package's columnar loads: the window path
(``readers/row_worker.py`` ``_load_window_columns`` / ``_form_window_chunk``
:232-254), the columnar reader's plain load and transform
(``readers/columnar_worker.py`` ``ColumnarWorker.process`` / ``_load`` /
``_apply_transform`` :420-565, without its cache, predicate, quarantine and
lineage branches) and the row reader's column-wise row load
(``readers/row_worker.py`` ``_load_rows`` :300-322). Each reads the row
group's columns with pyarrow and decodes each column in one shot with its
codec.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import RowGroupPiece
from petastorm_tpu_torch.ngram import NGram, NGramWindowChunk
from petastorm_tpu_torch.transform import (TransformSpec,
                                           apply_columnar_transform)
from petastorm_tpu_torch.unischema import Unischema

_SCALAR = ScalarCodec()


def decode_columns(table, schema: Unischema) -> Dict[str, np.ndarray]:
    """Codec-decode every column of ``table`` that ``schema`` declares."""
    out = {}
    for name in table.column_names:
        field = schema.fields.get(name)
        if field is None:
            continue
        chunk = table.column(name).combine_chunks()
        out[name] = (field.codec or _SCALAR).decode_column(field, chunk)
    return out


def load_columns(piece: RowGroupPiece, schema: Unischema,
                 names: List[str]) -> Dict[str, np.ndarray]:
    """The row group's columns ``names`` (those ``schema`` declares),
    decoded."""
    names = [n for n in names if n in schema.fields]
    table = pq.ParquetFile(piece.path).read_row_group(piece.row_group,
                                                      columns=names)
    return decode_columns(table, schema)


def load_window_chunk(piece: RowGroupPiece, schema: Unischema,
                      ngram: NGram) -> Optional[NGramWindowChunk]:
    """All valid windows of one row group (None when there are none)."""
    return ngram.form_windows_columnar(
        load_columns(piece, schema, ngram.get_all_field_names()))


def load_columnar(piece: RowGroupPiece, schema: Unischema, names: List[str],
                  transform_spec: Optional[TransformSpec] = None,
                  transformed_schema: Optional[Unischema] = None
                  ) -> Optional[Dict[str, np.ndarray]]:
    """The row group as a dict of decoded column arrays, after
    ``transform_spec`` (its ``func`` sees the whole dict; the result keeps
    the transformed schema's fields). None when no row is left."""
    columns = load_columns(piece, schema, names)
    if transform_spec is not None:
        columns = apply_columnar_transform(transform_spec,
                                           transformed_schema, columns)
    if not columns or not len(next(iter(columns.values()))):
        return None
    return columns


def load_rows(piece: RowGroupPiece, schema: Unischema,
              names: List[str]) -> List[Dict]:
    """The row group as row dicts, decoded column-wise and then split."""
    columns = load_columns(piece, schema, names)
    keys = [n for n in names if n in columns]
    return [dict(zip(keys, values))
            for values in zip(*(columns[k] for k in keys))]
