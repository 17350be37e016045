"""Read one row group and turn it into NGram window chunks.

The port's counterpart of the JAX package's columnar window path
(``readers/row_worker.py`` ``_load_window_columns`` / ``_form_window_chunk``
:232-254, consumed through ``Reader.iter_ngram_chunks``, ``reader.py:1099``):
read the row group's referenced columns with pyarrow, decode each column in
one shot with its codec, and form all valid windows column-wise.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import RowGroupPiece
from petastorm_tpu_torch.ngram import NGram, NGramWindowChunk
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


def load_window_chunk(piece: RowGroupPiece, schema: Unischema,
                      ngram: NGram) -> Optional[NGramWindowChunk]:
    """All valid windows of one row group (None when there are none)."""
    names = [n for n in ngram.get_all_field_names() if n in schema.fields]
    table = pq.ParquetFile(piece.path).read_row_group(piece.row_group,
                                                      columns=names)
    return ngram.form_windows_columnar(decode_columns(table, schema))
