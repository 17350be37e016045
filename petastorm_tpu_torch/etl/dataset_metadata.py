"""Write tensor datasets to Parquet and discover their row groups.

Counterpart of ``petastorm_tpu/etl/dataset_metadata.py``
(``DatasetWriter``/``materialize_dataset`` :82-258, ``load_row_groups``
:270-328, ``get_schema`` :331-352) for local stores. The metadata format is
the JAX package's: the Unischema as JSON under ``petastorm_tpu.unischema.v1``
and per-file row-group counts under
``petastorm_tpu.num_row_groups_per_file.v1`` in ``_common_metadata``, so the
two packages read each other's stores; nothing is pickled.
"""

from __future__ import annotations

import json
import os
import posixpath
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.fs import list_files, url_to_path
from petastorm_tpu_torch.unischema import Unischema, encode_row

#: ``_common_metadata`` keys, shared with the JAX package's stores.
UNISCHEMA_KEY = b'petastorm_tpu.unischema.v1'
ROW_GROUPS_PER_FILE_KEY = b'petastorm_tpu.num_row_groups_per_file.v1'

_COMMON_METADATA = '_common_metadata'
_DEFAULT_ROW_GROUP_SIZE_MB = 32


class MetadataError(RuntimeError):
    """A store's ``_common_metadata`` is missing or unusable."""


def _is_data_file(path: str) -> bool:
    base = os.path.basename(path)
    return (not base.startswith(('_', '.')) and base.endswith('.parquet'))


@dataclass(frozen=True)
class RowGroupPiece:
    """One unit of work: one row group of one parquet file."""
    path: str
    row_group: int
    num_rows: int = -1


class DatasetWriter:
    """Codec-encoding parquet writer: rows buffer into ``part_NNNNN.parquet``
    files whose row-group sizes follow ``row_group_size_mb``."""

    def __init__(self, dataset_path: str, schema: Unischema,
                 row_group_size_mb: float = _DEFAULT_ROW_GROUP_SIZE_MB,
                 rows_per_file: int = 100000, file_size_mb: float = 256,
                 compression: str = 'snappy'):
        self._path = dataset_path
        self._schema = schema
        self._row_group_bytes = int(row_group_size_mb * (1 << 20))
        self._rows_per_file = rows_per_file
        self._file_size_bytes = int(file_size_mb * (1 << 20))
        self._compression = compression
        self._buffer: List[Dict] = []
        self._buffer_bytes = 0
        self._part = 0
        self._row_groups_per_file: Dict[str, List[int]] = {}
        os.makedirs(dataset_path, exist_ok=True)

    @property
    def schema(self) -> Unischema:
        return self._schema

    def write_row(self, row_dict: Dict) -> None:
        encoded = encode_row(self._schema, row_dict)
        self._buffer.append(encoded)
        self._buffer_bytes += sum(
            len(v) if isinstance(v, (bytes, str)) else 8
            for v in encoded.values() if v is not None)
        if (len(self._buffer) >= self._rows_per_file
                or self._buffer_bytes >= self._file_size_bytes):
            self._flush()

    def write_rows(self, rows) -> None:
        for row in rows:
            self.write_row(row)

    def _flush(self) -> None:
        if not self._buffer:
            return
        table = pa.Table.from_pylist(self._buffer,
                                     schema=self._schema.as_arrow_schema())
        self._buffer, self._buffer_bytes = [], 0
        filename = 'part_{:05d}.parquet'.format(self._part)
        self._part += 1
        rows_per_group = max(1, int(table.num_rows * self._row_group_bytes
                                    / max(table.nbytes, 1)))
        pq.write_table(table, os.path.join(self._path, filename),
                       row_group_size=rows_per_group,
                       compression=self._compression)
        groups = -(-table.num_rows // rows_per_group)
        counts = [rows_per_group] * (groups - 1)
        counts.append(table.num_rows - rows_per_group * (groups - 1))
        self._row_groups_per_file[filename] = counts

    def close(self) -> Dict[str, List[int]]:
        self._flush()
        return dict(self._row_groups_per_file)


def _write_common_metadata(dataset_path: str, schema: Unischema,
                           row_groups_per_file: Dict[str, List[int]]) -> None:
    metadata = {UNISCHEMA_KEY: schema.to_json().encode('utf-8'),
                ROW_GROUPS_PER_FILE_KEY:
                    json.dumps(row_groups_per_file).encode('utf-8')}
    pq.write_metadata(schema.as_arrow_schema().with_metadata(metadata),
                      os.path.join(dataset_path, _COMMON_METADATA))


def read_common_metadata(dataset_path: str) -> Optional[Dict[bytes, bytes]]:
    """The ``_common_metadata`` schema metadata, or None if absent."""
    meta_path = os.path.join(dataset_path, _COMMON_METADATA)
    if not os.path.exists(meta_path):
        return None
    return dict(pq.read_schema(meta_path).metadata or {})


@contextmanager
def materialize_dataset(dataset_url: str, schema: Unischema,
                        row_group_size_mb: float = _DEFAULT_ROW_GROUP_SIZE_MB,
                        rows_per_file: int = 100000,
                        file_size_mb: float = 256,
                        compression: str = 'snappy',
                        overwrite: bool = False):
    """Context manager yielding a :class:`DatasetWriter`; on exit writes
    ``_common_metadata`` and checks that the store's row groups load::

        with materialize_dataset(url, schema) as writer:
            writer.write_rows(dict_rows)
    """
    path = url_to_path(dataset_url)
    if os.path.exists(path):
        existing = [f for f in list_files(path) if _is_data_file(f)]
        if existing and not overwrite:
            raise ValueError(
                '{} already contains {} data files; pass overwrite=True to '
                'replace them'.format(dataset_url, len(existing)))
        for f in existing:
            os.remove(f)
        meta_path = os.path.join(path, _COMMON_METADATA)
        if os.path.exists(meta_path):
            os.remove(meta_path)
    writer = DatasetWriter(path, schema, row_group_size_mb=row_group_size_mb,
                           rows_per_file=rows_per_file,
                           file_size_mb=file_size_mb, compression=compression)
    yield writer
    row_groups_per_file = writer.close()
    _write_common_metadata(path, schema, row_groups_per_file)
    if row_groups_per_file and not load_row_groups(path):
        raise MetadataError('metadata was written but no row groups are '
                            'discovered at {}'.format(dataset_url))


def load_row_groups(dataset_path: str) -> List[RowGroupPiece]:
    """All row groups as pieces sorted by (path, row group): from the
    metadata's per-file counts when present, else from the file footers."""
    metadata = read_common_metadata(dataset_path)
    if metadata and ROW_GROUPS_PER_FILE_KEY in metadata:
        counts = json.loads(metadata[ROW_GROUPS_PER_FILE_KEY].decode('utf-8'))
        return [RowGroupPiece(posixpath.join(dataset_path, rel), rg, n)
                for rel in sorted(counts)
                for rg, n in enumerate(counts[rel])]
    pieces = []
    for f in (f for f in list_files(dataset_path) if _is_data_file(f)):
        md = pq.ParquetFile(f).metadata
        pieces.extend(RowGroupPiece(f, rg, md.row_group(rg).num_rows)
                      for rg in range(md.num_row_groups))
    return pieces


def get_schema(dataset_path: str) -> Unischema:
    """The Unischema stored in ``_common_metadata``."""
    metadata = read_common_metadata(dataset_path)
    if metadata is None:
        raise MetadataError('Could not find _common_metadata at {}; was the '
                            'store written by materialize_dataset?'
                            .format(dataset_path))
    if UNISCHEMA_KEY not in metadata:
        raise MetadataError(
            '_common_metadata at {} does not carry a unischema (key {})'
            .format(dataset_path, UNISCHEMA_KEY))
    return Unischema.from_json(metadata[UNISCHEMA_KEY].decode('utf-8'))
