"""Write tensor datasets to Parquet and discover their row groups.

Counterpart of ``petastorm_tpu/etl/dataset_metadata.py``:
``RowGroupPiece`` with hive partitions (:55-79), ``DatasetWriter`` /
``materialize_dataset`` (:82-258), ``read_common_metadata`` /
``add_to_common_metadata`` (:176-204), ``load_row_groups`` with explicit
file lists and its footer cache (:260-328), ``get_schema`` (:331-352),
``get_schema_from_dataset_url`` (:355), ``read_dataset_arrow_schema`` and
``infer_or_load_unischema`` (:363-393).
The metadata format is the JAX package's: the Unischema as JSON under
``petastorm_tpu.unischema.v1``, per-file row-group counts under
``petastorm_tpu.num_row_groups_per_file.v1`` and row-group indexes under
``petastorm_tpu.rowgroup_index.v1`` in ``_common_metadata``, so the two
packages read each other's stores; nothing is pickled. A store written by
original petastorm, whose ``_common_metadata`` holds only its pickled
schema, is read through :mod:`petastorm_tpu_torch.compat`.

Every function takes the store's ``filesystem`` (a keyword, the host's
:data:`~petastorm_tpu_torch.fs.LOCAL_FILESYSTEM` when None), as JAX's take
it first: schema load and inference, the row-group listing, footers and
the legacy pickled schema read through it, and ``materialize_dataset``
writes through the filesystem of its URL (``storage_options`` as in JAX).
A local store still opens its files by path.
"""

from __future__ import annotations

import json
import posixpath
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.compat import (PETASTORM_UNISCHEMA_KEY,
                                        unischema_from_petastorm_pickle)
from petastorm_tpu_torch.errors import (PetastormMetadataError,
                                        PetastormMetadataGenerationError)
from petastorm_tpu_torch.fs import (LOCAL_FILESYSTEM,
                                    get_filesystem_and_path_or_paths,
                                    normalize_dir_url)
from petastorm_tpu_torch.unischema import (INFERRED_SCHEMA_NAME, Unischema,
                                           UnischemaField, encode_row)

#: ``_common_metadata`` keys, shared with the JAX package's stores.
UNISCHEMA_KEY = b'petastorm_tpu.unischema.v1'
ROW_GROUPS_PER_FILE_KEY = b'petastorm_tpu.num_row_groups_per_file.v1'
ROWGROUPS_INDEX_KEY = b'petastorm_tpu.rowgroup_index.v1'

_COMMON_METADATA = '_common_metadata'
_DEFAULT_ROW_GROUP_SIZE_MB = 32
_FOOTER_READ_THREADS = 8


def _is_data_file(path: str) -> bool:
    base = posixpath.basename(path)
    return (not base.startswith(('_', '.')) and base.endswith('.parquet'))


def _local(filesystem) -> bool:
    return filesystem is None or filesystem is LOCAL_FILESYSTEM


def read_footer(path: str, filesystem=None):
    """The ``pq.FileMetaData`` of one parquet file: by path on the host's
    filesystem, else through ``filesystem.open``."""
    if _local(filesystem):
        return pq.ParquetFile(path).metadata
    with filesystem.open(path, 'rb') as f:
        return pq.ParquetFile(f).metadata


def _read_schema(path: str, filesystem=None) -> pa.Schema:
    if _local(filesystem):
        return pq.read_schema(path)
    with filesystem.open(path, 'rb') as f:
        return pq.read_schema(f)


def _write_metadata(arrow_schema, path: str, filesystem=None) -> None:
    if _local(filesystem):
        pq.write_metadata(arrow_schema, path)
        return
    with filesystem.open(path, 'wb') as f:
        pq.write_metadata(arrow_schema, f)


def _partition_values_from_relpath(relpath: str) -> Dict[str, str]:
    """Hive-style ``key=value`` directory components as a dict."""
    values = {}
    for component in posixpath.dirname(relpath).split('/'):
        if '=' in component:
            key, _, value = component.partition('=')
            values[key] = value
    return values


@dataclass(frozen=True)
class RowGroupPiece:
    """One unit of work: one row group of one parquet file, with the hive
    partition values of its directory (strings, as on disk)."""
    path: str
    row_group: int
    num_rows: int = -1
    partition_values: Tuple[Tuple[str, str], ...] = field(default=())

    @property
    def partition_dict(self) -> Dict[str, str]:
        return dict(self.partition_values)


class DatasetWriter:
    """Codec-encoding parquet writer: rows buffer into ``part_NNNNN.parquet``
    files whose row-group sizes follow ``row_group_size_mb``."""

    def __init__(self, dataset_path: str, schema: Unischema,
                 row_group_size_mb: float = _DEFAULT_ROW_GROUP_SIZE_MB,
                 rows_per_file: int = 100000, file_size_mb: float = 256,
                 compression: str = 'snappy', filesystem=None):
        self._fs = filesystem if filesystem is not None else LOCAL_FILESYSTEM
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
        self._fs.makedirs(dataset_path, exist_ok=True)

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
        full_path = posixpath.join(self._path, filename)
        if _local(self._fs):
            pq.write_table(table, full_path, row_group_size=rows_per_group,
                           compression=self._compression)
        else:
            with self._fs.open(full_path, 'wb') as f:
                pq.write_table(table, f, row_group_size=rows_per_group,
                               compression=self._compression)
        groups = -(-table.num_rows // rows_per_group)
        counts = [rows_per_group] * (groups - 1)
        counts.append(table.num_rows - rows_per_group * (groups - 1))
        self._row_groups_per_file[filename] = counts

    def close(self) -> Dict[str, List[int]]:
        self._flush()
        return dict(self._row_groups_per_file)


def _write_common_metadata(dataset_path: str, schema: Unischema,
                           row_groups_per_file: Dict[str, List[int]],
                           filesystem=None,
                           extra_metadata: Optional[Dict[bytes, bytes]] = None
                           ) -> None:
    metadata = dict(extra_metadata or {})
    metadata.update({UNISCHEMA_KEY: schema.to_json().encode('utf-8'),
                     ROW_GROUPS_PER_FILE_KEY:
                         json.dumps(row_groups_per_file).encode('utf-8')})
    _write_metadata(schema.as_arrow_schema().with_metadata(metadata),
                    posixpath.join(dataset_path, _COMMON_METADATA),
                    filesystem)


def read_common_metadata(dataset_path, filesystem=None
                         ) -> Optional[Dict[bytes, bytes]]:
    """The ``_common_metadata`` schema metadata, or None if absent (always
    for an explicit list of files)."""
    if isinstance(dataset_path, list):
        return None
    fs = filesystem if filesystem is not None else LOCAL_FILESYSTEM
    meta_path = posixpath.join(dataset_path, _COMMON_METADATA)
    if not fs.exists(meta_path):
        return None
    return dict(_read_schema(meta_path, fs).metadata or {})


def add_to_common_metadata(dataset_path: str, key: bytes,
                           value: bytes, filesystem=None) -> None:
    """Merge one key into ``_common_metadata``, keeping the others."""
    existing = read_common_metadata(dataset_path, filesystem) or {}
    existing[key] = value
    if UNISCHEMA_KEY not in existing:
        raise PetastormMetadataError(
            'Cannot add metadata to {}: no unischema present'.format(
                dataset_path))
    schema = Unischema.from_json(existing[UNISCHEMA_KEY].decode('utf-8'))
    _write_metadata(schema.as_arrow_schema().with_metadata(existing),
                    posixpath.join(dataset_path, _COMMON_METADATA),
                    filesystem)


@contextmanager
def materialize_dataset(dataset_url: str, schema: Unischema,
                        row_group_size_mb: float = _DEFAULT_ROW_GROUP_SIZE_MB,
                        rows_per_file: int = 100000,
                        file_size_mb: float = 256,
                        compression: str = 'snappy',
                        overwrite: bool = False,
                        storage_options: Optional[Dict] = None):
    """Context manager yielding a :class:`DatasetWriter`; on exit writes
    ``_common_metadata`` and checks that the store's row groups load::

        with materialize_dataset(url, schema) as writer:
            writer.write_rows(dict_rows)

    ``dataset_url`` is any URL the readers take (``storage_options`` go to
    its filesystem)."""
    fs, path, _ = get_filesystem_and_path_or_paths(
        normalize_dir_url(dataset_url), storage_options)
    if fs.exists(path):
        existing = _list_data_files(path, fs)
        if existing and not overwrite:
            raise ValueError(
                '{} already contains {} data files; pass overwrite=True to '
                'replace them'.format(dataset_url, len(existing)))
        for f in existing:
            fs.rm(f)
        meta_path = posixpath.join(path, _COMMON_METADATA)
        if fs.exists(meta_path):
            fs.rm(meta_path)
    writer = DatasetWriter(path, schema, row_group_size_mb=row_group_size_mb,
                           rows_per_file=rows_per_file,
                           file_size_mb=file_size_mb, compression=compression,
                           filesystem=fs)
    yield writer
    row_groups_per_file = writer.close()
    _write_common_metadata(path, schema, row_groups_per_file, fs)
    if row_groups_per_file and not load_row_groups(path, filesystem=fs):
        raise PetastormMetadataGenerationError(
            'metadata was written but no row groups are discovered at {}'
            .format(dataset_url))


def _list_data_files(dataset_path, filesystem=None) -> List[str]:
    """The data files of a store directory, sorted (as the filesystem's
    ``find`` names them: absolute on a local one), or an explicit file list
    in the caller's order."""
    if isinstance(dataset_path, list):
        return list(dataset_path)
    fs = filesystem if filesystem is not None else LOCAL_FILESYSTEM
    return sorted(f for f in fs.find(dataset_path) if _is_data_file(f))


def _partition_values(dataset_path, path: str) -> Tuple[Tuple[str, str], ...]:
    if isinstance(dataset_path, list):
        return ()     # explicit file lists carry no hive partition values
    rel = posixpath.relpath(path, dataset_path)
    return tuple(sorted(_partition_values_from_relpath(rel).items()))


def load_row_groups(dataset_path, footer_cache: Optional[Dict] = None,
                    filesystem=None) -> List[RowGroupPiece]:
    """All row groups as pieces: from the metadata's per-file counts when
    present, else from the file footers (read on a few threads, and kept in
    ``footer_cache`` by path when one is given). A store directory's pieces
    are sorted by (path, row group); an explicit list of files keeps the
    caller's order."""
    metadata = read_common_metadata(dataset_path, filesystem)
    if metadata and ROW_GROUPS_PER_FILE_KEY in metadata:
        counts = json.loads(metadata[ROW_GROUPS_PER_FILE_KEY].decode('utf-8'))
        return [RowGroupPiece(posixpath.join(dataset_path, rel), rg, n,
                              _partition_values(dataset_path,
                                                posixpath.join(dataset_path,
                                                               rel)))
                for rel in sorted(counts)
                for rg, n in enumerate(counts[rel])]
    files = _list_data_files(dataset_path, filesystem)
    if not files:
        return []

    def footer(path):
        md = read_footer(path, filesystem)
        if footer_cache is not None:
            footer_cache[path] = md
        return path, md

    pieces = []
    with ThreadPoolExecutor(max_workers=_FOOTER_READ_THREADS) as executor:
        for path, md in executor.map(footer, files):
            parts = _partition_values(dataset_path, path)
            pieces.extend(RowGroupPiece(path, rg, md.row_group(rg).num_rows,
                                        parts)
                          for rg in range(md.num_row_groups))
    if not isinstance(dataset_path, list):
        pieces.sort(key=lambda p: (p.path, p.row_group))
    return pieces


def get_schema(dataset_path, filesystem=None) -> Unischema:
    """The Unischema stored in ``_common_metadata``: the JAX package's JSON,
    or original petastorm's pickle (:mod:`petastorm_tpu_torch.compat`)."""
    metadata = read_common_metadata(dataset_path, filesystem)
    if metadata is None:
        raise PetastormMetadataError(
            'Could not find _common_metadata at {}; was the store written by '
            'materialize_dataset? A plain parquet store reads with '
            'make_batch_reader.'.format(dataset_path))
    if UNISCHEMA_KEY not in metadata:
        if PETASTORM_UNISCHEMA_KEY in metadata:
            # written by original petastorm: its pickled schema, decoded by
            # the restricted unpickler
            return unischema_from_petastorm_pickle(
                metadata[PETASTORM_UNISCHEMA_KEY])
        raise PetastormMetadataError(
            '_common_metadata at {} does not carry a unischema (key {})'
            .format(dataset_path, UNISCHEMA_KEY))
    return Unischema.from_json(metadata[UNISCHEMA_KEY].decode('utf-8'))


def get_schema_from_dataset_url(dataset_url: str,
                                storage_options: Optional[Dict] = None
                                ) -> Unischema:
    """:func:`get_schema` of the store at ``dataset_url`` (any URL the
    readers take; ``storage_options`` go to its filesystem)."""
    fs, path, _ = get_filesystem_and_path_or_paths(
        normalize_dir_url(dataset_url), storage_options)
    return get_schema(path, fs)


def read_dataset_arrow_schema(dataset_path, filesystem=None) -> pa.Schema:
    """The store's physical arrow schema, from its first data file."""
    files = _list_data_files(dataset_path, filesystem)
    if not files:
        raise PetastormMetadataError('No parquet files found at {}'.format(
            dataset_path))
    return _read_schema(files[0], filesystem)


def infer_or_load_unischema(dataset_path, filesystem=None
                            ) -> Tuple[Unischema, bool]:
    """``(schema, was_stored)``: the stored Unischema, or one inferred from
    the physical arrow schema (plain stores, explicit file lists) plus a
    string field for each hive partition key the files do not hold."""
    try:
        return get_schema(dataset_path, filesystem), True
    except PetastormMetadataError:
        schema = Unischema.from_arrow_schema(
            read_dataset_arrow_schema(dataset_path, filesystem))
        keys: Dict[str, None] = {}
        if not isinstance(dataset_path, list):
            for f in _list_data_files(dataset_path, filesystem):
                keys.update(dict.fromkeys(_partition_values_from_relpath(
                    posixpath.relpath(f, dataset_path))))
        extra = [UnischemaField(k, str, (), None, False) for k in keys
                 if k not in schema.fields]
        if extra:
            schema = Unischema(INFERRED_SCHEMA_NAME,
                               list(schema.fields.values()) + extra)
        return schema, False
