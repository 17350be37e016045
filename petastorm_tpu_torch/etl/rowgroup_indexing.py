"""Build and load secondary row-group indexes.

A copy of ``petastorm_tpu/etl/rowgroup_indexing.py`` (:30-72): a thread
pool scans the row groups through the store's filesystem, the indexers see
each row group as decoded row dicts, and the result is the JAX package's
JSON under ``ROWGROUPS_INDEX_KEY`` in ``_common_metadata``.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.etl.dataset_metadata import (ROWGROUPS_INDEX_KEY,
                                                      add_to_common_metadata,
                                                      get_schema,
                                                      load_row_groups,
                                                      read_common_metadata)
from petastorm_tpu_torch.etl.rowgroup_indexers import RowGroupIndexerBase
from petastorm_tpu_torch.fs import (get_filesystem_and_path_or_paths,
                                    normalize_dir_url)
from petastorm_tpu_torch.readers.piece_worker import PlainReads
from petastorm_tpu_torch.readers.row_worker import load_rows


def build_rowgroup_index(dataset_url: str,
                         indexers: List[RowGroupIndexerBase],
                         storage_options: Optional[Dict] = None,
                         num_workers: int = 8) -> None:
    """Scan every row group, feed the indexers, and store the combined
    index in ``_common_metadata``."""
    fs, path, _ = get_filesystem_and_path_or_paths(
        normalize_dir_url(dataset_url), storage_options)
    schema = get_schema(path, filesystem=fs)
    pieces = load_row_groups(path, filesystem=fs)
    if not pieces:
        raise PetastormMetadataError('No row groups found at {}'.format(
            dataset_url))
    columns = sorted({c for indexer in indexers
                      for c in indexer.column_names})
    unknown = set(columns) - set(schema.fields)
    if unknown:
        raise ValueError('Indexed fields not in schema: {}'.format(
            sorted(unknown)))
    reads = PlainReads(fs)
    with ThreadPoolExecutor(max_workers=num_workers) as executor:
        scanned = executor.map(
            lambda p: load_rows(p, schema, columns, io=reads), pieces)
        for piece_index, rows in enumerate(scanned):
            for indexer in indexers:
                indexer.build_index(rows, piece_index)
    payload = json.dumps({ix.index_name: ix.to_json_dict()
                          for ix in indexers})
    add_to_common_metadata(path, ROWGROUPS_INDEX_KEY, payload.encode('utf-8'),
                           filesystem=fs)


def get_row_group_indexes(dataset_path: str, filesystem=None
                          ) -> Dict[str, RowGroupIndexerBase]:
    """The stored indexes, keyed by index name."""
    metadata = read_common_metadata(dataset_path, filesystem)
    if not metadata or ROWGROUPS_INDEX_KEY not in metadata:
        raise PetastormMetadataError(
            'Dataset at {} has no row-group index. Build one with '
            'petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index'
            .format(dataset_path))
    raw = json.loads(metadata[ROWGROUPS_INDEX_KEY].decode('utf-8'))
    return {name: RowGroupIndexerBase.from_json_dict(d)
            for name, d in raw.items()}
