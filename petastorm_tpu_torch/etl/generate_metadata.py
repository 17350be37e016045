"""Add (or write again) the port's metadata on an existing Parquet store.

A copy of ``petastorm_tpu/etl/generate_metadata.py``: the Unischema
comes from ``--unischema-class`` (a ``package.module.attribute`` path),
from the store's own metadata, or is inferred from its Parquet schema;
the row-group counts come from the file footers, read on a few threads;
an existing row-group index is kept. The metadata is the JAX package's
JSON, so either package reads the store afterwards.
"""

from __future__ import annotations

import argparse
import logging
import posixpath
from typing import Dict, Optional

from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.etl.dataset_metadata import (ROWGROUPS_INDEX_KEY,
                                                      _list_data_files,
                                                      _write_common_metadata,
                                                      load_row_groups,
                                                      read_common_metadata)
from petastorm_tpu_torch.fs import (get_filesystem_and_path_or_paths,
                                    normalize_dir_url)
from petastorm_tpu_torch.unischema import Unischema

logger = logging.getLogger(__name__)


def _import_unischema(full_name: str) -> Unischema:
    """The Unischema instance at a ``package.module.attribute`` path."""
    import importlib
    module_name, _, attr = full_name.rpartition('.')
    if not module_name:
        raise ValueError('--unischema-class must be a full module path, got '
                         '{!r}'.format(full_name))
    schema = getattr(importlib.import_module(module_name), attr)
    if not isinstance(schema, Unischema):
        raise ValueError('{} is not a Unischema instance'.format(full_name))
    return schema


def generate_metadata(dataset_url: str, unischema: Optional[Unischema] = None,
                      storage_options: Optional[Dict] = None) -> None:
    """Write ``_common_metadata`` (the schema and each file's row-group row
    counts) for the store at ``dataset_url``, keeping an existing index."""
    dataset_url = normalize_dir_url(dataset_url)
    fs, path, _ = get_filesystem_and_path_or_paths(dataset_url,
                                                   storage_options)
    existing = read_common_metadata(path, fs) or {}

    if unischema is None:
        from petastorm_tpu_torch.etl.dataset_metadata import \
            infer_or_load_unischema
        unischema, was_stored = infer_or_load_unischema(path, fs)
        if not was_stored:
            logger.info('No stored unischema; inferred one from the arrow '
                        'schema')

    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.parquet as pq

    files = _list_data_files(path, fs)
    if not files:
        raise PetastormMetadataError('No parquet files found at {}'.format(
            dataset_url))

    def scan(f):
        with fs.open(f, 'rb') as fh:
            md = pq.ParquetFile(fh).metadata
            return f, [md.row_group(i).num_rows
                       for i in range(md.num_row_groups)]

    counts = {}
    with ThreadPoolExecutor(max_workers=8) as ex:
        for f, per_group in ex.map(scan, files):
            counts[posixpath.relpath(f, path)] = per_group

    extra = {}
    if ROWGROUPS_INDEX_KEY in existing:
        extra[ROWGROUPS_INDEX_KEY] = existing[ROWGROUPS_INDEX_KEY]
    _write_common_metadata(path, unischema, counts, fs, extra_metadata=extra)
    # the store's row groups must load from the new metadata
    pieces = load_row_groups(path, filesystem=fs)
    logger.info('Wrote metadata for %d row groups across %d files',
                len(pieces), len(files))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Add petastorm_tpu metadata to an existing parquet store')
    parser.add_argument('dataset_url',
                        help='e.g. file:///tmp/ds, gs://bucket/ds')
    parser.add_argument('--unischema-class', default=None,
                        help='Full path to a Unischema instance, e.g. '
                             'mypkg.schemas.MySchema; if omitted, the schema '
                             'is loaded from existing metadata or inferred '
                             'from the parquet files')
    args = parser.parse_args(argv)
    schema = (_import_unischema(args.unischema_class)
              if args.unischema_class else None)
    logging.basicConfig(level=logging.INFO)
    generate_metadata(args.dataset_url, schema)


if __name__ == '__main__':
    main()
