"""Print a store's schema, row-group indexes and row groups.

A copy of ``petastorm_tpu/etl/metadata_util.py``.

Usage::

    python -m petastorm_tpu_torch.etl.metadata_util file:///tmp/dataset \
        [--schema] [--index] [--row-groups] [--skip-index NAME ...]
"""

from __future__ import annotations

import argparse

from petastorm_tpu_torch.fs import (get_filesystem_and_path_or_paths,
                                    normalize_dir_url)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Inspect petastorm_tpu metadata')
    parser.add_argument('dataset_url')
    parser.add_argument('--schema', action='store_true',
                        help='Print the unischema')
    parser.add_argument('--index', action='store_true',
                        help='Print rowgroup indexes')
    parser.add_argument('--row-groups', action='store_true',
                        help='Print row-group pieces')
    parser.add_argument('--skip-index', nargs='+', default=[],
                        help='Index names to skip when printing')
    args = parser.parse_args(argv)

    url = normalize_dir_url(args.dataset_url)
    fs, path, _ = get_filesystem_and_path_or_paths(url)

    if args.schema:
        from petastorm_tpu_torch.etl.dataset_metadata import \
            infer_or_load_unischema
        schema, stored = infer_or_load_unischema(path, fs)
        print('Schema ({}):'.format('stored' if stored else 'inferred'))
        for field in schema.fields.values():
            print('  {}'.format(field))

    if args.index:
        from petastorm_tpu_torch.etl.rowgroup_indexing import \
            get_row_group_indexes
        indexes = get_row_group_indexes(path, fs)
        if not indexes:
            print('No indexes found')
        for name, indexer in indexes.items():
            if name in args.skip_index:
                continue
            print('Index {}:'.format(name))
            print('  column: {}'.format(getattr(indexer, 'column_name', '?')))
            values = indexer.indexed_values
            print('  {} indexed values, e.g. {}'.format(
                len(values), list(values)[:5]))

    if args.row_groups:
        from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
        pieces = load_row_groups(path, filesystem=fs)
        print('{} row groups:'.format(len(pieces)))
        for p in pieces:
            print('  {}#{} rows={} partitions={}'.format(
                p.path, p.row_group, p.num_rows, dict(p.partition_dict)))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
