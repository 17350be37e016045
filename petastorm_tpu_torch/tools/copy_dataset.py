"""Copy a dataset, optionally keeping only some columns and dropping rows
with nulls.

A copy of ``petastorm_tpu/tools/copy_dataset.py``: row-group tables
stream through pyarrow, are decoded with the store's codecs and written
again with ``materialize_dataset``; ``field_regex`` picks the columns,
``not_null_fields`` drops rows, and ``rows_per_file`` and
``row_group_size_mb`` lay out the copy.

Usage::

    python -m petastorm_tpu_torch.tools.copy_dataset file:///src \
        file:///dst --field-regex 'id.*' --not-null-fields other_field \
        --rows-per-file 10000
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from petastorm_tpu_torch.etl.dataset_metadata import (get_schema,
                                                      load_row_groups,
                                                      materialize_dataset)
from petastorm_tpu_torch.fs import (get_filesystem_and_path_or_paths,
                                    normalize_dir_url)
from petastorm_tpu_torch.unischema import decode_row, match_unischema_fields

logger = logging.getLogger(__name__)


def copy_dataset(source_url: str, target_url: str,
                 field_regex: Optional[List[str]] = None,
                 not_null_fields: Optional[List[str]] = None,
                 overwrite_output: bool = False,
                 rows_per_file: int = 0,
                 row_group_size_mb: Optional[float] = None,
                 storage_options=None) -> int:
    """Copy ``source_url`` to ``target_url``; returns the rows copied.
    ``storage_options`` go to the source's filesystem."""
    source_url = normalize_dir_url(source_url)
    target_url = normalize_dir_url(target_url)
    fs, path, _ = get_filesystem_and_path_or_paths(source_url,
                                                   storage_options)
    schema = get_schema(path, fs)

    if field_regex:
        fields = match_unischema_fields(schema, field_regex)
        if not fields:
            raise ValueError('field_regex {} matched no fields'.format(
                field_regex))
        schema = schema.create_schema_view(fields)
    if not_null_fields:
        unknown = set(not_null_fields) - set(schema.fields)
        if unknown:
            raise ValueError('not_null_fields not in schema: {}'.format(
                sorted(unknown)))

    pieces = load_row_groups(path, filesystem=fs)
    copied = 0
    kwargs = {'rows_per_file': rows_per_file} if rows_per_file else {}
    if row_group_size_mb:
        kwargs['row_group_size_mb'] = row_group_size_mb
    with materialize_dataset(target_url, schema, overwrite=overwrite_output,
                             **kwargs) as writer:
        import pyarrow.parquet as pq
        for piece in pieces:
            with fs.open(piece.path, 'rb') as f:
                table = pq.ParquetFile(f).read_row_group(
                    piece.row_group,
                    columns=[n for n in schema.fields
                             if n not in piece.partition_dict])
            rows = table.to_pylist()
            for key, value in piece.partition_dict.items():
                if key in schema.fields:
                    for r in rows:
                        r[key] = value
            decoded = [decode_row(r, schema) for r in rows]
            if not_null_fields:
                decoded = [r for r in decoded
                           if all(r[f] is not None for f in not_null_fields)]
            writer.write_rows(decoded)
            copied += len(decoded)
    logger.info('Copied %d rows from %s to %s', copied, source_url,
                target_url)
    return copied


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('source_url')
    parser.add_argument('target_url')
    parser.add_argument('--field-regex', nargs='+', default=None)
    parser.add_argument('--not-null-fields', nargs='+', default=None)
    parser.add_argument('--overwrite-output', action='store_true')
    parser.add_argument('--rows-per-file', type=int, default=0)
    parser.add_argument('--row-group-size-mb', type=float, default=None)
    parser.add_argument('-v', action='store_true')
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.v:
        logging.basicConfig(level=logging.INFO)
    copy_dataset(args.source_url, args.target_url,
                 field_regex=args.field_regex,
                 not_null_fields=args.not_null_fields,
                 overwrite_output=args.overwrite_output,
                 rows_per_file=args.rows_per_file,
                 row_group_size_mb=args.row_group_size_mb)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
