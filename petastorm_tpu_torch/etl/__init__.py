"""Dataset writing and metadata of the port: the names of
``petastorm_tpu/etl/__init__.py`` (:8-10), with the port's signatures (a
store's path first, its ``filesystem`` a keyword)."""

from petastorm_tpu_torch.etl.dataset_metadata import (  # noqa: F401
    RowGroupPiece, get_schema, get_schema_from_dataset_url,
    infer_or_load_unischema, load_row_groups, materialize_dataset)

__all__ = ['materialize_dataset', 'load_row_groups', 'get_schema',
           'get_schema_from_dataset_url', 'infer_or_load_unischema',
           'RowGroupPiece']
