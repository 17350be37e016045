"""Row-group indexers: map field values to the set of row groups holding them.

A copy of ``petastorm_tpu/etl/rowgroup_indexers.py`` (:15-98):
``RowGroupIndexerBase``, ``SingleFieldIndexer`` and ``FieldNotNullIndexer``.
Indexes serialize to the JAX package's JSON (values stringified), so an
index built by either package reads in the other.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Set


class RowGroupIndexerBase(ABC):
    """Base class for indexers building secondary indexes over row groups."""

    def __init__(self, index_name: str, index_field: str):
        self._index_name = index_name
        self._index_field = index_field
        self._index: Dict[str, Set[int]] = {}

    @property
    def index_name(self) -> str:
        return self._index_name

    @property
    def column_names(self) -> List[str]:
        return [self._index_field]

    @property
    def indexed_values(self) -> List[str]:
        return sorted(self._index.keys())

    @abstractmethod
    def build_index(self, decoded_rows: List[dict], piece_index: int):
        """Accumulate index entries from one row group's decoded rows."""

    def get_row_group_indexes(self, value) -> Set[int]:
        return self._index.get(self._value_key(value), set())

    @staticmethod
    def _value_key(value) -> str:
        if isinstance(value, bytes):
            return value.decode('utf-8', 'replace')
        return str(value)

    # -- JSON (de)serialization ------------------------------------------------

    def to_json_dict(self) -> dict:
        return {
            'type': self.indexer_type,
            'index_name': self._index_name,
            'index_field': self._index_field,
            'values': {k: sorted(v) for k, v in self._index.items()},
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> 'RowGroupIndexerBase':
        indexer_cls = _INDEXER_TYPES[d['type']]
        indexer = indexer_cls(d['index_name'], d['index_field'])
        indexer._index = {k: set(v) for k, v in d['values'].items()}
        return indexer


class SingleFieldIndexer(RowGroupIndexerBase):
    """value -> {row-group indexes containing a row with that value}."""

    indexer_type = 'single_field'

    def build_index(self, decoded_rows, piece_index):
        for row in decoded_rows:
            value = row.get(self._index_field)
            if value is None:
                continue
            self._index.setdefault(self._value_key(value), set()).add(piece_index)


class FieldNotNullIndexer(RowGroupIndexerBase):
    """Single bucket of row groups having at least one non-null value."""

    indexer_type = 'not_null'
    _NOT_NULL_KEY = '__not_null__'

    def build_index(self, decoded_rows, piece_index):
        for row in decoded_rows:
            if row.get(self._index_field) is not None:
                self._index.setdefault(self._NOT_NULL_KEY, set()).add(piece_index)
                return

    def get_row_group_indexes(self, value=None) -> set:
        return self._index.get(self._NOT_NULL_KEY, set())


_INDEXER_TYPES = {
    SingleFieldIndexer.indexer_type: SingleFieldIndexer,
    FieldNotNullIndexer.indexer_type: FieldNotNullIndexer,
}
