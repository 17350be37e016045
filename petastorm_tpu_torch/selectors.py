"""Row-group selectors: choose row groups via the stored secondary indexes.

A copy of ``petastorm_tpu/selectors.py`` (:14-71): ``RowGroupSelectorBase``,
``SingleIndexSelector``, ``IntersectIndexSelector``, ``UnionIndexSelector``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Iterable, List, Set


class RowGroupSelectorBase(ABC):
    """Maps stored indexes to a set of selected row-group ordinals."""

    @abstractmethod
    def get_index_names(self) -> List[str]:
        """Names of the indexes this selector needs."""

    @abstractmethod
    def select_row_groups(self, index_dict: Dict) -> Set[int]:
        """Compute the selected row-group ordinals from the loaded indexes."""


class SingleIndexSelector(RowGroupSelectorBase):
    """Row groups containing any of the given values in one index."""

    def __init__(self, index_name: str, values_list: Iterable):
        self._index_name = index_name
        self._values = list(values_list)

    def get_index_names(self):
        return [self._index_name]

    def select_row_groups(self, index_dict):
        indexer = index_dict[self._index_name]
        selected: Set[int] = set()
        for value in self._values:
            selected |= indexer.get_row_group_indexes(value)
        return selected


class IntersectIndexSelector(RowGroupSelectorBase):
    """AND-composition: row groups selected by every child selector."""

    def __init__(self, single_index_selectors: List[SingleIndexSelector]):
        self._selectors = list(single_index_selectors)

    def get_index_names(self):
        return sorted({n for s in self._selectors for n in s.get_index_names()})

    def select_row_groups(self, index_dict):
        sets = [s.select_row_groups(index_dict) for s in self._selectors]
        return set.intersection(*sets) if sets else set()


class UnionIndexSelector(RowGroupSelectorBase):
    """OR-composition: row groups selected by any child selector."""

    def __init__(self, single_index_selectors: List[SingleIndexSelector]):
        self._selectors = list(single_index_selectors)

    def get_index_names(self):
        return sorted({n for s in self._selectors for n in s.get_index_names()})

    def select_row_groups(self, index_dict):
        selected: Set[int] = set()
        for s in self._selectors:
            selected |= s.select_row_groups(index_dict)
        return selected
