"""NGram: windows of consecutive timestamp-sorted rows.

A copy of ``petastorm_tpu/ngram.py``: ``valid_window_starts`` (:22-48),
``NGramWindowChunk`` (:51-66), ``NGram`` (:69-184), its row path
(``_window_passes_threshold``, ``form_ngram_dicts``,
``get_schema_at_timestep``, ``_timestep_view``, ``make_namedtuples`` and
``form_ngram`` :157-290) and its column path (``form_windows_columnar``
:224-252). Both paths sort by timestamp stably and apply the same
``delta_threshold`` and ``timestamp_overlap`` rules. Windows never cross
row-group boundaries. A window is ``{offset: {field: value}}`` for the
offsets of ``fields``: the row path builds one dict per window, the column
path a whole :class:`NGramWindowChunk` out of which consumers slice windows
column-wise.
"""

from __future__ import annotations

import numbers
from datetime import timedelta
from typing import Dict, List, Optional, Union

import numpy as np

from petastorm_tpu_torch.unischema import (Unischema, UnischemaField,
                                           match_unischema_fields)


def valid_window_starts(ts_sorted: np.ndarray, span: int, delta_threshold,
                        timestamp_overlap: bool) -> np.ndarray:
    """Start positions (in ts-sorted order) of all valid windows: every
    consecutive timestamp gap inside the window is at most
    ``delta_threshold``; without ``timestamp_overlap``, a greedy
    non-overlapping selection."""
    n = len(ts_sorted)
    if n < span:
        return np.empty(0, np.int64)
    if span == 1:
        starts = np.arange(n, dtype=np.int64)
    else:
        gap_ok = (np.diff(ts_sorted) <= delta_threshold).astype(np.int32)
        cum = np.concatenate([[0], np.cumsum(gap_ok)])
        valid = (cum[span - 1:] - cum[:n - span + 1]) == span - 1
        starts = np.nonzero(valid)[0].astype(np.int64)
    if timestamp_overlap or not len(starts):
        return starts
    keep, previous_end = [], None
    for s in starts:
        if previous_end is None or ts_sorted[s] > previous_end:
            keep.append(s)
            previous_end = ts_sorted[s + span - 1]
    return np.asarray(keep, np.int64)


class NGramWindowChunk:
    """All valid windows of one row group: ``columns`` holds each declared
    field's decoded column in timestamp order, ``starts`` each window's start
    row. The row at offset ``off`` of window ``i`` is ``starts[i] + off -
    base_offset``."""

    __slots__ = ('columns', 'starts')

    def __init__(self, columns: Dict[str, np.ndarray], starts: np.ndarray):
        self.columns = columns
        self.starts = starts

    def __len__(self) -> int:
        return len(self.starts)


class NGram:
    """A sliding window over consecutive rows.

    :param fields: ``{offset: [UnischemaField | name regex, ...]}``; a window
        spans ``max(offsets) - min(offsets) + 1`` rows.
    :param delta_threshold: largest timestamp step allowed inside a window.
    :param timestamp_field: the field (or its name) ordering rows.
    :param timestamp_overlap: if False, windows must not overlap in time.
    """

    def __init__(self, fields: Dict[int, List], delta_threshold,
                 timestamp_field: Union[UnischemaField, str],
                 timestamp_overlap: bool = True):
        if not fields:
            raise ValueError('NGram fields must have at least one timestep')
        if not all(isinstance(k, numbers.Integral) for k in fields):
            raise TypeError('NGram offsets must be integers, got {}'.format(
                sorted(map(repr, fields))))
        if not all(isinstance(v, (list, tuple)) for v in fields.values()):
            raise TypeError('NGram fields values must be lists of fields')
        if not isinstance(delta_threshold, (numbers.Number, timedelta)):
            raise TypeError('delta_threshold must be numeric, got {!r}'
                            .format(delta_threshold))
        self._offsets = sorted(fields)
        self._fields = {k: list(v) for k, v in fields.items()}
        self._delta_threshold = delta_threshold
        self._timestamp_field = timestamp_field
        self._timestamp_overlap = timestamp_overlap
        # offset -> (schema, view): one view (and namedtuple type) per
        # timestep, checked against the schema's identity
        self._view_cache: Dict = {}

    @property
    def fields(self) -> Dict[int, List]:
        return self._fields

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def length(self) -> int:
        """Window span in rows."""
        return self._offsets[-1] - self._offsets[0] + 1

    @property
    def timestamp_field_name(self) -> str:
        if isinstance(self._timestamp_field, UnischemaField):
            return self._timestamp_field.name
        return self._timestamp_field

    @property
    def timestamp_overlap(self) -> bool:
        return self._timestamp_overlap

    def resolve_regex_field_names(self, schema: Unischema) -> None:
        """Replace regex strings in ``fields`` with the matching fields."""
        for offset, field_list in self._fields.items():
            resolved = []
            for f in field_list:
                if isinstance(f, str):
                    matched = match_unischema_fields(schema, [f])
                    if not matched:
                        raise ValueError('NGram regex {!r} matched no fields'
                                         .format(f))
                    resolved.extend(matched)
                else:
                    resolved.append(f)
            seen = set()
            self._fields[offset] = [f for f in resolved
                                    if not (f.name in seen
                                            or seen.add(f.name))]

    def get_field_names_at_timestep(self, timestep: int) -> List[str]:
        return [f.name if isinstance(f, UnischemaField) else f
                for f in self._fields.get(timestep, [])]

    def get_schema_at_timestep(self, schema: Unischema,
                               timestep: int) -> Unischema:
        """The view of ``schema`` holding this timestep's fields."""
        return schema.create_schema_view(
            [f for f in self._fields.get(timestep, [])
             if f.name in schema.fields])

    def _declared(self) -> set:
        names = set()
        for field_list in self._fields.values():
            names.update(f.name if isinstance(f, UnischemaField) else f
                         for f in field_list)
        return names

    def get_all_field_names(self) -> List[str]:
        """Every field a worker must read: the declared ones plus the
        timestamp field."""
        return sorted(self._declared() | {self.timestamp_field_name})

    def timestep_layout(self, field_names):
        """``(offsets, base_offset, {offset: [field, ...]})`` with each
        timestep's fields filtered to ``field_names``."""
        offsets = sorted(self._fields)
        fields_at = {off: [n for n in self.get_field_names_at_timestep(off)
                           if n in field_names]
                     for off in offsets}
        return offsets, offsets[0], fields_at

    def _window_passes_threshold(self, window: List[dict]) -> bool:
        ts_name = self.timestamp_field_name
        return not any(current[ts_name] - previous[ts_name]
                       > self._delta_threshold
                       for previous, current in zip(window, window[1:]))

    def form_ngram_dicts(self, data: List[dict],
                         schema: Unischema) -> List[Dict[int, dict]]:
        """Every valid window of the rows ``data`` (stably sorted by
        timestamp) as ``{offset: {field: value}}``, each timestep holding
        its fields of ``schema``."""
        ts_name = self.timestamp_field_name
        rows = sorted(data, key=lambda r: r[ts_name])
        base = self._offsets[0]
        ngrams = []
        previous_end = None
        for start in range(len(rows) - self.length + 1):
            window = rows[start:start + self.length]
            if not self._window_passes_threshold(window):
                continue
            if (not self._timestamp_overlap and previous_end is not None
                    and window[0][ts_name] <= previous_end):
                continue
            ngrams.append({
                off: {name: window[off - base][name]
                      for name in self._timestep_view(schema, off).fields}
                for off in self._offsets})
            previous_end = window[-1][ts_name]
        return ngrams

    def _timestep_view(self, schema: Unischema, offset: int) -> Unischema:
        cached = self._view_cache.get(offset)
        if cached is not None and cached[0] is schema:
            return cached[1]
        view = self.get_schema_at_timestep(schema, offset)
        self._view_cache[offset] = (schema, view)
        return view

    def make_namedtuples(self, window: Dict[int, dict],
                         schema: Unischema) -> Dict[int, object]:
        """One dict window as ``{offset: namedtuple}`` of the timestep
        views of ``schema``."""
        return {off: self._timestep_view(schema, off).make_namedtuple(**row)
                for off, row in window.items()}

    def form_ngram(self, data: List[dict],
                   schema: Unischema) -> List[Dict[int, object]]:
        """:meth:`form_ngram_dicts` then :meth:`make_namedtuples`."""
        return [self.make_namedtuples(w, schema)
                for w in self.form_ngram_dicts(data, schema)]

    def form_windows_columnar(self, columns: Dict[str, np.ndarray]
                              ) -> Optional[NGramWindowChunk]:
        """Sort one row group's decoded columns by timestamp (stable), find
        the valid window starts, and return them as a chunk sliced to the
        envelope of valid windows (None when no window is valid)."""
        ts = np.asarray(columns[self.timestamp_field_name])
        order = np.argsort(ts, kind='stable')
        starts = valid_window_starts(ts[order], self.length,
                                     self._delta_threshold,
                                     self._timestamp_overlap)
        if not len(starts):
            return None
        declared = self._declared()
        lo, hi = int(starts[0]), int(starts[-1]) + self.length
        sorted_cols = {name: np.asarray(col)[order[lo:hi]]
                       for name, col in columns.items() if name in declared}
        return NGramWindowChunk(sorted_cols, starts - lo)
