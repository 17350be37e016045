"""O(1) exact checkpoint and resume for NGram window pipelines.

The port's copy of ``petastorm_tpu/indexed_ngram.py``. The unit of
addressing is a *window*: batch b of epoch e is a pure function of
``(dataset, ngram, seed, e, b)``. :class:`ShardedIndexedNGramLoader` gives
each rank of a mesh its slice of every global window batch, staged to its
device.

The window universe: within each row group, rows sort by the timestamp
field (stably) and a window starts at every position whose consecutive
timestamp deltas all stay within ``delta_threshold`` (without
``timestamp_overlap``, a greedy non-overlapping selection), as the
streaming NGram reader forms them. The index is built once from a scan of
the timestamp column (and a predicate's fields: its rejected rows drop
before windows form); each batch then assembles through ONE gather of the
rows of every offset, since a window never crosses a row group.

Batches come collated: ``{offset: {field: (B, ...) array}}``, the layout
the torch loader gives a streaming NGram reader.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.indexed import (IndexedBatchLoader,
                                         IndexedDatasetReader,
                                         sharded_batch_setup)
from petastorm_tpu_torch.ngram import NGram, valid_window_starts
from petastorm_tpu_torch.readers.columnar_worker import (
    predicate_row_mask, validate_predicate_fields)
from petastorm_tpu_torch.transform import (apply_columnar_transform,
                                           transform_schema)


def _scan_timestamps(dataset: IndexedDatasetReader, ts_name: str,
                     predicate=None) -> List[tuple]:
    """Per piece: ``(timestamp column, survivor local row indices or None)``,
    in one pass of :meth:`IndexedDatasetReader.scan_columns`. A
    ``predicate``'s fields are read with the timestamps and the rows it
    rejects drop before windows form, as in the streaming NGram reader, so
    a drop can open a timestamp gap that ``delta_threshold`` rejects."""
    pred_fields = (validate_predicate_fields(predicate, dataset.full_schema)
                   if predicate is not None else [])
    out: List[tuple] = []
    for _, cols, n in dataset.scan_columns({ts_name} | set(pred_fields)):
        ts = cols[ts_name]
        if predicate is None:
            out.append((ts, None))
        else:
            mask = predicate_row_mask(predicate, pred_fields, cols, n)
            idx = np.nonzero(mask)[0].astype(np.int64)
            out.append((ts[idx], idx))
    return out


class IndexedNGramLoader(IndexedBatchLoader):
    """Deterministic NGram window batches with O(1) exact resume.

    Yields ``{offset: {field: (batch_size, ...) array}}`` batches; the
    stream is a pure function of ``(dataset, ngram, seed)``, so
    ``state_dict()`` / ``load_state_dict()`` restore it byte for byte with
    any worker count.

    Shuffling works on whole windows (each stays timestamp-consecutive);
    the windows of ``shuffle_window_groups`` row groups shuffle together,
    as the row loader's rows do.
    """

    def __init__(self, dataset: IndexedDatasetReader, ngram: NGram,
                 batch_size: int, **kwargs):
        if kwargs.get('pad_spec') is not None:
            raise ValueError('IndexedNGramLoader does not support pad_spec '
                             '(NGram window fields are fixed-shape per '
                             'timestep)')
        # the predicate fixes the surviving ROWS during the index scan, and
        # the transform runs on each assembled batch: both here, not in the
        # row loader, whose row selection would fight the window permutation
        predicate = kwargs.pop('predicate', None)
        self._window_transform = kwargs.pop('transform_spec', None)
        ngram.resolve_regex_field_names(dataset.full_schema)
        self._ngram = ngram
        # read only the NGram's fields, as an explicit column list passed to
        # gather: a dataset shared with other loaders keeps its schema
        used = [n for n in ngram.get_all_field_names()
                if n in dataset.full_schema.fields]
        self._read_fields = tuple(used)
        view = dataset.full_schema.create_schema_view(
            [dataset.full_schema.fields[n] for n in used])
        if self._window_transform is not None:
            # each timestep's view filters on names after the transform; the
            # window universe is fixed at index build, so the transform must
            # not change the timestamps
            self._transformed_schema = transform_schema(
                view, self._window_transform)
        else:
            self._transformed_schema = view
        visible = set(self._transformed_schema.fields)
        self._offsets, self._base_offset, self._fields_at = \
            ngram.timestep_layout(visible)
        # a field present at fewer offsets than the window has is copied out
        # of the fused gather: its slice would pin the whole
        # (n_offsets * B, ...) base for the batch's lifetime
        present_count: Dict[str, int] = {}
        for names in self._fields_at.values():
            for n in names:
                present_count[n] = present_count.get(n, 0) + 1
        self._copy_fields = {n for n, c in present_count.items()
                             if c < len(self._offsets)}
        span = ngram.length

        scan = _scan_timestamps(dataset, ngram.timestamp_field_name,
                                predicate=predicate)
        win_starts: List[np.ndarray] = []
        counts = []
        # sorted position -> global row, flat over pieces: entry
        # row_offsets[p] + s is the global row of the s-th timestamp-sorted
        # surviving row of piece p
        pos_to_row = np.empty(dataset.total_rows, np.int64)
        for p, (ts, survivors) in enumerate(scan):
            order = np.argsort(ts, kind='stable')
            lo = dataset.row_offsets[p]
            if survivors is None:
                pos_to_row[lo:lo + len(ts)] = lo + order
            else:
                pos_to_row[lo:lo + len(ts)] = lo + survivors[order]
            starts = valid_window_starts(ts[order], span,
                                         ngram.delta_threshold,
                                         ngram.timestamp_overlap)
            win_starts.append(starts)
            counts.append(len(starts))
        self._pos_to_row = pos_to_row
        counts = np.asarray(counts, np.int64)
        win_offsets = np.concatenate([[0], np.cumsum(counts)])
        # global window id -> (piece, sorted start position), flat arrays
        self._win_piece = np.repeat(np.arange(len(counts), dtype=np.int64),
                                    counts)
        self._flat_starts = (np.concatenate(win_starts) if win_starts
                             else np.empty(0, np.int64))

        super().__init__(dataset, batch_size, **kwargs)
        # the public attributes report what is active: the window loader
        # owns the predicate and the transform, and .schema is the view of
        # the NGram's fields after the transform
        self.predicate = predicate
        self.transform_spec = self._window_transform
        self.schema = self._transformed_schema
        # the permutation shuffles windows (grouped by piece), not rows
        self.total_rows = int(win_offsets[-1])       # total windows
        self._perm_offsets = win_offsets
        self.batches_per_epoch = self.total_rows // batch_size
        if self.batches_per_epoch == 0:
            raise NoDataAvailableError(
                'Dataset yields {} NGram windows < batch_size {}'.format(
                    self.total_rows, batch_size))

    @property
    def total_windows(self) -> int:
        return self.total_rows

    def _assemble(self, epoch: int, batch: int) -> Dict[int, Dict[str, np.ndarray]]:
        """One gather a batch: the rows of every offset share row groups (a
        window never crosses a piece), so the ``(n_offsets, B)`` row matrix
        is read in one call."""
        win_ids = self._batch_rows(epoch, batch)     # global window indices
        piece_ids = self._win_piece[win_ids]
        base_pos = self._dataset.row_offsets[piece_ids] + self._flat_starts[win_ids]
        rel = np.asarray(self._offsets, np.int64) - self._base_offset
        rows = self._pos_to_row[(base_pos[None, :] + rel[:, None]).ravel()]
        cols = self._dataset.gather(rows, self._read_fields)
        if self._window_transform is not None:
            # one columnar transform over the whole gather: row-wise by
            # contract, so it equals the streaming path's per-row transform
            cols = apply_columnar_transform(self._window_transform,
                                            self._transformed_schema, cols)
        n = len(win_ids)
        out: Dict[int, Dict[str, np.ndarray]] = {}
        for i, offset in enumerate(self._offsets):
            sl = slice(i * n, (i + 1) * n)
            out[int(offset)] = {
                name: (cols[name][sl].copy() if name in self._copy_fields
                       else cols[name][sl])
                for name in self._fields_at[offset] if name in cols}
        return out


class ShardedIndexedNGramLoader(IndexedNGramLoader):
    """Deterministic NGram window batches over a mesh (JAX
    ``ShardedIndexedNGramLoader``, ``indexed_ngram.py:218-250``):
    ``batch_size`` is the GLOBAL window batch; every rank derives the same
    window permutation and assembles only the windows at its positions
    (:func:`~petastorm_tpu_torch.indexed.sharded_batch_setup`), each
    timestep's columns staged to its device in the nested ``{offset:
    {field: tensor}}`` layout. The schedule is a pure function of the
    cursor, so the ranks stay in lockstep with no collective."""

    def __init__(self, dataset: IndexedDatasetReader, ngram: NGram,
                 batch_size: int, mesh, batch_axis: str = 'data', **kwargs):
        sharding, local_positions = sharded_batch_setup(mesh, batch_axis,
                                                        batch_size)
        super().__init__(dataset, ngram, batch_size, **kwargs)
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.sharding = sharding
        self._local_positions = local_positions

    def _batch_rows(self, epoch: int, batch: int) -> np.ndarray:
        return super()._batch_rows(epoch, batch)[self._local_positions]

    def __iter__(self):
        from petastorm_tpu_torch.torch_utils import stage_to_global
        for batch in super().__iter__():
            yield {off: stage_to_global(cols, self.sharding)
                   for off, cols in batch.items()}


def make_indexed_ngram_loader(dataset_url, ngram: NGram, batch_size: int,
                              num_epochs: int = 1, seed: int = 0,
                              shuffle: bool = True,
                              shuffle_window_groups: int = 4,
                              workers_count: int = 4,
                              prefetch_batches: int = 8,
                              storage_options=None,
                              cache_groups=None, mesh=None,
                              batch_axis: str = 'data',
                              predicate=None,
                              transform_spec=None) -> IndexedNGramLoader:
    """Deterministic, O(1)-resumable NGram window batches on the host, or
    with ``mesh`` a :class:`ShardedIndexedNGramLoader` (this rank's slice
    of each global window batch on its device; JAX
    ``indexed_ngram.py:253-295``).

    ``predicate`` drops rows before windows form, during the index scan;
    ``transform_spec`` runs the columnar transform on each assembled batch
    (it must not change the timestamp field). Both keep the stream a pure
    function of the cursor.

    ::

        loader = make_indexed_ngram_loader(url, ngram, batch_size=64,
                                           num_epochs=10, seed=0)
        loader.load_state_dict(saved)        # exact mid-epoch restore
        for batch in loader:                 # {offset: {field: (B, ...)}}
            ...
    """
    dataset = IndexedDatasetReader(
        dataset_url, storage_options=storage_options,
        cache_groups=(cache_groups if cache_groups is not None
                      else max(8, shuffle_window_groups + workers_count)))
    kwargs = dict(num_epochs=num_epochs, seed=seed, shuffle=shuffle,
                  shuffle_window_groups=shuffle_window_groups,
                  workers_count=workers_count,
                  prefetch_batches=prefetch_batches, predicate=predicate,
                  transform_spec=transform_spec)
    if mesh is None:
        return IndexedNGramLoader(dataset, ngram, batch_size, **kwargs)
    return ShardedIndexedNGramLoader(dataset, ngram, batch_size, mesh=mesh,
                                     batch_axis=batch_axis, **kwargs)
