"""Deterministic random-access loader with O(1) exact resume.

The port's copy of ``petastorm_tpu/indexed.py``. **Batch b of epoch e is
a pure function of (dataset, seed, e, b).**

- :class:`IndexedDatasetReader` (:50) reads decoded row groups by index
  (an LRU row-group cache, one Parquet handle per thread, the columns
  decoded by the port's column decode,
  :func:`~petastorm_tpu_torch.readers.columnar_worker.decode_column`,
  which honors ``PETASTORM_TPU_BATCHED_DECODE``).
- :class:`IndexedBatchLoader` (:352) derives each epoch's window-shuffled
  permutation of global row indices from ``(seed, epoch)``
  (:func:`epoch_permutation`, seeded ``np.random.default_rng((seed,
  epoch))`` as JAX seeds it), slices it into fixed batches, assembles them
  on a thread pool by index and reorders the results, so the pool's
  scheduling cannot change the stream. ``state_dict()`` /
  ``load_state_dict()`` restore it byte for byte with any worker count,
  without replay.

- :class:`ShardedIndexedLoader` (:630) gives each rank of a mesh its slice
  of every global batch (:func:`sharded_batch_setup`: the contiguous block
  of positions at its ``batch_axis`` coordinate, so the ``seq`` ranks of
  one data group get equal batches by construction), staged to its device.
  The schedule being a pure function of the cursor, the ranks stay in
  lockstep with no collective, and a cursor saved at one world size
  resumes the same global stream at another.

The schedule: the port's :class:`~petastorm_tpu_torch.workers.thread_pool.
ThreadPool` ventilates the ``(epoch, batch)`` grid lazily from the cursor
through its :class:`~petastorm_tpu_torch.workers.thread_pool.
VentilationJob` (``schedule=``), bounded by ``workers_count +
prefetch_batches`` items in flight, beating as the ``ventilator`` entity
through :attr:`IndexedBatchLoader.heartbeat`; the pool's worker is the
loader's own assembly (JAX's ``_ScheduleVentilator`` and
``_IndexedBatchWorker``, :314-349). A worker's exception reaches the
consumer. A pool whose threads outlive ``join`` is kept, and the dataset's
handles are closed only once every thread it lists
(:attr:`ThreadPool.threads`) has exited.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import (infer_or_load_unischema,
                                                      load_row_groups)
from petastorm_tpu_torch.fs import (get_filesystem_and_path_or_paths,
                                    normalize_dataset_url_or_urls)
from petastorm_tpu_torch.padding import (check_pad_spec_fields,
                                         pad_ragged_batch,
                                         require_single_bucket_pad_spec,
                                         validate_pad_spec)
from petastorm_tpu_torch.readers.columnar_worker import (
    decode_column, make_partition_columns, predicate_row_mask,
    validate_predicate_fields)
from petastorm_tpu_torch.transform import (apply_columnar_transform,
                                           transform_schema)
from petastorm_tpu_torch.unischema import match_unischema_fields
from petastorm_tpu_torch.utils import cast_partition_value
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     ThreadPool)

logger = logging.getLogger(__name__)

#: Seconds a loader waits for its pool's threads after a pass.
POOL_JOIN_TIMEOUT_S = 10.0


class IndexedDatasetReader:
    """Random-access decoded reads over a dataset of the port.

    ``read_piece(i)`` returns the decoded columns of row group ``i``
    (through a bounded LRU cache); global row index arithmetic is exposed
    through ``row_offsets`` / ``total_rows``. Thread-safe.
    """

    def __init__(self, dataset_url: str, schema_fields: Optional[List[str]] = None,
                 storage_options=None, cache_groups: int = 8):
        dataset_url = normalize_dataset_url_or_urls(dataset_url)
        fs, path, _ = get_filesystem_and_path_or_paths(dataset_url,
                                                       storage_options)
        if isinstance(path, list):
            raise ValueError('IndexedDatasetReader needs a single dataset url')
        self._filesystem = fs
        self._path = path
        # plain parquet stores work too: the schema is inferred from the
        # footer and the row counts come from the footers
        stored_schema, _ = infer_or_load_unischema(path, fs)
        #: the whole stored schema: a predicate may use fields outside the
        #: output view, as with the streaming readers
        self.full_schema = stored_schema
        if schema_fields is not None:
            matched = match_unischema_fields(stored_schema, schema_fields)
            if not matched:
                raise ValueError('schema_fields {} matched no fields'.format(
                    schema_fields))
            self.schema = stored_schema.create_schema_view(matched)
        else:
            self.schema = stored_schema
        self.pieces = load_row_groups(path, filesystem=fs)
        if not self.pieces:
            raise NoDataAvailableError('No row groups at {}'.format(path))
        if any(p.num_rows < 0 for p in self.pieces):
            raise ValueError('IndexedDatasetReader needs per-row-group row '
                             'counts (regenerate dataset metadata)')
        counts = np.asarray([p.num_rows for p in self.pieces], np.int64)
        #: row_offsets[i] = global index of the first row of piece i
        self.row_offsets = np.concatenate([[0], np.cumsum(counts)])
        self.total_rows = int(self.row_offsets[-1])

        # keyed by (piece index, fields tuple or None): narrowed and full
        # reads of one piece never alias
        self._cache: 'collections.OrderedDict[tuple, Dict[str, np.ndarray]]' = \
            collections.OrderedDict()
        self._cache_groups = cache_groups
        self._lock = threading.Lock()
        # a ParquetFile must not be read from two threads at once: each
        # thread opens its own handles
        self._local = threading.local()
        self._open_files: List = []

    # -- io --------------------------------------------------------------------

    def _parquet_file(self, path: str):
        import pyarrow.parquet as pq
        files = getattr(self._local, 'files', None)
        if files is None:
            files = self._local.files = {}
        pf = files.get(path)
        if pf is None:
            handle = self._filesystem.open(path, 'rb')
            try:
                pf = pq.ParquetFile(handle)
            except Exception:
                handle.close()   # a bad footer must not leak the handle
                raise
            files[path] = pf
            with self._lock:
                self._open_files.append(handle)
        return pf

    def close(self):
        """Close every Parquet handle any thread opened."""
        with self._lock:
            handles, self._open_files = self._open_files, []
        self._local = threading.local()
        for handle in handles:
            try:
                handle.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()

    def read_piece(self, piece_index: int,
                   fields: Optional[tuple] = None) -> Dict[str, np.ndarray]:
        """Decoded columns of row group ``piece_index``.

        ``fields`` (a tuple of names from the whole schema) narrows the read
        to those columns: the NGram loader reads another column set than the
        output view without changing shared state; the cache keys on
        (piece, fields), so narrowed and full reads never alias."""
        cache_key = (piece_index, fields)
        with self._lock:
            cached = self._cache.get(cache_key)
            if cached is not None:
                self._cache.move_to_end(cache_key)
                return cached
        piece = self.pieces[piece_index]
        lookup = self.schema.fields if fields is None else self.full_schema.fields
        names = list(self.schema.fields.keys()) if fields is None else list(fields)
        partition_keys = set(piece.partition_dict.keys())
        stored = [n for n in names if n not in partition_keys]
        table = self._parquet_file(piece.path).read_row_group(
            piece.row_group, columns=stored)
        columns = {}
        for name in names:
            if name in table.column_names:
                columns[name] = decode_column(
                    lookup[name], table.column(name).combine_chunks())
        for key, value in piece.partition_dict.items():
            if key in lookup and (fields is None or key in names):
                typed = cast_partition_value(lookup[key].numpy_dtype, value)
                if isinstance(typed, str):
                    col = np.empty(table.num_rows, dtype=object)
                    col[:] = typed
                else:
                    col = np.full(table.num_rows, typed)
                columns[key] = col
        with self._lock:
            self._cache[cache_key] = columns
            while len(self._cache) > self._cache_groups:
                self._cache.popitem(last=False)
        return columns

    def gather(self, global_rows: np.ndarray,
               fields: Optional[tuple] = None) -> Dict[str, np.ndarray]:
        """Decoded columns for the given global row indices, in order
        (``fields`` as :meth:`read_piece`'s)."""
        piece_ids = np.searchsorted(self.row_offsets, global_rows,
                                    side='right') - 1
        local = global_rows - self.row_offsets[piece_ids]
        out: Dict[str, np.ndarray] = {}
        for p in np.unique(piece_ids):
            mask = piece_ids == p
            cols = self.read_piece(int(p), fields)
            idx = local[mask]
            for name, col in cols.items():
                if name not in out:
                    out[name] = np.empty((len(global_rows),) + col.shape[1:],
                                         dtype=col.dtype)
                elif out[name].dtype != col.dtype:
                    # a nullable int column is int64 in a null-free group
                    # and NaN-holed float in a null-bearing one: promote,
                    # never cast NaN into an int
                    if out[name].dtype.kind == 'O' or col.dtype.kind == 'O':
                        promoted = np.dtype(object)
                    else:
                        promoted = np.promote_types(out[name].dtype,
                                                    col.dtype)
                    if promoted != out[name].dtype:
                        out[name] = out[name].astype(promoted)
                out[name][mask] = col[idx]
        return out

    def scan_columns(self, fields):
        """Yield ``(piece_index, {field: decoded column}, n_rows)`` for every
        piece, decoding ONLY ``fields`` (names of the whole schema;
        partition columns made from the piece's directory values): the one
        pass behind a predicate's row set and the NGram window index.

        The scan opens its own handles and closes them on exit, an error
        included, and never registers them with the reader: a close of the
        reader's handles would break reads that loaders sharing it have in
        flight."""
        import pyarrow.parquet as pq
        fields = sorted(set(fields))
        scan_files: Dict[str, tuple] = {}
        try:
            for piece_index, piece in enumerate(self.pieces):
                partition_keys = set(piece.partition_dict.keys())
                stored = [n for n in fields if n not in partition_keys]
                n = piece.num_rows
                cols: Dict[str, np.ndarray] = {}
                if stored:
                    entry = scan_files.get(piece.path)
                    if entry is None:
                        handle = self._filesystem.open(piece.path, 'rb')
                        try:
                            entry = (pq.ParquetFile(handle), handle)
                        except Exception:
                            handle.close()
                            raise
                        scan_files[piece.path] = entry
                    table = entry[0].read_row_group(piece.row_group,
                                                    columns=stored)
                    n = table.num_rows
                    for name in stored:
                        cols[name] = decode_column(
                            self.full_schema.fields[name],
                            table.column(name).combine_chunks())
                cols.update(make_partition_columns(self.full_schema, piece, n,
                                                   set(fields)))
                yield piece_index, cols, n
        finally:
            for _, handle in scan_files.values():
                try:
                    handle.close()
                except OSError:
                    pass

    def evaluate_predicate(self, predicate) -> np.ndarray:
        """Global indices of the rows ``predicate`` includes, in dataset
        order: one pass decoding only the predicate's fields (checked
        against the whole stored schema), so the loader's batch grid has a
        known row universe."""
        fields = validate_predicate_fields(predicate, self.full_schema)
        surviving = []
        for piece_index, cols, n in self.scan_columns(fields):
            mask = predicate_row_mask(predicate, fields, cols, n)
            surviving.append(self.row_offsets[piece_index]
                             + np.nonzero(mask)[0])
        if not surviving:
            return np.empty(0, np.int64)
        return np.concatenate(surviving).astype(np.int64)


def epoch_permutation(total_rows: int, row_offsets: np.ndarray, seed, epoch: int,
                      shuffle: bool = True,
                      shuffle_window_groups: int = 4) -> np.ndarray:
    """The (seed, epoch)-deterministic global row order: shuffle the order
    of the row groups, then the rows within each window of
    ``shuffle_window_groups`` groups."""
    if not shuffle:
        return np.arange(total_rows, dtype=np.int64)
    rng = np.random.default_rng((seed, epoch))
    n_pieces = len(row_offsets) - 1
    group_order = rng.permutation(n_pieces)
    out = []
    for start in range(0, n_pieces, shuffle_window_groups):
        window = group_order[start:start + shuffle_window_groups]
        idx = np.concatenate([np.arange(row_offsets[g], row_offsets[g + 1],
                                        dtype=np.int64) for g in window])
        rng.shuffle(idx)
        out.append(idx)
    return np.concatenate(out) if out else np.empty(0, np.int64)


def _next_cursor(epoch: int, batch: int, batches_per_epoch: int):
    """The (epoch, batch) grid's successor: the one rule the ventilated
    schedule, the consumer's expected order and the checkpoint cursor
    share."""
    batch += 1
    return (epoch, batch) if batch < batches_per_epoch else (epoch + 1, 0)


class IndexedBatchLoader:
    """Deterministic batch stream with O(1) exact checkpoint and resume.

    Yields dicts of numpy column arrays of exactly ``batch_size`` rows
    (``drop_last`` always: the indexing needs a fixed batch grid; an
    epoch's tail rows come in with the next epoch's shuffle).

    :param seed: with ``shuffle=True`` the stream is a pure function of
        (dataset, seed): two loaders with equal parameters yield the same
        stream whatever the pool's scheduling.
    :param workers_count: threads assembling batches by index.
    :param prefetch_batches: bound on assembled batches not yet consumed.

    Checkpointing::

        state = loader.state_dict()          # {'epoch': e, 'batch': b, ...}
        restored = IndexedBatchLoader(same arguments...)
        restored.load_state_dict(state)
        for batch in restored:               # continues exactly at (e, b)
            ...
    """

    def __init__(self, dataset: IndexedDatasetReader, batch_size: int,
                 num_epochs: int = 1, seed: int = 0, shuffle: bool = True,
                 shuffle_window_groups: int = 4, workers_count: int = 4,
                 prefetch_batches: int = 8, predicate=None,
                 transform_spec=None, pad_spec=None):
        if num_epochs is None:
            raise ValueError('IndexedBatchLoader needs a finite num_epochs '
                             '(the resume cursor indexes a finite schedule)')
        self._dataset = dataset
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.seed = seed
        self.shuffle = shuffle
        self.shuffle_window_groups = shuffle_window_groups
        self.workers_count = workers_count
        self.prefetch_batches = prefetch_batches
        self.predicate = predicate
        self.transform_spec = transform_spec
        #: ``heartbeat(entity, stage)`` for the pool's ventilator (a
        #: ``HealthMonitor.beat``), or None
        self.heartbeat = None
        if transform_spec is not None:
            self.schema = transform_schema(dataset.schema, transform_spec)
        else:
            self.schema = dataset.schema
        # ragged fields pad inside the deterministic batch function, after
        # the transform, so exact resume covers them too
        self.pad_spec = validate_pad_spec(pad_spec)
        check_pad_spec_fields(self.pad_spec, self.schema.fields,
                              'IndexedBatchLoader')
        if predicate is not None:
            # the surviving row set is fixed once, here: the stream stays a
            # pure function of (dataset, predicate, seed, cursor), and the
            # window shuffle runs over each piece's survivors
            self._selection = dataset.evaluate_predicate(predicate)
            self._perm_offsets = np.searchsorted(
                self._selection, dataset.row_offsets, side='left')
            total = len(self._selection)
        else:
            self._selection = None
            self._perm_offsets = dataset.row_offsets
            total = dataset.total_rows
        self.total_rows = int(total)
        self.batches_per_epoch = total // batch_size
        if self.batches_per_epoch == 0:
            raise NoDataAvailableError(
                'Dataset has {} rows{} < batch_size {}'.format(
                    total, ' (after predicate)' if predicate else '',
                    batch_size))
        self.epoch = 0
        self.batch = 0
        self._perm_cache: 'collections.OrderedDict[int, np.ndarray]' = \
            collections.OrderedDict()
        self._perm_lock = threading.Lock()
        # pools whose threads outlived join(): the dataset's close waits
        # until they are gone
        self._stale_pools: List = []

    # -- deterministic addressing ---------------------------------------------

    def _permutation(self, epoch: int) -> np.ndarray:
        with self._perm_lock:
            perm = self._perm_cache.get(epoch)
            if perm is not None:
                return perm
        perm = epoch_permutation(self.total_rows,
                                 self._perm_offsets, self.seed, epoch,
                                 self.shuffle, self.shuffle_window_groups)
        with self._perm_lock:
            self._perm_cache[epoch] = perm
            while len(self._perm_cache) > 2:
                self._perm_cache.popitem(last=False)
        return perm

    def _batch_rows(self, epoch: int, batch: int) -> np.ndarray:
        """Global row indices of batch ``batch`` of epoch ``epoch``; under a
        predicate the permutation's positions index the survivors."""
        positions = self._permutation(epoch)[batch * self.batch_size:
                                             (batch + 1) * self.batch_size]
        if self._selection is not None:
            return self._selection[positions]
        return positions

    def _apply_transform(self, columns: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The columnar ``TransformSpec``, then ``pad_spec``: a pure
        function of the batch, so the stream stays deterministic."""
        if self.transform_spec is not None:
            columns = apply_columnar_transform(self.transform_spec,
                                               self.schema, columns)
        if self.pad_spec:
            columns = pad_ragged_batch(columns, self.pad_spec)
        return columns

    def _assemble(self, epoch: int, batch: int) -> Dict[str, np.ndarray]:
        return self._apply_transform(
            self._dataset.gather(self._batch_rows(epoch, batch)))

    def _work(self, cursor):
        """The pool's worker: one ventilated ``(epoch, batch)`` assembled."""
        epoch, batch = cursor
        return epoch, batch, self._assemble(epoch, batch)

    # -- checkpoint state ------------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        """The cursor of the NEXT batch to yield; O(1) to save and restore."""
        return {'epoch': self.epoch, 'batch': self.batch, 'version': 1}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        """Restore the cursor; a state that is not a dict, has no or an
        unknown ``version``, or lacks a cursor key raises (a garbage state
        must fail here, not resume training at the wrong place)."""
        if not isinstance(state, dict):
            raise ValueError('loader state must be a dict, got '
                             '{!r}'.format(type(state).__name__))
        if 'version' not in state:
            raise ValueError("loader state has no 'version' key — it was "
                             'not produced by state_dict() (keys: '
                             '{})'.format(sorted(state)))
        if state['version'] != 1:
            raise ValueError('Unknown state version {!r} (this build reads '
                             'version 1)'.format(state['version']))
        missing = [k for k in ('epoch', 'batch') if k not in state]
        if missing:
            raise ValueError('loader state is missing key(s) {} (keys '
                             'present: {})'.format(missing, sorted(state)))
        self.epoch = int(state['epoch'])
        self.batch = int(state['batch'])
        if self.batch >= self.batches_per_epoch:
            self.epoch += self.batch // self.batches_per_epoch
            self.batch = self.batch % self.batches_per_epoch

    # -- iteration -------------------------------------------------------------

    def _sweep_stale_pools(self) -> bool:
        """Drop the stale pools whose threads have exited; True while any
        is still alive (closing the dataset under it is unsafe)."""
        self._stale_pools = [p for p in self._stale_pools
                             if any(t.is_alive() for t in p.threads)]
        return bool(self._stale_pools)

    def close(self, stale_thread_grace_s: float = 5.0):
        """Close the dataset's Parquet handles (reopened on a later read).

        When an earlier pass left a pool thread alive past its join, wait up
        to ``stale_thread_grace_s`` for it, then close all the same (an
        explicit close must release the handles; that thread's read then
        fails)."""
        deadline = time.monotonic() + stale_thread_grace_s
        while self._sweep_stale_pools():
            if time.monotonic() >= deadline:
                logger.warning(
                    'Closing indexed dataset with %d stale worker thread(s) '
                    'still alive after %.1fs grace; their in-flight reads '
                    'may fail',
                    sum(t.is_alive() for p in self._stale_pools
                        for t in p.threads),
                    stale_thread_grace_s)
                self._stale_pools = []
                break
            time.sleep(0.05)
        self._dataset.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()

    def _schedule(self, start_epoch, start_batch):
        e, b = start_epoch, start_batch
        while e < self.num_epochs:
            yield e, b
            e, b = _next_cursor(e, b, self.batches_per_epoch)

    def __iter__(self):
        if self.epoch >= self.num_epochs:
            return
        # a close deferred by an earlier pass whose pool outlived its join
        if self._stale_pools and not self._sweep_stale_pools():
            self._dataset.close()
        pool = ThreadPool(self.workers_count,
                          results_queue_size=self.prefetch_batches)
        pool.start(self._work, [],
                   schedule=self._schedule(self.epoch, self.batch),
                   max_in_flight=self.workers_count + self.prefetch_batches,
                   heartbeat=self.heartbeat)
        stash: Dict[tuple, Dict[str, np.ndarray]] = {}
        try:
            for expected in self._schedule(self.epoch, self.batch):
                while expected not in stash:
                    epoch, batch, columns = pool.get_results()
                    stash[(epoch, batch)] = columns
                columns = stash.pop(expected)
                # the cursor moves BEFORE the yield: a state saved while the
                # consumer holds this batch points at the next one
                self.epoch, self.batch = _next_cursor(
                    *expected, self.batches_per_epoch)
                yield columns
        except EmptyResultError:
            raise RuntimeError('worker pool drained before schedule finished')
        finally:
            pool.stop()
            try:
                pool.join(POOL_JOIN_TIMEOUT_S)
            except TimeoutError:
                pass
            # the handles the pool's threads opened are closed once those
            # threads are gone (the next pass's threads open their own):
            # a file closed under a live read breaks that read
            if any(t.is_alive() for t in pool.threads):
                self._stale_pools.append(pool)
            else:
                self._dataset.close()


def sharded_batch_setup(mesh, batch_axis: str, batch_size: int):
    """Check a global batch against a mesh axis and derive this rank's
    ``(NamedSharding, local_positions)`` (JAX ``indexed.py:601-627``): the
    positions are the contiguous block of the global batch at this rank's
    ``batch_axis`` coordinate, so every rank sharing that coordinate (the
    ``seq`` ranks of one data group) derives the same positions. Shared by
    the sharded row and NGram loaders."""
    from petastorm_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                                   batch_sharding)
    n_shards = axis_size(mesh, batch_axis)
    if batch_size % n_shards:
        raise ValueError(
            'global batch_size {} must divide evenly over the {} devices '
            "of mesh axis '{}'".format(batch_size, n_shards, batch_axis))
    per = batch_size // n_shards
    start = axis_index(mesh, batch_axis) * per
    return (batch_sharding(mesh, batch_axis),
            np.arange(start, start + per, dtype=np.int64))


class ShardedIndexedLoader(IndexedBatchLoader):
    """Deterministic batches over a mesh: O(1) exact resume, and this
    rank's slice of every global batch staged to its device (JAX
    ``ShardedIndexedLoader``, ``indexed.py:630-665``).

    ``batch_size`` is the GLOBAL batch. Every rank derives the same
    ``(seed, epoch, batch)``-addressed permutation slice and gathers only
    the rows at its positions (:func:`sharded_batch_setup`); the cursor
    being global, the ranks stay in lockstep by construction, and a
    restored ``state_dict()`` resumes the identical global stream with any
    world size (which rows land on which rank changes, the global batches
    do not). The transform runs on the rank's sub-batch, so it must be
    row-wise. Strings and objects ride under ``batch['_host']``;
    ``loader.sharding`` says which slice a batch holds."""

    def __init__(self, dataset: IndexedDatasetReader, batch_size: int,
                 mesh, batch_axis: str = 'data', **kwargs):
        sharding, local_positions = sharded_batch_setup(mesh, batch_axis,
                                                        batch_size)
        super().__init__(dataset, batch_size, **kwargs)
        require_single_bucket_pad_spec(self.pad_spec, 'ShardedIndexedLoader')
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.sharding = sharding
        self._local_positions = local_positions

    def _assemble(self, epoch: int, batch: int) -> Dict[str, np.ndarray]:
        rows = self._batch_rows(epoch, batch)
        return self._apply_transform(
            self._dataset.gather(rows[self._local_positions]))

    def __iter__(self):
        from petastorm_tpu_torch.torch_utils import stage_to_global
        for local_batch in super().__iter__():
            yield stage_to_global(local_batch, self.sharding)


def make_indexed_loader(dataset_url, batch_size, num_epochs=1, seed=0,
                        shuffle=True, shuffle_window_groups=4,
                        workers_count=4, prefetch_batches=8,
                        schema_fields=None, storage_options=None,
                        cache_groups=None, mesh=None, batch_axis='data',
                        predicate=None, transform_spec=None, pad_spec=None):
    """:class:`IndexedDatasetReader` + :class:`IndexedBatchLoader` (host
    numpy batches), or with ``mesh`` a :class:`ShardedIndexedLoader` (this
    rank's slice of each global ``batch_size`` batch on its device; JAX
    ``indexed.py:668-704``).

    Works on plain parquet stores too (schema inferred, row counts from the
    footers). ``predicate`` fixes the surviving row set once, when the
    loader is made; ``transform_spec`` runs the columnar transform on each
    batch; both keep the stream a pure function of the cursor."""
    dataset = IndexedDatasetReader(
        dataset_url, schema_fields=schema_fields,
        storage_options=storage_options,
        cache_groups=(cache_groups if cache_groups is not None
                      else max(8, shuffle_window_groups + workers_count)))
    kwargs = dict(num_epochs=num_epochs, seed=seed, shuffle=shuffle,
                  shuffle_window_groups=shuffle_window_groups,
                  workers_count=workers_count,
                  prefetch_batches=prefetch_batches, predicate=predicate,
                  transform_spec=transform_spec, pad_spec=pad_spec)
    if mesh is None:
        return IndexedBatchLoader(dataset, batch_size, **kwargs)
    return ShardedIndexedLoader(dataset, batch_size, mesh=mesh,
                                batch_axis=batch_axis, **kwargs)
