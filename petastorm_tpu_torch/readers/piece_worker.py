"""Each pool worker's read layer: file handles, readahead and the cache.

The port's counterpart of ``petastorm_tpu/readers/piece_worker.py``:
``FileHandleCache`` (:59-133) and, from ``ParquetPieceWorker``, the cache
keys (:208-250, :743-752), the readahead planner (``prefetch_lookahead``
:311, ``prefetch_hint`` :316, ``_plan_item`` :329-358, ``_read_key`` :374,
``_readahead_read`` :377), the read (``_read_row_group`` :405), the cached
load (``_cached_load`` :715) and ``shutdown`` (:277-289). The port's loads
stay functions (``load_columnar``, ``load_window_chunk``,
``load_row_item``, ``load_batch_item``): each takes an ``io`` argument
through which it reads (:meth:`PieceWorker.read`) and caches
(:meth:`PieceWorker.cached`). A pool makes one :class:`PieceWorker` per
thread or worker interpreter from a :class:`PieceWorkerSpec`, the picklable
recipe the reader builds, and calls it on each item.

Resilience, ranged reads, pod observability, lineage and quarantine are
not ported yet.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import pyarrow.parquet as pq

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.readers.readahead import RowGroupReadahead

#: Open Parquet files a worker keeps (per reading thread): many-file stores
#: would otherwise hold a handle and a footer per file ever read.
FILE_HANDLE_CACHE_SIZE = 32


class FileHandleCache:
    """A small LRU of open :class:`pq.ParquetFile` handles that closes what
    it evicts. One reading thread owns an instance (a handle must not serve
    two reads at once); the lock guards only the bookkeeping."""

    def __init__(self, open_fn, max_size: int = FILE_HANDLE_CACHE_SIZE):
        if max_size < 1:
            raise ValueError('max_size must be >= 1, got {}'.format(max_size))
        self._open_fn = open_fn
        self._max_size = max_size
        self._entries: 'OrderedDict[str, pq.ParquetFile]' = OrderedDict()
        self._lock = threading.Lock()

    def get(self, path: str) -> pq.ParquetFile:
        with self._lock:
            handle = self._entries.get(path)
            if handle is not None:
                self._entries.move_to_end(path)
                return handle
        handle = self._open_fn(path)
        evicted = []
        with self._lock:
            raced = self._entries.get(path)
            if raced is not None:
                self._entries.move_to_end(path)
                evicted.append(handle)   # lost a race: keep the cached one
                handle = raced
            else:
                self._entries[path] = handle
                while len(self._entries) > self._max_size:
                    evicted.append(self._entries.popitem(last=False)[1])
        for old in evicted:
            old.close()
        return handle

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, path: str) -> bool:
        with self._lock:
            return path in self._entries

    def close_all(self) -> None:
        with self._lock:
            entries, self._entries = self._entries, OrderedDict()
        for handle in entries.values():
            handle.close()


class PlainReads:
    """The loads' ``io`` when none is given: a fresh handle a read, no
    readahead and no cache."""

    @staticmethod
    def read(piece, columns: List[str]):
        return pq.ParquetFile(piece.path).read_row_group(piece.row_group,
                                                         columns=columns)

    @staticmethod
    def cached(prefix: str, piece, fill: Callable):
        return fill()


PLAIN_READS = PlainReads()


def read_key(piece, columns: List[str]) -> Tuple:
    """What a prefetched read is matched by."""
    return (piece.path, piece.row_group, tuple(columns))


def cache_key_format(dataset_path, view_fields, decode_hints=None,
                     device_plans=None) -> str:
    """The format of a reader's cache keys, with ``{}`` for the payload
    kind, the file and the row group: JAX's key
    (``ParquetPieceWorker._cache_key``). Everything that changes what a
    decoded row group holds is in it: the store, the column view (readers
    with other ``schema_fields`` must not serve each other), the decode
    hints and the device-decode plans (raw grids and decoded arrays never
    serve each other)."""
    dataset = hashlib.md5(str(dataset_path).encode()).hexdigest()
    view = hashlib.md5(','.join(sorted(view_fields)).encode()).hexdigest()[:12]
    hints = ''
    if decode_hints:
        hints = ':' + hashlib.md5(repr(sorted(
            (k, sorted(v.items())) for k, v in decode_hints.items()))
            .encode()).hexdigest()[:12]
    plans = ''
    if device_plans:
        plans = ':dd' + hashlib.md5(','.join(sorted(device_plans)).encode()
                                    ).hexdigest()[:8]
    return '{}:' + dataset + ':' + view + ':{}:{}' + hints + plans


class PieceWorkerSpec:
    """The picklable recipe of a reader's pool workers.

    :param load: ``load(item, io=worker)``, one of the loads bound to the
        reader's schema and options.
    :param plan: ``plan(item) -> (cache key prefix, columns)`` of a
        no-predicate item: the kind of payload its load caches and the
        columns of its first read.
    :param cache: a :class:`~petastorm_tpu_torch.cache.CacheBase`.
    :param io_readahead: 0, a depth, or ``'auto'``.
    :param key_format: :func:`cache_key_format` of the reader.
    """

    def __init__(self, load, plan, cache, io_readahead, key_format):
        self.load = load
        self.plan = plan
        self.cache = cache
        self.io_readahead = io_readahead
        self.key_format = key_format

    def make_worker(self) -> 'PieceWorker':
        return PieceWorker(self)


class PieceWorker:
    """One worker's read state: its file handles, its readahead (a
    background thread with handles of its own), and the cache. Calling it
    loads one work item; a pool hints it with the items it holds next
    (:meth:`prefetch_hint`), in the order it will call it on them."""

    def __init__(self, spec: PieceWorkerSpec):
        self._load = spec.load
        self._plan = spec.plan
        self.cache = spec.cache
        self._key_format = spec.key_format
        self._files = FileHandleCache(pq.ParquetFile)
        self._prefetch_files: Optional[FileHandleCache] = None
        #: the :class:`RowGroupReadahead`, or None without readahead
        self.readahead: Optional[RowGroupReadahead] = None
        if spec.io_readahead:
            self._prefetch_files = FileHandleCache(pq.ParquetFile)
            self.readahead = RowGroupReadahead(self._readahead_read,
                                               spec.io_readahead)

    def __call__(self, item):
        return self._load(item, io=self)

    def cache_key(self, prefix: str, piece) -> str:
        return self._key_format.format(prefix, piece.path, piece.row_group)

    def cached(self, prefix: str, piece, fill: Callable):
        """The cache's value for the payload ``prefix`` of ``piece``,
        ``fill()`` on a miss."""
        return self.cache.get(self.cache_key(prefix, piece), fill)

    def read(self, piece, columns: List[str]):
        """The row group's ``columns``: the readahead's read when it
        prefetched it, else read here."""
        if self.readahead is not None:
            table = self.readahead.take(read_key(piece, columns))
            if table is not None:
                return table
        return self._files.get(piece.path).read_row_group(piece.row_group,
                                                          columns=columns)

    def _readahead_read(self, piece, columns: List[str]):
        # the background thread's handles, never the worker's
        return self._prefetch_files.get(piece.path).read_row_group(
            piece.row_group, columns=columns)

    @property
    def prefetch_lookahead(self) -> int:
        """How many items past the current one the pool should hold back
        and hint (0: none)."""
        return self.readahead.depth if self.readahead is not None else 0

    def prefetch_hint(self, upcoming) -> None:
        """Schedule the reads of the plannable ones of ``upcoming``, the
        items this worker runs next, in order, the current one first."""
        if self.readahead is None:
            return
        self.readahead.sync([plan for plan in map(self._plan_item, upcoming)
                             if plan is not None])

    def _plan_item(self, item) -> Optional[Tuple]:
        """``(read key, piece, columns)`` of the first read of ``item``'s
        load, or None when it cannot be planned: a predicate item reads in
        dependent steps, and a cached item may not read at all. With the
        shared cache only the keys the host does not hold are planned; a
        cache without ``contains`` plans nothing."""
        if item.predicate is not None:
            return None
        prefix, columns = self._plan(item)
        if not isinstance(self.cache, NullCache):
            contains = getattr(self.cache, 'contains', None)
            if contains is None or contains(self.cache_key(prefix,
                                                           item.piece)):
                return None
        return read_key(item.piece, columns), item.piece, columns

    def shutdown(self) -> None:
        """End the readahead, close the handles, and close the shared
        cache (flushing its counters; idempotent across threads)."""
        if self.readahead is not None:
            self.readahead.stop()
        if self._prefetch_files is not None:
            self._prefetch_files.close_all()
        self._files.close_all()
        close = getattr(self.cache, 'close', None)
        if close is not None:
            close()


def make_worker(process):
    """The object a pool calls on each item: ``process.make_worker()`` for
    a :class:`PieceWorkerSpec`, else ``process`` itself (a plain
    ``process(item)`` callable)."""
    factory = getattr(process, 'make_worker', None)
    return factory() if factory is not None else process


def shutdown_worker(worker) -> None:
    shutdown = getattr(worker, 'shutdown', None)
    if shutdown is not None:
        shutdown()
