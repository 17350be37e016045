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

Lineage and quarantine (JAX ``piece_worker.py:33-56, 218-233, 565-705``
and ``workers/worker_base.py:46-61, 151-168``): a worker calls its load
with itself as ``io``, which then also carries the item's context. A load
reports the source-row offsets of what it returns (:meth:`PieceWorker.
set_offsets`), collects cell-level decode failures in a
:class:`DecodeErrorSink` and drops their rows
(:meth:`PieceWorker.apply_quarantine_drops`), and hands a failing
transform to :meth:`PieceWorker.quarantine_item`. The worker wraps each
payload in a :class:`~petastorm_tpu_torch.lineage.LineageEnvelope` with its
:class:`~petastorm_tpu_torch.lineage.Provenance`, keeps the provenance of
an item that left no row and the quarantine records, and the pools drain
both after each item (:meth:`PieceWorker.drain_lineage`).

The stats plane (JAX ``workers/worker_base.py:73-149`` and
``piece_worker.py:405-425, 554-562, 660-666, 715-740``): a worker
accumulates per-stage seconds (:meth:`PieceWorker.record_time`), counters,
gauges, latency observations (a
:class:`~petastorm_tpu_torch.latency.LatencyDeltas`, unless the latency
plane is off) and, when the reader traces, spans; its pool drains them
after each item (:meth:`PieceWorker.drain_stage_times`,
:meth:`~PieceWorker.drain_stat_counts`, :meth:`~PieceWorker.drain_latency`,
:meth:`~PieceWorker.drain_spans`). The loads report through ``io`` as
well: the read is timed here, the decode path counts and the decode's
latency and span come from the loads.

Heartbeats (JAX ``workers/worker_base.py:35-112`` and
``piece_worker.py:261-268, 413, 509, 724``): a worker publishes the record
of its own entity, ``worker-<id>`` (:meth:`PieceWorker.beat`), and of its
readahead thread, ``readahead-<id>`` (:meth:`PieceWorker.beat_entity`):
``'starting'`` when made, ``'io'`` on entering a read (and a wait on
another process's cache fill), ``'decode'`` on entering a decode, the stage
of a timed section when it ends (``worker_io`` after a read), and
``'idle'`` when its pool marks an item done (:meth:`PieceWorker.item_done`).
Its pool reads them (:meth:`PieceWorker.heartbeat_snapshot`). A spec with
``health=False`` (replay, ``PETASTORM_TPU_HEALTH=0``) beats nothing.

Under the autotune controller (the spec's ``readahead_controlled``, JAX
``piece_worker.py:246-280``) every worker has a readahead, dormant at
depth 0 when the reader started without one, whose depth only
:meth:`PieceWorker.set_readahead_depth` moves.

Resilience, ranged reads and pod observability are not ported yet.
"""

from __future__ import annotations

import copy
import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.latency import LatencyDeltas
from petastorm_tpu_torch.lineage import (NEVER_QUARANTINE, LineageEnvelope,
                                         Provenance, make_quarantine_record)
from petastorm_tpu_torch.readers.readahead import RowGroupReadahead

#: Open Parquet files a worker keeps (per reading thread): many-file stores
#: would otherwise hold a handle and a footer per file ever read.
FILE_HANDLE_CACHE_SIZE = 32

#: Row offsets a quarantine record lists at most: a row group corrupt
#: throughout must not ship thousands of offsets an item.
_QUARANTINE_OFFSET_CAP = 64

#: Offsets an ``('index', ...)`` selection names at most; a larger
#: scattered match set is ``('opaque', n)`` (predicate readers are audited
#: by item anyway).
_SELECTION_INDEX_CAP = 4096

#: What a load returns for an item whose failure was quarantined or skipped
#: whole: no payload, and no empty delivery either.
QUARANTINED = object()


class DecodeErrorSink:
    """The cell-level decode failures of one item (``on_decode_error`` other
    than ``'raise'``): ``errors`` holds ``(row_offset, field, exception)``;
    ``dense_fields`` names the columns that fell from the dense decode to
    an object array and are made dense again once the failing rows are
    dropped."""

    __slots__ = ('errors', 'dense_fields')

    def __init__(self):
        self.errors: List[Tuple[int, str, BaseException]] = []
        self.dense_fields = set()


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
    readahead, no cache, no lineage, and every failure raised."""

    tolerant = False
    tracks_offsets = False
    offsets = None

    @staticmethod
    def read(piece, columns: List[str]):
        return pq.ParquetFile(piece.path).read_row_group(piece.row_group,
                                                         columns=columns)

    @staticmethod
    def cached(prefix: str, piece, fill: Callable):
        return fill()

    @staticmethod
    def error_sink():
        return None

    @staticmethod
    def set_offsets(offsets) -> None:
        pass

    @staticmethod
    def quarantine_item(stage, error, rows=None) -> bool:
        return False

    @staticmethod
    def record_count(name: str, n: int = 1) -> None:
        pass

    @staticmethod
    def beat(stage: str) -> None:
        pass

    @staticmethod
    def record_latency(stage: str, seconds: float) -> None:
        pass

    @staticmethod
    def record_span(name, cat, start_s, dur_s, args=None) -> None:
        pass


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
    :param lineage: wrap each payload with its provenance.
    :param on_decode_error: ``'raise'``, ``'skip'`` or ``'quarantine'``.
    :param shard: the reader's ``cur_shard``, -1 when unsharded.
    :param dataset: the 12-character digest of the dataset path.
    :param file_indexes: ``path -> ordinal`` by first appearance among the
        reader's pieces.
    :param windows: the payloads are NGram windows, not rows.
    :param trace: record spans (the reader has a tracer).
    :param latency: record latency observations (the reader's stats carry
        a latency plane).
    :param health: publish heartbeats (JAX's worker arg ``'health'``).
    :param readahead_controlled: the autotune controller owns the readahead
        depth (JAX's worker arg): each worker has a readahead, dormant at
        ``io_readahead`` 0, and ``'auto'`` does not retune itself.
    """

    def __init__(self, load, plan, cache, io_readahead, key_format,
                 lineage=False, on_decode_error='raise', shard=-1,
                 dataset='', file_indexes=None, windows=False, trace=False,
                 latency=False, health=True, readahead_controlled=False):
        self.load = load
        self.plan = plan
        self.cache = cache
        self.io_readahead = io_readahead
        self.key_format = key_format
        self.lineage = lineage
        self.on_decode_error = on_decode_error
        self.shard = shard
        self.dataset = dataset
        self.file_indexes = dict(file_indexes or {})
        self.windows = windows
        self.trace = trace
        self.latency = latency
        self.health = health
        self.readahead_controlled = readahead_controlled

    def make_worker(self, worker_id: int = 0) -> 'PieceWorker':
        return PieceWorker(self, worker_id)

    def for_replay(self) -> 'PieceWorkerSpec':
        """The recipe of a worker that fetches items again: no readahead,
        no cache, no lineage, no heartbeats; the same load and decode-error
        policy."""
        return PieceWorkerSpec(self.load, self.plan, NullCache(), 0,
                               self.key_format,
                               on_decode_error=self.on_decode_error,
                               health=False)


class PieceWorker:
    """One worker's read state: its file handles, its readahead (a
    background thread with handles of its own), and the cache. Calling it
    loads one work item; a pool hints it with the items it holds next
    (:meth:`prefetch_hint`), in the order it will call it on them."""

    def __init__(self, spec: PieceWorkerSpec, worker_id: int = 0):
        self._load = spec.load
        self._plan = spec.plan
        self.cache = spec.cache
        self._key_format = spec.key_format
        self._lineage = spec.lineage
        self._on_decode_error = spec.on_decode_error
        #: decode and transform failures drop rows instead of raising
        self.tolerant = spec.on_decode_error != 'raise'
        #: the loads report source-row offsets (lineage or tolerance on)
        self.tracks_offsets = self._lineage or self.tolerant
        self._shard = spec.shard
        self._dataset = spec.dataset
        self._file_indexes = spec.file_indexes
        self._windows = spec.windows
        #: the pool's ordinal of this worker (its provenance's worker_id and
        #: its heartbeat entity's)
        self.worker_id = worker_id
        #: source-row offsets of what the current item's load returns: a
        #: symbolic ``('range', lo, hi)``, an int array, or None (unknown)
        self.offsets = None
        self._item = None
        self._quarantines: List[dict] = []
        self._empty: List[Provenance] = []
        #: per-stage seconds, counters, last-value gauges and spans since
        #: the pool's last drain
        self.stage_times: Dict[str, float] = {}
        self.stat_counts: Dict[str, int] = {}
        self.stat_gauges: Dict[str, float] = {}
        self.trace_spans: List[tuple] = []
        self.tracing_enabled = bool(spec.trace)
        self._trace_pid = os.getpid()
        #: latency observations since the last drain (None: the plane is
        #: off)
        self.latency = LatencyDeltas() if spec.latency else None
        #: heartbeat records, ``entity -> (stage, ts, items)``: each beat
        #: replaces a whole tuple, so another thread may read them
        self.heartbeats: Dict[str, tuple] = {}
        self.health_enabled = spec.health is not False
        self._entity = 'worker-{}'.format(worker_id)
        self._items_done = 0
        self._files = FileHandleCache(pq.ParquetFile)
        self._prefetch_files: Optional[FileHandleCache] = None
        #: the :class:`RowGroupReadahead`, or None without readahead
        self.readahead: Optional[RowGroupReadahead] = None
        controlled = getattr(spec, 'readahead_controlled', False)
        if spec.io_readahead or controlled:
            self._prefetch_files = FileHandleCache(pq.ParquetFile)
            # the background thread beats its own entity: a wedged
            # prefetch read is the readahead's, not the worker's
            entity = 'readahead-{}'.format(worker_id)
            self.readahead = RowGroupReadahead(
                self._readahead_read, spec.io_readahead or 0,
                trace=self.tracing_enabled,
                beat=((lambda stage: self.beat_entity(entity, stage))
                      if self.health_enabled else None),
                controlled=controlled)
        if self.health_enabled:
            self.beat('starting')

    def __call__(self, item):
        """The payload of ``item``: its load's result, wrapped with its
        provenance when lineage is on; None when the item left no row or
        was quarantined whole."""
        if not self.tracks_offsets:
            # an item that left no row publishes nothing, as with lineage
            payload = self._load(item, io=self)
            return payload if _payload_rows(payload) else None
        self._item = item
        self.offsets = None
        try:
            payload = self._load(item, io=self)
        except Exception as e:
            if not self.quarantine_item('decode', e):
                raise
            return None
        if payload is QUARANTINED:
            return None
        n = _payload_rows(payload)
        if not n:
            if self._lineage:
                # an item processed fine that left no row: the audit must
                # see a delivery of 0 rows, not a drop
                self._empty.append(self._make_provenance(('index', ()), 0))
            return None
        if not self._lineage:
            return payload
        selection = (('windows', n) if self._windows
                     else self._compact_selection(self.offsets, n))
        return LineageEnvelope(payload, self._make_provenance(selection, n))

    # -- the stats plane -----------------------------------------------------

    def record_time(self, stage: str, seconds: float) -> None:
        """``seconds`` of wall time against a ``ReaderStats`` stage; a
        latency stage fed by it (``worker_io_s``: ``io``) gets one
        observation. The end of a timed stage is progress: a beat of the
        stage's name without ``_s``."""
        self.stage_times[stage] = self.stage_times.get(stage, 0.0) + seconds
        if self.latency is not None:
            self.latency.record_time_stage(stage, seconds)
        if self.health_enabled:
            self.beat(stage[:-2] if stage.endswith('_s') else stage)

    def record_count(self, name: str, n: int = 1) -> None:
        self.stat_counts[name] = self.stat_counts.get(name, 0) + n

    def record_gauge(self, name: str, value) -> None:
        """A gauge sample (the last one of an item wins)."""
        self.stat_gauges[name] = value

    def record_latency(self, stage: str, seconds: float) -> None:
        """One observation of a latency stage; nothing when the plane is
        off."""
        if self.latency is not None:
            self.latency.record(stage, seconds)

    def record_span(self, name: str, cat: str, start_s: float, dur_s: float,
                    args=None) -> None:
        """One span on this process's and thread's track; nothing unless
        the reader traces."""
        if self.tracing_enabled:
            self.trace_spans.append((name, cat, start_s, dur_s,
                                     self._trace_pid, threading.get_ident(),
                                     args))

    # -- heartbeats ----------------------------------------------------------

    def beat(self, stage: str) -> None:
        """This worker is now in ``stage`` and still making progress."""
        if self.health_enabled:
            self.heartbeats[self._entity] = (stage, time.perf_counter(),
                                             self._items_done)

    def beat_entity(self, entity: str, stage: str, items: int = 0) -> None:
        """A heartbeat of an entity this worker owns (its readahead
        thread); safe from that entity's thread."""
        if self.health_enabled:
            self.heartbeats[entity] = (stage, time.perf_counter(), items)

    def item_done(self) -> None:
        """One item fully processed (its pool calls this after publishing
        it): the items count rises and the worker beats ``idle``."""
        self._items_done += 1
        self.beat('idle')

    def heartbeat_snapshot(self) -> Dict[str, dict]:
        """``{entity: {'stage', 'ts', 'items', 'pid'}}`` of every entity
        this worker publishes; safe from any thread."""
        pid = self._trace_pid
        return {entity: {'stage': stage, 'ts': ts, 'items': items,
                         'pid': pid}
                for entity, (stage, ts, items)
                in list(self.heartbeats.items())}

    def drain_stage_times(self) -> Dict[str, float]:
        times, self.stage_times = self.stage_times, {}
        return times

    def drain_stat_counts(self):
        """``(counters, gauges)`` since the last drain."""
        counts, self.stat_counts = self.stat_counts, {}
        gauges, self.stat_gauges = self.stat_gauges, {}
        return counts, gauges

    def drain_latency(self):
        """The latency deltas since the last drain (None when the plane is
        off or nothing was observed)."""
        return self.latency.drain() if self.latency is not None else None

    def drain_spans(self) -> List[tuple]:
        spans, self.trace_spans = self.trace_spans, []
        return spans

    # -- lineage and quarantine ----------------------------------------------

    def set_offsets(self, offsets) -> None:
        """The source-row offsets of what the current load returns."""
        self.offsets = offsets

    def error_sink(self) -> Optional[DecodeErrorSink]:
        """A sink for cell-level decode failures, None under ``'raise'``."""
        return DecodeErrorSink() if self.tolerant else None

    def drain_lineage(self) -> Tuple[List[dict], List[Provenance]]:
        """The quarantine records and the provenance of empty items
        collected since the last drain."""
        out = (self._quarantines, self._empty)
        self._quarantines, self._empty = [], []
        return out

    def _make_provenance(self, selection: tuple, rows: int) -> Provenance:
        item = self._item
        return Provenance(
            dataset=self._dataset,
            file_index=self._file_indexes.get(item.piece.path, -1),
            path=item.piece.path, row_group=item.piece.row_group,
            rows=int(rows), selection=selection, epoch=int(item.epoch),
            shard=self._shard, piece_index=int(item.piece_index),
            partition=tuple(item.drop_partition or (0, 1)),
            worker_id=self.worker_id)

    def _compact_selection(self, offsets, rows_n: int) -> tuple:
        """The shortest selection naming the delivered source rows;
        ``offsets`` as :attr:`offsets`."""
        source_rows = self._item.piece.num_rows
        if offsets is None:
            return ('opaque', int(rows_n))
        if isinstance(offsets, tuple):
            lo, hi = int(offsets[1]), int(offsets[2])
            if lo == 0 and hi == source_rows:
                return ('all', hi)
            return ('slice', lo, hi)
        n = len(offsets)
        if n == 0:
            return ('index', ())
        contiguous = (n == 1
                      or (int(offsets[-1]) - int(offsets[0]) == n - 1
                          and bool(np.all(np.diff(offsets) == 1))))
        if contiguous:
            lo, hi = int(offsets[0]), int(offsets[-1]) + 1
            if lo == 0 and source_rows is not None and hi == source_rows:
                return ('all', n)
            return ('slice', lo, hi)
        if n > _SELECTION_INDEX_CAP:
            return ('opaque', int(rows_n))
        return ('index', tuple(int(o) for o in offsets))

    def quarantine_event(self, stage: str, error: BaseException, rows: int,
                         field: Optional[str] = None,
                         row_offsets=None) -> None:
        """One quarantined failure: counted, and recorded under
        ``'quarantine'`` (``'skip'`` drops it without a record)."""
        self.record_count('rows_quarantined', int(rows))
        self.record_count('items_quarantined', 1)
        if self._on_decode_error != 'quarantine':
            return
        item = self._item
        self._quarantines.append(make_quarantine_record(
            item.piece, int(item.piece_index), int(item.epoch),
            tuple(item.drop_partition or (0, 1)), self._shard, stage, error,
            field=field, rows=rows,
            row_offsets=(list(row_offsets)[:_QUARANTINE_OFFSET_CAP]
                         if row_offsets is not None else None)))

    def quarantine_item(self, stage: str, error: BaseException,
                        rows: Optional[int] = None) -> bool:
        """Quarantine or skip a whole failing item; False when the error
        must propagate (policy ``'raise'``, or a failure of the
        infrastructure that no policy swallows)."""
        if not self.tolerant or isinstance(error, NEVER_QUARANTINE):
            return False
        if rows is None:
            num_rows = self._item.piece.num_rows
            rows = num_rows if (num_rows or 0) >= 0 else 1
        self.quarantine_event(stage, error, rows)
        return True

    def apply_quarantine_drops(self, columns: Dict[str, np.ndarray],
                               sink: DecodeErrorSink, num_rows: int
                               ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Drop the rows whose cells failed to decode from every column
        (columns the tolerant decode made object arrays become dense
        again), record one event a field, and return ``(columns, kept
        source offsets)``."""
        bad_rows = sorted({row for row, _field, _exc in sink.errors})
        by_field: Dict[str, List] = {}
        for row, field, exc in sink.errors:
            by_field.setdefault(field, []).append((row, exc))
        for field, fails in by_field.items():
            self.quarantine_event('decode', fails[0][1], rows=len(fails),
                                  field=field,
                                  row_offsets=[r for r, _e in fails])
        keep = np.ones(num_rows, dtype=bool)
        keep[np.asarray(bad_rows, dtype=np.int64)] = False
        kept = np.flatnonzero(keep)
        out = {}
        for name, arr in columns.items():
            arr = arr[kept] if len(arr) == num_rows else arr
            if name in sink.dense_fields and arr.dtype == object and len(arr):
                arr = np.stack(list(arr))
            out[name] = arr
        return out, kept

    def cache_key(self, prefix: str, piece) -> str:
        return self._key_format.format(prefix, piece.path, piece.row_group)

    def cached(self, prefix: str, piece, fill: Callable):
        """The cache's value for the payload ``prefix`` of ``piece``,
        ``fill()`` on a miss; a shared cache's hit, miss and eviction
        counts and its resident bytes go to the stats. A shared cache's
        lookup beats ``io``: a wait on another process's fill is a storage
        stall."""
        cache = self.cache
        take_events = getattr(cache, 'take_events', None)
        if take_events is not None:
            self.beat('io')
        value = cache.get(self.cache_key(prefix, piece), fill)
        if take_events is not None:
            for name, n in take_events().items():
                if n:
                    self.record_count(name, n)
            self.record_gauge('shared_cache_bytes', cache.occupancy_bytes())
        return value

    def read(self, piece, columns: List[str]):
        """The row group's ``columns``: the readahead's read when it
        prefetched it, else read here, timed as ``worker_io_s``. The entry
        beat ``io`` names a read that never returns."""
        self.beat('io')
        if self.readahead is not None:
            table = self.readahead.take(read_key(piece, columns))
            self.readahead.drain_stats_into(self)
            if table is not None:
                return table
        start = time.perf_counter()
        table = self._files.get(piece.path).read_row_group(piece.row_group,
                                                           columns=columns)
        elapsed = time.perf_counter() - start
        self.record_time('worker_io_s', elapsed)
        self.record_span('parquet_read', 'io', start, elapsed,
                         args={'row_group': piece.row_group})
        return table

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

    def set_readahead_depth(self, depth: int) -> None:
        """Set the readahead's depth live (the autotune controller's
        actuator); nothing for a worker built without a readahead."""
        if self.readahead is not None:
            self.readahead.set_depth(depth)

    def shutdown(self, close_cache: bool = True) -> None:
        """End the readahead, close the handles, and close the shared
        cache (flushing its counters; idempotent across threads).
        ``close_cache=False`` leaves the cache open: a thread worker retired
        by a shrink shares it with the pool's other threads."""
        if self.readahead is not None:
            self.readahead.stop()
        if self._prefetch_files is not None:
            self._prefetch_files.close_all()
        self._files.close_all()
        close = getattr(self.cache, 'close', None)
        if close is not None and close_cache:
            close()


def _payload_rows(payload) -> int:
    """Rows (or windows) of a load's result: a dict of columns, an arrow
    table, a list of rows or windows, a window chunk, or None."""
    if payload is None:
        return 0
    if isinstance(payload, dict):
        return len(next(iter(payload.values()))) if payload else 0
    rows = getattr(payload, 'num_rows', None)       # an arrow table
    return rows if rows is not None else len(payload)


def make_worker(process, worker_id: int = 0):
    """The object a pool calls on each item: ``process.make_worker()`` for
    a :class:`PieceWorkerSpec` (its provenance naming ``worker_id``), else
    ``process`` itself (a plain ``process(item)`` callable)."""
    if isinstance(process, PieceWorkerSpec):
        return process.make_worker(worker_id)
    factory = getattr(process, 'make_worker', None)
    return factory() if factory is not None else process


def with_readahead_depth(process, depth: int):
    """``process`` whose workers start at readahead ``depth``: a copy of a
    :class:`PieceWorkerSpec`, anything else as it is. A pool grown after a
    live :meth:`PieceWorker.set_readahead_depth` makes its new workers from
    this, so they do not come up at the reader's first depth."""
    if not isinstance(process, PieceWorkerSpec):
        return process
    spec = copy.copy(process)
    spec.io_readahead = depth
    return spec


def shutdown_worker(worker, close_cache: bool = True) -> None:
    """``worker.shutdown()`` where it has one; ``close_cache=False`` keeps a
    :class:`PieceWorker`'s cache open for the workers that share it."""
    shutdown = getattr(worker, 'shutdown', None)
    if shutdown is None:
        return
    if isinstance(worker, PieceWorker):
        shutdown(close_cache=close_cache)
    else:
        shutdown()
