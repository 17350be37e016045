"""A worker's row-group readahead: its next reads overlap its decode.

The port's copy of ``petastorm_tpu/readers/readahead.py``
(``RowGroupReadahead`` :72). One background thread per worker issues the
Parquet reads of the worker's next items while the worker decodes the
current one:

- **One background thread.** A ``pq.ParquetFile`` must not serve two reads
  at once, so the thread reads through its own handle cache, apart from the
  worker's (:class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorker`).
- **FIFO.** The pool hints the worker with its upcoming items in the order
  it will process them, and the worker takes the reads in that order.
  :meth:`RowGroupReadahead.sync` treats the outstanding reads as a prefix
  of the hinted plans and cancels them all on any mismatch: a prefetch out
  of step turns into an inline read, never into wrong data.
- **``depth='auto'``** starts at :data:`AUTO_INITIAL_DEPTH` and follows the
  average read time over the average gap between two :meth:`take` calls
  (the worker's decode of one item), up to :data:`AUTO_MAX_DEPTH`.

The hit, miss, read and wait tallies since the start stay on the object
(:meth:`RowGroupReadahead.tallies`); the background thread never touches
the worker's stats. What accumulated since the last call, and with
``trace`` a ``readahead_read`` span per background read, moves into the
worker on the worker's own thread (:meth:`RowGroupReadahead.drain_stats_into`,
JAX :226-253). With ``beat``, the background thread publishes its
liveness (``idle`` waiting for a request, ``io`` reading, ``stopped`` at
its end; JAX :84-87, :281-291), which the owning worker records as its
``readahead-<id>`` entity.

Under the autotune controller (``controlled=True``, JAX :89-144) the depth
is the controller's: the local ``'auto'`` retune never runs, and only
:meth:`RowGroupReadahead.set_depth` moves it. Depth 0 is dormant: the
hints flow, nothing is prefetched, and a later :meth:`set_depth` wakes it.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from petastorm_tpu_torch.tracing import make_span

#: Upper bound of ``depth='auto'``, and the lookahead the reader sizes its
#: in-flight bound by under ``'auto'``.
AUTO_MAX_DEPTH = 8

#: ``depth='auto'``'s depth until enough samples arrive.
AUTO_INITIAL_DEPTH = 2


class _Prefetch:
    """One background read."""

    __slots__ = ('key', 'piece', 'columns', 'table', 'error', 'done',
                 'cancelled', 'read_s')

    def __init__(self, key, piece, columns):
        self.key = key
        self.piece = piece
        self.columns = columns
        self.table = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.cancelled = False
        self.read_s = 0.0


class RowGroupReadahead:
    """A bounded FIFO of prefetched reads and the thread that reads them.

    :param read_fn: ``read_fn(piece, columns) -> pa.Table``; runs only on
        the background thread, so it must use its own file handles.
    :param depth: the most reads outstanding, or ``'auto'``. ``0`` is
        dormant: nothing is prefetched until :meth:`set_depth` raises it.
    :param trace: keep a ``readahead_read`` span of each background read
        (on the background thread's track) for :meth:`drain_stats_into`.
    :param beat: ``beat(stage)``, called from the background thread (so
        safe across threads), or None.
    :param controlled: the autotune controller owns the depth: the local
        ``'auto'`` retune never runs (two tuners on one knob would
        oscillate), and only :meth:`set_depth` moves it.
    """

    def __init__(self, read_fn, depth, trace: bool = False, beat=None,
                 controlled: bool = False):
        if depth != 'auto' and (not isinstance(depth, int) or depth < 0):
            raise ValueError(
                "readahead depth must be a non-negative int or 'auto', got "
                '{!r}'.format(depth))
        self._read_fn = read_fn
        self._auto = depth == 'auto' and not controlled
        self._depth = AUTO_INITIAL_DEPTH if depth == 'auto' else depth
        self._lock = threading.Lock()
        self._scheduled: deque = deque()      # FIFO of un-consumed _Prefetch
        self._requests: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._tallies = {'readahead_hits': 0, 'readahead_misses': 0,
                         'readahead_io_s': 0.0, 'readahead_wait_s': 0.0}
        # what accumulated since the last drain_stats_into, and its spans
        self._pending = dict.fromkeys(self._tallies, 0)
        self._trace = trace
        self._beat = beat
        self._trace_spans: list = []
        # 'auto' measurements, under self._lock
        self._read_s_sum = 0.0
        self._read_samples = 0
        self._gap_s_sum = 0.0
        self._gap_samples = 0
        self._last_serve_end: Optional[float] = None

    @property
    def depth(self) -> int:
        """The current target depth (fixed, or 'auto''s live value)."""
        with self._lock:
            return self._depth

    def set_depth(self, depth: int) -> None:
        """Pin the target depth live (the autotune controller's actuator):
        the local ``'auto'`` retune stops for good. ``0`` makes the
        readahead dormant (outstanding reads drain normally, no new one is
        scheduled); a later positive depth wakes it. Capped at
        :data:`AUTO_MAX_DEPTH`."""
        if not isinstance(depth, int) or depth < 0:
            raise ValueError('readahead depth must be a non-negative int, '
                             'got {!r}'.format(depth))
        with self._lock:
            self._auto = False
            self._depth = min(depth, AUTO_MAX_DEPTH)

    def tallies(self) -> Dict[str, float]:
        """Hits and misses of :meth:`take`, seconds of background reads
        and seconds :meth:`take` waited for one, since the start."""
        with self._lock:
            return dict(self._tallies)

    def _retune_locked(self) -> None:
        if not self._auto or self._read_samples < 2 or self._gap_samples < 2:
            return
        avg_read = self._read_s_sum / self._read_samples
        avg_gap = self._gap_s_sum / self._gap_samples
        ratio = avg_read / max(avg_gap, 1e-9)
        self._depth = int(min(AUTO_MAX_DEPTH, max(1, math.ceil(ratio))))

    def sync(self, plans: List[Tuple]) -> int:
        """Reconcile the outstanding reads with the ordered upcoming
        ``plans`` (``(key, piece, columns)``) and schedule new reads up to
        the depth; returns the number outstanding. Outstanding reads that
        are not a prefix of ``plans`` are all cancelled."""
        with self._lock:
            if self._stopped:
                return 0
            matches = len(self._scheduled) <= len(plans) and all(
                entry.key == plan[0]
                for entry, plan in zip(self._scheduled, plans))
            if not matches:
                self._cancel_all_locked()
            for key, piece, columns in plans[len(self._scheduled):]:
                if len(self._scheduled) >= self._depth:
                    break
                entry = _Prefetch(key, piece, columns)
                self._scheduled.append(entry)
                self._requests.put(entry)
            occupancy = len(self._scheduled)
            if occupancy and self._thread is None:
                self._thread = threading.Thread(
                    target=self._reader_loop, daemon=True,
                    name='petastorm-torch-readahead')
                self._thread.start()
        return occupancy

    def take(self, key):
        """The table read for ``key`` (waiting for it), or None when it was
        not prefetched: the caller reads inline. Called from the worker
        thread, in the order of the hints."""
        now = time.perf_counter()
        with self._lock:
            entry = None
            if self._scheduled and self._scheduled[0].key == key:
                entry = self._scheduled.popleft()
            if entry is None:
                if self._depth > 0:
                    self._tallies['readahead_misses'] += 1
                    self._pending['readahead_misses'] += 1
                # an inline read follows: skip the next gap sample
                self._last_serve_end = None
                return None
            if self._last_serve_end is not None:
                self._gap_s_sum += now - self._last_serve_end
                self._gap_samples += 1
        wait_start = time.perf_counter()
        entry.done.wait()
        waited = time.perf_counter() - wait_start
        with self._lock:
            for tally in (self._tallies, self._pending):
                tally['readahead_hits'] += 1
                tally['readahead_wait_s'] += waited
            self._last_serve_end = time.perf_counter()
            self._retune_locked()
        if entry.error is not None:
            raise entry.error
        return entry.table

    def drain_stats_into(self, worker) -> None:
        """Move what accumulated since the last call into ``worker`` (a
        :class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorker`),
        from the worker's thread: read and wait seconds, hits and misses,
        the spans, and the ``readahead_depth`` gauge. The wait counts as
        ``worker_io_s`` too: it is the storage stall the readahead did not
        hide."""
        with self._lock:
            pending = self._pending
            self._pending = dict.fromkeys(pending, 0)
            spans, self._trace_spans = self._trace_spans, []
            occupancy = len(self._scheduled)
        for stage in ('readahead_io_s', 'readahead_wait_s'):
            if pending[stage]:
                worker.record_time(stage, pending[stage])
        if pending['readahead_wait_s']:
            worker.record_time('worker_io_s', pending['readahead_wait_s'])
        for name in ('readahead_hits', 'readahead_misses'):
            if pending[name]:
                worker.record_count(name, pending[name])
        if spans and getattr(worker, 'tracing_enabled', False):
            worker.trace_spans.extend(spans)
        worker.record_gauge('readahead_depth', occupancy)

    def _cancel_all_locked(self) -> None:
        for entry in self._scheduled:
            entry.cancelled = True
        self._scheduled.clear()
        self._last_serve_end = None

    def stop(self) -> None:
        """Cancel the outstanding reads and end the background thread."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._cancel_all_locked()
        self._requests.put(None)
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)

    def _reader_loop(self) -> None:
        beat = self._beat
        while True:
            if beat is not None:
                beat('idle')
            entry = self._requests.get()
            if entry is None:
                if beat is not None:
                    beat('stopped')
                return
            if entry.cancelled:
                entry.done.set()
                continue
            if beat is not None:
                beat('io')
            start = time.perf_counter()
            try:
                entry.table = self._read_fn(entry.piece, entry.columns)
            except BaseException as e:  # noqa: BLE001 - re-raised in take()
                entry.error = e
            entry.read_s = time.perf_counter() - start
            with self._lock:
                if not entry.cancelled:
                    self._tallies['readahead_io_s'] += entry.read_s
                    self._pending['readahead_io_s'] += entry.read_s
                    if self._trace:
                        self._trace_spans.append(make_span(
                            'readahead_read', 'io', start, entry.read_s))
                self._read_s_sum += entry.read_s
                self._read_samples += 1
                self._retune_locked()
            entry.done.set()
