"""A thread pool fed by a seeded epoch ventilator.

A small copy of ``petastorm_tpu/workers/thread_pool.py`` and
``workers/ventilator.py``: the ventilator puts work items (a
:class:`WorkItem` per row-group piece and row-drop partition, as the JAX
reader ventilates them, ``reader.py:646-663``) into the pool for ``num_epochs`` epochs (None = forever), reshuffling the
item order each epoch from one ``np.random.default_rng(seed)``, with at most
``max_in_flight`` items outstanding. Each thread makes its worker once,
``process.make_worker()`` for a reader's
:class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorkerSpec` (else
``process`` itself), runs it on each item and publishes the results; a
worker exception is re-raised in the consumer by
:meth:`ThreadPool.get_results`. A worker with a ``prefetch_lookahead``
takes up to that many more items off the queue without waiting and is
hinted the whole pending FIFO, the current item first
(``prefetch_hint``), before each item (JAX ``thread_pool.py:66-135``):
its readahead reads the next row groups while it decodes this one, and
with one worker the items keep their ventilation order. With ``profiling_enabled`` each worker
thread runs under its own ``cProfile`` and :meth:`ThreadPool.join` logs
the aggregate (JAX ``thread_pool.py:58-64, 613-620``). Once every result
is consumed,
:meth:`ThreadPool.reset` ventilates the items for more epochs, the shuffle
continuing from the same generator and the epochs counting on (the JAX
ventilator's ``reset``, ``workers/ventilator.py:252-263``). After each
item a worker's quarantine records and empty deliveries go to
``pool.lineage``, the reader's tracker (JAX ``thread_pool.py:183-190,
233-236``). ``stop()`` then ``join()`` ends every thread.

The stats plane (JAX ``thread_pool.py:160-200, 550-592``): ``pool.stats``
is the pool's :class:`~petastorm_tpu_torch.workers.stats.ReaderStats`,
``pool.tracer`` its :class:`~petastorm_tpu_torch.tracing.Tracer` (None
unless the reader traces) and ``pool.diagnostics`` a snapshot of both.
After each item a worker thread merges what its worker accumulated
(:func:`merge_worker_stats`: stage times with the derived decode time,
counts, gauges, latency deltas, spans and a ``process_item`` span) and
the time it then blocked on the full results queue
(``worker_publish_wait_s``); the consumer records its wait
(``queue_wait_s``, the ``queue_wait`` latency and span), ``items_out`` and
the ``queue_depth`` gauge. An item that left no row publishes nothing the
consumer sees, as in JAX.

Live actuators (the autotune controller's knobs, JAX
``thread_pool.py:313-512`` and ``workers/ventilator.py:71-150``):
:meth:`ThreadPool.resize` grows the pool by starting threads and shrinks
it by queueing retire requests, each taken by one thread that first
publishes every item it already holds; the pass ends when every thread
that served it has put its end marker on the results queue, a retiring
thread after its last result. :meth:`ThreadPool.set_readahead_depth`
reaches every worker (and the workers a later grow makes),
:meth:`ThreadPool.set_results_queue_bound` moves the results queue's
bound, and the :class:`VentilationJob` holds the in-flight window
(``set_max_in_flight``, ``pause``, ``resume``).

Heartbeats (JAX ``thread_pool.py:125, 201, 522-536, 629-640`` and
``workers/ventilator.py:85-109``): the ventilator publishes the
``ventilator`` entity through its :class:`VentilationJob` (``ventilate``,
``backpressured`` while it waits on the in-flight bound, ``done``); a
worker beats ``processing`` before each item, ``backpressured`` while its
result waits on a full queue and ``processing`` again when it goes in,
``idle`` once the item is published (``item_done``) and ``stopped`` at its
end. :meth:`ThreadPool.heartbeats` reads the workers' records live.

Worker auto-recovery (JAX ``thread_pool.py:128-170, 218-225, 386-480``),
with ``recovery`` the options of
:func:`~petastorm_tpu_torch.resilience.resolve_recovery`: a worker thread
killed by a ``BaseException`` (an injected
:class:`~petastorm_tpu_torch.faultfs.SimulatedWorkerCrash`) or by a
transient ``OSError`` that escaped the retry budget is replaced by a new
worker under a fresh worker id, counted as serving the pass in its place
(it takes the end marker the dead thread never took), and the items it
held go back on the item queue ahead of the end markers, the pending FIFO
first and the item it was running last. Only that item counts a crash:
at ``poison_threshold`` crashes it is quarantined through the lineage
channel (stage ``'worker-crash'``) instead of going out again. Respawns
are bounded by ``max_respawns`` (``max(3, workers_count)`` when None);
with recovery off, the budget spent or the pool stopping, the death ships
to the consumer, which raises it. A permanent ``OSError`` and
``MemoryError`` always ship: recovery must not turn a deleted file into a
quarantine.
"""

from __future__ import annotations

import cProfile
import io
import logging
import pstats
import queue
import threading
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from petastorm_tpu_torch.readers.piece_worker import (make_worker,
                                                      shutdown_worker,
                                                      with_readahead_depth)
from petastorm_tpu_torch.resilience import TRANSIENT, classify_error
from petastorm_tpu_torch.workers.stats import (ReaderStats,
                                               finalize_item_times)

logger = logging.getLogger(__name__)

_DONE = object()


class WorkItem(NamedTuple):
    """One ventilated unit of work: a row-group piece, the row predicate of
    that piece (the user's, combined with the residual of ``filters``
    specialised to the piece; None for none), its row-drop partition
    ``(partition, num_partitions)``, the piece's ordinal among the
    reader's pieces and the epoch it is ventilated for (set by
    :func:`ventilation_order`)."""
    piece: object
    predicate: object = None
    drop_partition: Tuple[int, int] = (0, 1)
    piece_index: int = -1
    epoch: int = 0


class EmptyResultError(Exception):
    """The ventilator has finished and every result has been consumed."""


def ventilation_order(items: List, num_epochs: Optional[int], shuffle: bool,
                      rng, first_epoch: int = 0, on_ventilate=None):
    """The items in the order the ventilator sends them: ``num_epochs``
    epochs (None = forever) numbered from ``first_epoch``, each reshuffled
    from ``rng`` when ``shuffle``. A :class:`WorkItem` goes out with its
    epoch set, after ``on_ventilate(item)`` (the reader's lineage ledger).
    Every pool ventilates through this, so the pools give one order for
    one seed, and each counts epochs on across its resets (JAX
    ``workers/ventilator.py:192-196``)."""
    epoch = first_epoch
    while num_epochs is None or epoch < first_epoch + num_epochs:
        order = np.arange(len(items))
        if shuffle:
            rng.shuffle(order)
        for i in order:
            item = items[int(i)]
            if isinstance(item, WorkItem):
                item = item._replace(epoch=epoch)
                if on_ventilate is not None:
                    on_ventilate(item)
            yield item
        epoch += 1
        if not items:
            break


class VentilationJob:
    """What a pool ventilates, and from which epoch its next pass counts:
    the items, the shuffle, the seeded generator, the reader's
    ``on_ventilate`` hook, and ``heartbeat(entity, stage)`` (the reader's
    ``HealthMonitor.beat``, or None), through which the ventilator beats
    as the ``ventilator`` entity.

    It also holds the in-flight window (JAX ``workers/ventilator.py:71-150``):
    at most ``max_in_flight`` items ventilated and not yet processed
    (None: no bound), counted by a condition and a counter rather than a
    semaphore, so the autotune controller can move the bound both ways
    live (:meth:`set_max_in_flight`) and a process pool's shrink or
    recovery can quiesce ventilation (:meth:`pause`, :meth:`resume`, which
    nest: the ventilation stays paused until every pause is resumed).

    A ``schedule`` (any iterable, read lazily) is ventilated once, as it
    comes, in place of the items' epochs: the indexed loaders' ``(epoch,
    batch)`` grid, walked from a cursor in O(1) memory (the role of JAX's
    ``_ScheduleVentilator``, ``indexed.py:314-337``). It takes no items,
    epochs, shuffle or seed, and its pool cannot be reset."""

    def __init__(self, items: List, shuffle: bool, seed, on_ventilate=None,
                 heartbeat=None, max_in_flight: Optional[int] = None,
                 schedule=None):
        self.items = list(items)
        self.schedule = schedule
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.on_ventilate = on_ventilate
        self.heartbeat = heartbeat
        self.next_epoch = 0
        self._max_in_flight = max_in_flight
        self._in_flight = 0
        self._paused = 0
        self._slot_cv = threading.Condition()

    def beat(self, stage: str) -> None:
        if self.heartbeat is not None:
            self.heartbeat('ventilator', stage)

    def acquire_slot(self, stop: threading.Event) -> bool:
        """Wait for a free in-flight slot; False once ``stop`` is set. A
        wait beats ``backpressured`` once (an idle-class stage: a stall is
        downstream), a slot ``ventilate``."""
        waited = False
        with self._slot_cv:
            while not stop.is_set():
                if not self._paused and (
                        self._max_in_flight is None
                        or self._in_flight < self._max_in_flight):
                    self._in_flight += 1
                    break
                if not waited:
                    waited = True
                    self.beat('backpressured')
                self._slot_cv.wait(timeout=0.1)
            else:
                return False
        self.beat('ventilate')
        return True

    def processed_item(self) -> None:
        """One ventilated item was processed: its slot frees."""
        with self._slot_cv:
            self._in_flight -= 1
            self._slot_cv.notify_all()

    @property
    def max_in_flight(self) -> Optional[int]:
        """The live in-flight bound (the ventilation window)."""
        with self._slot_cv:
            return self._max_in_flight

    def set_max_in_flight(self, bound: int) -> None:
        """Move the in-flight bound live. A smaller bound recalls nothing:
        it admits no new item until enough complete; a larger one wakes a
        back-pressured ventilator at once."""
        if not isinstance(bound, int) or bound < 1:
            raise ValueError('max_in_flight must be a positive int, got '
                             '{!r}'.format(bound))
        with self._slot_cv:
            self._max_in_flight = bound
            self._slot_cv.notify_all()

    def pause(self) -> None:
        """Admit no new item (those in flight complete): the quiesce of a
        process pool's shrink, and of a recovery episode. Each pause needs
        its own :meth:`resume`."""
        with self._slot_cv:
            self._paused += 1

    def resume(self) -> None:
        """Undo one :meth:`pause`; the last wakes the ventilator at once."""
        with self._slot_cv:
            self._paused = max(0, self._paused - 1)
            self._slot_cv.notify_all()

    @property
    def in_flight(self) -> int:
        """Items ventilated and not yet reported processed."""
        with self._slot_cv:
            return self._in_flight

    def order(self, num_epochs: Optional[int]):
        """The next pass's :func:`ventilation_order`, or the schedule."""
        if self.schedule is not None:
            return iter(self.schedule)
        first = self.next_epoch
        if num_epochs is not None:
            self.next_epoch += num_epochs
        return ventilation_order(self.items, num_epochs, self.shuffle,
                                 self.rng, first, self.on_ventilate)


def absorb_lineage(lineage, quarantines, empty) -> None:
    """Hand what a worker collected on an item to the reader's ``lineage``
    tracker (None: nothing takes it): its quarantine records, and the
    provenance of items it processed that left no row (JAX
    ``thread_pool.py:183-190``)."""
    if lineage is not None:
        lineage.add_quarantines(quarantines)
        for provenance in empty:
            lineage.register(provenance)


def merge_worker_stats(stats, tracer, worker, start: float,
                       elapsed: float) -> None:
    """Merge what ``worker`` accumulated on the item it just ran, from
    ``start`` for ``elapsed`` seconds, into the pool's ``stats`` and
    ``tracer`` (None: no tracing): its stage times with the derived
    ``worker_decode_s``, counts, gauges and latency deltas, its spans and
    a ``process_item`` span. A plain callable has only the time."""
    drain = getattr(worker, 'drain_stage_times', None)
    times = drain() if drain is not None else {}
    stats.merge_times(finalize_item_times(times, elapsed))
    if drain is not None:
        counts, gauges = worker.drain_stat_counts()
        stats.merge_counts(counts)
        stats.merge_gauges(gauges)
        stats.merge_latency(worker.drain_latency())
    if tracer is not None:
        tracer.add_span('process_item', 'worker', start, elapsed)
        if drain is not None:
            tracer.merge(worker.drain_spans())


def drain_lineage(worker, lineage) -> None:
    """:func:`absorb_lineage` of what ``worker`` collected on its last
    item; a worker without lineage (a plain callable) has nothing."""
    drain = getattr(worker, 'drain_lineage', None)
    if drain is not None:
        absorb_lineage(lineage, *drain())


class _Retire:
    """A shrink request on the shared item queue (JAX ``_RetireSentinel``):
    the thread that takes it processes and publishes every item its
    lookahead already holds, then exits; ``done`` is set once it did."""

    __slots__ = ('done',)

    def __init__(self):
        self.done = threading.Event()


class ThreadPool:
    #: workers are hinted their upcoming items: a reader may turn on
    #: ``io_readahead``
    supports_prefetch_hints = True

    def __init__(self, workers_count: int, results_queue_size: int = 50,
                 profiling_enabled: bool = False, tracer=None,
                 recovery: Optional[dict] = None):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1')
        self.stats = ReaderStats()
        # worker auto-recovery: the options (None: off), the respawns used
        # and each item key's crash count
        self._recovery = recovery
        self._respawns_used = 0
        self._crash_counts = {}
        #: the reader's tracer (None: no tracing)
        self.tracer = tracer
        self._workers_count = workers_count
        self._profiling_enabled = profiling_enabled
        self._profiles: List[cProfile.Profile] = []
        self._results = queue.Queue(maxsize=results_queue_size)
        self._items: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._process = None
        # membership and end-of-pass accounting, under self._lock (list and
        # counter work only, and puts on the unbounded item queue): each
        # worker as (worker id, worker), the threads of this pass, the
        # threads retired by a shrink and not yet joined, the shrink
        # requests not yet taken
        self._lock = threading.Lock()
        self._members: List[Tuple[int, object]] = []
        self._threads: List[threading.Thread] = []
        self._retired: List[threading.Thread] = []
        self._retiring: List[_Retire] = []
        self._next_worker_id = workers_count
        self._readahead_override: Optional[int] = None
        # this pass: threads started, end markers the consumer took, and
        # whether the ventilator queued its end markers
        self._pass_threads = 0
        self._pass_exits = 0
        self._pass_ventilated = False
        self._ventilator: Optional[threading.Thread] = None
        self._job: Optional[VentilationJob] = None
        #: the reader's lineage tracker (set before :meth:`start`): each
        #: worker's quarantine records and empty deliveries drain into it
        self.lineage = None

    def start(self, process: Callable, items: List, num_epochs: Optional[int]
              = 1, shuffle: bool = True, seed=None,
              max_in_flight: Optional[int] = None,
              on_ventilate=None, heartbeat=None, schedule=None) -> None:
        """Start the workers and the ventilator over ``items`` (or over
        ``schedule``, see :class:`VentilationJob`); ``on_ventilate(item)``
        sees each work item as it is ventilated, and the ventilator beats
        through ``heartbeat``."""
        if self._job is not None:
            raise RuntimeError('pool already started')
        if schedule is not None and (items or num_epochs != 1
                                     or not shuffle or seed is not None):
            raise ValueError('a schedule is ventilated in place of items, '
                             'epochs, shuffle and seed: pass none of them')
        self._job = VentilationJob(items, shuffle, seed, on_ventilate,
                                   heartbeat, max_in_flight
                                   or 2 * self._workers_count, schedule)
        self._process = process
        self._members = [(i, make_worker(process, worker_id=i))
                         for i in range(self._workers_count)]
        self._launch(num_epochs)

    @property
    def workers_count(self) -> int:
        """The live worker count (the target of the last :meth:`resize`)."""
        return self._workers_count

    @property
    def workers(self) -> List:
        """Each worker thread's worker, made once and kept across resets."""
        with self._lock:
            return [worker for _, worker in self._members]

    @property
    def threads(self) -> List[threading.Thread]:
        """Every thread the pool started and has not joined: the workers'
        of this pass, the retired ones and the ventilator (a loader that
        closes files under them checks that none is alive)."""
        with self._lock:
            threads = self._threads + self._retired
        return threads + ([self._ventilator] if self._ventilator else [])

    @property
    def ventilation(self) -> Optional[VentilationJob]:
        """The :class:`VentilationJob` (its live in-flight window)."""
        return self._job

    def _start_thread(self, worker_id: int, worker) -> None:
        """Start a thread serving ``worker`` in this pass (under the
        lock)."""
        t = threading.Thread(target=self._work, args=(worker,),
                             name='petastorm-torch-worker-%d' % worker_id,
                             daemon=True)
        self._threads.append(t)
        self._pass_threads += 1
        t.start()

    def _launch(self, num_epochs):
        with self._lock:
            # workers a shrink dropped after the last pass's end markers
            # went out leave now
            dropped = self._members[self._workers_count:]
            del self._members[self._workers_count:]
            self._pass_threads = self._pass_exits = 0
            self._pass_ventilated = False
            for worker_id, worker in self._members:
                self._start_thread(worker_id, worker)
        for _, worker in dropped:
            shutdown_worker(worker)
        self._ventilator = threading.Thread(
            target=self._ventilate, args=(self._job.order(num_epochs),),
            name='petastorm-torch-ventilator', daemon=True)
        self._ventilator.start()

    def _pass_complete(self) -> bool:
        with self._lock:
            return self._pass_exits >= self._pass_threads

    def reset(self, num_epochs: Optional[int] = 1) -> None:
        """Ventilate the items for ``num_epochs`` more epochs; legal only
        once every result of the previous ones was consumed, and never on a
        pool started with a ``schedule``."""
        if self._job is not None and self._job.schedule is not None:
            raise RuntimeError('a scheduled pool ventilates its schedule '
                               'once: start a new pool')
        if not self._pass_complete() or self._stop.is_set():
            raise RuntimeError('Cannot reset a pool that has not completed')
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads + [self._ventilator]:
            t.join()
        self.reap_retired()
        self._launch(num_epochs)

    def _ventilate(self, order):
        job = self._job
        job.beat('ventilate')
        try:
            for item in order:
                if not job.acquire_slot(self._stop):
                    return
                self._items.put(item)
        finally:
            with self._lock:
                # one end marker a thread that is not retiring: a shrink's
                # retire requests are all ahead of them in the queue
                self._pass_ventilated = True
                for _ in range(self._workers_count):
                    self._items.put(_DONE)
            job.beat('done')

    def _publish(self, value, beat=None) -> bool:
        """Put ``value`` on the results queue, giving up once stopped.
        ``beat`` (the publishing worker's) marks the time blocked on a full
        queue ``backpressured``: a paused consumer is not a stalled
        worker."""
        blocked = False
        while not self._stop.is_set():
            try:
                self._results.put(value, timeout=0.1)
                if blocked and beat is not None:
                    beat('processing')
                return True
            except queue.Full:
                if not blocked and beat is not None:
                    blocked = True
                    beat('backpressured')
        return False

    def _work(self, worker):
        profiler = cProfile.Profile() if self._profiling_enabled else None
        if profiler is not None:
            try:
                profiler.enable()
            except ValueError:
                # Python 3.12+ allows one profiler a process, and it sees
                # every thread: this worker is profiled by another's
                profiler = None
        beat = getattr(worker, 'beat', None)
        retire = None
        try:
            retire = self._serve(worker, beat)
        finally:
            if beat is not None:
                beat('stopped')
            if profiler is not None:
                profiler.disable()
                self._profiles.append(profiler)   # list.append is atomic
        if retire is not None:
            self._retire(worker, retire)

    def _serve(self, worker, beat) -> Optional[_Retire]:
        """Serve items until the end marker (publishing it) or a retire
        request (returned, once every item already held is published)."""
        hint = getattr(worker, 'prefetch_hint', None)
        item_done = getattr(worker, 'item_done', None)
        pending = deque()
        ventilated = False        # this worker has seen the end marker
        retire = None
        while not self._stop.is_set():
            if not pending:
                if retire is not None:
                    return retire
                item = self._items.get()
                if item is _DONE:
                    self._publish(_DONE)
                    return None
                if isinstance(item, _Retire):
                    return item
                pending.append(item)
            while (not ventilated and retire is None and len(pending) - 1
                   < getattr(worker, 'prefetch_lookahead', 0)):
                try:
                    extra = self._items.get_nowait()
                except queue.Empty:
                    break
                if extra is _DONE:
                    # every item is out: leave the marker for the next get
                    self._items.put(_DONE)
                    ventilated = True
                    break
                if isinstance(extra, _Retire):
                    # take nothing new: finish what is held, then go
                    retire = extra
                    break
                pending.append(extra)
            if hint is not None:
                hint(list(pending))
            item = pending.popleft()
            if beat is not None:
                beat('processing')
            start = time.perf_counter()
            try:
                result = worker(item)
                drain_lineage(worker, self.lineage)
            except BaseException as e:
                # a death (a BaseException, or a transient OSError that
                # escaped the retry budget) goes to recovery; anything else,
                # or a death recovery declines, is re-raised in the consumer
                crash = (not isinstance(e, Exception)
                         or (isinstance(e, OSError)
                             and classify_error(e) == TRANSIENT))
                # what the failed attempt counted (retries, a permanent
                # read failure) is merged all the same
                merge_worker_stats(self.stats, self.tracer, worker, start,
                                   time.perf_counter() - start)
                if crash and self._handle_worker_crash(worker, item, pending,
                                                       retire, e):
                    return None
                self._job.processed_item()
                self._publish(('error', e))
                return None
            self._job.processed_item()
            merge_worker_stats(self.stats, self.tracer, worker, start,
                               time.perf_counter() - start)
            publish_start = time.perf_counter()
            published = self._publish(('ok', result), beat)
            self.stats.add_time('worker_publish_wait_s',
                                time.perf_counter() - publish_start)
            if not published:
                return None
            if item_done is not None:
                item_done()
        return None

    def _retire(self, worker, request: _Retire) -> None:
        """A retiring thread's last act: its worker leaves the pool (its
        readahead and files closed, the shared cache left to the others),
        the thread moves to the retired list for :meth:`reap_retired`, and
        an end marker follows its last result, so the consumer ends the
        pass only after it."""
        shutdown_worker(worker, close_cache=False)
        me = threading.current_thread()
        with self._lock:
            self._members = [m for m in self._members if m[1] is not worker]
            if me in self._threads:
                self._threads.remove(me)
            self._retired.append(me)
            if request in self._retiring:
                self._retiring.remove(request)
        request.done.set()
        self._publish(_DONE)

    # -- worker auto-recovery ------------------------------------------------

    @staticmethod
    def _item_key(item):
        """An item's identity across epochs and redispatches (the poison
        count's key): ``(piece_index, drop_partition)`` of a work item, its
        repr otherwise."""
        piece_index = getattr(item, 'piece_index', -1)
        if not isinstance(item, WorkItem) or piece_index < 0:
            return ('raw', repr(item)[:200])
        return (piece_index, tuple(item.drop_partition or (0, 1)))

    def _quarantine_poison(self, item, crash_count: int) -> None:
        from petastorm_tpu_torch.lineage import crash_quarantine_record
        logger.error('poison item %s killed %d worker(s); quarantining it '
                     'instead of crash-looping', self._item_key(item),
                     crash_count)
        tracker = self.lineage
        piece_index = getattr(item, 'piece_index', -1)
        if tracker is not None and tracker.enabled and piece_index >= 0:
            tracker.add_quarantines([crash_quarantine_record(
                tracker, piece_index, item.epoch, item.drop_partition,
                crash_count)])

    def _requeue(self, entries: List) -> None:
        """Put ``entries`` back on the item queue, in order, behind every
        item already there and ahead of the end markers: an item queued
        behind a marker would be stranded once every thread took one.
        Under the queue's own mutex, waking as many waiting threads."""
        q = self._items
        with q.mutex:
            at = next((i for i, entry in enumerate(q.queue)
                       if entry is _DONE), len(q.queue))
            for offset, entry in enumerate(entries):
                q.queue.insert(at + offset, entry)
            q.unfinished_tasks += len(entries)
            q.not_empty.notify(len(entries))

    def _handle_worker_crash(self, worker, item, pending, retire,
                             exc: BaseException) -> bool:
        """A worker thread is dying on ``item``, holding ``pending`` (and
        the shrink request ``retire``, or None). With recovery on and budget
        left: start a replacement in its place, hand the held items back
        (the suspect last, or quarantined at the poison threshold), shut
        the dead worker down and return True; the thread then exits without
        an end marker, which its replacement takes. False when recovery is
        off, spent, or the pool is stopping."""
        recovery = self._recovery
        if recovery is None or self._stop.is_set():
            return False
        budget = recovery.get('max_respawns')
        if budget is None:
            budget = max(3, self._workers_count)
        me = threading.current_thread()
        key = self._item_key(item)
        with self._lock:
            if self._stop.is_set():
                return False
            if self._respawns_used >= budget:
                logger.error('worker respawn budget exhausted (%d); letting '
                             'the crash surface', budget)
                return False
            self._respawns_used += 1
            count = self._crash_counts.get(key, 0) + 1
            self._crash_counts[key] = count
            poison = count >= recovery.get('poison_threshold', 3)
            worker_id = self._next_worker_id
            self._next_worker_id += 1
            process = self._process
            if self._readahead_override is not None:
                process = with_readahead_depth(process,
                                               self._readahead_override)
            replacement = make_worker(process, worker_id=worker_id)
            self._members = [(worker_id, replacement) if w is worker
                             else (wid, w) for wid, w in self._members]
            if me in self._threads:
                self._threads.remove(me)
            self._retired.append(me)     # joined by reap_retired and join
            entries = list(pending) + ([] if poison else [item])
            if retire is not None:
                entries.append(retire)
            self._requeue(entries)
            # the replacement serves the pass in the dead thread's place
            self._pass_threads -= 1
            self._start_thread(worker_id, replacement)
        redispatched = len(entries) - (retire is not None)
        logger.warning('worker thread %s died (%s: %s); respawned as worker '
                       '%d and re-dispatching %d item(s)', me.name,
                       type(exc).__name__, exc, worker_id, redispatched)
        self.stats.add('worker_respawns')
        if poison:
            self._quarantine_poison(item, count)
            self.stats.add('poison_items_quarantined')
            self._job.processed_item()
        if redispatched:
            self.stats.add('items_redispatched', redispatched)
        shutdown_worker(worker, close_cache=False)
        return True

    # -- live actuators (the autotune controller's knobs) --------------------

    def resize(self, workers_count: int, timeout_s: float = 30.0) -> int:
        """Resize the pool live to ``workers_count`` workers (JAX
        ``thread_pool.py:313-395``); returns the new count.

        A grow makes workers (at the live readahead depth) and starts their
        threads at once. A shrink queues one retire request a worker to
        go: the thread that takes it publishes every item its lookahead
        already holds, drains its stats and exits, so each item is
        delivered exactly once; retired threads are joined here, bounded by
        ``timeout_s``, and by :meth:`reap_retired`. Once the pass's end
        markers are queued, a grow's threads and a shrink's exits wait for
        the next pass."""
        if not isinstance(workers_count, int) or workers_count < 1:
            raise ValueError('workers_count must be a positive int, got '
                             '{!r}'.format(workers_count))
        requests = []
        with self._lock:
            if self._stop.is_set() or self._job is None:
                return self._workers_count
            delta = workers_count - self._workers_count
            for _ in range(max(0, delta)):
                worker_id = self._next_worker_id
                self._next_worker_id += 1
                process = self._process
                if self._readahead_override is not None:
                    process = with_readahead_depth(process,
                                                   self._readahead_override)
                worker = make_worker(process, worker_id=worker_id)
                self._members.append((worker_id, worker))
                if not self._pass_ventilated:
                    self._start_thread(worker_id, worker)
            if delta < 0 and not self._pass_ventilated:
                requests = [_Retire() for _ in range(-delta)]
                self._retiring.extend(requests)
                for request in requests:
                    self._items.put(request)
            self._workers_count = workers_count
        if requests:
            self.reap_retired(timeout_s)
        return self._workers_count

    def reap_retired(self, timeout_s: float = 10.0) -> int:
        """Wait for the retire requests outstanding (bounded by
        ``timeout_s``; not once stopping) and join the retired threads;
        returns how many requests are still outstanding (0: settled)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            outstanding = list(self._retiring)
        for request in outstanding:
            remaining = deadline - time.monotonic()
            if self._stop.is_set() or remaining <= 0:
                break
            request.done.wait(remaining)
        with self._lock:
            retired, self._retired = self._retired, []
            still = len(self._retiring)
        for t in retired:
            t.join(max(0.0, deadline - time.monotonic()))
        return still

    def set_readahead_depth(self, depth: int) -> None:
        """Set every worker's readahead depth live; workers a later grow
        makes start at it."""
        self._readahead_override = depth
        for worker in self.workers:
            setter = getattr(worker, 'set_readahead_depth', None)
            if setter is not None:
                setter(depth)

    @property
    def readahead_depth(self) -> Optional[int]:
        """The depth of the last :meth:`set_readahead_depth` (None before
        one)."""
        return self._readahead_override

    def set_results_queue_bound(self, maxsize: int) -> None:
        """Move the results queue's bound live (JAX
        ``thread_pool.py:496-512``): ``queue.Queue`` keeps ``maxsize`` as an
        attribute under its ``mutex``; putters blocked on a full queue are
        woken, so an enlargement takes effect at once."""
        if not isinstance(maxsize, int) or maxsize < 1:
            raise ValueError('results queue bound must be a positive int, '
                             'got {!r}'.format(maxsize))
        q = self._results
        with q.mutex:
            q.maxsize = maxsize
            q.not_full.notify_all()

    @property
    def results_queue_bound(self) -> int:
        return self._results.maxsize

    def get_results(self):
        """The next result; raises a worker's exception, or
        :class:`EmptyResultError` when every epoch is consumed or the pool
        was stopped."""
        stats = self.stats
        entered = time.perf_counter()
        while True:
            if self._pass_complete():
                raise EmptyResultError()
            wait_start = time.perf_counter()
            try:
                value = self._results.get(timeout=0.1)
            except queue.Empty:
                stats.add_time('queue_wait_s',
                               time.perf_counter() - wait_start)
                if self._stop.is_set():     # stopped: nothing more comes
                    raise EmptyResultError()
                continue
            stats.add_time('queue_wait_s', time.perf_counter() - wait_start)
            if value is _DONE:
                with self._lock:
                    self._pass_exits += 1
                continue
            kind, payload = value
            if kind == 'error':
                self.stop()
                raise payload
            if payload is None:     # an item that left no row
                continue
            stats.gauge('queue_depth', self._results.qsize())
            stats.add('items_out')
            now = time.perf_counter()
            stats.record_latency('queue_wait', now - entered)
            if self.tracer is not None:
                self.tracer.add_span('queue_wait', 'consumer', entered,
                                     now - entered)
            return payload

    def heartbeats(self) -> dict:
        """The workers' heartbeat records, read live (they run in this
        process); a retired worker's are gone with it."""
        records = {}
        for worker in self.workers:
            snapshot = getattr(worker, 'heartbeat_snapshot', None)
            if snapshot is not None:
                records.update(snapshot())
        return records

    @property
    def diagnostics(self) -> dict:
        """The results queue's size and a snapshot of :attr:`stats`."""
        out = {'output_queue_size': self._results.qsize()}
        out.update(self.stats.snapshot())
        return out

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for every thread (after :meth:`stop`); raises
        ``TimeoutError`` when one is still alive after ``timeout`` s."""
        with self._lock:
            threads = self._threads + self._retired
        for _ in threads:
            self._items.put(_DONE)   # wake workers blocked on an empty queue
        threads += [self._ventilator] if self._ventilator else []
        for t in threads:
            t.join(timeout)
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            raise TimeoutError('pool threads still running: %s' % alive)
        with self._lock:
            members, self._members = self._members, []
            self._retired = []
        for _, worker in members:
            shutdown_worker(worker)
        if self._profiles:
            stats = pstats.Stats(self._profiles[0])
            for p in self._profiles[1:]:
                stats.add(p)
            out = io.StringIO()
            stats.stream = out
            stats.sort_stats('cumulative').print_stats(30)
            logger.info('Aggregated worker profile:\n%s', out.getvalue())
            self._profiles = []
