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
                                                      shutdown_worker)
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
    the items, the shuffle, the seeded generator, and the reader's
    ``on_ventilate`` hook."""

    def __init__(self, items: List, shuffle: bool, seed, on_ventilate=None):
        self.items = list(items)
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.on_ventilate = on_ventilate
        self.next_epoch = 0

    def order(self, num_epochs: Optional[int]):
        """The next pass's :func:`ventilation_order`."""
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


class ThreadPool:
    #: workers are hinted their upcoming items: a reader may turn on
    #: ``io_readahead``
    supports_prefetch_hints = True

    def __init__(self, workers_count: int, results_queue_size: int = 50,
                 profiling_enabled: bool = False, tracer=None):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1')
        self.stats = ReaderStats()
        #: the reader's tracer (None: no tracing)
        self.tracer = tracer
        self._workers_count = workers_count
        self._profiling_enabled = profiling_enabled
        self._profiles: List[cProfile.Profile] = []
        self._results = queue.Queue(maxsize=results_queue_size)
        self._items: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        #: each thread's worker, made at start and kept across resets
        self.workers: List = []
        self._slots: Optional[threading.Semaphore] = None
        self._ventilator: Optional[threading.Thread] = None
        self._workers_done = 0
        self._job: Optional[VentilationJob] = None
        #: the reader's lineage tracker (set before :meth:`start`): each
        #: worker's quarantine records and empty deliveries drain into it
        self.lineage = None

    def start(self, process: Callable, items: List, num_epochs: Optional[int]
              = 1, shuffle: bool = True, seed=None,
              max_in_flight: Optional[int] = None,
              on_ventilate=None) -> None:
        """Start the workers and the ventilator over ``items``;
        ``on_ventilate(item)`` sees each work item as it is ventilated."""
        if self._threads:
            raise RuntimeError('pool already started')
        self._slots = threading.Semaphore(max_in_flight
                                          or 2 * self._workers_count)
        self._job = VentilationJob(items, shuffle, seed, on_ventilate)
        self.workers = [make_worker(process, worker_id=i)
                        for i in range(self._workers_count)]
        self._launch(num_epochs)

    @property
    def workers_count(self) -> int:
        return self._workers_count

    def _launch(self, num_epochs):
        for i, worker in enumerate(self.workers):
            t = threading.Thread(target=self._work, args=(worker,),
                                 name='petastorm-torch-worker-%d' % i,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._ventilator = threading.Thread(
            target=self._ventilate, args=(self._job.order(num_epochs),),
            name='petastorm-torch-ventilator', daemon=True)
        self._ventilator.start()

    def reset(self, num_epochs: Optional[int] = 1) -> None:
        """Ventilate the items for ``num_epochs`` more epochs; legal only
        once every result of the previous ones was consumed."""
        if self._workers_done != self._workers_count or self._stop.is_set():
            raise RuntimeError('Cannot reset a pool that has not completed')
        for t in self._threads + [self._ventilator]:
            t.join()
        self._threads = []
        self._workers_done = 0
        self._launch(num_epochs)

    def _ventilate(self, order):
        try:
            for item in order:
                while not self._slots.acquire(timeout=0.1):
                    if self._stop.is_set():
                        return
                if self._stop.is_set():
                    return
                self._items.put(item)
        finally:
            for _ in range(self._workers_count):
                self._items.put(_DONE)

    def _publish(self, value) -> bool:
        while not self._stop.is_set():
            try:
                self._results.put(value, timeout=0.1)
                return True
            except queue.Full:
                continue
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
        try:
            self._serve(worker)
        finally:
            if profiler is not None:
                profiler.disable()
                self._profiles.append(profiler)   # list.append is atomic

    def _serve(self, worker):
        hint = getattr(worker, 'prefetch_hint', None)
        pending = deque()
        ventilated = False        # this worker has seen the end marker
        while not self._stop.is_set():
            if not pending:
                item = self._items.get()
                if item is _DONE:
                    self._publish(_DONE)
                    return
                pending.append(item)
            while (not ventilated and len(pending) - 1
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
                pending.append(extra)
            if hint is not None:
                hint(list(pending))
            item = pending.popleft()
            start = time.perf_counter()
            try:
                result = worker(item)
                drain_lineage(worker, self.lineage)
            except Exception as e:     # re-raised in the consumer
                self._publish(('error', e))
                return
            finally:
                self._slots.release()
            merge_worker_stats(self.stats, self.tracer, worker, start,
                               time.perf_counter() - start)
            publish_start = time.perf_counter()
            published = self._publish(('ok', result))
            self.stats.add_time('worker_publish_wait_s',
                                time.perf_counter() - publish_start)
            if not published:
                return

    def get_results(self):
        """The next result; raises a worker's exception, or
        :class:`EmptyResultError` when every epoch is consumed or the pool
        was stopped."""
        stats = self.stats
        entered = time.perf_counter()
        while True:
            if self._workers_done == self._workers_count:
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
                self._workers_done += 1
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
        for _ in self._threads:
            self._items.put(_DONE)   # wake workers blocked on an empty queue
        threads = self._threads + ([self._ventilator]
                                   if self._ventilator else [])
        for t in threads:
            t.join(timeout)
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            raise TimeoutError('pool threads still running: %s' % alive)
        workers, self.workers = self.workers, []
        for worker in workers:
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
