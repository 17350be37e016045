"""A worker pool of separate interpreters over ZeroMQ.

The port's copy of ``petastorm_tpu/workers/process_pool.py``
(``ProcessPool`` :113-260, :405-535, :757-812 and ``_worker_bootstrap``
:825-1116), behind the interface of the port's
:class:`~petastorm_tpu_torch.workers.thread_pool.ThreadPool`: ``start(process,
items, ...)``, ``get_results()``, ``reset()``, ``stop()``, ``join()``.

- Three sockets: the parent PUSHes work items, PUBlishes control
  messages, and PULLs results; each worker PULLs, SUBscribes and PUSHes.
- Start-up barrier: every worker reports in before the first item goes
  out, within 60 s.
- Stop: the FINISHED broadcast repeats until every worker answered (a
  subscriber that joined late misses the first ones), draining results
  meanwhile.
- Orphans: a worker exits when its parent is gone.
- A worker's exception is pickled with its formatted traceback and raised
  in the consumer by :meth:`ProcessPool.get_results`, the traceback added
  as a note.
- ``results_queue_size`` is the high-water mark of the results sockets:
  a worker blocks on a full one, as a thread blocks on a full queue.
- Results travel as ``[meta, control, buf0..bufN]``: the serializer's
  frames around a pickled control marker. Arrays are rebuilt over the
  received frames without a copy: read-only over ``bytes`` under
  ``zmq_copy_buffers=True``; writable over memoryviews of the ZMQ frames,
  which keep their messages alive, under ``False``.

Each worker interpreter makes its worker once (``process.make_worker()``
for a reader's :class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorkerSpec`,
else ``process`` itself) and shuts it down at the end. PUSH hands items out
round robin when it sends them, so what a worker's socket holds is already
its own: a worker with a ``prefetch_lookahead`` drains up to that many more
items into its own FIFO without waiting and is hinted the whole FIFO, the
current item first, before each item (JAX :965-1035).

Lineage (JAX :152-157, 501-532, 569-573, 890-905, 1076-1079): a worker
sends an envelope's provenance in the control frame, ``(DATA,
provenance)``, and the payload alone through the serializer, so the
payload frames stay out-of-band; the consumer wraps them again in a
:class:`~petastorm_tpu_torch.lineage.LineageEnvelope`. The item's
quarantine records and empty deliveries ride its ``ITEM_DONE`` message
into ``pool.lineage``.

The stats plane (JAX :440-535, 561-579, 856-905, 1040-1096): a worker
times each item (``process_item``), the serializing of its payload
(``serialize_s`` and a ``serialize`` span) and the send
(``worker_publish_wait_s``), and ships what its worker accumulated (stage
times with the derived decode time, counts, gauges, latency deltas,
spans, the serializer's ``copies`` as ``payload_copies``) in the item's
``ITEM_DONE`` frame; :meth:`ProcessPool._merge_item_stats` merges it into
``pool.stats`` and ``pool.tracer``. The consumer records its wait
(``queue_wait_s``, the ``queue_wait`` latency and span), the deserialize
(``deserialize_s``, latency and span, and its own ``copies``), the
frames' bytes (``bytes_moved``) and count (``payload_frames``),
``items_out`` and the ``queue_depth`` gauge (items in flight). Spans keep
the worker's pid and thread id: ``time.perf_counter()`` is
CLOCK_MONOTONIC, one timeline for every process.

Workers are interpreters started by :func:`exec_in_new_process`: they see
no GPU and import neither torch nor jax. Resize (autotune), recovery
(resilience) and heartbeats (health) come with their own slices.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import threading
import time
import traceback
from collections import deque
from typing import List, Optional

from petastorm_tpu_torch.lineage import LineageEnvelope
from petastorm_tpu_torch.readers.piece_worker import (make_worker,
                                                      shutdown_worker)
from petastorm_tpu_torch.workers.exec_in_new_process import \
    exec_in_new_process
from petastorm_tpu_torch.workers.serializers import (ZeroCopySerializer,
                                                     as_multipart)
from petastorm_tpu_torch.workers.stats import (ReaderStats,
                                               finalize_item_times)
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     VentilationJob,
                                                     absorb_lineage)

_STARTUP_TIMEOUT_S = 60
_SHUTDOWN_TIMEOUT_S = 10
_LOCALHOST = 'tcp://127.0.0.1'

# control markers in the second frame of a result message
_DATA = 'DATA'
_STARTED = 'STARTED'
_ITEM_DONE = 'ITEM_DONE'        # after an item's result, if it had one
_TERMINATED = 'TERMINATED'
# the control channel's one message
_FINISHED = 'FINISHED'

#: Below this payload size the worker lets ZMQ copy at send time.
_ZMQ_NOCOPY_SEND_THRESHOLD = 64 * 1024


class _WorkerError:
    def __init__(self, exc, formatted):
        self.exc = exc
        self.formatted = formatted


def _import_zmq():
    try:
        import dill  # noqa: F401  (the workers' bootstrap needs it)
        import zmq
    except ImportError as e:
        raise ImportError(
            "reader_pool_type='process' needs pyzmq and dill (the optional "
            "extra 'zmq': pip install pyzmq dill): {}".format(e)) from e
    return zmq


class ProcessPool:
    """Ventilates work items into ``workers_count`` worker interpreters and
    hands their results to one consumer thread."""

    #: workers are hinted their upcoming items: a reader may turn on
    #: ``io_readahead``
    supports_prefetch_hints = True

    def __init__(self, workers_count: int, serializer=None,
                 zmq_copy_buffers: bool = True,
                 results_queue_size: int = 50, tracer=None):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1')
        self.stats = ReaderStats()
        #: the reader's tracer (None: no tracing)
        self.tracer = tracer
        self._zmq = _import_zmq()
        self._workers_count = workers_count
        self._serializer = as_multipart(serializer or ZeroCopySerializer())
        self._zmq_copy_buffers = zmq_copy_buffers
        self._hwm = results_queue_size
        self._processes: List[subprocess.Popen] = []
        self._context = None
        self._work_sender = None
        self._control_sender = None
        self._results_receiver = None
        self._poller = None
        self._job = None
        self._ventilator: Optional[threading.Thread] = None
        self._slots: Optional[threading.Semaphore] = None
        self._lock = threading.Lock()
        self._ventilated = 0
        self._processed = 0
        self._produced = 0
        self._ventilation_done = True
        self._stop = threading.Event()
        self._stopped = False
        self._terminated = 0
        #: the reader's lineage tracker (set before :meth:`start`)
        self.lineage = None

    @property
    def workers_count(self) -> int:
        return self._workers_count

    def start(self, process, items: List, num_epochs: Optional[int] = 1,
              shuffle: bool = True, seed=None,
              max_in_flight: Optional[int] = None,
              on_ventilate=None) -> None:
        """Start the workers, each running ``process(item)``, wait until all
        reported in, then ventilate ``items``, at most ``max_in_flight``
        (default twice the workers) not yet processed; ``on_ventilate(item)``
        sees each work item as it is ventilated."""
        if self._processes:
            raise RuntimeError('pool already started')
        zmq = self._zmq
        self._context = zmq.Context()
        self._work_sender = self._context.socket(zmq.PUSH)
        work_port = self._work_sender.bind_to_random_port(_LOCALHOST)
        self._control_sender = self._context.socket(zmq.PUB)
        control_port = self._control_sender.bind_to_random_port(_LOCALHOST)
        self._results_receiver = self._context.socket(zmq.PULL)
        self._results_receiver.setsockopt(zmq.RCVHWM, self._hwm)
        results_port = self._results_receiver.bind_to_random_port(_LOCALHOST)
        self._poller = zmq.Poller()
        self._poller.register(self._results_receiver, zmq.POLLIN)
        addresses = ['{}:{}'.format(_LOCALHOST, port)
                     for port in (work_port, control_port, results_port)]
        for worker_id in range(self._workers_count):
            self._processes.append(exec_in_new_process(
                _worker_bootstrap,
                args=(process, self._serializer, *addresses, os.getpid(),
                      self._hwm, worker_id)))

        started = 0
        deadline = time.monotonic() + _STARTUP_TIMEOUT_S
        while started < self._workers_count:
            if not dict(self._poller.poll(100)):
                if time.monotonic() < deadline:
                    self._check_workers_alive()
                    continue
                self.stop()
                self.join()
                raise TimeoutError('Only {}/{} workers started within {}s'
                                   .format(started, self._workers_count,
                                           _STARTUP_TIMEOUT_S))
            _, control = self._recv()
            if control == _STARTED:
                started += 1

        self._slots = threading.Semaphore(max_in_flight
                                          or 2 * self._workers_count)
        self._job = VentilationJob(items, shuffle, seed, on_ventilate)
        self._launch(num_epochs)

    def _launch(self, num_epochs):
        self._ventilation_done = False
        self._ventilator = threading.Thread(
            target=self._ventilate, args=(self._job.order(num_epochs),),
            name='petastorm-torch-ventilator', daemon=True)
        self._ventilator.start()

    def _ventilate(self, order):
        """The ventilator thread: the only user of the work socket."""
        try:
            for item in order:
                while not self._slots.acquire(timeout=0.1):
                    if self._stop.is_set():
                        return
                if self._stop.is_set():
                    return
                with self._lock:
                    self._ventilated += 1
                self._work_sender.send_pyobj(item)
        finally:
            self._ventilation_done = True

    def _recv(self):
        """One ``[meta, control, buf0..bufN]`` message as ``(payload frames,
        control)``; under ``zmq_copy_buffers=False`` the payload frames are
        memoryviews over the ZMQ frames, converted here once."""
        frames = self._results_receiver.recv_multipart(
            copy=self._zmq_copy_buffers)
        if not self._zmq_copy_buffers:
            control = frames[1].bytes
            payload = [frames[0].buffer] + [f.buffer for f in frames[2:]]
        else:
            control = frames[1]
            payload = [frames[0]] + frames[2:]
        return payload, pickle.loads(control)

    def _all_consumed(self) -> bool:
        # read the flag first: once it is set, the count of items
        # ventilated is final
        done = self._ventilation_done
        with self._lock:
            return done and self._ventilated == self._processed

    def get_results(self):
        """The next result; raises a worker's exception, or
        :class:`EmptyResultError` when every epoch is consumed or the pool
        was stopped."""
        stats = self.stats
        entered = time.perf_counter()
        while True:
            if self._stopped or self._all_consumed():
                raise EmptyResultError()
            wait_start = time.perf_counter()
            ready = dict(self._poller.poll(100))
            stats.add_time('queue_wait_s', time.perf_counter() - wait_start)
            if not ready:
                self._check_workers_alive()
                continue
            payload, control = self._recv()
            extra = None
            if isinstance(control, tuple):   # (marker, provenance or stats)
                control, extra = control
            if control == _ITEM_DONE:
                self._merge_item_stats(extra)
                with self._lock:
                    self._processed += 1
                    in_flight = self._ventilated - self._processed
                self._slots.release()
                stats.gauge('queue_depth', in_flight)
                continue
            if isinstance(control, _WorkerError):
                self.stop()
                raise _with_traceback(control)
            if control == _DATA:
                with self._lock:
                    self._produced += 1
                copies_before = getattr(self._serializer, 'copies', 0)
                deser_start = time.perf_counter()
                result = self._serializer.deserialize_multipart(payload)
                now = time.perf_counter()
                stats.add_time('deserialize_s', now - deser_start)
                stats.record_latency('queue_wait', deser_start - entered)
                stats.record_latency('deserialize', now - deser_start)
                if self.tracer is not None:
                    self.tracer.add_span('queue_wait', 'consumer', entered,
                                         deser_start - entered)
                    self.tracer.add_span('deserialize', 'transport',
                                         deser_start, now - deser_start)
                # the consumer's copies count too: the worker's arrive in
                # the ITEM_DONE frame
                copies = (getattr(self._serializer, 'copies', 0)
                          - copies_before)
                if copies:
                    stats.add('payload_copies', copies)
                stats.add('bytes_moved', sum(_nbytes(f) for f in payload))
                stats.add('payload_frames', len(payload))
                stats.add('items_out')
                if extra is not None:
                    result = LineageEnvelope(result, extra)
                return result
            # a late _STARTED or _TERMINATED: nothing to do

    def _merge_item_stats(self, item_stats) -> None:
        """Merge what a worker shipped in an ``ITEM_DONE`` frame (JAX
        :561-579): its stats, spans, copies, quarantine records and empty
        deliveries."""
        if not item_stats:
            return
        stats = self.stats
        stats.merge_times(item_stats.get('times'))
        stats.merge_counts(item_stats.get('counts'))
        stats.merge_gauges(item_stats.get('gauges'))
        stats.merge_latency(item_stats.get('latency'))
        if item_stats.get('payload_copies'):
            stats.add('payload_copies', item_stats['payload_copies'])
        if self.tracer is not None:
            self.tracer.merge(item_stats.get('spans'))
        absorb_lineage(self.lineage, item_stats.get('quarantines', ()),
                       item_stats.get('empty_publishes', ()))

    @property
    def diagnostics(self) -> dict:
        """The pool's accounting (JAX :802-812) and a snapshot of
        :attr:`stats`."""
        with self._lock:
            out = {'items_consumed': self._processed,
                   'items_produced': self._produced,
                   'items_inprocess': self._ventilated - self._processed,
                   'zmq_copy_buffers': self._zmq_copy_buffers}
        out.update(self.stats.snapshot())
        return out

    def _check_workers_alive(self):
        dead = [p.returncode for p in self._processes
                if p.poll() not in (None, 0)]
        if dead and not self._stopped:
            self.stop()
            self.join()
            raise RuntimeError('Worker process(es) died with exit codes {}'
                               .format(dead))

    def reset(self, num_epochs: Optional[int] = 1) -> None:
        """Ventilate the items for ``num_epochs`` more epochs, the shuffle
        continuing from the same generator; legal only once every result
        of the previous ones was consumed."""
        if self._stopped or not self._all_consumed():
            raise RuntimeError('Cannot reset a pool that has not completed')
        self._ventilator.join()
        self._launch(num_epochs)

    def stop(self) -> None:
        """Stop ventilating and end the workers: the FINISHED broadcast
        repeats, draining results, until every worker answered or 10 s
        passed."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        if self._control_sender is None:
            return
        deadline = time.monotonic() + _SHUTDOWN_TIMEOUT_S
        while (self._terminated < len(self._processes)
               and time.monotonic() < deadline):
            self._control_sender.send_pyobj(_FINISHED)
            if dict(self._poller.poll(50)):
                _, control = self._recv()
                if control == _TERMINATED:
                    self._terminated += 1

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for every worker (after :meth:`stop`), killing one that
        outlives ``timeout`` (10 s by default), then close the sockets."""
        timeout = _SHUTDOWN_TIMEOUT_S if timeout is None else timeout
        for proc in self._processes:
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if self._ventilator is not None:
            self._ventilator.join(timeout)
        for sock in (self._work_sender, self._control_sender,
                     self._results_receiver):
            if sock is not None:
                sock.close(linger=0)
        if self._context is not None:
            self._context.term()
            self._context = None


def _with_traceback(error: _WorkerError) -> BaseException:
    exc = error.exc
    exc.add_note('Traceback in the worker process:\n' + error.formatted)
    return exc


def _nbytes(frame) -> int:
    nbytes = getattr(frame, 'nbytes', None)
    if nbytes is not None:
        return nbytes
    size = getattr(frame, 'size', None)       # pa.Buffer
    if isinstance(size, int):
        return size
    return len(frame)


def _worker_bootstrap(process, serializer, work_addr, control_addr,
                      results_addr, parent_pid, hwm, worker_id=0):
    """Entry point of a worker interpreter: serve items until FINISHED."""
    import zmq

    def monitor_parent():
        while True:
            try:
                os.kill(parent_pid, 0)
            except OSError:
                os._exit(0)
            time.sleep(1)

    threading.Thread(target=monitor_parent, daemon=True,
                     name='petastorm-torch-parent-monitor').start()

    serializer = as_multipart(serializer)
    worker = make_worker(process, worker_id)
    hint = getattr(worker, 'prefetch_hint', None)
    drain = getattr(worker, 'drain_lineage', None)
    drain_times = getattr(worker, 'drain_stage_times', None)
    tracing = getattr(worker, 'tracing_enabled', False)
    pid = os.getpid()
    # one item's transport seconds, and the bootstrap's own spans
    item = {'serialize_s': 0.0, 'publish_wait_s': 0.0}
    item_spans = []
    context = zmq.Context()
    work_receiver = context.socket(zmq.PULL)
    work_receiver.connect(work_addr)
    control_receiver = context.socket(zmq.SUB)
    control_receiver.setsockopt(zmq.SUBSCRIBE, b'')
    control_receiver.connect(control_addr)
    results_sender = context.socket(zmq.PUSH)
    results_sender.setsockopt(zmq.SNDHWM, hwm)
    results_sender.connect(results_addr)

    def send(payload_frames, control):
        message = [payload_frames[0], pickle.dumps(control)] + list(
            payload_frames[1:])
        # large payloads go zero-copy: the worker drops them after sending
        nocopy = (sum(_nbytes(f) for f in payload_frames)
                  >= _ZMQ_NOCOPY_SEND_THRESHOLD)
        results_sender.send_multipart(message, copy=not nocopy)

    def send_error(e):
        formatted = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:      # an exception that cannot cross: its text does
            e = RuntimeError('{}: {}'.format(type(e).__name__, e))
        send([b''], _WorkerError(e, formatted))

    def publish(payload, control):
        start = time.perf_counter()
        frames = serializer.serialize_multipart(payload)
        serialized = time.perf_counter()
        item['serialize_s'] += serialized - start
        if tracing:
            item_spans.append(('serialize', 'transport', start,
                               serialized - start, pid,
                               threading.get_ident(), None))
        send(frames, control)
        item['publish_wait_s'] += time.perf_counter() - serialized

    def item_stats(start, elapsed, copies_before):
        """What the pool merges of this item (JAX :1050-1090)."""
        times = drain_times() if drain_times is not None else {}
        transport = item['serialize_s'] + item['publish_wait_s']
        times['serialize_s'] = (times.get('serialize_s', 0.0)
                                + item['serialize_s'])
        times['worker_publish_wait_s'] = (
            times.get('worker_publish_wait_s', 0.0) + item['publish_wait_s'])
        out = {'times': finalize_item_times(times, elapsed, transport),
               'payload_copies': (getattr(serializer, 'copies', 0)
                                  - copies_before)}
        if drain_times is not None:
            counts, gauges = worker.drain_stat_counts()
            out.update(counts=counts, gauges=gauges,
                       latency=worker.drain_latency())
        if tracing:
            item_spans.append(('process_item', 'worker', start, elapsed,
                               pid, threading.get_ident(), None))
            out['spans'] = item_spans + worker.drain_spans()
            item_spans.clear()
        quarantines, empty = drain() if drain is not None else ((), ())
        if quarantines:
            out['quarantines'] = quarantines
        if empty:
            out['empty_publishes'] = empty
        return out

    send([b''], _STARTED)
    poller = zmq.Poller()
    poller.register(work_receiver, zmq.POLLIN)
    poller.register(control_receiver, zmq.POLLIN)
    pending = deque()
    try:
        while True:
            # wait only when there is nothing to process
            socks = dict(poller.poll(None if not pending else 0))
            if control_receiver in socks:
                if control_receiver.recv_pyobj() == _FINISHED:
                    break       # pending items are dropped: the pool stops
            if work_receiver in socks:
                while len(pending) - 1 < getattr(worker, 'prefetch_lookahead',
                                                 0):
                    try:
                        pending.append(work_receiver.recv_pyobj(zmq.NOBLOCK))
                    except zmq.Again:
                        break
            if not pending:
                continue
            if hint is not None:
                hint(list(pending))
            work = pending.popleft()
            item['serialize_s'] = item['publish_wait_s'] = 0.0
            copies_before = getattr(serializer, 'copies', 0)
            start = time.perf_counter()
            try:
                result = worker(work)
            except Exception as e:     # shipped to the consumer
                send_error(e)
            else:
                if isinstance(result, LineageEnvelope):
                    # the record rides the control frame: the serializer
                    # (and its out-of-band frames) sees the payload alone
                    publish(result.payload, (_DATA, result.provenance))
                elif result is not None:
                    publish(result, _DATA)
            send([b''], (_ITEM_DONE, item_stats(
                start, time.perf_counter() - start, copies_before)))
    finally:
        shutdown_worker(worker)
        send([b''], _TERMINATED)
        for sock in (work_receiver, control_receiver, results_sender):
            sock.close(linger=1000)
        context.term()
