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
current item first, before each item (JAX :965-1035). The spec carries
the store's :class:`~petastorm_tpu_torch.fs.FilesystemFactory`, with its
``storage_options``: each worker interpreter resolves its filesystem
afresh from it (fsspec imported there only for a remote scheme) and
wraps it in the chaos scenario the environment arms.

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

Heartbeats (JAX :49-51, :101-112, :183-193, :450-490, :536-568,
:618-622, :864-963, :1033, :1086-1104): a worker beats ``processing``
before each item, ``backpressured`` while a send waits on the results
socket's high-water mark (``processing`` once it goes), ``idle`` after the
item's ``ITEM_DONE`` and ``stopped`` at its end; its records ride each
``ITEM_DONE`` frame and a :class:`_WorkerHeartbeat` frame that a thread of
its own sends every :data:`HEARTBEAT_INTERVAL_S` (2 s), so a
wedged item still beats. That thread owns its own PUSH socket (ZMQ sockets
are not thread-safe), sends with ``NOBLOCK`` and closes it with
``linger=0``, so the worker's ``context.term()`` never hangs on it. The
consumer merges the records as it drains (:meth:`ProcessPool.heartbeats`),
ages clamped to its last drain, and forgets those of a dead worker.

Live actuators (the autotune controller's knobs, JAX :277-403 and the
worker side :985-1022): :meth:`ProcessPool.resize` grows the pool through
the same bootstrap, each newcomer under a fresh worker id and at the live
readahead depth, and shrinks it by drain-then-retire: the ventilation
pauses, both in-flight counts (the pool's and the
:class:`~petastorm_tpu_torch.workers.thread_pool.VentilationJob`'s) fall
to zero while the consumer drains, then one ``RETIRE`` marker a worker
to go goes out on the work socket; the worker that takes it acks with
:class:`_WorkerRetired` (collected on the consumer's thread) and exits 0,
and the resizing thread reaps it and resumes the ventilation. No item is
in flight toward a retiring interpreter, so each is delivered exactly
once; a quiesce that times out aborts the shrink with the count
unchanged. :meth:`ProcessPool.set_readahead_depth` broadcasts
``(SET_READAHEAD, depth)`` on the control socket.

Worker auto-recovery (JAX :121-140, :579-760), with ``recovery`` the
options of :func:`~petastorm_tpu_torch.resilience.resolve_recovery`: each
item goes out as ``(seq, item)`` and stays in an outstanding map until its
``ITEM_DONE`` (which carries the seq) comes back. A dead interpreter (a
non-zero exit: SIGKILL, or a worker that raised an injected
:class:`~petastorm_tpu_torch.faultfs.SimulatedWorkerCrash`, which exits
non-zero and sends no ``TERMINATED``) begins a recovery episode on the
consumer's thread: the ventilation pauses, the dead worker's heartbeats are
dropped and a replacement starts under a fresh worker id (a shrink waits
for its start frame, as for a grow's). The episode ends once every
replacement reported in, no item completed for the settle window
(``settle_s``, at least 1.25 heartbeat intervals with heartbeats on) and
every surviving worker beats an idle stage, judged only on a poll that
found the results socket empty: what is still outstanding then died with
the worker. An ``ITEM_DONE`` for a seq already accounted counts once. Each such item counts one crash; repeat offenders go
out last; one whose lineage ledger shows it delivered
(:meth:`~petastorm_tpu_torch.lineage.LineageTracker.delivery_deficit`: its
payload arrived, its ``ITEM_DONE`` died) is only accounted, one at
``poison_threshold`` crashes is quarantined, the rest go out again
(``items_redispatched``); then the ventilation resumes. Payload and
``ITEM_DONE`` frames are not taken as ordered: delivery is read from the
lineage ledger alone, so with lineage off an item goes out again even if
its payload arrived (at least once). Respawns are bounded by
``max_respawns`` (``max(3, workers_count)`` when None); beyond it, or with
recovery off, a death stops the pool with ``RuntimeError`` naming the exit
codes. The liveness check runs at least every
:data:`_LIVENESS_CHECK_S` while the consumer drains, and
:attr:`ProcessPool.recoveries` records each episode (the dead, their exit
codes, when it began and ended, and when the first item sent again came
back).

Workers are interpreters started by :func:`exec_in_new_process`: they see
no GPU and import neither torch nor jax.
"""

from __future__ import annotations

import logging
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
                                                      shutdown_worker,
                                                      with_readahead_depth)
from petastorm_tpu_torch.workers.exec_in_new_process import \
    exec_in_new_process
from petastorm_tpu_torch.workers.serializers import (ZeroCopySerializer,
                                                     as_multipart)
from petastorm_tpu_torch.workers.stats import (ReaderStats,
                                               finalize_item_times)
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     VentilationJob,
                                                     absorb_lineage)

logger = logging.getLogger(__name__)

_STARTUP_TIMEOUT_S = 60
_SHUTDOWN_TIMEOUT_S = 10
_LOCALHOST = 'tcp://127.0.0.1'

# control markers in the second frame of a result message
_DATA = 'DATA'
_STARTED = 'STARTED'
_ITEM_DONE = 'ITEM_DONE'        # after an item's result, if it had one
_TERMINATED = 'TERMINATED'
# the control channel's messages: the stop, and a live readahead depth
# as (SET_READAHEAD, depth)
_FINISHED = 'FINISHED'
_SET_READAHEAD = 'SET_READAHEAD'
#: The work-socket marker of a shrink: the worker that takes it processes
#: what it holds, acks with :class:`_WorkerRetired` and exits 0. Sent only
#: once the pool quiesced, so it never strands a ventilated item.
_RETIRE = 'RETIRE'
# what an outstanding map's pop gives for a seq it no longer holds
_GONE = object()

#: The period of a worker's liveness frame (JAX :49-51): low by design,
#: it exists for items that take minutes, not as a telemetry channel.
HEARTBEAT_INTERVAL_S = 2.0

#: Below this payload size the worker lets ZMQ copy at send time.
_ZMQ_NOCOPY_SEND_THRESHOLD = 64 * 1024

#: The longest the consumer goes between liveness checks (and recovery
#: steps) while results keep arriving.
_LIVENESS_CHECK_S = 0.25


class _WorkerError:
    def __init__(self, exc, formatted):
        self.exc = exc
        self.formatted = formatted


class _WorkerRetired:
    """The ack of a ``RETIRE`` marker: the worker finished what it held and
    exits 0 (a retirement, never a death)."""

    __slots__ = ('worker_id',)

    def __init__(self, worker_id):
        self.worker_id = worker_id


class _WorkerHeartbeat:
    """The liveness frame: a worker's current heartbeat records, sent every
    :data:`HEARTBEAT_INTERVAL_S` from a socket of its own, so an item that
    takes minutes (or never ends) still beats; the ``ITEM_DONE`` frame
    carries them only when an item completes."""

    __slots__ = ('worker_id', 'records')

    def __init__(self, worker_id, records):
        self.worker_id = worker_id
        self.records = records


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
                 results_queue_size: int = 50, tracer=None,
                 recovery: Optional[dict] = None):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1')
        self.stats = ReaderStats()
        # worker auto-recovery: the options (None: off); seq -> item of
        # every item sent and not yet accounted; the respawns used; each
        # item key's crash count; the live episode (None: none)
        self._recovery = recovery
        self._outstanding = {}
        self._next_seq = 0
        self._respawns_used = 0
        self._crash_counts = {}
        self._recovering = None
        #: one record a recovery episode, on ``time.monotonic()``: the dead
        #: worker ids and exit codes, when it began and finalized, the
        #: items sent again and when the first of them came back
        self.recoveries: List[dict] = []
        self._awaiting_redelivery = {}      # seq -> its episode's record
        self._hb_enabled = True
        self._last_alive_check = time.monotonic()
        # the work socket's sends: the ventilator's, a redispatch's (the
        # consumer's thread) and a shrink's markers (ZMQ sockets are not
        # thread-safe)
        self._send_lock = threading.Lock()
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
        self._lock = threading.Lock()
        # the spawn recipe (the process and the socket addresses), each
        # interpreter by worker id, the acked retirements not yet reaped,
        # the live readahead depth; resizes are serialized, and the control
        # socket's sends too (the stop's broadcast and the depth's)
        self._spawn_args = None
        self._procs_by_id = {}
        self._next_worker_id = workers_count
        self._retired_ids: List[int] = []
        self._started_ids = set()
        self._readahead_override: Optional[int] = None
        self._resize_lock = threading.Lock()
        self._control_lock = threading.Lock()
        self._ventilated = 0
        self._processed = 0
        self._produced = 0
        self._ventilation_done = True
        self._stop = threading.Event()
        self._stopped = False
        self._terminated = 0
        #: the reader's lineage tracker (set before :meth:`start`)
        self.lineage = None
        # the workers' heartbeat records, from ITEM_DONE and liveness
        # frames drained on the consumer's thread; _last_drain is the
        # newest time they are trusted up to: a consumer that stops
        # polling stops observing, and records must not age meanwhile
        self._hb_lock = threading.Lock()
        self._heartbeats = {}
        self._last_drain = time.perf_counter()

    @property
    def workers_count(self) -> int:
        return self._workers_count

    def start(self, process, items: List, num_epochs: Optional[int] = 1,
              shuffle: bool = True, seed=None,
              max_in_flight: Optional[int] = None,
              on_ventilate=None, heartbeat=None) -> None:
        """Start the workers, each running ``process(item)``, wait until all
        reported in, then ventilate ``items``, at most ``max_in_flight``
        (default twice the workers) not yet processed; ``on_ventilate(item)``
        sees each work item as it is ventilated, and the ventilator beats
        through ``heartbeat``."""
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
        self._spawn_args = (process, addresses)
        self._hb_enabled = getattr(process, 'health', True) is not False
        for worker_id in range(self._workers_count):
            self._spawn(worker_id)

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
            if isinstance(control, tuple) and control[0] == _STARTED:
                started += 1
                self._started_ids.add(control[1])

        self._job = VentilationJob(items, shuffle, seed, on_ventilate,
                                   heartbeat, max_in_flight
                                   or 2 * self._workers_count)
        self._launch(num_epochs)

    def _spawn(self, worker_id: int, replacement: bool = False) -> None:
        """Start one worker interpreter through the bootstrap; after a live
        :meth:`set_readahead_depth` it starts at that depth. A
        ``replacement`` of a dead worker has its ``worker-kill`` chaos
        kills spent (:func:`~petastorm_tpu_torch.faultfs.mark_replacement`)."""
        process, addresses = self._spawn_args
        if self._readahead_override is not None:
            process = with_readahead_depth(process, self._readahead_override)
        proc = exec_in_new_process(
            _worker_bootstrap,
            args=(process, self._serializer, *addresses, os.getpid(),
                  self._hwm, worker_id, replacement))
        with self._lock:
            # copy on write: _check_workers_alive iterates the list it took
            self._processes = self._processes + [proc]
            self._procs_by_id[worker_id] = proc

    @property
    def ventilation(self) -> Optional[VentilationJob]:
        """The :class:`VentilationJob` (its live in-flight window)."""
        return self._job

    # -- live actuators (the autotune controller's knobs) --------------------

    def resize(self, workers_count: int, timeout_s: float = 30.0) -> int:
        """Resize the pool live to ``workers_count`` interpreters; returns
        the live count (JAX :277-392).

        A grow starts interpreters through the bootstrap at once; ZMQ hands
        them items as soon as they connect. A shrink is drain-then-retire:
        the ventilation pauses, the in-flight items drain to zero (the
        consumer must keep calling :meth:`get_results` meanwhile, from
        another thread than this one), one ``RETIRE`` marker a worker to go
        goes out, the acks arrive through :meth:`get_results`, the exited
        interpreters are reaped and the ventilation resumes. A quiesce or
        ack that does not complete within ``timeout_s`` aborts safely: the
        ventilation resumes and the count stays (a late ack still lowers
        it when it lands)."""
        if not isinstance(workers_count, int) or workers_count < 1:
            raise ValueError('workers_count must be a positive int, got '
                             '{!r}'.format(workers_count))
        with self._resize_lock:
            if self._stopped or self._spawn_args is None:
                return self._workers_count
            current = self._workers_count
            if workers_count > current:
                for _ in range(workers_count - current):
                    with self._lock:
                        worker_id = self._next_worker_id
                        self._next_worker_id += 1
                    self._spawn(worker_id)
                with self._lock:
                    self._workers_count += workers_count - current
            elif workers_count < current:
                self._retire_workers(current - workers_count, timeout_s)
            return self._workers_count

    def _retire_workers(self, k: int, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        job = self._job
        job.pause()
        acked = False
        try:
            # both counts must settle: the job's rises before the send,
            # covering the window the pool's count misses, and proves no
            # send is under way on the work socket when the markers go out;
            # and every worker a grow started must have reported in, or
            # PUSH, which hands messages to connected workers only, could
            # give two markers to one worker and none to a newcomer
            while True:
                with self._lock:
                    in_flight = self._ventilated - self._processed
                    starting = set(self._procs_by_id) - self._started_ids
                if in_flight == 0 and job.in_flight == 0 and not starting:
                    break
                if self._stopped:
                    return
                if time.monotonic() >= deadline:
                    logger.warning('pool shrink aborted: %d items still in '
                                   'flight, %d workers starting after %.1fs',
                                   in_flight, len(starting), timeout_s)
                    return
                time.sleep(0.02)
            target = self._workers_count - k
            for _ in range(k):
                self._send_work(_RETIRE)
            # the acks arrive while the consumer drains; a stopping pool
            # counts them in stop()
            while time.monotonic() < deadline and not self._stopped:
                with self._lock:
                    if self._workers_count <= target:
                        acked = True
                        break
                time.sleep(0.02)
            self.reap_retired(max(0.0, deadline - time.monotonic()))
        finally:
            if not acked:
                # a marker may be unconsumed yet: let a retiring
                # interpreter's disconnect reach the PUSH side before items
                # flow again (its final drain covers the rest)
                time.sleep(0.25)
            job.resume()

    def _on_worker_retired(self, worker_id) -> None:
        """A ``_WorkerRetired`` ack, on the consumer's thread: the live
        count drops; the interpreter is reaped by :meth:`reap_retired`."""
        with self._lock:
            self._workers_count = max(0, self._workers_count - 1)
            self._retired_ids.append(worker_id)

    def reap_retired(self, timeout_s: float = 10.0) -> int:
        """Wait for (and drop) the interpreters of acked retirements;
        returns how many were reaped. An acked worker has already exited,
        so the waits settle at once."""
        with self._lock:
            acked, self._retired_ids = self._retired_ids, []
        deadline = time.monotonic() + timeout_s
        for worker_id in acked:
            with self._lock:
                proc = self._procs_by_id.pop(worker_id, None)
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            with self._lock:
                self._processes = [p for p in self._processes
                                   if p is not proc]
        return len(acked)

    def set_readahead_depth(self, depth: int) -> None:
        """Broadcast a live readahead depth to every worker interpreter on
        the control socket; interpreters a later grow starts get it in
        their spawn arguments."""
        self._readahead_override = int(depth)
        with self._control_lock:
            if self._control_sender is not None and not self._stopped:
                self._control_sender.send_pyobj((_SET_READAHEAD, int(depth)))

    @property
    def readahead_depth(self) -> Optional[int]:
        """The depth of the last :meth:`set_readahead_depth` (None before
        one). The results sockets' high-water mark is no live knob: the
        controller's queue bound is the thread pool's, as in JAX."""
        return self._readahead_override

    def _launch(self, num_epochs):
        self._ventilation_done = False
        self._ventilator = threading.Thread(
            target=self._ventilate, args=(self._job.order(num_epochs),),
            name='petastorm-torch-ventilator', daemon=True)
        self._ventilator.start()

    def _ventilate(self, order):
        """The ventilator thread: the only user of the work socket."""
        job = self._job
        job.beat('ventilate')
        try:
            for item in order:
                if not job.acquire_slot(self._stop):
                    return
                with self._lock:
                    self._ventilated += 1
                    seq = self._next_seq
                    self._next_seq += 1
                    self._outstanding[seq] = item
                if not self._send_work((seq, item)):
                    return
        finally:
            self._ventilation_done = True
            job.beat('done')

    def _send_work(self, message) -> bool:
        """Send ``message`` on the work socket; False once the pool stops.
        PUSH blocks while no worker is connected (every one dead, or gone
        at a stop), so the send polls the stop flag instead of blocking."""
        zmq = self._zmq
        while not self._stop.is_set():
            with self._send_lock:
                try:
                    self._work_sender.send_pyobj(message, flags=zmq.NOBLOCK)
                    return True
                except zmq.Again:
                    pass
            time.sleep(0.005)
        return False

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
            now = time.perf_counter()
            stats.add_time('queue_wait_s', now - wait_start)
            with self._hb_lock:
                self._last_drain = now
            if (not ready or time.monotonic() - self._last_alive_check
                    >= _LIVENESS_CHECK_S):
                self._last_alive_check = time.monotonic()
                self._check_workers_alive()
                if not ready:
                    # an episode ends only on an empty poll (as JAX's): a
                    # consumer back from a long step finds the survivors'
                    # payloads, ITEM_DONEs and beats still queued, and its
                    # view of them (a survivor blocked on the high-water
                    # mark beats 'backpressured', an idle stage) is stale
                    self._maybe_finalize_recovery()
            if not ready:
                continue
            payload, control = self._recv()
            if isinstance(control, _WorkerHeartbeat):
                self._merge_heartbeats(control.records)
                continue
            extra = None
            if isinstance(control, tuple):   # (marker, provenance or stats)
                control, extra = control
            if control == _ITEM_DONE:
                self._merge_item_stats(extra)
                with self._lock:
                    seq = (extra or {}).get('seq')
                    # a seq already accounted (a second ITEM_DONE) must not
                    # count again: the epoch would end one item early
                    already = self._outstanding.pop(seq, _GONE) is _GONE
                    if not already:
                        self._processed += 1
                    in_flight = self._ventilated - self._processed
                    episode = self._awaiting_redelivery.pop(seq, None)
                if episode is not None and episode['first_redelivery'] is None:
                    episode['first_redelivery'] = time.monotonic()
                self._note_recovery_progress()
                if not already:
                    self._job.processed_item()
                stats.gauge('queue_depth', in_flight)
                continue
            if isinstance(control, _WorkerRetired):
                self._on_worker_retired(control.worker_id)
                continue
            if isinstance(control, _WorkerError):
                self.stop()
                raise _with_traceback(control)
            if control == _DATA:
                self._note_recovery_progress()
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
            if control == _STARTED:
                # a grown or replacement worker reported in (its id rides
                # the frame)
                with self._lock:
                    self._started_ids.add(extra)
                if self._recovering is not None:
                    self._recovering['awaiting_start'].discard(extra)
            # a late _TERMINATED: nothing to do

    def _merge_heartbeats(self, records) -> None:
        """Keep each entity's newest record. Liveness and ``ITEM_DONE``
        frames come on two PUSH sockets that the PULL side fair-queues, so
        a liveness frame taken mid-item can arrive after that item's
        ``idle`` record; replacing wholesale (as JAX's pool does) would
        put the older, active stage back and age it into a false stall."""
        if not records:
            return
        with self._hb_lock:
            for entity, record in records.items():
                held = self._heartbeats.get(entity)
                if held is None or record.get('ts', 0.0) >= held.get('ts',
                                                                     0.0):
                    self._heartbeats[entity] = record

    def heartbeats(self) -> dict:
        """The latest heartbeat records the workers shipped, as of the last
        drained frame (the consumer's poll keeps draining while it waits,
        so they stay live while no item completes). Ages are clamped to
        the last drain: while the consumer does not poll (a long step, a
        kernel build) the records stop refreshing through no fault of the
        workers, so each reads at the age it had when last observed; a
        wedged worker ages on once the consumer polls again."""
        with self._hb_lock:
            records = dict(self._heartbeats)
            gap = max(0.0, time.perf_counter() - self._last_drain)
        if not gap:
            return records
        return {entity: dict(record, ts=record.get('ts', 0.0) + gap)
                for entity, record in records.items()}

    def _merge_item_stats(self, item_stats) -> None:
        """Merge what a worker shipped in an ``ITEM_DONE`` frame (JAX
        :561-579): its stats, spans, copies, heartbeats, quarantine records
        and empty deliveries."""
        if not item_stats:
            return
        self._merge_heartbeats(item_stats.get('heartbeats'))
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
        """A dead interpreter (non-zero exit) begins a recovery episode
        while recovery is on and its budget lasts; otherwise the pool stops
        and ``RuntimeError`` names the exit codes. A death during start-up
        is always loud."""
        dead_procs = [p for p in self._processes if p.poll() not in (None, 0)]
        dead = [p.returncode for p in dead_procs]
        if dead_procs:
            # a dead worker's last beat must not age into a false stall
            dead_pids = {p.pid for p in dead_procs}
            with self._hb_lock:
                self._heartbeats = {
                    entity: record
                    for entity, record in self._heartbeats.items()
                    if record.get('pid') not in dead_pids}
        if not dead or self._stopped:
            return
        recovery = self._recovery
        if recovery is not None and self._job is not None:
            budget = recovery.get('max_respawns')
            if budget is None:
                budget = max(3, self._workers_count)
            if self._respawns_used + len(dead) <= budget:
                self._begin_recovery(dead_procs, dead)
                return
            logger.error('worker respawn budget exhausted (%d used, %d '
                         'dead, budget %d): stopping the pool',
                         self._respawns_used, len(dead), budget)
        with self._lock:
            # the dead send no TERMINATED: the stop waits for the living
            self._processes = [p for p in self._processes
                               if p not in dead_procs]
        self.stop()
        self.join()
        raise RuntimeError('Worker process(es) died with exit codes {}'
                           .format(dead))

    # -- worker auto-recovery ------------------------------------------------

    def _begin_recovery(self, dead_procs, codes) -> None:
        """One recovery episode's start, on the consumer's thread: the dead
        interpreters leave the pool, the ventilation pauses, and a
        replacement starts for each under a fresh worker id. Results keep
        flowing meanwhile; :meth:`_maybe_finalize_recovery` ends it."""
        with self._lock:
            dead_ids = [wid for wid, proc in self._procs_by_id.items()
                        if proc in dead_procs]
            self._processes = [p for p in self._processes
                               if p not in dead_procs]
            for wid in dead_ids:
                self._procs_by_id.pop(wid, None)
        logger.warning('worker process(es) %s died with exit codes %s; '
                       'respawning and re-ventilating their in-flight items',
                       dead_ids, codes)
        if self._recovering is None:
            self._job.pause()
        replacements = set()
        for _ in dead_procs:
            with self._lock:
                worker_id = self._next_worker_id
                self._next_worker_id += 1
            self._spawn(worker_id, replacement=True)
            replacements.add(worker_id)
        self._respawns_used += len(dead_procs)
        self.stats.add('worker_respawns', len(dead_procs))
        now = time.monotonic()
        if self._recovering is not None:
            # a replacement died while the episode settled: fold it in
            self._recovering['awaiting_start'] |= replacements
            self._recovering['last_progress'] = now
            self.recoveries[-1]['dead'] += dead_ids
            self.recoveries[-1]['codes'] += list(codes)
        else:
            self._recovering = {'awaiting_start': replacements,
                                'last_progress': now}
            self.recoveries.append({'dead': dead_ids, 'codes': list(codes),
                                    'began': now, 'finalized': None,
                                    'redispatched': 0,
                                    'first_redelivery': None})

    def _note_recovery_progress(self) -> None:
        if self._recovering is not None:
            self._recovering['last_progress'] = time.monotonic()

    def _maybe_finalize_recovery(self) -> None:
        """End the episode once every replacement reported in, no item
        completed for the settle window and every surviving worker beats an
        idle stage: the items still outstanding died with the dead
        workers. A survivor that starts an item beats a busy stage, seen at
        most one heartbeat interval late, so with the window at least 1.25
        intervals an item a survivor holds always blocks the end."""
        recovering = self._recovering
        if recovering is None or self._stopped:
            return
        if recovering['awaiting_start']:
            return
        settle_s = (self._recovery or {}).get('settle_s', 1.0)
        if self._hb_enabled:
            settle_s = max(settle_s, 1.25 * HEARTBEAT_INTERVAL_S)
        if time.monotonic() - recovering['last_progress'] < settle_s:
            return
        if self._hb_enabled:
            from petastorm_tpu_torch.health import IDLE_STAGES
            with self._hb_lock:
                records = dict(self._heartbeats)
            for entity, record in records.items():
                if (entity.startswith('worker-')
                        and record.get('stage') not in IDLE_STAGES):
                    return          # a survivor is mid-item: wait on
        self._recovering = None
        self._finalize_recovery()

    @staticmethod
    def _item_key(seq, item):
        """An item's identity across epochs (the poison count's key):
        ``(piece_index, drop_partition)`` of a work item, its seq
        otherwise (a count then spans one dispatch)."""
        piece_index = getattr(item, 'piece_index', -1)
        if piece_index is None or piece_index < 0:
            return ('seq', seq)
        return (piece_index, tuple(item.drop_partition or (0, 1)))

    def _synthesize_processed(self, seq) -> None:
        """Account an outstanding item without sending it again (it was
        delivered, or is quarantined): the ``ITEM_DONE`` the dead worker
        never sent."""
        with self._lock:
            self._processed += 1
            self._outstanding.pop(seq, None)
        self._job.processed_item()

    def _finalize_recovery(self) -> None:
        from petastorm_tpu_torch.lineage import crash_quarantine_record
        with self._lock:
            lost = sorted(self._outstanding.items(), key=lambda kv: kv[0])
        poison_threshold = (self._recovery or {}).get('poison_threshold', 3)
        tracker = (self.lineage if self.lineage is not None
                   and self.lineage.enabled else None)
        plan = []
        for seq, item in lost:
            key = self._item_key(seq, item)
            count = self._crash_counts.get(key, 0) + 1
            self._crash_counts[key] = count
            plan.append((count, seq, item, key))
        redispatched = 0
        episode = self.recoveries[-1]
        episode['finalized'] = time.monotonic()
        # repeat offenders go last: the innocents lost with a poison item
        # complete before it can kill again
        for count, seq, item, key in sorted(plan, key=lambda e: (e[0],
                                                                  e[1])):
            piece_index = getattr(item, 'piece_index', None)
            epoch = getattr(item, 'epoch', 0)
            partition = getattr(item, 'drop_partition', (0, 1))
            deficit = (tracker.delivery_deficit(epoch, piece_index,
                                                partition)
                       if tracker is not None and piece_index is not None
                       and piece_index >= 0 else None)
            if deficit is not None and deficit <= 0:
                # its payload arrived before its ITEM_DONE died: sending it
                # again would be the duplicate the audit catches
                self._synthesize_processed(seq)
                continue
            if count >= poison_threshold:
                logger.error('poison item %s killed %d worker(s); '
                             'quarantining it instead of crash-looping', key,
                             count)
                if tracker is not None and piece_index is not None \
                        and piece_index >= 0:
                    tracker.add_quarantines([crash_quarantine_record(
                        tracker, piece_index, epoch, partition, count)])
                self.stats.add('poison_items_quarantined')
                self._synthesize_processed(seq)
                continue
            with self._lock:
                self._awaiting_redelivery[seq] = episode
            if not self._send_work((seq, item)):
                return
            redispatched += 1
        episode['redispatched'] = redispatched
        if redispatched:
            self.stats.add('items_redispatched', redispatched)
            logger.warning('re-ventilated %d in-flight item(s) lost with '
                           'crashed worker(s)', redispatched)
        self._job.resume()

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
        # acked retirees have exited: count them out of the wait below
        self.reap_retired(timeout_s=2.0)
        deadline = time.monotonic() + _SHUTDOWN_TIMEOUT_S
        while (self._terminated < len(self._processes)
               and time.monotonic() < deadline):
            with self._control_lock:
                self._control_sender.send_pyobj(_FINISHED)
            if dict(self._poller.poll(50)):
                _, control = self._recv()
                if control == _TERMINATED:
                    self._terminated += 1
                elif isinstance(control, _WorkerRetired):
                    # a late shrink ack: that worker exits too
                    self._on_worker_retired(control.worker_id)
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
                      results_addr, parent_pid, hwm, worker_id=0,
                      replacement=False):
    """Entry point of a worker interpreter: serve items until FINISHED."""
    import zmq

    if replacement:
        from petastorm_tpu_torch import faultfs
        faultfs.mark_replacement()

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
    health_on = getattr(process, 'health', True) is not False
    beat = getattr(worker, 'beat', None) if health_on else None
    hb_snapshot = (getattr(worker, 'heartbeat_snapshot', None)
                   if health_on else None)
    item_done = getattr(worker, 'item_done', None)
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
        try:
            results_sender.send_multipart(message, copy=not nocopy,
                                          flags=zmq.NOBLOCK)
        except zmq.Again:   # the high-water mark: the consumer is slower
            if beat is not None:
                beat('backpressured')
            results_sender.send_multipart(message, copy=not nocopy)
            if beat is not None:
                beat('processing')

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

    send([b''], (_STARTED, worker_id))

    hb_stop = threading.Event()
    hb_thread = None
    if hb_snapshot is not None:
        def hb_loop():
            sock = context.socket(zmq.PUSH)
            sock.connect(results_addr)
            try:
                while not hb_stop.wait(HEARTBEAT_INTERVAL_S):
                    try:
                        # a blocking send with the consumer gone would not
                        # see hb_stop and would hang context.term(); a
                        # dropped frame costs nothing, the next is fresher
                        sock.send_multipart(
                            [b'', pickle.dumps(_WorkerHeartbeat(
                                worker_id, hb_snapshot()))],
                            flags=zmq.NOBLOCK)
                    except zmq.Again:
                        continue
            except zmq.ZMQError:
                pass            # the pool is tearing down
            finally:
                sock.close(linger=0)

        hb_thread = threading.Thread(target=hb_loop, daemon=True,
                                     name='petastorm-torch-worker-heartbeat')
        hb_thread.start()
    poller = zmq.Poller()
    poller.register(work_receiver, zmq.POLLIN)
    poller.register(control_receiver, zmq.POLLIN)
    pending = deque()
    retiring = False
    crashed = False

    def is_retire(entry):
        return isinstance(entry, str) and entry == _RETIRE

    try:
        while True:
            # wait only when there is nothing to process
            socks = dict(poller.poll(None if not pending else 0))
            if control_receiver in socks:
                message = control_receiver.recv_pyobj()
                if message == _FINISHED:
                    break       # pending items are dropped: the pool stops
                if (isinstance(message, tuple) and len(message) == 2
                        and message[0] == _SET_READAHEAD):
                    # a live depth, applied between items on this thread
                    setter = getattr(worker, 'set_readahead_depth', None)
                    if setter is not None:
                        setter(message[1])
            if work_receiver in socks and not retiring:
                while len(pending) - 1 < getattr(worker, 'prefetch_lookahead',
                                                 0):
                    try:
                        entry = work_receiver.recv_pyobj(zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    if is_retire(entry):
                        # take nothing new: finish what is held, then go
                        retiring = True
                        break
                    pending.append(entry)
            if retiring and not pending:
                # an item that slipped in behind the marker (a shrink that
                # timed out and resumed early) is processed, not stranded
                while True:
                    try:
                        entry = work_receiver.recv_pyobj(zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    if not is_retire(entry):
                        pending.append(entry)
                if pending:
                    continue
                send([b''], _WorkerRetired(worker_id))
                break
            if not pending:
                continue
            if hint is not None:
                hint([entry[1] for entry in pending])
            seq, work = pending.popleft()
            if beat is not None:
                beat('processing')
            item['serialize_s'] = item['publish_wait_s'] = 0.0
            copies_before = getattr(serializer, 'copies', 0)
            start = time.perf_counter()
            try:
                result = worker(work)
            except Exception as e:     # shipped to the consumer
                send_error(e)
            except BaseException as e:
                # a death (an injected SimulatedWorkerCrash): the
                # interpreter exits non-zero, without a TERMINATED frame,
                # and the parent's liveness check sees it
                crashed = True
                if isinstance(e, SystemExit) and not e.code:
                    raise SystemExit('worker {} died of {}'.format(
                        worker_id, type(e).__name__)) from e
                raise
            else:
                if isinstance(result, LineageEnvelope):
                    # the record rides the control frame: the serializer
                    # (and its out-of-band frames) sees the payload alone
                    publish(result.payload, (_DATA, result.provenance))
                elif result is not None:
                    publish(result, _DATA)
            elapsed = time.perf_counter() - start
            if item_done is not None:
                item_done()
            done = item_stats(start, elapsed, copies_before)
            done['seq'] = seq
            if hb_snapshot is not None:
                done['heartbeats'] = hb_snapshot()
            send([b''], (_ITEM_DONE, done))
            if beat is not None:
                # a blocked send resumed at 'processing'; between items
                # the stage is idle
                beat('idle')
    finally:
        if beat is not None:
            beat('stopped')
        hb_stop.set()
        if hb_thread is not None:
            hb_thread.join(timeout=5)
        shutdown_worker(worker)
        if not retiring and not crashed:
            # a retiree acked already: a second frame would let stop()
            # count it twice; a dead worker is out of the pool already
            send([b''], _TERMINATED)
        for sock in (work_receiver, control_receiver, results_sender):
            sock.close(linger=1000)
        context.term()
