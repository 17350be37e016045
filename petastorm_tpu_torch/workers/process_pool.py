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

Workers are interpreters started by :func:`exec_in_new_process`: they see
no GPU and import neither torch nor jax. Resize (autotune), recovery
(resilience), heartbeats (health), the lineage envelope and the stats
plane of the JAX pool come with their own slices.
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

import numpy as np

from petastorm_tpu_torch.readers.piece_worker import (make_worker,
                                                      shutdown_worker)
from petastorm_tpu_torch.workers.exec_in_new_process import \
    exec_in_new_process
from petastorm_tpu_torch.workers.serializers import (ZeroCopySerializer,
                                                     as_multipart)
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     ventilation_order)

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
                 results_queue_size: int = 50):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1')
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
        self._ventilation_done = True
        self._stop = threading.Event()
        self._stopped = False
        self._terminated = 0

    @property
    def workers_count(self) -> int:
        return self._workers_count

    def start(self, process, items: List, num_epochs: Optional[int] = 1,
              shuffle: bool = True, seed=None,
              max_in_flight: Optional[int] = None) -> None:
        """Start the workers, each running ``process(item)``, wait until all
        reported in, then ventilate ``items``, at most ``max_in_flight``
        (default twice the workers) not yet processed."""
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
        for _ in range(self._workers_count):
            self._processes.append(exec_in_new_process(
                _worker_bootstrap,
                args=(process, self._serializer, *addresses, os.getpid(),
                      self._hwm)))

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
        self._job = (list(items), shuffle, np.random.default_rng(seed))
        self._launch(num_epochs)

    def _launch(self, num_epochs):
        items, shuffle, rng = self._job
        self._ventilation_done = False
        self._ventilator = threading.Thread(
            target=self._ventilate,
            args=(ventilation_order(items, num_epochs, shuffle, rng),),
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
        while True:
            if self._stopped or self._all_consumed():
                raise EmptyResultError()
            if not dict(self._poller.poll(100)):
                self._check_workers_alive()
                continue
            payload, control = self._recv()
            if control == _ITEM_DONE:
                with self._lock:
                    self._processed += 1
                self._slots.release()
                continue
            if isinstance(control, _WorkerError):
                self.stop()
                raise _with_traceback(control)
            if control == _DATA:
                return self._serializer.deserialize_multipart(payload)
            # a late _STARTED or _TERMINATED: nothing to do

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
                      results_addr, parent_pid, hwm):
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
    worker = make_worker(process)
    hint = getattr(worker, 'prefetch_hint', None)
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
            item = pending.popleft()
            try:
                result = worker(item)
            except Exception as e:     # shipped to the consumer
                send_error(e)
            else:
                if result is not None:
                    send(serializer.serialize_multipart(result), _DATA)
            send([b''], _ITEM_DONE)
    finally:
        shutdown_worker(worker)
        send([b''], _TERMINATED)
        for sock in (work_receiver, control_receiver, results_sender):
            sock.close(linger=1000)
        context.term()
