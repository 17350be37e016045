"""A thread pool fed by a seeded epoch ventilator.

A small copy of ``petastorm_tpu/workers/thread_pool.py`` and
``workers/ventilator.py``: the ventilator puts work items (a
:class:`WorkItem` per row-group piece and row-drop partition, as the JAX
reader ventilates them, ``reader.py:646-663``) into the pool for ``num_epochs`` epochs (None = forever), reshuffling the
item order each epoch from one ``np.random.default_rng(seed)``, with at most
``max_in_flight`` items outstanding. Workers run ``process(item)`` and
publish results; a worker exception is re-raised in the consumer by
:meth:`ThreadPool.get_results`. ``stop()`` then ``join()`` ends every thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

_DONE = object()


class WorkItem(NamedTuple):
    """One ventilated unit of work: a row-group piece, the row predicate of
    that piece (the user's, combined with the residual of ``filters``
    specialised to the piece; None for none) and its row-drop partition
    ``(partition, num_partitions)``."""
    piece: object
    predicate: object = None
    drop_partition: Tuple[int, int] = (0, 1)


class EmptyResultError(Exception):
    """The ventilator has finished and every result has been consumed."""


class ThreadPool:
    def __init__(self, workers_count: int, results_queue_size: int = 50):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1')
        self._workers_count = workers_count
        self._results = queue.Queue(maxsize=results_queue_size)
        self._items: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._slots: Optional[threading.Semaphore] = None
        self._ventilator: Optional[threading.Thread] = None
        self._workers_done = 0

    def start(self, process: Callable, items: List, num_epochs: Optional[int]
              = 1, shuffle: bool = True, seed=None,
              max_in_flight: Optional[int] = None) -> None:
        """Start the workers and the ventilator over ``items``."""
        if self._threads:
            raise RuntimeError('pool already started')
        self._slots = threading.Semaphore(max_in_flight
                                          or 2 * self._workers_count)
        for i in range(self._workers_count):
            t = threading.Thread(target=self._work, args=(process,),
                                 name='petastorm-torch-worker-%d' % i,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._ventilator = threading.Thread(
            target=self._ventilate, args=(list(items), num_epochs, shuffle,
                                          seed),
            name='petastorm-torch-ventilator', daemon=True)
        self._ventilator.start()

    def _ventilate(self, items, num_epochs, shuffle, seed):
        rng = np.random.default_rng(seed)
        epoch = 0
        try:
            while num_epochs is None or epoch < num_epochs:
                order = np.arange(len(items))
                if shuffle:
                    rng.shuffle(order)
                for i in order:
                    while not self._slots.acquire(timeout=0.1):
                        if self._stop.is_set():
                            return
                    if self._stop.is_set():
                        return
                    self._items.put(items[int(i)])
                epoch += 1
                if not items:
                    break
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

    def _work(self, process):
        while not self._stop.is_set():
            item = self._items.get()
            if item is _DONE:
                self._publish(_DONE)
                return
            try:
                result = process(item)
            except Exception as e:     # re-raised in the consumer
                self._publish(('error', e))
                return
            finally:
                self._slots.release()
            if not self._publish(('ok', result)):
                return

    def get_results(self):
        """The next result; raises a worker's exception, or
        :class:`EmptyResultError` when every epoch is consumed or the pool
        was stopped."""
        while True:
            if self._workers_done == self._workers_count:
                raise EmptyResultError()
            try:
                value = self._results.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():     # stopped: nothing more comes
                    raise EmptyResultError()
                continue
            if value is _DONE:
                self._workers_done += 1
                continue
            kind, payload = value
            if kind == 'error':
                self.stop()
                raise payload
            return payload

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
