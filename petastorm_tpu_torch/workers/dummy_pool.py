"""A pool that runs each item on the consumer's thread.

The port's copy of ``petastorm_tpu/workers/dummy_pool.py`` (:17-107), behind
the interface of :class:`~petastorm_tpu_torch.workers.thread_pool.ThreadPool`:
nothing runs until :meth:`DummyPool.get_results` asks, which processes the
next item in ventilation order and returns its result. A profiler or a
debugger then sees the worker code on the caller's thread, and the item
order is exactly the ventilation order. Its one worker is made at start
(``process.make_worker()`` for a reader's
:class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorkerSpec`, else
``process``) and shut down at :meth:`DummyPool.join`. It hints no upcoming
items, so a reader turns ``io_readahead`` off on it. After each item the
worker's quarantine records and empty deliveries go to ``pool.lineage``
(JAX ``dummy_pool.py:27-29, 69-76``).
"""

from __future__ import annotations

from typing import List, Optional

from petastorm_tpu_torch.readers.piece_worker import (make_worker,
                                                      shutdown_worker)
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     VentilationJob,
                                                     drain_lineage)

_END = object()


class DummyPool:
    def __init__(self):
        self._job: Optional[VentilationJob] = None
        self._worker = None
        self._order = iter(())
        #: the reader's lineage tracker (set before :meth:`start`)
        self.lineage = None

    def start(self, process, items: List, num_epochs: Optional[int] = 1,
              shuffle: bool = True, seed=None, on_ventilate=None) -> None:
        if self._job is not None:
            raise RuntimeError('pool already started')
        self._job = VentilationJob(items, shuffle, seed, on_ventilate)
        self._worker = make_worker(process)
        self.reset(num_epochs)

    def get_results(self):
        """The result of the next item; raises its exception, or
        :class:`EmptyResultError` when every epoch is consumed or the pool
        was stopped."""
        item = next(self._order, _END)
        if item is _END:
            raise EmptyResultError()
        result = self._worker(item)
        drain_lineage(self._worker, self.lineage)
        return result

    def reset(self, num_epochs: Optional[int] = 1) -> None:
        """Ventilate the items for ``num_epochs`` more epochs, the shuffle
        continuing from the same generator and the epochs counting on."""
        self._order = self._job.order(num_epochs)

    def stop(self) -> None:
        self._order = iter(())

    def join(self, timeout: Optional[float] = None) -> None:
        worker, self._worker = self._worker, None
        if worker is not None:
            shutdown_worker(worker)
