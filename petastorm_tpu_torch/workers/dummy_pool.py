"""A pool that runs each item on the consumer's thread.

The port's copy of ``petastorm_tpu/workers/dummy_pool.py`` (:17-107), behind
the interface of :class:`~petastorm_tpu_torch.workers.thread_pool.ThreadPool`:
nothing runs until :meth:`DummyPool.get_results` asks, which processes the
next item in ventilation order and returns its result. A profiler or a
debugger then sees the worker code on the caller's thread, and the item
order is exactly the ventilation order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     ventilation_order)

_END = object()


class DummyPool:
    def __init__(self):
        self._job = None
        self._order = iter(())

    def start(self, process, items: List, num_epochs: Optional[int] = 1,
              shuffle: bool = True, seed=None) -> None:
        if self._job is not None:
            raise RuntimeError('pool already started')
        self._job = (process, list(items), shuffle,
                     np.random.default_rng(seed))
        self.reset(num_epochs)

    def get_results(self):
        """The result of the next item; raises its exception, or
        :class:`EmptyResultError` when every epoch is consumed or the pool
        was stopped."""
        item = next(self._order, _END)
        if item is _END:
            raise EmptyResultError()
        return self._job[0](item)

    def reset(self, num_epochs: Optional[int] = 1) -> None:
        """Ventilate the items for ``num_epochs`` more epochs, the shuffle
        continuing from the same generator."""
        _, items, shuffle, rng = self._job
        self._order = ventilation_order(items, num_epochs, shuffle, rng)

    def stop(self) -> None:
        self._order = iter(())

    def join(self, timeout: Optional[float] = None) -> None:
        pass
