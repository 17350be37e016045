"""Shuffling buffers: row-granular ones (add items, take one at a time) and
column-major batching ones (feed dicts of column arrays, take batches of
exactly ``batch_size`` rows).

A copy of ``petastorm_tpu/readers/shuffling_buffer.py`` (the row buffers
``NoopShufflingBuffer`` / ``RandomShufflingBuffer`` :48-128, and the batched
no-op and random buffers :131-286).
"""

from __future__ import annotations

import collections

import numpy as np


class NoopShufflingBuffer:
    """First in, first out."""

    def __init__(self):
        self._queue = collections.deque()
        self._done = False

    def add_many(self, items):
        self._queue.extend(items)

    def retrieve(self):
        return self._queue.popleft()

    def can_add(self):
        return not self._done

    def can_retrieve(self):
        return len(self._queue) > 0

    @property
    def size(self):
        return len(self._queue)

    def finish(self):
        self._done = True


class RandomShufflingBuffer:
    """Bounded uniform shuffling, seeded: each retrieve takes a random item
    and moves the last one into its slot.

    :param shuffling_buffer_capacity: ``can_add`` turns False at or above it
        (one ``add_many`` may overshoot).
    :param min_after_retrieve: ``can_retrieve`` needs this many items
        buffered until :meth:`finish`.
    :param extra_capacity: room for the overshoot.
    """

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve,
                 extra_capacity=1000, seed=None):
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._items = [None] * (shuffling_buffer_capacity + extra_capacity)
        self._size = 0
        self._done_adding = False
        self._random = np.random.RandomState(seed)

    def add_many(self, items):
        if self._done_adding:
            raise RuntimeError('Cannot add to a finished shuffling buffer')
        if not self.can_add():
            raise RuntimeError('Buffer is over capacity; check can_add()')
        needed = self._size + len(items)
        if needed > len(self._items):
            self._items.extend([None] * (needed - len(self._items)))
        for item in items:
            self._items[self._size] = item
            self._size += 1

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError('Not enough items in the buffer; check '
                               'can_retrieve()')
        idx = self._random.randint(self._size)
        item = self._items[idx]
        self._size -= 1
        self._items[idx] = self._items[self._size]
        self._items[self._size] = None
        return item

    def can_add(self):
        return self._size < self._capacity and not self._done_adding

    def can_retrieve(self):
        floor = 1 if self._done_adding else self._min_after_retrieve
        return self._size >= floor

    @property
    def size(self):
        return self._size

    def finish(self):
        self._done_adding = True


class BatchedBufferBase:
    def __init__(self, batch_size):
        self._batch_size = batch_size
        self._done_adding = False
        self._size = 0

    def can_add(self):
        return not self._done_adding

    @property
    def size(self):
        return self._size

    def finish(self):
        self._done_adding = True


class BatchedNoopShufflingBuffer(BatchedBufferBase):
    """Re-chunks incoming column batches into fixed-size batches, in order."""

    def __init__(self, batch_size):
        super().__init__(batch_size)
        self._chunks = collections.deque()

    def add_many(self, columns):
        if self._done_adding:
            raise RuntimeError('Cannot add to a finished buffer')
        columns = {k: np.asarray(v) for k, v in columns.items()}
        n = len(next(iter(columns.values())))
        if n:
            self._chunks.append(columns)
            self._size += n

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError('Not enough rows buffered; check '
                               'can_retrieve()')
        want = min(self._batch_size, self._size)
        parts = collections.defaultdict(list)
        got = 0
        while got < want:
            chunk = self._chunks[0]
            avail = len(next(iter(chunk.values())))
            take = min(avail, want - got)
            if take == avail:
                self._chunks.popleft()
                for k, v in chunk.items():
                    parts[k].append(v)
            else:
                for k, v in chunk.items():
                    parts[k].append(v[:take])
                self._chunks[0] = {k: v[take:] for k, v in chunk.items()}
            got += take
        self._size -= got
        return {k: (v[0] if len(v) == 1 else np.concatenate(v))
                for k, v in parts.items()}

    def can_retrieve(self):
        if self._done_adding:
            return self._size > 0
        return self._size >= self._batch_size


class BatchedRandomShufflingBuffer(BatchedBufferBase):
    """Uniform shuffling over preallocated column storage: each retrieve
    takes the head of a fresh seeded permutation and compacts the rest."""

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve,
                 batch_size, seed=None):
        super().__init__(batch_size)
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._random = np.random.RandomState(seed)
        self._columns = None
        self._extra = collections.deque()   # overflow not yet merged

    def can_add(self):
        return self._size < self._capacity and not self._done_adding

    def can_retrieve(self):
        floor = (1 if self._done_adding
                 else max(self._min_after_retrieve, self._batch_size))
        return self._size >= floor

    def add_many(self, columns):
        if self._done_adding:
            raise RuntimeError('Cannot add to a finished buffer')
        if not self.can_add():
            raise RuntimeError('Buffer is over capacity; check can_add()')
        columns = {k: np.asarray(v) for k, v in columns.items()}
        n = len(next(iter(columns.values())))
        if n == 0:
            return
        if self._columns is None:
            self._columns = {k: np.empty((self._capacity,) + v.shape[1:],
                                         dtype=v.dtype)
                             for k, v in columns.items()}
        fit = min(n, self._capacity - self._size)
        for k, v in columns.items():
            self._columns[k][self._size:self._size + fit] = v[:fit]
        if fit < n:
            self._extra.append({k: v[fit:] for k, v in columns.items()})
        self._size += n

    def _stored(self):
        return self._size - sum(len(next(iter(c.values())))
                                for c in self._extra)

    def _merge_extra(self):
        stored = self._stored()
        while self._extra and stored < self._capacity:
            chunk = self._extra[0]
            n = len(next(iter(chunk.values())))
            fit = min(n, self._capacity - stored)
            for k, v in chunk.items():
                self._columns[k][stored:stored + fit] = v[:fit]
            if fit < n:
                self._extra[0] = {k: v[fit:] for k, v in chunk.items()}
            else:
                self._extra.popleft()
            stored += fit

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError('Not enough rows buffered; check '
                               'can_retrieve()')
        stored = self._stored()
        want = min(self._batch_size, stored)
        perm = self._random.permutation(stored)
        take, rest = perm[:want], perm[want:]
        batch = {k: v[take].copy() for k, v in self._columns.items()}
        for k in self._columns:
            self._columns[k][:len(rest)] = self._columns[k][rest]
        self._size -= want
        self._merge_extra()
        return batch
