"""Torch loader and device staging: the port's counterpart of
``petastorm_tpu/jax_utils.py``.

- :class:`TorchDataLoader` batches an NGram reader's window chunks into
  ``{offset: {field: tensor}}`` batches of exactly ``batch_size`` windows
  (the chunked path of ``JaxDataLoader``, ``jax_utils.py:656-697``, over
  the batched buffers, ``_drive_batched_buffer`` :598-618). Windows shuffle
  as whole units with a seeded buffer. Batches stay on the host, in pinned
  memory when the loader's device is a CUDA device.
- :func:`prefetch_to_device` (``jax_utils.py:1193-1300``) stages batches
  ahead of the consumer on a background thread: ``non_blocking`` copies from
  pinned memory on a side CUDA stream, handed to the consumer's stream with
  an event and ``record_stream``.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.readers.shuffling_buffer import (
    BatchedNoopShufflingBuffer, BatchedRandomShufflingBuffer)


def _map(batch, fn):
    """Apply ``fn`` to every leaf of a nested dict batch."""
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    return fn(batch)


def _to_tensor(value, pin: bool):
    """numpy numeric/bool column → torch tensor (pinned when ``pin``);
    other columns (strings, ragged objects) stay numpy."""
    if isinstance(value, np.ndarray) and value.dtype.kind in 'biuf':
        t = torch.from_numpy(np.ascontiguousarray(value))
        return t.pin_memory() if pin else t
    return value


def _take_rows(col, pos):
    """Rows ``pos`` of ``col``: a zero-copy slice when they are one
    consecutive range, a gather otherwise."""
    if (len(pos) and int(pos[-1]) - int(pos[0]) == len(pos) - 1
            and bool(np.all(np.diff(pos) == 1))):
        lo = int(pos[0])
        return col[lo:lo + len(pos)]
    return col[pos]


class TorchDataLoader:
    """Batches of exactly ``batch_size`` NGram windows (the last short one
    dropped when ``drop_last``) from a ``make_reader(..., NGram)`` reader.

    :param shuffling_queue_capacity: 0 keeps reader order; otherwise windows
        shuffle in a buffer of that many windows, seeded by ``seed``.
    :param device: the device batches are meant for (``'cuda'`` by default,
        which raises without CUDA; ``'cpu'`` explicitly). On a CUDA device
        the host tensors are pinned so :func:`prefetch_to_device` copies
        them asynchronously.
    """

    def __init__(self, reader, batch_size=1, shuffling_queue_capacity=0,
                 drop_last=False, seed=None, device=None):
        self.device = resolve_device(device)
        self.reader = reader
        self._ngram = getattr(reader, 'ngram', None)
        if self._ngram is None or not getattr(reader, 'ngram_chunked', False):
            raise NotImplementedError(
                'TorchDataLoader batches chunked NGram readers in this slice')
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        self.batch_size = batch_size
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self.drop_last = drop_last
        self.seed = seed
        self._pin = self.device.type == 'cuda'

    def _make_buffer(self):
        if self.shuffling_queue_capacity > 0:
            return BatchedRandomShufflingBuffer(
                self.shuffling_queue_capacity + self.batch_size,
                min_after_retrieve=max(
                    1, self.shuffling_queue_capacity - self.batch_size),
                batch_size=self.batch_size, seed=self.seed)
        return BatchedNoopShufflingBuffer(self.batch_size)

    def _column_stream(self):
        offsets, base, fields_at = self._ngram.timestep_layout(
            self.reader.schema.fields)
        for chunk in self.reader.iter_ngram_chunks():
            flat = {}
            for off in offsets:
                pos = chunk.starts + (off - base)
                for name in fields_at[off]:
                    col = chunk.columns.get(name)
                    if col is not None:
                        flat[(off, name)] = _take_rows(col, pos)
            yield flat

    def _finish(self, flat):
        batch = {}
        for (off, name), col in flat.items():
            batch.setdefault(off, {})[name] = _to_tensor(col, self._pin)
        return batch

    def __iter__(self):
        buffer = self._make_buffer()
        for columns in self._column_stream():
            while not buffer.can_add():
                yield self._finish(buffer.retrieve())
            buffer.add_many(columns)
            while buffer.can_retrieve() and buffer.size >= self.batch_size:
                yield self._finish(buffer.retrieve())
        buffer.finish()
        while buffer.can_retrieve():
            batch = buffer.retrieve()
            n = len(next(iter(batch.values())))
            if n == self.batch_size or not self.drop_last:
                yield self._finish(batch)


def prefetch_to_device(iterator, size=2, device=None):
    """Stage up to ``size`` batches ahead of the consumer on a background
    thread. On a CUDA device each tensor leaf is copied from pinned host
    memory with ``non_blocking=True`` on a side stream; the consumer's
    current stream waits on the copy's event and ``record_stream`` keeps the
    allocator from reusing the memory early. ``device='cpu'`` converts numpy
    leaves to tensors and stages nothing. Non-tensor leaves pass through."""
    device = resolve_device(device)
    if size < 1:
        raise ValueError('size must be >= 1')
    if device.type == 'cpu':
        return _pipeline(iterator, size,
                         lambda b: (_map(b, lambda x: _to_tensor(x, False)),
                                    None), None)
    if device.index is None:     # 'cuda' names the current device
        device = torch.device('cuda', torch.cuda.current_device())
    side = torch.cuda.Stream(device=device)

    def stage(x):
        if isinstance(x, np.ndarray):
            x = _to_tensor(x, True)
        if not torch.is_tensor(x) or x.device == device:
            return x
        if x.device.type == 'cpu' and not x.is_pinned():
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    def put(batch):
        with torch.cuda.stream(side):
            staged = _map(batch, stage)
            event = torch.cuda.Event()
            event.record(side)
        return staged, event

    def hand_off(staged, event):
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        _map(staged, lambda t: t.record_stream(current)
             if torch.is_tensor(t) and t.is_cuda else None)

    return _pipeline(iterator, size, put, hand_off)


def _pipeline(iterator, size, put, hand_off):
    """Producer thread filling a ring of ``size`` staged batches; it waits
    for a free slot before staging the next batch, so at most ``size`` sit
    staged beside the one the consumer holds. Producer exceptions re-raise in
    the consumer; closing the generator stops the producer and joins it."""
    ring = collections.deque()
    done = object()
    cv = threading.Condition()
    state = {'error': None, 'finished': False}

    def producer():
        try:
            for batch in iterator:
                with cv:
                    while len(ring) >= size and not state['finished']:
                        cv.wait()
                    if state['finished']:
                        return
                # only this thread appends, so the slot stays free
                staged = put(batch)
                with cv:
                    if state['finished']:
                        return
                    ring.append(staged)
                    cv.notify_all()
        except Exception as e:     # re-raised in the consumer
            state['error'] = e
        finally:
            with cv:
                ring.append(done)
                cv.notify_all()

    thread = threading.Thread(target=producer, daemon=True,
                              name='petastorm-torch-prefetch')

    def consume():
        thread.start()
        try:
            while True:
                with cv:
                    while not ring:
                        cv.wait()
                    item = ring.popleft()
                    cv.notify_all()
                if item is done:
                    if state['error'] is not None:
                        raise state['error']
                    return
                staged, event = item
                if hand_off is not None:
                    hand_off(staged, event)
                yield staged
        finally:
            with cv:
                state['finished'] = True
                ring.clear()
                cv.notify_all()
            thread.join()

    return consume()
