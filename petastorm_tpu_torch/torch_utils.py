"""Torch loader and device staging: the port's counterpart of
``petastorm_tpu/jax_utils.py``.

- :class:`TorchDataLoader` batches a reader's NGram window chunks, row
  groups of column arrays, or rows into batches of exactly ``batch_size``
  (``JaxDataLoader``'s chunked NGram, batched and row paths over its
  buffers, ``_drive_batched_buffer`` ``jax_utils.py:598-618`` and
  ``_iter_row_stream`` :712-752). Items shuffle as whole units with a
  seeded buffer. Batches stay on the host, in pinned memory when the
  loader's device is a CUDA device.
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
    BatchedNoopShufflingBuffer, BatchedRandomShufflingBuffer,
    NoopShufflingBuffer, RandomShufflingBuffer)


def _map(batch, fn):
    """Apply ``fn`` to every leaf of a nested dict batch."""
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    return fn(batch)


def _to_tensor(value, pin: bool):
    """numpy numeric/bool column → torch tensor (pinned when ``pin``);
    other columns (strings, ragged objects) stay numpy."""
    if isinstance(value, np.ndarray) and value.dtype.kind in 'biuf':
        if pin:             # one copy, straight into pinned memory
            t = torch.empty(value.shape, pin_memory=True,
                            dtype=torch.from_numpy(
                                np.empty(0, value.dtype)).dtype)
            np.copyto(t.numpy(), value)
            return t
        # a read-only column (a zero-copy arrow view) is copied: a tensor
        # over it could be written to
        return torch.from_numpy(np.ascontiguousarray(value)
                                if value.flags.writeable else np.array(value))
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
    """Batches of exactly ``batch_size`` items (the last short one dropped
    when ``drop_last``) from a reader of the port, as dicts of tensors:

    - an NGram reader (``make_reader(..., NGram)``): ``{offset: {field:
      tensor}}`` batches of windows, collated column-wise from window
      chunks (``jax_utils.py:656-697``);
    - a columnar or batch reader (``make_columnar_reader``,
      ``make_batch_reader``; ``batched_output``): ``{field: tensor}``
      batches re-chunked from the row groups' column arrays
      (``_iter_batched``, ``jax_utils.py:620-636``);
    - a row reader (``make_reader(..., [fields] or None)``): ``{field:
      tensor}`` batches collated from rows (``_iter_rows``,
      ``jax_utils.py:638-654, 712-783``).

    Numeric columns become tensors; strings and ragged columns stay numpy.

    :param shuffling_queue_capacity: 0 keeps reader order; otherwise items
        (windows, rows) shuffle in a buffer of that many, seeded by ``seed``.
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
        if self._ngram is not None and not getattr(reader, 'ngram_chunked',
                                                   False):
            raise NotImplementedError(
                'TorchDataLoader batches NGram readers through window chunks')
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

    def _window_columns(self):
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

    def _row_group_columns(self):
        for item in self.reader:
            yield item._asdict()

    def _tensors(self, batch):
        out = {}
        for key, col in batch.items():
            col = _to_tensor(col, self._pin)
            if isinstance(key, tuple):             # (offset, field)
                out.setdefault(key[0], {})[key[1]] = col
            else:
                out[key] = col
        return out

    def _drive_batched_buffer(self, column_stream):
        """Feed column dicts, drain fixed-size batches, honour
        ``drop_last`` on the tail."""
        buffer = self._make_buffer()
        for columns in column_stream:
            while not buffer.can_add():
                yield self._tensors(buffer.retrieve())
            buffer.add_many(columns)
            while buffer.can_retrieve() and buffer.size >= self.batch_size:
                yield self._tensors(buffer.retrieve())
        buffer.finish()
        while buffer.can_retrieve():
            batch = buffer.retrieve()
            n = len(next(iter(batch.values())))
            if n == self.batch_size or not self.drop_last:
                yield self._tensors(batch)

    def _iter_rows(self):
        """Row stream through a row shuffling buffer, collated into
        fixed-size batches."""
        if self.shuffling_queue_capacity > 0:
            buffer = RandomShufflingBuffer(
                self.shuffling_queue_capacity,
                min_after_retrieve=max(1, self.shuffling_queue_capacity - 1),
                seed=self.seed)
        else:
            buffer = NoopShufflingBuffer()
        pending = []

        def drain(final):
            while buffer.can_retrieve():
                pending.append(buffer.retrieve())
                if len(pending) == self.batch_size:
                    yield self._tensors(_collate(pending))
                    pending.clear()
            if final and pending and not self.drop_last:
                yield self._tensors(_collate(pending))

        for row in self.reader:
            while not buffer.can_add():
                yield from drain(False)
                if not buffer.can_retrieve():
                    break
            buffer.add_many([row._asdict()])
            yield from drain(False)
        buffer.finish()
        yield from drain(True)

    def __iter__(self):
        if self._ngram is not None:
            return self._drive_batched_buffer(self._window_columns())
        if getattr(self.reader, 'batched_output', False):
            return self._drive_batched_buffer(self._row_group_columns())
        return self._iter_rows()


def _collate(rows):
    """Rows (dicts) → column arrays: stacked where every value has one
    shape and a numeric dtype, else an object array of the values."""
    out = {}
    for key in rows[0]:
        vals = [np.asarray(r[key]) for r in rows]
        if (len({v.shape for v in vals}) == 1
                and not {v.dtype.kind for v in vals} & set('USO')):
            out[key] = np.stack(vals)
        else:
            col = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                col[i] = v
            out[key] = col
    return out


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
