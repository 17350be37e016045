"""PyTorch adapter of the port: ``DataLoader`` over row readers and
``BatchedDataLoader`` over batched readers, yielding dicts of
``torch.Tensor`` batches on the loader's device.

A copy of ``petastorm_tpu/pytorch.py``: the dtype sanitiser
``_sanitize_pytorch_types`` (:25), ``decimal_friendly_collate`` (:51),
``LoaderBase`` (:69), ``DataLoader`` (:111) and ``BatchedDataLoader``
(:170), over the port's shuffling buffers
(:mod:`petastorm_tpu_torch.readers.shuffling_buffer`), which draw as
JAX's for equal seeds.

Both loaders take ``device``: ``None`` is the CUDA device
(:func:`~petastorm_tpu_torch.device.resolve_device`, which raises without
one), and every collated tensor is moved there; ``device='cpu'`` keeps
the batches on the host. String and ragged fields stay Python lists, as
in JAX. :class:`BatchedDataLoader` drops object columns (strings, ragged
lists) as JAX's does.
"""

from __future__ import annotations

import logging
from decimal import Decimal

import numpy as np
import torch

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.readers.shuffling_buffer import (
    BatchedNoopShufflingBuffer, BatchedRandomShufflingBuffer,
    NoopShufflingBuffer, RandomShufflingBuffer)

logger = logging.getLogger(__name__)


def _sanitize_pytorch_types(row_as_dict):
    """In-place casts torch can hold: bool → uint8, uint16 → int32, uint32
    → int64, Decimal → float64; a None value raises (fill nulls with a
    TransformSpec)."""
    for name, value in row_as_dict.items():
        if value is None:
            raise TypeError(
                'Field {} is None. Use a TransformSpec to fill nulls before '
                'the torch loader'.format(name))
        if isinstance(value, Decimal):
            row_as_dict[name] = float(value)
            continue
        arr = np.asarray(value)
        if arr.dtype == np.bool_:
            row_as_dict[name] = arr.astype(np.uint8)
        elif arr.dtype == np.uint16:
            row_as_dict[name] = arr.astype(np.int32)
        elif arr.dtype == np.uint32:
            row_as_dict[name] = arr.astype(np.int64)
        elif (arr.dtype.kind == 'O' and arr.size
              and isinstance(arr.flat[0], Decimal)):
            row_as_dict[name] = arr.astype(np.float64)
        else:
            row_as_dict[name] = arr
    return row_as_dict


def decimal_friendly_collate(batch_rows):
    """Stack a list of sanitised row dicts into a dict of host tensors;
    string and ragged fields come back as Python lists."""
    out = {}
    for key in batch_rows[0]:
        vals = [r[key] for r in batch_rows]
        arrs = [np.asarray(v) for v in vals]
        shapes = {a.shape for a in arrs}
        kinds = {a.dtype.kind for a in arrs}
        if len(shapes) == 1 and not (kinds & {'U', 'S', 'O'}):
            out[key] = torch.as_tensor(np.stack(arrs))
        else:
            out[key] = vals
    return out


def _to_device(batch, device):
    """Each tensor of a collated batch (a dict, list or tuple of them) on
    ``device``; other values as they are."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)) and any(
            isinstance(v, torch.Tensor) for v in batch):
        return type(batch)(_to_device(v, device) for v in batch)
    return batch


class LoaderBase:
    """One iteration at a time, none after a failed one; a new iteration
    after the first resets the reader (with a warning) unless the epoch is
    served from memory. The context manager stops and joins the reader."""

    def __init__(self, reader, device=None):
        self.device = resolve_device(device)
        self.reader = reader
        self._in_iter = None
        self._error = None

    def __iter__(self):
        if self._error is not None:
            raise RuntimeError('Cannot start a new iteration after a failed '
                               'one') from self._error
        if self._in_iter is not None and self._in_iter:
            raise RuntimeError('Loader is already being iterated')
        if self._in_iter is not None and not self._cache_hot():
            self.reader.reset()
            logger.warning('Start a new pass of the Reader. To avoid I/O, '
                           'pass inmemory_cache_all=True')
        self._in_iter = True
        try:
            for batch in self._iter_impl():
                yield batch
        except Exception as e:
            self._error = e
            raise
        finally:
            self._in_iter = False

    def _iter_impl(self):
        raise NotImplementedError

    def _cache_hot(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.reader.stop()
        self.reader.join()


class DataLoader(LoaderBase):
    """Rows through a seeded row shuffling buffer into ``collate_fn``; a
    batched reader's column batches are taken apart into rows first."""

    def __init__(self, reader, batch_size=1,
                 collate_fn=decimal_friendly_collate,
                 shuffling_queue_capacity=0, seed=None, device=None):
        super().__init__(reader, device)
        if getattr(reader, 'ngram', None) is not None:
            raise NotImplementedError('NGram readers are not supported by '
                                      'the torch DataLoader')
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self.seed = seed

    def _collate(self, rows):
        return _to_device(self.collate_fn(rows), self.device)

    def _iter_impl(self):
        if self.shuffling_queue_capacity > 0:
            buffer = RandomShufflingBuffer(
                self.shuffling_queue_capacity,
                min_after_retrieve=max(1, self.shuffling_queue_capacity - 1),
                seed=self.seed)
        else:
            buffer = NoopShufflingBuffer()
        rows = []

        def drain(final):
            while buffer.can_retrieve():
                rows.append(buffer.retrieve())
                if len(rows) == self.batch_size:
                    yield self._collate(rows)
                    rows.clear()
            if final and rows:
                yield self._collate(rows)
                rows.clear()

        def as_dict(item):
            return item._asdict() if hasattr(item, '_asdict') else dict(item)

        for item in self.reader:
            if self.reader.batched_output:
                cols = as_dict(item)
                n = len(next(iter(cols.values())))
                for i in range(n):
                    while not buffer.can_add():
                        yield from drain(False)
                    buffer.add_many([_sanitize_pytorch_types(
                        {k: v[i] for k, v in cols.items()})])
            else:
                while not buffer.can_add():
                    yield from drain(False)
                buffer.add_many([_sanitize_pytorch_types(as_dict(item))])
            yield from drain(False)
        buffer.finish()
        yield from drain(True)


class BatchedDataLoader(LoaderBase):
    """Column batches of a batched reader through the seeded batched
    buffers into tensors; with ``inmemory_cache_all`` every pass after the
    first replays the first pass's batches from memory, without a reader
    pass.

    :param transform_fn: applied to the dict of numpy column batches before
        they become tensors.
    """

    def __init__(self, reader, batch_size=1, transform_fn=None,
                 shuffling_queue_capacity=0, seed=None,
                 inmemory_cache_all=False, device=None):
        super().__init__(reader, device)
        if getattr(reader, 'ngram', None) is not None:
            raise NotImplementedError('NGram readers are not supported by '
                                      'the torch BatchedDataLoader')
        if not reader.batched_output:
            raise ValueError('BatchedDataLoader requires a batched reader '
                             '(make_batch_reader); use DataLoader for row '
                             'readers')
        self.batch_size = batch_size
        self.transform_fn = transform_fn
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self.seed = seed
        self.inmemory_cache_all = inmemory_cache_all
        self._cache = [] if inmemory_cache_all else None
        self._cache_complete = False

    def _cache_hot(self):
        return self._cache_complete

    def _to_torch(self, batch):
        if self.transform_fn is not None:
            batch = self.transform_fn(batch)
        out = {}
        for k, v in batch.items():
            arr = np.asarray(v)
            if arr.dtype.kind in ('U', 'S', 'O'):
                out[k] = v
            else:
                # arrow's zero-copy views and received frames are
                # read-only: copied, so no tensor aliases memory the
                # loader does not own
                if not arr.flags.writeable:
                    arr = arr.copy()
                out[k] = torch.as_tensor(arr).to(self.device)
        return out

    def _iter_impl(self):
        if self._cache_complete:
            yield from self._cache
            return
        if self._cache is not None:
            self._cache = []
        if self.shuffling_queue_capacity > 0:
            buffer = BatchedRandomShufflingBuffer(
                self.shuffling_queue_capacity + self.batch_size,
                min_after_retrieve=max(
                    1, self.shuffling_queue_capacity - self.batch_size),
                batch_size=self.batch_size, seed=self.seed)
        else:
            buffer = BatchedNoopShufflingBuffer(self.batch_size)

        def emit(columns):
            batch = self._to_torch(columns)
            if self._cache is not None:
                self._cache.append(batch)
            return batch

        for chunk in self.reader:
            cols = (chunk._asdict() if hasattr(chunk, '_asdict')
                    else dict(chunk))
            cols = _sanitize_pytorch_types(cols)
            # object and ragged columns have no place in the column buffer
            dense = {k: v for k, v in cols.items()
                     if np.asarray(v).dtype.kind not in ('U', 'S', 'O')}
            while not buffer.can_add():
                yield emit(buffer.retrieve())
            buffer.add_many(dense)
            while buffer.can_retrieve() and buffer.size >= self.batch_size:
                yield emit(buffer.retrieve())
        buffer.finish()
        while buffer.can_retrieve():
            yield emit(buffer.retrieve())
        if self._cache is not None:
            self._cache_complete = True
