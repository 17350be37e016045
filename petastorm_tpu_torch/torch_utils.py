"""Torch loader and device staging: the port's counterpart of
``petastorm_tpu/jax_utils.py``.

- :class:`TorchLoaderBase` (``JaxLoaderBase``, ``jax_utils.py:289-420``):
  the iteration guard, a new reader pass on each new iteration (unless the
  epoch is cached), the context manager, ``prefetch_depth`` and
  :meth:`~TorchLoaderBase.iter_prefetched`, and the per-step goodput
  monitor (:mod:`petastorm_tpu_torch.goodput`) fed from ``__iter__``.
- :class:`TorchDataLoader` (``JaxDataLoader``, :422-783) batches a reader's
  NGram window chunks, NGram windows, row groups of column arrays, or rows
  into batches of exactly ``batch_size`` (the chunked NGram, per-window
  NGram, batched and row paths over its buffers, ``_drive_batched_buffer``
  :598-618, ``_iter_ngram`` :699-710 and ``_iter_row_stream`` :712-752).
  Items shuffle as whole units with a seeded buffer. Ragged columns pad to
  buckets under ``pad_spec`` (:138-286), then a ``transform_fn`` runs, and
  ``inmemory_cache_all`` replays epoch 1 from memory. Batches stay on the
  host, in pinned memory when the loader's device is a CUDA device.
- :func:`make_torch_loader` (``make_jax_loader``, :1106-1132) and
  :func:`epoch_cache_on_device` (:1135-1168).
- :func:`prefetch_to_device` (:1193-1300) stages batches ahead of the
  consumer on a background thread: ``non_blocking`` copies from pinned
  memory on a side CUDA stream, handed to the consumer's stream with an
  event and ``record_stream``.
- Device decode (``jax_utils.py:502-530, 569-573, 1217-1250``): a
  ``TorchDataLoader`` over a columnar reader that planned device decode
  claims the plans. Plain iteration then decodes the raw uint8 grids on
  the loader's device, before ``pad_spec`` and ``transform_fn``;
  :meth:`TorchLoaderBase.iter_prefetched` instead stages the raw grids
  and decodes them on the side stream after the copy
  (``prefetch_to_device(fused_fn=)``), so the raw bytes are what crosses
  PCIe and the decode runs once a batch.

Not here yet: the sharded loaders and ``require_single_bucket_pad_spec``
(the multi-GPU slice) and ``infeed_diagnosis`` (the tracing and health
slice).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

import numpy as np
import torch

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.goodput import GoodputMonitor, goodput_enabled
from petastorm_tpu_torch.ops.decode import (build_fused_infeed,
                                            split_device_columns)
from petastorm_tpu_torch.readers.shuffling_buffer import (
    BatchedNoopShufflingBuffer, BatchedRandomShufflingBuffer,
    NoopShufflingBuffer, RandomShufflingBuffer)

logger = logging.getLogger(__name__)

#: Environment default of the prefetch window (:func:`prefetch_to_device`
#: ``size`` and the loaders' ``prefetch_depth``): the JAX package's
#: variable, so one setting serves both. Unset means
#: :data:`DEFAULT_PREFETCH_DEPTH`.
PREFETCH_DEPTH_ENV_VAR = 'PETASTORM_TPU_PREFETCH_DEPTH'

#: Stage batch N+1 while batch N computes.
DEFAULT_PREFETCH_DEPTH = 2


def resolve_prefetch_depth(depth):
    """Validated prefetch depth: the explicit knob wins, then
    :data:`PREFETCH_DEPTH_ENV_VAR`, then :data:`DEFAULT_PREFETCH_DEPTH`."""
    if depth is None:
        raw = os.environ.get(PREFETCH_DEPTH_ENV_VAR, '').strip()
        if not raw:
            return DEFAULT_PREFETCH_DEPTH
        depth = raw
    if isinstance(depth, float):
        raise ValueError('prefetch depth must be an integer >= 1, got {!r}'
                         .format(depth))
    try:
        depth = int(depth)
    except (TypeError, ValueError):
        raise ValueError('prefetch depth must be an integer >= 1, got {!r}'
                         .format(depth))
    if depth < 1:
        raise ValueError('prefetch depth must be >= 1, got {}'.format(depth))
    return depth


def validate_pad_spec(pad_spec):
    """Normalize and validate a ragged-padding spec.

    ``pad_spec`` maps a field name to ``{'buckets': [n1, n2, ...]}`` or
    ``{'max_len': n}``, with optional ``'pad_value'`` (default 0),
    ``'length_field'`` (default ``'<name>_len'``), ``'dtype'`` and
    ``'trailing_shape'``. The last two only shape a batch of zero rows,
    where neither can be inferred (without them it takes ``pad_value``'s
    dtype and no trailing dims)."""
    if not pad_spec:
        return None
    normalized = {}
    for name, spec in pad_spec.items():
        spec = dict(spec)
        buckets = spec.pop('buckets', None)
        max_len = spec.pop('max_len', None)
        pad_value = spec.pop('pad_value', 0)
        length_field = spec.pop('length_field', name + '_len')
        dtype = spec.pop('dtype', None)
        trailing_shape = spec.pop('trailing_shape', ())
        if spec:
            raise ValueError('pad_spec for {!r} has unknown keys {}'.format(
                name, sorted(spec)))
        if (buckets is None) == (max_len is None):
            raise ValueError("pad_spec for {!r} needs exactly one of "
                             "'buckets' or 'max_len'".format(name))
        if buckets is None:
            buckets = [max_len]
        buckets = sorted(int(b) for b in buckets)
        if not buckets or buckets[0] <= 0:
            raise ValueError('pad_spec buckets for {!r} must be positive '
                             'ints, got {!r}'.format(name, buckets))
        normalized[name] = {'buckets': buckets, 'pad_value': pad_value,
                            'length_field': length_field,
                            'dtype': None if dtype is None else np.dtype(dtype),
                            'trailing_shape': tuple(trailing_shape)}
    return normalized


def check_pad_spec_fields(pad_spec, field_names, who: str) -> None:
    """Check a normalized pad_spec against a schema's field names: every
    padded field must exist, and no ``length_field`` may collide with a
    column (padding would overwrite it)."""
    if not pad_spec:
        return
    names = set(field_names)
    unknown = set(pad_spec) - names
    if unknown:
        raise ValueError('{}: pad_spec names unknown fields {} (schema has '
                         '{})'.format(who, sorted(unknown), sorted(names)))
    for name, spec in pad_spec.items():
        if spec['length_field'] in names:
            raise ValueError(
                "{}: pad_spec length_field {!r} for {!r} collides with an "
                'existing column; pick another via length_field='.format(
                    who, spec['length_field'], name))


def pad_ragged_batch(batch, pad_spec):
    """Pad the ragged (object-dtype) numpy columns of a collated batch into
    dense arrays of a bucket's width.

    For each field of the spec, rows pad along their first dimension to the
    smallest bucket that holds the batch's longest row, and the true lengths
    come out as an int32 ``length_field`` column. A column that arrives
    dense (rows of one length, always so at ``batch_size=1``) still pads to
    a bucket, with a constant length column."""
    out = dict(batch)
    for name, spec in pad_spec.items():
        col = out.get(name)
        if col is None:
            continue
        if torch.is_tensor(col) or not (isinstance(col, np.ndarray)
                                        and col.dtype == object):
            if not torch.is_tensor(col):    # a device-decoded column stays
                col = np.asarray(col)
            if col.ndim < 2:
                raise ValueError('pad_spec field {!r} has scalar rows; '
                                 'padding needs at least one dimension'
                                 .format(name))
            width = col.shape[1]
            bucket = next((b for b in spec['buckets'] if b >= width), None)
            if bucket is None:
                raise ValueError(
                    'pad_spec field {!r}: row length {} exceeds largest '
                    'bucket {}'.format(name, width, spec['buckets'][-1]))
            if bucket != width:
                shape = (len(col), bucket) + tuple(col.shape[2:])
                padded = (col.new_full(shape, spec['pad_value'])
                          if torch.is_tensor(col) else
                          np.full(shape, spec['pad_value'], dtype=col.dtype))
                padded[:, :width] = col
                col = padded
            out[name] = col
            out[spec['length_field']] = np.full(len(col), width, np.int32)
            continue
        rows = [np.asarray(v) for v in col]
        if not rows:
            # zero rows: the smallest bucket, dtype and trailing dims from
            # the spec
            bucket = spec['buckets'][0]
            dtype = spec['dtype']
            if dtype is None:
                dtype = np.asarray(spec['pad_value']).dtype
            shape = (0, bucket) + spec['trailing_shape']
            out[name] = np.empty(shape, dtype=dtype)
            out[spec['length_field']] = np.empty((0,), np.int32)
            continue
        if any(r.ndim < 1 for r in rows):
            raise ValueError('pad_spec field {!r} has scalar rows; padding '
                             'needs at least one dimension'.format(name))
        lengths = np.asarray([len(r) for r in rows], np.int32)
        longest = int(lengths.max())
        bucket = next((b for b in spec['buckets'] if b >= longest), None)
        if bucket is None:
            raise ValueError(
                'pad_spec field {!r}: row length {} exceeds largest bucket {}'
                .format(name, longest, spec['buckets'][-1]))
        first = rows[0]
        dense = np.full((len(rows), bucket) + first.shape[1:],
                        spec['pad_value'], dtype=first.dtype)
        for i, r in enumerate(rows):
            dense[i, :len(r)] = r
        out[name] = dense
        out[spec['length_field']] = lengths
    return out


def _map(batch, fn):
    """Apply ``fn`` to every leaf of a nested dict batch."""
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    return fn(batch)


def _to_tensor(value, pin: bool):
    """numpy numeric/bool column → torch tensor (pinned when ``pin``);
    other columns (strings, ragged objects) stay numpy, copied when
    read-only. A read-only column is a view of memory the loader does not
    own (an arrow buffer, a received frame, a shared-cache mapping): it is
    copied, so no tensor over it can be written to and no cached batch
    keeps a shared-cache mapping alive."""
    if not isinstance(value, np.ndarray):
        return value
    if value.dtype.kind in 'biuf':
        if pin:             # one copy, straight into pinned memory
            t = torch.empty(value.shape, pin_memory=True,
                            dtype=torch.from_numpy(
                                np.empty(0, value.dtype)).dtype)
            np.copyto(t.numpy(), value)
            return t
        return torch.from_numpy(np.ascontiguousarray(value)
                                if value.flags.writeable else np.array(value))
    return value if value.flags.writeable else np.array(value)


def _take_rows(col, pos):
    """Rows ``pos`` of ``col``: a zero-copy slice when they are one
    consecutive range, a gather otherwise."""
    if (len(pos) and int(pos[-1]) - int(pos[0]) == len(pos) - 1
            and bool(np.all(np.diff(pos) == 1))):
        lo = int(pos[0])
        return col[lo:lo + len(pos)]
    return col[pos]


class TorchLoaderBase:
    """The iteration guard and the pass protocol of a loader, as JAX's
    ``JaxLoaderBase`` (``jax_utils.py:289-420``): one iteration at a time
    ("Loader is already being iterated"), none after a failed one, and each
    new iteration after the first resets the reader for another pass (with
    a warning) unless the epoch is served from a cache. ``goodput`` is the
    loader's :class:`~petastorm_tpu_torch.goodput.GoodputMonitor` (None
    under ``PETASTORM_TPU_GOODPUT=0``): ``__iter__`` feeds it each step's
    fetch wait and train wall; call ``loader.goodput.fence(outputs)`` in
    the step for the device / host split, and pass ``goodput=
    loader.goodput`` to :func:`prefetch_to_device` for the staging time."""

    def __init__(self, reader, device=None):
        self.device = resolve_device(device)
        self.reader = reader
        self._in_iter = None
        self._error = None
        #: Lookahead of :meth:`iter_prefetched`; subclasses set it from
        #: their ``prefetch_depth`` knob.
        self.prefetch_depth = resolve_prefetch_depth(None)
        self.goodput = GoodputMonitor() if goodput_enabled() else None

    def iter_prefetched(self, to_device=True):
        """Iterate with a background lookahead of ``self.prefetch_depth``
        batches: staged onto the loader's device by
        :func:`prefetch_to_device` (which reports to ``self.goodput``), or
        with ``to_device=False`` kept on the host. Where the loader can
        leave its device decode to the staging (:meth:`_staging_decode`),
        the raw grids are staged and decoded after the copy."""
        if to_device:
            fused = self._staging_decode()
            return prefetch_to_device(self._iterate(decode=fused is None),
                                      self.prefetch_depth,
                                      device=self.device,
                                      goodput=self.goodput, fused_fn=fused)
        return _pipeline(iter(self), self.prefetch_depth,
                         lambda batch: (batch, None), None)

    def _staging_decode(self):
        """The decode :func:`prefetch_to_device` runs after staging when the
        loader yields raw grids, or None when the loader decodes itself."""
        return None

    def __iter__(self):
        return self._iterate(decode=True)

    def _iterate(self, decode):
        if self._error is not None:
            raise RuntimeError('Cannot start a new iteration after a failed '
                               'one') from self._error
        if self._in_iter is not None and self._in_iter:
            raise RuntimeError('Loader is already being iterated')
        if self._in_iter is not None and not self._cache_hot():
            self.reader.reset()
            logger.warning('Start a new pass of the Reader. To avoid I/O, '
                           'consider in-memory caching '
                           '(inmemory_cache_all=True).')
        self._in_iter = True
        goodput = self.goodput
        try:
            if goodput is None:
                yield from self._iter_impl(decode)
            else:
                it = self._iter_impl(decode)
                fetch_start = time.perf_counter()
                for batch in it:
                    now = time.perf_counter()
                    goodput.note_fetch(now - fetch_start, batch)
                    step_start = now
                    yield batch
                    # the consumer held the generator suspended for its
                    # train step; the step's end starts the next fetch
                    fetch_start = time.perf_counter()
                    goodput.finish_step(fetch_start - step_start)
        except Exception as e:
            self._error = e
            raise
        finally:
            self._in_iter = False

    def _iter_impl(self, decode):
        """The batches of one pass; ``decode`` False leaves claimed raw
        columns undecoded for the staging to decode."""
        raise NotImplementedError

    def _cache_hot(self):
        """True when a new pass is served from a cache and the reader need
        not be reset."""
        return False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()

    def stop(self):
        self.reader.stop()

    def join(self):
        self.reader.join()


class TorchDataLoader(TorchLoaderBase):
    """Batches of exactly ``batch_size`` items (the last short one dropped
    when ``drop_last``) from a reader of the port, as dicts of tensors:

    - an NGram reader (``make_reader(..., NGram)``): ``{offset: {field:
      tensor}}`` batches of windows, collated column-wise from window
      chunks (``jax_utils.py:656-697``), or, under a row predicate,
      residual filters or a transform, window by window
      (``jax_utils.py:699-710``);
    - a columnar or batch reader (``make_columnar_reader``,
      ``make_batch_reader``; ``batched_output``): ``{field: tensor}``
      batches re-chunked from the row groups' column arrays
      (``_iter_batched``, ``jax_utils.py:620-636``);
    - a row reader (``make_reader(..., [fields] or None)``): ``{field:
      tensor}`` batches collated from rows (``_iter_rows``,
      ``jax_utils.py:638-654, 712-783``).

    Numeric columns become tensors; strings, and ragged columns that no
    ``pad_spec`` pads, stay numpy.

    :param shuffling_queue_capacity: 0 keeps reader order; otherwise items
        (windows, rows) shuffle in a buffer of that many, seeded by ``seed``.
    :param transform_fn: a callable applied to each finished batch (after
        padding, on the tensors).
    :param inmemory_cache_all: keep epoch 1's batches and replay them on
        later iterations without touching or resetting the reader; a pass
        abandoned part way leaves no partial cache.
    :param pad_spec: ragged fields to pad into dense bucketed columns, with
        their lengths in a ``<name>_len`` column (see
        :func:`validate_pad_spec`); not with NGram readers.
    :param prefetch_depth: lookahead of :meth:`iter_prefetched` (default
        ``PETASTORM_TPU_PREFETCH_DEPTH``, the JAX package's variable, else
        2).
    :param device: the device batches are meant for (``'cuda'`` by default,
        which raises without CUDA; ``'cpu'`` explicitly). On a CUDA device
        the host tensors are pinned so :func:`prefetch_to_device` copies
        them asynchronously.
    :param device_decode: claim the reader's device-decode plans (the
        default). The raw uint8 grids of the planned columns then decode
        on ``device``, followed by the reader's ``device=True``
        ``TransformSpec``: in the loader before ``pad_spec`` and
        ``transform_fn``, or under :meth:`iter_prefetched` after the copy.
        Other columns stay on the host unless a device spec needs them.
        False leaves the decode to the reader, on the host.
    """

    def __init__(self, reader, batch_size=1, shuffling_queue_capacity=0,
                 transform_fn=None, drop_last=False, seed=None,
                 inmemory_cache_all=False, pad_spec=None,
                 prefetch_depth=None, device=None, device_decode=True):
        super().__init__(reader, device)
        self._ngram = getattr(reader, 'ngram', None)
        if self._ngram is not None and pad_spec:
            raise ValueError('pad_spec is not supported with NGram readers '
                             '(window fields are fixed-shape per timestep)')
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        self.batch_size = batch_size
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self.transform_fn = transform_fn
        self.drop_last = drop_last
        self.seed = seed
        self.inmemory_cache_all = inmemory_cache_all
        self.pad_spec = validate_pad_spec(pad_spec)
        if self.pad_spec:
            schema_fields = getattr(getattr(reader, 'schema', None), 'fields',
                                    None)
            if schema_fields is not None:
                check_pad_spec_fields(self.pad_spec, schema_fields,
                                      'TorchDataLoader')
        self._cache = [] if inmemory_cache_all else None
        self._cache_complete = False
        self.prefetch_depth = resolve_prefetch_depth(prefetch_depth)
        self._pin = self.device.type == 'cuda'
        #: name -> DeviceColumnPlan claimed from the reader
        self._device_plans = {}
        self._device_transform_spec = None
        self._fused = None
        claim = getattr(reader, '_defer_device_decode_to_loader', None)
        if (device_decode and claim is not None
                and getattr(reader, 'device_decode_plans', None)):
            self._device_plans, self._device_transform_spec = claim()
            self._fused = build_fused_infeed(self._device_plans,
                                             self._device_transform_spec)

    def _cache_hot(self):
        return self._cache_complete

    def _staging_decode(self):
        # the staging may decode only what nothing before it must see
        # decoded: no transform_fn, no padding of a planned column, and no
        # cache (a cached raw batch would replay undecoded)
        if (self._fused is None or self.transform_fn is not None
                or self._cache is not None
                or set(self.pad_spec or ()) & set(self._device_plans)):
            return None
        return self._fused

    def _decode(self, batch):
        """Decode the planned raw columns on the loader's device and run the
        device ``TransformSpec``; host-only columns merge back as they
        were."""
        device_cols, host_cols = split_device_columns(
            batch, self._device_plans,
            include_unplanned=self._device_transform_spec is not None)
        staged = {}
        for name, col in device_cols.items():
            col = _to_tensor(col, self._pin)
            staged[name] = col.to(self.device, non_blocking=True)
        out = dict(self._fused(staged))
        out.update(host_cols)
        return out

    def _iter_impl(self, decode=True):
        if self._cache_complete:
            yield from self._cache
            return
        if self._cache is not None:
            self._cache = []        # an abandoned pass may have left some
        for batch in self._collated():
            if self._fused is not None and decode:
                batch = self._decode(batch)
            if self.pad_spec:
                batch = pad_ragged_batch(batch, self.pad_spec)
            batch = self._tensors(batch)
            if self.transform_fn is not None:
                batch = self.transform_fn(batch)
            if self._cache is not None:
                self._cache.append(batch)
            yield batch
        if self._cache is not None:
            self._cache_complete = True

    def _collated(self):
        """Collated numpy batches of the reader's kind."""
        if self._ngram is not None and self.reader.ngram_chunked:
            return self._drive_batched_buffer(self._window_columns())
        if self._ngram is not None:
            # windows shuffle as whole units; a batch is collated per offset
            return self._iter_rows(lambda window: window, _collate_windows)
        if getattr(self.reader, 'batched_output', False):
            return self._drive_batched_buffer(self._row_group_columns())
        return self._iter_rows(lambda row: row._asdict(), _collate)

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
                yield buffer.retrieve()
            buffer.add_many(columns)
            while buffer.can_retrieve() and buffer.size >= self.batch_size:
                yield buffer.retrieve()
        buffer.finish()
        while buffer.can_retrieve():
            batch = buffer.retrieve()
            n = len(next(iter(batch.values())))
            if n == self.batch_size or not self.drop_last:
                yield batch

    def _iter_rows(self, prepare, collate):
        """Row (or window) stream, each item through ``prepare``, through a
        row shuffling buffer, collated by ``collate`` into fixed-size
        batches."""
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
                    yield collate(pending)
                    pending.clear()
            if final and pending and not self.drop_last:
                yield collate(pending)

        for row in self.reader:
            while not buffer.can_add():
                yield from drain(False)
                if not buffer.can_retrieve():
                    break
            buffer.add_many([prepare(row)])
            yield from drain(False)
        buffer.finish()
        yield from drain(True)


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


def _collate_windows(windows):
    """``{offset: namedtuple}`` windows → ``{(offset, field): column}``."""
    return {(off, name): col
            for off in sorted(windows[0])
            for name, col in _collate([w[off]._asdict()
                                       for w in windows]).items()}


def make_torch_loader(reader, batch_size=1, mesh=None,
                      shuffling_queue_capacity=0, transform_fn=None,
                      drop_last=False, seed=None, inmemory_cache_all=False,
                      pad_spec=None, prefetch_depth=None, device=None,
                      device_decode=True):
    """A :class:`TorchDataLoader` over ``reader`` (JAX ``make_jax_loader``).
    ``device_decode=False`` leaves a bytes-through reader's decode to the
    reader, on the host. ``mesh`` (a sharded loader over several devices)
    raises ``NotImplementedError``: it comes with the multi-GPU slice."""
    if mesh is not None:
        raise NotImplementedError(
            'make_torch_loader(mesh=...) is not ported to petastorm_tpu_torch '
            'yet; sharded loaders come with the multi-GPU slice')
    return TorchDataLoader(reader, batch_size=batch_size,
                           shuffling_queue_capacity=shuffling_queue_capacity,
                           transform_fn=transform_fn, drop_last=drop_last,
                           seed=seed, inmemory_cache_all=inmemory_cache_all,
                           pad_spec=pad_spec, prefetch_depth=prefetch_depth,
                           device=device, device_decode=device_decode)


def epoch_cache_on_device(loader, device=None):
    """Iterate epochs forever, epoch 1 cached on ``device`` (the CUDA device
    unless ``device='cpu'``): the first pass stages each batch's numeric
    columns there and keeps them, later passes replay the same tensors with
    no host work and no copies. Strings and object arrays stay on the host.
    ``loader`` is iterated once."""
    device = resolve_device(device)

    def put(x):
        x = _to_tensor(x, False)
        return x.to(device) if torch.is_tensor(x) else x

    cache = []
    for batch in loader:
        staged = _map(batch, put)
        cache.append(staged)
        yield staged
    if not cache:
        return
    while True:
        yield from cache


def prefetch_to_device(iterator, size=None, device=None, goodput=None,
                       fused_fn=None):
    """Stage up to ``size`` batches (default :func:`resolve_prefetch_depth`)
    ahead of the consumer on a background thread. On a CUDA device each
    tensor leaf is copied from pinned host memory with
    ``non_blocking=True`` on a side stream; the consumer's current stream
    waits on the copy's event and ``record_stream`` keeps the allocator
    from reusing the memory early. ``device='cpu'`` converts numpy leaves
    to tensors and stages nothing. Non-tensor leaves pass through.
    ``goodput`` (a :class:`~petastorm_tpu_torch.goodput.GoodputMonitor`,
    e.g. ``loader.goodput``) gets each staging dispatch's host time.
    ``fused_fn`` (:func:`~petastorm_tpu_torch.ops.decode.build_fused_infeed`)
    runs over each staged batch's tensors on the side stream, after the
    copy and before the event that hands the batch off: the device decode
    of a bytes-through batch overlaps the consumer's step like the copy."""
    device = resolve_device(device)
    size = resolve_prefetch_depth(size)

    def fuse(staged):
        if fused_fn is None or not isinstance(staged, dict):
            return staged
        out = dict(fused_fn({k: v for k, v in staged.items()
                             if torch.is_tensor(v)}))
        out.update({k: v for k, v in staged.items()
                    if not torch.is_tensor(v)})
        return out

    if device.type == 'cpu':
        def put(batch):
            return fuse(_map(batch, lambda x: _to_tensor(x, False))), None
    else:
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
                staged = fuse(_map(batch, stage))
                event = torch.cuda.Event()
                event.record(side)
            return staged, event

    hand_off = None if device.type == 'cpu' else _hand_off(device)
    if goodput is not None:
        untimed = put

        def put(batch):
            start = time.perf_counter()
            out = untimed(batch)
            goodput.note_stage(time.perf_counter() - start)
            return out
    return _pipeline(iterator, size, put, hand_off)


def _hand_off(device):
    def hand_off(staged, event):
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        _map(staged, lambda t: t.record_stream(current)
             if torch.is_tensor(t) and t.is_cuda else None)
    return hand_off


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
