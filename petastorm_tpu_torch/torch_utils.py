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
  buckets under ``pad_spec`` (:mod:`petastorm_tpu_torch.padding`), then a
  ``transform_fn`` runs, and
  ``inmemory_cache_all`` replays epoch 1 from memory. Batches stay on the
  host, in pinned memory when the loader's device is a CUDA device.
- :func:`make_torch_loader` (``make_jax_loader``, :1106-1132) and
  :func:`epoch_cache_on_device` (:1135-1168).
- :func:`prefetch_to_device` (:1193-1300) stages batches ahead of the
  consumer on a background thread: ``non_blocking`` copies from pinned
  memory on a side CUDA stream, handed to the consumer's stream with an
  event and ``record_stream``. Its staging of one batch is
  :func:`stage_to_device` (JAX's ``stage_to_global``), which the
  profiler's staging probe times too.
- Device decode (``jax_utils.py:502-530, 569-573, 1217-1250``): a
  ``TorchDataLoader`` over a columnar reader that planned device decode
  claims the plans. Plain iteration then decodes the raw uint8 grids on
  the loader's device, before ``pad_spec`` and ``transform_fn``;
  :meth:`TorchLoaderBase.iter_prefetched` instead stages the raw grids
  and decodes them on the side stream after the copy
  (``prefetch_to_device(fused_fn=)``), so the raw bytes are what crosses
  PCIe and the decode runs once a batch.
- Lineage (``jax_utils.py:471-480, 563-580, 620-655, 759-763``): with the
  reader's lineage on, each row carries its packed source id
  (:data:`~petastorm_tpu_torch.lineage.LINEAGE_COLUMN`, int64) through the
  shuffling buffer; the loader pops it before the device decode,
  ``pad_spec`` and ``transform_fn`` and puts it back as a
  :class:`~petastorm_tpu_torch.lineage.BatchProvenance` under
  ``batch['_provenance']``, which the staging passes through unstaged.
  NGram batches carry none (a window spans rows).

- The stats, latency and tracing planes (``jax_utils.py:297-393, 528-530,
  587-610, 746, 1001-1100, 1193-1259``): a loader records into its
  reader's ``stats`` and ``tracer`` the ``infeed_wait`` and ``train_step``
  latencies and spans of each step, the ``shuffle_buffer_depth`` gauge,
  ``rows_decoded_device`` of planned columns and, with lineage on,
  ``e2e_batch`` at batch delivery; :func:`prefetch_to_device` records
  ``device_stage_s``, the ``device_stage`` latency and span (the host's
  dispatch of the copies: nothing here waits on the card) and the
  ``prefetch_occupancy`` gauge. :func:`infeed_diagnosis` classifies a
  stats snapshot.
- The health plane (``jax_utils.py:303-307, 1086-1097, 1277-1308``): a
  loader's ``health`` is its reader's
  :class:`~petastorm_tpu_torch.health.HealthMonitor`, and the staging
  thread of :func:`prefetch_to_device` (``health=``) beats as the
  ``loader-prefetch`` entity: ``staging`` while it stages a batch,
  ``backpressured`` while the ring is full, ``idle`` while it waits on
  the loader (so a wedged worker is the one entity named) and ``done``
  at its end. :func:`infeed_diagnosis` (``heartbeats=``) folds the
  pipeline's verdict in, and ``roofline=`` (a ``reader.profile()``) the
  roofline summary.

- Data parallelism (``jax_utils.py:199-210, 786-998``):
  :class:`ShardedTorchLoader` drives a :class:`TorchDataLoader` of this
  rank's local batch (``drop_last``) and stages each batch to the rank's
  device (:func:`stage_to_global`); before every step, once the process
  group has more than one rank, the ranks agree that each has a batch
  (:func:`_all_processes_ready`), so all stop together at the shortest
  rank's stream and a rank with a surplus batch drains its reader
  (``Reader.drain``). The port's global array is the rank's shard and its
  :class:`~petastorm_tpu_torch.parallel.mesh.NamedSharding`
  (``loader.sharding``; :func:`~petastorm_tpu_torch.parallel.mesh.
  gather_global` assembles it). :func:`require_single_bucket_pad_spec`
  keeps the ranks' padded widths equal.
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
from petastorm_tpu_torch.health import (DEFAULT_STALL_AFTER_S,
                                        bottleneck_signals, classify_pipeline)
from petastorm_tpu_torch.lineage import (LINEAGE_COLUMN, PACK_SHIFT,
                                         PROVENANCE_KEY, BatchProvenance,
                                         pack_rows)
from petastorm_tpu_torch.ops.decode import (build_fused_infeed,
                                            split_device_columns)
from petastorm_tpu_torch.padding import (check_pad_spec_fields,
                                         pad_ragged_batch,
                                         require_single_bucket_pad_spec,
                                         validate_pad_spec)
from petastorm_tpu_torch.readers.shuffling_buffer import (
    BatchedNoopShufflingBuffer, BatchedRandomShufflingBuffer,
    NoopShufflingBuffer, RandomShufflingBuffer)
from petastorm_tpu_torch.workers.stats import (batched_decode_fraction,
                                               device_decode_fraction,
                                               readahead_hit_rate,
                                               recommend_io_readahead)

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
    loader.goodput`` to :func:`prefetch_to_device` for the staging time.
    The monitor is registered with the reader (``register_goodput``), whose
    ``/goodput`` and flight records read it. ``health`` is the reader's
    :class:`~petastorm_tpu_torch.health.HealthMonitor` (None for a reader
    without one): :meth:`iter_prefetched` beats its staging thread into
    it; pass ``health=loader.health`` to :func:`prefetch_to_device`.

    ``stats`` and ``tracer`` are the reader's (None for a reader without):
    each step's ``infeed_wait`` (the fetch) and ``train_step`` (the
    consumer's hold of the batch) go into them as latencies and spans, and
    the goodput monitor exports its steps into them."""

    def __init__(self, reader, device=None):
        self.device = resolve_device(device)
        self.reader = reader
        self._in_iter = None
        self._error = None
        self.stats = getattr(reader, 'stats', None)
        self.tracer = getattr(reader, 'tracer', None)
        #: Lookahead of :meth:`iter_prefetched`; subclasses set it from
        #: their ``prefetch_depth`` knob.
        self.prefetch_depth = resolve_prefetch_depth(None)
        self.health = getattr(reader, 'health', None)
        self.goodput = (GoodputMonitor(stats=self.stats, tracer=self.tracer)
                        if goodput_enabled() else None)
        register = getattr(reader, 'register_goodput', None)
        if register is not None and self.goodput is not None:
            register(self.goodput)

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
                                      goodput=self.goodput, fused_fn=fused,
                                      stats=self.stats, tracer=self.tracer,
                                      health=self.health)
        return _pipeline(iter(self), self.prefetch_depth,
                         lambda batch: (batch, None), None, self.stats,
                         self.health)

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
        tracer = self.tracer
        latency = getattr(self.stats, 'latency', None)
        try:
            if goodput is None and tracer is None and latency is None:
                yield from self._iter_impl(decode)
            else:
                it = self._iter_impl(decode)
                fetch_start = time.perf_counter()
                for batch in it:
                    now = time.perf_counter()
                    if latency is not None:
                        latency.record('infeed_wait', now - fetch_start)
                    if tracer is not None:
                        tracer.add_span('infeed_wait', 'consumer',
                                        fetch_start, now - fetch_start)
                    if goodput is not None:
                        goodput.note_fetch(now - fetch_start, batch)
                    step_start = now
                    yield batch
                    # the consumer held the generator suspended for its
                    # train step; the step's end starts the next fetch
                    fetch_start = time.perf_counter()
                    step_s = fetch_start - step_start
                    if latency is not None:
                        latency.record('train_step', step_s)
                    if tracer is not None:
                        tracer.add_span('train_step', 'consumer',
                                        step_start, step_s)
                    if goodput is not None:
                        goodput.finish_step(step_s)
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
    ``pad_spec`` pads, stay numpy. With the reader's lineage on, a batch
    outside NGram also holds ``'_provenance'``, a
    :class:`~petastorm_tpu_torch.lineage.BatchProvenance` naming each row's
    source (``reader.replay(batch)`` fetches the rows again).

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
        #: the reader's lineage tracker; rows carry their packed source ids
        #: when it is on (not NGram windows: a window spans rows)
        self._lineage = getattr(reader, 'lineage', None)
        self._lineage_on = (self._ngram is None
                            and getattr(self._lineage, 'enabled', False))
        #: ``e2e_batch`` (ventilation of a batch's oldest source item to the
        #: batch) is recorded here, the last delivery point, so the reader
        #: records none (JAX ``jax_utils.py:485-493``)
        self._e2e_on = (self._lineage_on
                        and getattr(self.stats, 'latency', None) is not None)
        if self._e2e_on:
            defer = getattr(reader, '_defer_e2e_to_loader', None)
            if defer is not None:
                defer()
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
        return self._fused_counted

    def _fused_counted(self, columns):
        """The fused decode, its planned cells counted as
        ``rows_decoded_device`` (JAX ``jax_utils.py:526-530``)."""
        planned = [n for n in self._device_plans if n in columns]
        if planned and self.stats is not None:
            rows = int(columns[planned[0]].shape[0])
            self.stats.add('rows_decoded_device', rows * len(planned))
        return self._fused(columns)

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
        out = dict(self._fused_counted(staged))
        out.update(host_cols)
        return out

    def _iter_impl(self, decode=True):
        if self._cache_complete:
            yield from self._cache
            return
        if self._cache is not None:
            self._cache = []        # an abandoned pass may have left some
        for batch in self._collated():
            # the source column never reaches the decode, the padding, the
            # user's transform or the card: it comes back as provenance
            sources = (batch.pop(LINEAGE_COLUMN, None) if self._lineage_on
                       else None)
            if self._fused is not None and decode:
                batch = self._decode(batch)
            if self.pad_spec:
                batch = pad_ragged_batch(batch, self.pad_spec)
            batch = self._tensors(batch)
            if self.transform_fn is not None:
                batch = self.transform_fn(batch)
            if sources is not None and isinstance(batch, dict):
                batch[PROVENANCE_KEY] = BatchProvenance(sources, self._lineage)
                if self._e2e_on and len(sources):
                    # the smallest seq is the earliest registered item
                    ts = self._lineage.ventilated_ts(
                        int(np.asarray(sources).min()) >> PACK_SHIFT)
                    if ts is not None:
                        self.stats.record_latency(
                            'e2e_batch', time.perf_counter() - ts)
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
        if self._lineage_on:
            reader = self.reader

            def prepare(row):
                row = row._asdict()
                if reader.last_seq is not None:
                    row[LINEAGE_COLUMN] = ((reader.last_seq << PACK_SHIFT)
                                           | reader.last_row_offset)
                return row
            return self._iter_rows(prepare, _collate)
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
        lineage_on = self._lineage_on
        for item in self.reader:
            columns = item._asdict()
            n = len(next(iter(columns.values()))) if columns else 0
            if lineage_on and n and self.reader.last_seq is not None:
                # one int64 column a row group: the rows' packed source ids
                columns[LINEAGE_COLUMN] = pack_rows(self.reader.last_seq, n)
            yield columns

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
        stats = self.stats
        for columns in column_stream:
            while not buffer.can_add():
                yield buffer.retrieve()
            buffer.add_many(columns)
            if stats is not None:
                stats.gauge('shuffle_buffer_depth', buffer.size)
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

        stats = self.stats
        for count, row in enumerate(self.reader):
            while not buffer.can_add():
                yield from drain(False)
                if not buffer.can_retrieve():
                    break
            buffer.add_many([prepare(row)])
            # one gauge sample in 64 rows: a lock a row would tax the path
            if stats is not None and count % 64 == 0:
                stats.gauge('shuffle_buffer_depth', buffer.size)
            yield from drain(False)
        buffer.finish()
        yield from drain(True)


def _collate(rows):
    """Rows (dicts) → column arrays: stacked where every value has one
    shape and a numeric dtype, else an object array of the values."""
    out = {}
    for key in rows[0]:
        if key == LINEAGE_COLUMN:
            out[key] = np.fromiter((r[key] for r in rows), dtype=np.int64,
                                   count=len(rows))
            continue
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


def _device_column(value) -> bool:
    """Whether a batch column can live on the device: a tensor, or a
    numpy array that is not strings, bytes or objects."""
    if torch.is_tensor(value):
        return True
    return getattr(value, 'dtype', np.dtype(object)).kind not in 'USO'


_SIDE_STREAMS = {}


def _side_stream(device):
    """One staging stream a CUDA device, made on first use."""
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


def stage_to_global(batch, sharding, stats=None, tracer=None, fused_fn=None,
                    goodput=None):
    """Stage this rank's local batch, its shard of the global batch under
    ``sharding`` (a :class:`~petastorm_tpu_torch.parallel.mesh.
    NamedSharding`), to the rank's device: the port's counterpart of JAX's
    ``stage_to_global`` (``jax_utils.py:956-998``). Numeric columns go
    through the pinned side-stream path (:func:`stage_to_device`) and the
    consumer's stream waits on the copy's event; strings, objects and the
    ``'_provenance'`` record ride under ``batch['_host']`` untouched.
    ``fused_fn`` (a device decode, :func:`~petastorm_tpu_torch.ops.decode.
    build_fused_infeed`) runs over the staged columns on the side stream.
    The device is the mesh's (``'cuda'``: the current card). ``stats`` gets the host time as ``device_stage_s`` and a
    ``device_stage`` latency, ``tracer`` a ``device_stage`` span and
    ``goodput`` the step's ``h2d_stage`` leg, as JAX feeds them."""
    timed = stats is not None or tracer is not None or goodput is not None
    start = time.perf_counter() if timed else 0.0
    device = torch.device(sharding.mesh.device_type)
    if device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())
    columns, host = {}, {}
    for name, value in batch.items():
        if name != PROVENANCE_KEY and _device_column(value):
            columns[name] = value
        else:
            host[name] = value
    stream = _side_stream(device) if device.type == 'cuda' else None
    staged, event = stage_to_device(columns, device, stream, fused_fn)
    if event is not None:
        _hand_off(device)(staged, event)
    staged = dict(staged)
    if host:
        staged['_host'] = host
    if timed:
        elapsed = time.perf_counter() - start
        if stats is not None:
            stats.add_time('device_stage_s', elapsed)
            stats.record_latency('device_stage', elapsed)
        if tracer is not None:
            tracer.add_span('device_stage', 'device', start, elapsed)
        if goodput is not None:
            goodput.note_stage(elapsed)
    return staged


def _all_processes_ready(local_ready: bool) -> bool:
    """True iff EVERY rank of the default process group has a next batch:
    one ``all_reduce(MIN)`` of one int a step (JAX ``jax_utils.py:945-953``
    allgathers a flag). The flag lives on the card under NCCL, on the host
    under gloo."""
    import torch.distributed as dist
    on = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    flag = torch.tensor([1 if local_ready else 0], dtype=torch.int32,
                        device=on)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


class ShardedTorchLoader(TorchLoaderBase):
    """This rank's share of a global batch, staged to its device, over a
    mesh (JAX ``ShardedJaxLoader``, ``jax_utils.py:786-942``).

    One process a device: each rank reads its own reader (e.g. its shard,
    ``shard_by_jax_process=True``) and batches ``local_batch_size`` items;
    the global batch is ``local_batch_size`` times the ``batch_axis`` size
    (``loader.sharding`` says which slice this rank holds). ``drop_last`` is
    forced True, and once the process group has more than one rank every
    step is preceded by a readiness ``all_reduce``, so all ranks yield the
    same number of steps even when row-group sharding is unbalanced (9 row
    groups over 2 ranks): a rank with a surplus batch drains its reader
    (``Reader.drain``; under ``inmemory_cache_all`` it runs its stream out
    instead, as the cache replays it) and stops, where entering the next
    step's collectives alone would hang the others.

    String and object columns cannot live on the device; they come under
    ``batch['_host']``. NGram readers keep the nested ``{offset: {field:
    tensor}}`` layout, each timestep staged.

    Device decode: this loader claims a bytes-through reader's plans and
    decodes after the staging, on the rank's device, unless a host stage
    needs the decoded values first: with a ``transform_fn``, or a
    ``pad_spec`` naming a planned column, it declines (JAX's log words) and
    the reader decodes on the host.
    """

    def __init__(self, reader, mesh, local_batch_size, batch_axis='data',
                 shuffling_queue_capacity=0, transform_fn=None, seed=None,
                 inmemory_cache_all=False, pad_spec=None,
                 prefetch_depth=None):
        from petastorm_tpu_torch.parallel.mesh import batch_sharding
        super().__init__(reader, mesh.device_type)
        self._ngram = getattr(reader, 'ngram', None)
        self.mesh = mesh
        self.batch_axis = batch_axis
        normalized_pad_spec = validate_pad_spec(pad_spec)
        require_single_bucket_pad_spec(normalized_pad_spec,
                                       'ShardedTorchLoader')
        # device_decode=False: this loader claims the raw columns and
        # decodes them after the staging, on the rank's device
        self._loader = TorchDataLoader(
            reader, batch_size=local_batch_size,
            shuffling_queue_capacity=shuffling_queue_capacity,
            transform_fn=transform_fn, drop_last=True, seed=seed,
            inmemory_cache_all=inmemory_cache_all, pad_spec=pad_spec,
            prefetch_depth=prefetch_depth, device=self.device,
            device_decode=False)
        self.sharding = batch_sharding(mesh, batch_axis)
        self.stats = self._loader.stats
        self.prefetch_depth = self._loader.prefetch_depth
        if self.goodput is not None:
            # the inner loader is driven through _iter_impl, past its own
            # monitor: the outer one is live, shared with the staging
            self._loader.goodput = self.goodput
            register = getattr(reader, 'register_goodput', None)
            if register is not None:
                register(self.goodput)
        self._device_plans = {}
        self._device_fused_fn = None
        claim = getattr(reader, '_defer_device_decode_to_loader', None)
        available_plans = getattr(reader, 'device_decode_plans', None)
        if claim is not None and available_plans:
            padded_planned = sorted(set(normalized_pad_spec or {})
                                    & set(available_plans))
            if transform_fn is not None:
                logger.info(
                    'ShardedTorchLoader: transform_fn needs decoded host '
                    'columns; declining the bytes-through claim (the reader '
                    'host-decodes). Use a TransformSpec(device=True) on the '
                    'reader to keep decode on the accelerator.')
            elif padded_planned:
                logger.info(
                    'ShardedTorchLoader: pad_spec names device-planned '
                    'columns %s which pad before staging; declining the '
                    'bytes-through claim (the reader host-decodes).',
                    padded_planned)
            else:
                plans, device_spec = claim()
                if plans:
                    self._device_plans = plans
                    self._device_fused_fn = build_fused_infeed(plans,
                                                               device_spec)

    def _cache_hot(self):
        return self._loader._cache_hot()

    def _iter_impl(self, decode=True):
        import torch.distributed as dist
        lockstep = dist.is_initialized() and dist.get_world_size() > 1
        it = self._loader._iter_impl(decode=False)
        while True:
            batch = next(it, None)
            if lockstep:
                if not _all_processes_ready(batch is not None):
                    # drain the surplus before stopping: a stream abandoned
                    # mid-epoch would leave the reader unresettable. The
                    # epoch cache needs the whole stream (it replays it);
                    # otherwise the items are dropped undecoded.
                    drain = getattr(self.reader, 'drain', None)
                    if self._loader.inmemory_cache_all or drain is None:
                        for _ in it:
                            pass
                    else:
                        drain()
                    return
            elif batch is None:
                return
            kw = dict(stats=self.stats, tracer=self.tracer,
                      goodput=self.goodput)
            if self._ngram is not None:
                yield {off: stage_to_global(cols, self.sharding, **kw)
                       for off, cols in batch.items()}
                continue
            if self._device_plans and self.stats is not None:
                planned = [n for n in self._device_plans if n in batch]
                if planned:
                    self.stats.add('rows_decoded_device',
                                   int(batch[planned[0]].shape[0])
                                   * len(planned))
            yield stage_to_global(batch, self.sharding,
                                  fused_fn=self._device_fused_fn, **kw)


def make_torch_loader(reader, batch_size=1, mesh=None, batch_axis='data',
                      shuffling_queue_capacity=0, transform_fn=None,
                      drop_last=False, seed=None, inmemory_cache_all=False,
                      pad_spec=None, prefetch_depth=None, device=None,
                      device_decode=True):
    """A :class:`TorchDataLoader` over ``reader`` (JAX ``make_jax_loader``,
    ``jax_utils.py:1106-1132``), or with ``mesh`` a
    :class:`ShardedTorchLoader` whose ``batch_size`` is this rank's share
    (the global batch is ``batch_size`` times the ``batch_axis`` size; its
    ``drop_last`` is always on, it claims a device decode itself, and its
    device is the mesh's). ``device_decode=False`` leaves a bytes-through
    reader's decode to the reader, on the host."""
    if mesh is not None:
        return ShardedTorchLoader(
            reader, mesh, batch_size, batch_axis=batch_axis,
            shuffling_queue_capacity=shuffling_queue_capacity,
            transform_fn=transform_fn, seed=seed,
            inmemory_cache_all=inmemory_cache_all, pad_spec=pad_spec,
            prefetch_depth=prefetch_depth)
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


def infeed_diagnosis(snapshot: dict, heartbeats=None, stall_after_s=None,
                     roofline=None, latency=None, slo=None) -> dict:
    """Classify an infeed from a ``ReaderStats`` snapshot
    (``reader.diagnostics``) and name the knob that attacks its bottleneck
    (JAX ``jax_utils.py:1001-1100``): ``io`` (raise ``io_readahead``),
    ``decode`` (raise ``workers_count``), ``consumer`` (the step is the
    ceiling), ``balanced`` or ``tail-stall``, through
    :func:`~petastorm_tpu_torch.health.bottleneck_signals`.

    ``latency`` (``reader.latency``) adds per-stage percentiles; ``slo`` (a
    :meth:`~petastorm_tpu_torch.latency.SLOMonitor.evaluate` verdict) is
    embedded. ``heartbeats`` (``reader.health.heartbeats()``) folds the
    live health plane in: ``pipeline_state`` and ``stalled_entities`` from
    :func:`~petastorm_tpu_torch.health.classify_pipeline` (the watchdog's
    and ``/healthz``'s classification) over ``stall_after_s`` (default
    :data:`~petastorm_tpu_torch.health.DEFAULT_STALL_AFTER_S`), and a
    stalled entity overrides ``bottleneck`` with ``'stalled'``.
    ``roofline`` (a :meth:`~petastorm_tpu_torch.reader.Reader.profile`
    result or its :func:`~petastorm_tpu_torch.profiler.roofline_summary`)
    adds a ``roofline`` section: the measured rate as a fraction of the
    binding stage's calibrated ceiling."""
    signals = bottleneck_signals(snapshot)
    io_s, decode_s = signals['io_s'], signals['decode_s']
    out = {
        'bottleneck': signals['bottleneck'],
        'io_s': round(io_s, 4),
        'decode_s': round(decode_s, 4),
        'io_decode_ratio': round(io_s / decode_s, 3) if decode_s else None,
        'io_overlap_fraction': snapshot.get('io_overlap_fraction', 0.0),
        'readahead_hit_rate': readahead_hit_rate(snapshot),
        'recommended_io_readahead': recommend_io_readahead(snapshot),
        'rows_quarantined': snapshot.get('rows_quarantined', 0),
        'rows_decoded_batched': snapshot.get('rows_decoded_batched', 0),
        'rows_decoded_percell': snapshot.get('rows_decoded_percell', 0),
        'batched_decode_fraction': batched_decode_fraction(snapshot),
        # one block on the device side: decode placement, goodput and the
        # prefetch ring answer "is the card fed?"
        'device': {
            'rows_decoded_device': snapshot.get('rows_decoded_device', 0),
            'bytes_shipped_raw': snapshot.get('bytes_shipped_raw', 0),
            'device_decode_fraction': device_decode_fraction(snapshot),
            'goodput_fraction': snapshot.get('goodput_fraction'),
            'data_stall_fraction': snapshot.get('data_stall_fraction'),
            'prefetch_occupancy': snapshot.get('prefetch_occupancy', 0),
            'prefetch_occupancy_max': snapshot.get('prefetch_occupancy_max',
                                                   0),
        },
        'queue_wait_p50_s': round(snapshot.get('queue_wait_p50_s', 0.0), 6),
        'queue_wait_p99_s': round(snapshot.get('queue_wait_p99_s', 0.0), 6),
        'e2e_latency_p99_s': round(snapshot.get('e2e_latency_p99_s', 0.0), 6),
        'hint': signals['hint'],
    }
    if signals.get('tail_stall'):
        out['tail_stall'] = True
    if latency is not None:
        out['latency'] = latency.summary()
    if slo is not None:
        out['slo'] = slo
    if heartbeats is not None:
        verdict = classify_pipeline(
            heartbeats, snapshot,
            DEFAULT_STALL_AFTER_S if stall_after_s is None else stall_after_s)
        out['pipeline_state'] = verdict['state']
        out['stalled_entities'] = verdict['stalled_entities']
        if verdict['state'] == 'stalled':
            # a wedged entity trumps the aggregate signals: the time sums
            # stop moving when the stall starts
            out['bottleneck'] = 'stalled'
            out['hint'] = verdict['hint']
    if roofline is not None:
        from petastorm_tpu_torch.profiler import roofline_summary
        out['roofline'] = (roofline_summary(roofline)
                           if roofline.get('kind') ==
                           'petastorm_tpu_roofline_profile' else roofline)
    return out


def _stage_leaf(x, device):
    """One leaf staged to CUDA ``device``: a numpy numeric column copied
    into a pinned tensor, a CPU tensor pinned, either copied to the device
    with ``non_blocking=True``; anything else as it is."""
    if isinstance(x, np.ndarray):
        x = _to_tensor(x, True)
    if not torch.is_tensor(x) or x.device == device:
        return x
    if x.device.type == 'cpu' and not x.is_pinned():
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def _fuse(fused_fn, staged):
    """``fused_fn`` over a staged batch's tensors, its other leaves kept."""
    if fused_fn is None or not isinstance(staged, dict):
        return staged
    out = dict(fused_fn({k: v for k, v in staged.items()
                         if torch.is_tensor(v)}))
    out.update({k: v for k, v in staged.items() if not torch.is_tensor(v)})
    return out


def stage_to_device(batch, device, stream=None, fused_fn=None):
    """Stage one batch to ``device``: ``(staged batch, event)``, the port's
    counterpart of JAX's ``stage_to_global``, run by
    :func:`prefetch_to_device` and timed by the profiler's staging probe.

    On a CUDA ``device`` (with an index) each leaf is staged on ``stream``
    (:func:`_stage_leaf`: pinned allocation and copy, then a
    ``non_blocking`` copy), ``fused_fn`` runs over the staged tensors on
    that stream, and ``event`` is recorded on it after them: waiting on
    it (``event.synchronize()``, or a stream's ``wait_event``) waits for
    this batch alone. On the CPU the numpy leaves become tensors and
    ``event`` is None."""
    if device.type == 'cpu':
        return _fuse(fused_fn, _map(batch, lambda x: _to_tensor(x, False))), \
            None
    with torch.cuda.stream(stream):
        staged = _fuse(fused_fn, _map(batch, lambda x: _stage_leaf(x, device)))
        event = torch.cuda.Event()
        event.record(stream)
    return staged, event


def prefetch_batches(iterator, size=None, health=None, stats=None):
    """Host lookahead without device staging (JAX ``jax_utils.py:1171``): a
    background thread keeps up to ``size`` batches (default
    :func:`resolve_prefetch_depth`) ready as they come, and the consumer's
    step moves each batch to the device itself. No side stream, no pinning
    and no event: the batches are the iterator's own. ``health`` (a
    :class:`~petastorm_tpu_torch.health.HealthMonitor`, e.g.
    ``reader.health``) gets the thread's beats as the ``loader-prefetch``
    entity; ``stats`` (a ``ReaderStats``) the ring's depth as the
    ``prefetch_occupancy`` gauge, whose empty reading at step boundaries is
    the starving signal. :func:`prefetch_to_device` is the staging
    counterpart, for batches large enough that the copy is worth
    overlapping on a side stream."""
    return _pipeline(iterator, resolve_prefetch_depth(size),
                     lambda batch: (batch, None), None, stats, health)


def prefetch_to_device(iterator, size=None, device=None, goodput=None,
                       fused_fn=None, stats=None, tracer=None, health=None):
    """Stage up to ``size`` batches (default :func:`resolve_prefetch_depth`)
    ahead of the consumer on a background thread. On a CUDA device each
    tensor leaf is copied from pinned host memory with
    ``non_blocking=True`` on a side stream; the consumer's current stream
    waits on the copy's event and ``record_stream`` keeps the allocator
    from reusing the memory early. ``device='cpu'`` converts numpy leaves
    to tensors and stages nothing. Non-tensor leaves pass through.
    ``goodput`` (a :class:`~petastorm_tpu_torch.goodput.GoodputMonitor`,
    e.g. ``loader.goodput``) gets each staging dispatch's host time. A
    batch's ``'_provenance'`` passes through unstaged.
    ``fused_fn`` (:func:`~petastorm_tpu_torch.ops.decode.build_fused_infeed`)
    runs over each staged batch's tensors on the side stream, after the
    copy and before the event that hands the batch off: the device decode
    of a bytes-through batch overlaps the consumer's step like the copy.
    ``stats`` (a ``ReaderStats``, e.g. ``reader.stats``) gets each
    staging dispatch's host time as ``device_stage_s`` and a
    ``device_stage`` latency, and the ring's depth as the
    ``prefetch_occupancy`` gauge; ``tracer`` a ``device_stage`` span on the
    staging thread's track. The time is the host's dispatch of the
    ``non_blocking`` copies: nothing here waits on the card. ``health`` (a
    :class:`~petastorm_tpu_torch.health.HealthMonitor`, e.g.
    ``reader.health``) gets the staging thread's heartbeats as the
    ``loader-prefetch`` entity."""
    device = resolve_device(device)
    size = resolve_prefetch_depth(size)
    side = None
    if device.type == 'cuda':
        if device.index is None:     # 'cuda' names the current device
            device = torch.device('cuda', torch.cuda.current_device())
        side = torch.cuda.Stream(device=device)

    def put(batch):
        return stage_to_device(batch, device, side, fused_fn)

    hand_off = None if device.type == 'cpu' else _hand_off(device)
    if goodput is not None or stats is not None or tracer is not None:
        untimed = put

        def put(batch):
            start = time.perf_counter()
            out = untimed(batch)
            elapsed = time.perf_counter() - start
            if stats is not None:
                stats.add_time('device_stage_s', elapsed)
                stats.record_latency('device_stage', elapsed)
            if tracer is not None:
                tracer.add_span('device_stage', 'device', start, elapsed)
            if goodput is not None:
                goodput.note_stage(elapsed)
            return out
    return _pipeline(iterator, size, put, hand_off, stats, health)


def _hand_off(device):
    def hand_off(staged, event):
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        _map(staged, lambda t: t.record_stream(current)
             if torch.is_tensor(t) and t.is_cuda else None)
    return hand_off


def _pipeline(iterator, size, put, hand_off, stats=None, health=None):
    """Producer thread filling a ring of ``size`` staged batches; it waits
    for a free slot before staging the next batch, so at most ``size`` sit
    staged beside the one the consumer holds. Producer exceptions re-raise in
    the consumer; closing the generator stops the producer and joins it.
    ``stats`` gets the ring's depth at every put and take as the
    ``prefetch_occupancy`` gauge (read under the ring's lock, recorded
    outside it). ``health`` gets the producer's beats as the
    ``loader-prefetch`` entity (JAX ``jax_utils.py:1277-1308``; the port
    waits for the slot before it stages, so a full ring beats
    ``backpressured`` before ``staging``, not after)."""
    ring = collections.deque()
    done = object()
    cv = threading.Condition()
    state = {'error': None, 'finished': False}
    gauge = stats.gauge if stats is not None else None
    beat = health.beat if health is not None else None

    def producer():
        try:
            for batch in iterator:
                with cv:
                    if beat is not None and len(ring) >= size:
                        # a full ring: the consumer is the slow side, an
                        # idle-class stage, never a staging stall
                        beat('loader-prefetch', 'backpressured')
                    while len(ring) >= size and not state['finished']:
                        cv.wait()
                    if state['finished']:
                        return
                if beat is not None:
                    beat('loader-prefetch', 'staging')
                # only this thread appends, so the slot stays free
                staged = put(batch)
                with cv:
                    if state['finished']:
                        return
                    ring.append(staged)
                    depth = len(ring)
                    cv.notify_all()
                if gauge is not None:
                    gauge('prefetch_occupancy', depth)
                if beat is not None:
                    # what follows is the wait on the loader: idle, so a
                    # wedged worker is the entity a stall names
                    beat('loader-prefetch', 'idle')
        except Exception as e:     # re-raised in the consumer
            state['error'] = e
        finally:
            if beat is not None:
                beat('loader-prefetch', 'done')
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
                    # the end marker is no staged batch: a drained ring
                    # reads 0
                    depth = len(ring) - (1 if ring and ring[-1] is done
                                         else 0)
                    cv.notify_all()
                if item is done:
                    if state['error'] is not None:
                        raise state['error']
                    return
                if gauge is not None:
                    gauge('prefetch_occupancy', depth)
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
