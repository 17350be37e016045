"""Readers of the port over local and remote stores.

Counterparts of ``petastorm_tpu/reader.py`` ``make_reader`` (:210),
``make_columnar_reader`` (:352-427), ``make_batch_reader`` (:430-486) and
``Reader`` (:489): its selection of row groups (``_filter_row_groups``
:952-1026) and its ventilation (:646-663). A reader lists the store's
row-group pieces, prunes them (a predicate on partition keys only, then
``filters`` on partition values and on footer statistics, then a
``rowgroup_selector``, then ``cur_shard``/``shard_count`` over what is
left), and ventilates one work item per piece and row-drop partition
(seeded shuffle, epochs) into a thread pool whose workers read and decode
each row group column-wise. A row predicate (the user's that needs stored
columns, and the residual of ``filters`` specialised to the piece) runs on
the workers. ``decode_hints`` decode jpeg fields at a reduced resolution
(``_relax_hinted_shapes`` :140-161, applied :617-626). The pool is a
thread pool, a pool of worker processes over ZeroMQ or a pool that runs
items on the consumer's thread (``reader_pool_type``; ``_make_pool``
:116-130). A columnar reader plans device decode (:750-783): its
fixed-shape ``NdarrayCodec`` columns travel as raw uint8 grids that a
loader claiming them decodes on its device
(:meth:`Reader._defer_device_decode_to_loader`), or that the reader
decodes on the host when none does (:meth:`Reader._host_decode_raw`). A
reader yields one of five kinds of item:

- ``make_reader(url, schema_fields=NGram(...))``: NGram window chunks,
  through :meth:`Reader.iter_ngram_chunks` (``ngram_chunked``: no row
  predicate, residual filter or transform, as :941-944);
- the same with a row predicate, residual filters or a transform: one
  ``{offset: namedtuple}`` window per ``next(reader)``;
- ``make_reader(url, schema_fields=[...] or None)``: one schema namedtuple
  per row, after an optional per-row
  :class:`~petastorm_tpu_torch.transform.TransformSpec`;
- ``make_columnar_reader(url, ...)``: one namedtuple of decoded column
  arrays per row group (``batched_output``), after an optional columnar
  transform;
- ``make_batch_reader(url or [file urls], ...)``: one namedtuple of column
  arrays per row group of any Parquet store, as arrow stores them
  (``batched_output``), after an optional pandas transform.

Each pool worker reads through its own
:class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorker`: a cache of
open Parquet files, ``io_readahead`` (a background thread that reads the
worker's next row groups while it decodes the current one) and the
row-group cache of ``cache_type`` (:func:`_make_cache` :81-113).

Sample lineage (:mod:`petastorm_tpu_torch.lineage`, JAX :501-518,
681-725, 1140-1150, 1327-1384), on unless ``PETASTORM_TPU_LINEAGE=0``:
every item the reader yields has a provenance record
(:attr:`Reader.last_provenance`), ``reader.lineage`` keeps per-epoch
ledgers of what was ventilated and delivered, :meth:`Reader.audit` checks
exactly-once delivery, :meth:`Reader.replay` fetches recorded rows again,
and ``on_decode_error='quarantine'`` (or ``'skip'``) drops the rows of a
corrupt cell or a failing transform instead of raising, recording them in
``reader.lineage.quarantines()``.

The stats, latency and tracing planes (JAX :133-137, 501-534, 699-785,
812-824, 1040-1048, 1390-1504): ``reader.stats`` is the pool's
:class:`~petastorm_tpu_torch.workers.stats.ReaderStats` (its latency
histograms ``reader.latency``, None under ``PETASTORM_TPU_LATENCY=0``),
``reader.diagnostics`` a snapshot of it, ``reader.tracer`` the span ring
of ``trace=`` (or ``PETASTORM_TPU_TRACE``), exported as a Chrome trace at
:meth:`Reader.join` when ``trace`` names a file; ``metrics_interval`` and
``metrics_out`` start a :class:`~petastorm_tpu_torch.tracing.MetricsEmitter`
and ``slo`` a :class:`~petastorm_tpu_torch.latency.SLOMonitor`
(``reader.slo``).

The live health plane (:mod:`petastorm_tpu_torch.health`, JAX :515-517,
578-583, 738, 862-933, 1154-1240, 1389-1490): ``reader.health`` merges the
heartbeats of the ventilator, the pool's workers and their readahead
threads, and of a staging thread given ``health=reader.health``.
``stall_timeout=S`` starts a :class:`~petastorm_tpu_torch.health.
PipelineWatchdog` (``reader.watchdog``) that writes a flight record into
``flight_record_dir`` once per stall episode (:meth:`Reader.
dump_flight_record`); ``debug_port=N`` (or ``PETASTORM_TPU_DEBUG_PORT``)
serves a :class:`~petastorm_tpu_torch.health.DebugServer` on
``127.0.0.1:N`` (``reader.debug_port``; 0 binds a free port).

The roofline profiler and the autotune controller
(:mod:`petastorm_tpu_torch.profiler`, :mod:`petastorm_tpu_torch.autotune`;
JAX :535-543, 741-749, 786, 825-862, 905-916, 1186-1212, 1244-1326,
1394-1397, 1460): :meth:`Reader.profile` judges the measured rate against
per-stage ceilings calibrated on this host, dataset and device,
:meth:`Reader.explain_throughput` says it in a sentence, and
``autotune=True`` (or an options dict) starts a
:class:`~petastorm_tpu_torch.autotune.PipelineController` (``reader.
autotune``) that resizes the pool, sets the readahead depth, the
ventilation window and the results queue's bound live. Their gauges join
``/metrics``, ``/profile`` and ``/autotune`` serve them, and flight
records carry their ``roofline`` and ``autotune`` sections.

Fault tolerance (:mod:`petastorm_tpu_torch.resilience`, JAX :118-126,
285-330, 405-408, 465-468, 519-523): ``retry`` (on by default), ``hedge``
(off) and ``worker_recovery`` (on) are resolved in each factory, so a typo
fails it; retry and hedge ride the worker spec as plain dicts, and
recovery reaches the thread and process pools.

Remote stores (:mod:`petastorm_tpu_torch.fs`, JAX :311, 388, 454, 548,
585): a dataset URL resolves to a filesystem and a path
(``storage_options`` go to the filesystem), the reader reads the store's
metadata and footers through it, and the workers make theirs from its
picklable factory. ``remote_read`` picks the workers' read plane
(:mod:`petastorm_tpu_torch.objectstore`): ``'serial'``, ``'prebuffer'``
or ``'ranged'``; None or ``'auto'`` is ``prebuffer`` on a remote store and
``serial`` on a local one.

Not ported yet (each raises ``NotImplementedError``): JAX-process and
elastic sharding.
"""

from __future__ import annotations

import copy
import functools
import hashlib
import logging
import os
import tempfile
import time

from petastorm_tpu_torch.cache import LocalDiskCache, NullCache
from petastorm_tpu_torch import profiler
from petastorm_tpu_torch.autotune import (HostArbiter, PipelineController,
                                          ReaderActuators, resolve_autotune,
                                          scratch_dir)
from petastorm_tpu_torch.codecs import build_decode_overrides
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import (infer_or_load_unischema,
                                                      load_row_groups)
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
from petastorm_tpu_torch.filters import (FiltersPredicate,
                                         RowGroupStatsEvaluator,
                                         filter_column_names,
                                         normalize_filters,
                                         validate_filter_types)
from petastorm_tpu_torch.fs import (FilesystemFactory,
                                    get_filesystem_and_path_or_paths,
                                    normalize_dataset_url_or_urls)
from petastorm_tpu_torch.health import (DEFAULT_STALL_AFTER_S, DebugServer,
                                        HealthMonitor, PipelineWatchdog,
                                        build_flight_record,
                                        classify_pipeline, resolve_debug_port,
                                        write_flight_record)
from petastorm_tpu_torch.latency import SLOMonitor, validate_slo_targets
from petastorm_tpu_torch.lineage import (BatchProvenance, CoverageAuditor,
                                         LineageTracker, batch_provenance_of,
                                         lineage_enabled, unwrap_envelope,
                                         validate_decode_error_policy)
from petastorm_tpu_torch.lineage import replay as _lineage_replay
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.objectstore import resolve_remote_read
from petastorm_tpu_torch.ops.decode import decode_raw_host, plan_device_decode
from petastorm_tpu_torch.predicates import in_reduce
from petastorm_tpu_torch.readers.batch_worker import (BatchResultsReader,
                                                      load_batch_item,
                                                      plan_batch)
from petastorm_tpu_torch.readers.columnar_worker import (
    load_columnar, load_window_chunk, plan_columnar, plan_window_chunk,
    transform_fingerprint)
from petastorm_tpu_torch.readers.piece_worker import (PieceWorkerSpec,
                                                      cache_key_format)
from petastorm_tpu_torch.readers.readahead import (AUTO_INITIAL_DEPTH,
                                                   AUTO_MAX_DEPTH)
from petastorm_tpu_torch.readers.row_worker import load_row_item, plan_rows
from petastorm_tpu_torch.resilience import (resolve_hedge, resolve_recovery,
                                            resolve_retry)
from petastorm_tpu_torch.tracing import MetricsEmitter, Tracer, resolve_trace
from petastorm_tpu_torch.transform import (apply_columnar_transform,
                                           transform_schema)
from petastorm_tpu_torch.unischema import (Unischema, UnischemaField,
                                           match_unischema_fields)
from petastorm_tpu_torch.utils import cast_partition_value
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.serializers import (ArrowTableSerializer,
                                                     ZeroCopySerializer)
from petastorm_tpu_torch.workers.stats import device_decode_fraction
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     ThreadPool, WorkItem)

logger = logging.getLogger(__name__)

#: Parameters of the JAX package's factories that the port does not take
#: yet, with the later slice that brings them (none are left).
_UNPORTED = {}


def _refuse_unported(factory, options):
    """``NotImplementedError`` for a parameter of the JAX package's factory
    that the port does not take yet, ``TypeError`` for an unknown one."""
    for name in options:
        if name not in _UNPORTED:
            raise TypeError('{}() got an unexpected keyword argument {!r}'
                            .format(factory, name))
        raise NotImplementedError(
            '{}({}=...) is not ported to petastorm_tpu_torch yet; it comes '
            'with the {} slice'.format(factory, name, _UNPORTED[name]))


def _resolve_shard(cur_shard, shard_count, shard_by_jax_process=False,
                   elastic=None):
    """``(cur_shard, shard_count)`` as JAX's ``_resolve_jax_shard``
    resolves them: with ``elastic=``, this host's place in the pod's live
    membership (:func:`~petastorm_tpu_torch.podelastic.resolve_elastic_shard`;
    the arguments as given under ``PETASTORM_TPU_ELASTIC=0``); with
    ``shard_by_jax_process``, this rank and the world size of the
    ``torch.distributed`` process group, ``(0, 1)`` without one
    (:func:`~petastorm_tpu_torch.parallel.mesh.host_shard`); else the
    arguments as given."""
    if elastic is not None:
        from petastorm_tpu_torch.podelastic import resolve_elastic_shard
        cur_shard, shard_count, _ = resolve_elastic_shard(
            elastic, cur_shard, shard_count, shard_by_jax_process)
        return cur_shard, shard_count
    if not shard_by_jax_process:
        return cur_shard, shard_count
    if cur_shard is not None or shard_count is not None:
        raise ValueError('shard_by_jax_process is mutually exclusive with '
                         'explicit cur_shard/shard_count')
    from petastorm_tpu_torch.parallel.mesh import host_shard
    return host_shard()


def _resolve_resilience(retry, hedge, worker_recovery):
    """The three fault-tolerance knobs resolved where the factory is called
    (a typo fails it, with JAX's error text): ``(retry, hedge, recovery)``
    options as plain dicts, None for off."""
    return (resolve_retry(retry), resolve_hedge(hedge),
            resolve_recovery(worker_recovery))


def _validate_io_readahead(io_readahead):
    """``io_readahead`` normalised: 0 (None or 0: off), a positive int (a
    fixed depth a worker), or ``'auto'`` (sized from the worker's live
    read-to-decode ratio)."""
    if io_readahead in (None, 0):
        return 0
    if io_readahead == 'auto':
        return 'auto'
    if isinstance(io_readahead, int) and io_readahead > 0:
        return io_readahead
    raise ValueError("io_readahead must be a non-negative int or 'auto', got "
                     '{!r}'.format(io_readahead))


#: ``cache_type`` of every factory: no cache, a pickle-on-disk cache of one
#: reader, or the host-wide tiered cache of decoded row groups.
CACHE_TYPES = ('null', 'local-disk', 'shared')


def _make_cache(cache_type, cache_location, cache_size_limit,
                cache_row_size_estimate, cache_extra_settings):
    if cache_type in (None, 'null'):
        return NullCache()
    if cache_type == 'local-disk':
        if not cache_location or not cache_size_limit:
            raise ValueError("cache_type='local-disk' needs cache_location and "
                             'cache_size_limit')
        return LocalDiskCache(cache_location, cache_size_limit,
                              cache_row_size_estimate or 0,
                              **(cache_extra_settings or {}))
    if cache_type == 'shared':
        if not cache_location or not cache_size_limit:
            raise ValueError("cache_type='shared' needs cache_location and "
                             'cache_size_limit')
        from petastorm_tpu_torch.sharedcache import (SharedRowGroupCache,
                                                     shared_cache_enabled)
        if not shared_cache_enabled():
            # the kill switch: no attachment, no files, no shared state
            logger.warning(
                "cache_type='shared' disabled via %s=0; reads are uncached",
                'PETASTORM_TPU_SHARED_CACHE')
            return NullCache()
        return SharedRowGroupCache(cache_location, cache_size_limit,
                                   **(cache_extra_settings or {}))
    raise ValueError('cache_type must be one of {}; got {!r}'.format(
        ', '.join(repr(t) for t in CACHE_TYPES), cache_type))


def _make_pool(reader_pool_type, workers_count, results_queue_size,
               serializer, zmq_copy_buffers, profiling_enabled, tracer=None,
               recovery=None):
    """The reader's pool; ``recovery`` (resolved worker-recovery options,
    None: off) reaches the thread and process pools, as in JAX (the dummy
    pool runs items on the consumer's thread: a death there is the
    caller's)."""
    if reader_pool_type == 'thread':
        return ThreadPool(workers_count, results_queue_size,
                          profiling_enabled=profiling_enabled, tracer=tracer,
                          recovery=recovery)
    if reader_pool_type == 'process':
        from petastorm_tpu_torch.workers.process_pool import ProcessPool
        return ProcessPool(workers_count, serializer=serializer,
                           zmq_copy_buffers=zmq_copy_buffers,
                           results_queue_size=results_queue_size,
                           tracer=tracer, recovery=recovery)
    if reader_pool_type == 'dummy':
        return DummyPool(tracer=tracer)
    raise ValueError("reader_pool_type must be one of 'thread', 'process', "
                     "'dummy'; got {!r}".format(reader_pool_type))


def _make_tracer(trace):
    """``trace=`` (and ``PETASTORM_TPU_TRACE``) resolved into ``(Tracer or
    None, Chrome trace path or None)``."""
    enabled, export_path = resolve_trace(trace)
    return (Tracer() if enabled else None), export_path


def _validate_shard_range(cur_shard, shard_count):
    if cur_shard is None and shard_count is None:
        return
    if (cur_shard is None) != (shard_count is None):
        raise ValueError('cur_shard and shard_count must be specified '
                         'together (got cur_shard={!r}, shard_count={!r})'
                         .format(cur_shard, shard_count))
    if shard_count < 1:
        raise ValueError('shard_count must be a positive integer, got '
                         'shard_count={!r}'.format(shard_count))
    if not 0 <= cur_shard < shard_count:
        raise ValueError('cur_shard must be in [0, shard_count), got '
                         'cur_shard={!r} for shard_count={!r}'.format(
                             cur_shard, shard_count))


def _relax_hinted_shapes(schema, decode_hints, stored_schema):
    """``schema`` with the spatial dims of hinted fields made wildcards,
    since a scaled decode changes them: only for fields whose codec can
    scale, and only where a transform did not redeclare the shape."""
    fields = []
    for f in schema.fields.values():
        stored = stored_schema.fields.get(f.name)
        scalable = (stored is not None
                    and getattr(stored.codec, 'can_scale',
                                lambda _f: False)(stored))
        if (f.name in decode_hints and scalable and f.shape
                and len(f.shape) >= 2 and f.shape == stored.shape):
            f = UnischemaField(f.name, f.numpy_dtype,
                               (None, None) + tuple(f.shape[2:]),
                               f.codec, f.nullable)
        fields.append(f)
    return Unischema(schema._name, fields)


def _resolve_store(factory, dataset_url, storage_options, single=True):
    """``(path or paths, filesystem factory)`` of the store's URL (a list of
    file URLs only where ``single`` is False: ``make_batch_reader``)."""
    _, path, filesystem_factory = get_filesystem_and_path_or_paths(
        normalize_dataset_url_or_urls(dataset_url), storage_options)
    if single and isinstance(path, list):
        raise ValueError('{} supports a single dataset url; a list of file '
                         'urls is only supported by make_batch_reader'
                         .format(factory))
    return path, filesystem_factory


def make_reader(dataset_url, schema_fields=None, num_epochs=1,
                shuffle_row_groups=True, workers_count=10, seed=None,
                transform_spec=None, predicate=None, filters=None,
                rowgroup_selector=None, cur_shard=None, shard_count=None,
                shard_by_jax_process=False,
                shuffle_row_drop_partitions=1, decode_hints=None,
                reader_pool_type='thread', results_queue_size=50,
                zmq_copy_buffers=True, profiling_enabled=False,
                cache_type='null', cache_location=None, cache_size_limit=None,
                cache_row_size_estimate=None, cache_extra_settings=None,
                io_readahead=0, on_decode_error='raise', trace=None,
                metrics_interval=0, metrics_out=None, slo=None,
                debug_port=None, stall_timeout=0, flight_record_dir=None,
                autotune=None, retry=None, hedge=None, worker_recovery=None,
                storage_options=None, remote_read=None, elastic=None,
                **unported):
    """Row-granular reader over the petastorm store at ``dataset_url``
    (a path, ``file://``, ``s3://``, ``gs://``, ``hdfs://`` or
    ``memory://``; ``storage_options`` go to its filesystem).
    ``schema_fields``: an :class:`NGram` (window
    chunks, or ``{offset: namedtuple}`` windows under a row predicate,
    residual filters or a transform), a list of field names, regexes or
    fields, or None for every field (one namedtuple per row).
    ``num_epochs=None`` loops forever; ``seed`` fixes the per-epoch
    row-group order.

    Selection: ``predicate`` (a :mod:`~petastorm_tpu_torch.predicates`
    object; on partition keys only it prunes row groups, else it runs on
    the workers), ``filters`` (pyarrow-style DNF, see
    :mod:`~petastorm_tpu_torch.filters`), ``rowgroup_selector`` (a
    :mod:`~petastorm_tpu_torch.selectors` object over the store's
    row-group indexes), ``cur_shard``/``shard_count`` (every
    ``shard_count``-th row group left, from ``cur_shard``; or
    ``shard_by_jax_process=True``, which takes this rank and the world size
    of the ``torch.distributed`` process group, ``(0, 1)`` without one; or
    ``elastic=
    {'coord_root': d[, 'host_id', 'ttl_beats']}``, which derives them from
    this host's place in the pod's live membership when the reader is
    made, :mod:`~petastorm_tpu_torch.podelastic`; off under
    ``PETASTORM_TPU_ELASTIC=0``), and
    ``shuffle_row_drop_partitions`` (each row group is ventilated that many
    times, each time with one slice of its rows). ``transform_spec.func``
    receives one row dict and returns it transformed (a ``device=True``
    spec's gets its numeric fields as CPU tensors). ``decode_hints``:
    ``{field: kwargs of CompressedImageCodec.decode_scaled}``, e.g.
    ``{'image': {'scale': 2}}``; the hinted fields' spatial dims become
    wildcards in ``schema``.

    The pool: ``reader_pool_type`` ``'thread'`` (``workers_count`` threads,
    results queued up to ``results_queue_size``; ``profiling_enabled`` logs
    the workers' aggregate ``cProfile`` at ``join``), ``'process'``
    (``workers_count`` worker interpreters over ZeroMQ, which needs pyzmq
    and dill; ``results_queue_size`` is the results socket's high-water
    mark; arrays arrive as views of the received frames, read-only unless
    ``zmq_copy_buffers=False``) or ``'dummy'`` (each item on the consumer's
    thread).

    ``io_readahead=K`` gives each worker a background thread that reads the
    row groups of its next K items while it decodes the current one;
    ``'auto'`` sizes K from the worker's live read-to-decode ratio. The
    dummy pool turns it off (it hints no upcoming items).

    ``cache_type``: ``'null'`` (no cache), ``'local-disk'`` (decoded row
    groups pickled under ``cache_location``, at most ``cache_size_limit``
    bytes) or ``'shared'`` (the host-wide tiered cache of
    :mod:`~petastorm_tpu_torch.sharedcache` rooted at ``cache_location``:
    every reader and worker process on the host that names it reads and
    decodes a row group once; its hits are **read-only** views over shared
    memory). ``cache_extra_settings`` go to the cache's constructor (e.g.
    ``{'mem_size_limit_bytes': ...}``, tier 0's budget). A cache with a
    ``predicate`` raises ``RuntimeError``. ``PETASTORM_TPU_SHARED_CACHE=0``
    turns ``'shared'`` off.

    Every yielded item carries sample lineage (``reader.lineage``,
    :meth:`Reader.audit`, :meth:`Reader.replay`; off under
    ``PETASTORM_TPU_LINEAGE=0``). ``on_decode_error`` is the bad-sample
    policy: ``'raise'`` (the default), ``'skip'`` (drop the rows of a
    corrupt cell or a failing transform) or ``'quarantine'`` (drop them
    and record them in ``reader.lineage.quarantines()``).

    Observability: ``trace=True`` (or ``PETASTORM_TPU_TRACE``) records a
    span of every pipeline stage into ``reader.tracer``; a string names
    the Chrome trace file written at :meth:`Reader.join` (open it in
    https://ui.perfetto.dev). ``metrics_interval=N`` writes
    ``reader.diagnostics`` every N seconds into ``metrics_out`` (JSON lines,
    or Prometheus text for a ``.prom`` path), and once more at ``join``.
    ``slo`` (a dict of targets, see
    :func:`~petastorm_tpu_torch.latency.validate_slo_targets`) gives
    ``reader.slo``, whose ``evaluate()`` returns a verdict.

    Health: ``debug_port=N`` (or ``PETASTORM_TPU_DEBUG_PORT``) serves the
    live endpoints on ``127.0.0.1:N`` (``/healthz`` ``/slo`` ``/metrics``
    ``/diagnostics`` ``/coverage`` ``/goodput`` ``/stacks``; 0 binds a
    free port, read back from ``reader.debug_port``); ``stall_timeout=S``
    starts a watchdog that classifies the pipeline from its heartbeats
    every S/4 seconds and writes a flight record (JSON) into
    ``flight_record_dir`` (else the temp directory) when an entity made no
    progress for S seconds. ``PETASTORM_TPU_HEALTH=0`` turns the
    heartbeats off.

    Autotune: ``autotune=True`` (or a dict of
    :data:`~petastorm_tpu_torch.autotune.AUTOTUNE_OPTION_KEYS`, e.g.
    ``dict(tick_interval_s=1.0, max_workers=8, device='cuda')``; or
    ``PETASTORM_TPU_AUTOTUNE=1``) starts a controller (``reader.autotune``)
    that moves ``workers_count``, the readahead depth, the ventilation
    window and the results queue's bound live on the thread and process
    pools, judging each move by the roofline model calibrated on this host
    and ``device`` (CUDA by default). ``PETASTORM_TPU_AUTOTUNE=0`` turns it
    off whatever the kwarg says. :meth:`Reader.profile` and
    :meth:`Reader.explain_throughput` give the roofline verdict
    (``PETASTORM_TPU_PROFILER=0`` turns them off).

    Fault tolerance, JAX's knobs and defaults
    (:mod:`~petastorm_tpu_torch.resilience`): ``retry`` (default on;
    ``False`` off, or a dict of ``attempts``, ``initial_backoff_s``,
    ``max_backoff_s``, ``total_budget_s``) retries transient storage errors
    and truncated reads with full-jitter backoff under a total wall budget,
    a permanent error failing on its first attempt; ``hedge`` (default off;
    ``True`` for an adaptive threshold, a threshold in seconds, or a dict)
    fires a second read of a row group when the first exceeds the threshold,
    the first result winning; ``worker_recovery`` (default on; ``False``
    off, or a dict of ``max_respawns``, ``poison_threshold``, ``settle_s``)
    replaces a worker thread or interpreter that died and sends the items it
    held out again, quarantining an item that killed ``poison_threshold``
    workers. With lineage on an item goes out again only if it was not
    delivered (exactly once); under ``PETASTORM_TPU_LINEAGE=0`` a process
    worker that died between an item's payload and its accounting frame
    gets that item sent again (at least once). ``PETASTORM_TPU_CHAOS``
    (:mod:`~petastorm_tpu_torch.faultfs`) arms the seeded fault injector
    under the workers' reads.

    ``remote_read``: the workers' read plane, ``'serial'`` (plain reads),
    ``'prebuffer'`` (pyarrow coalesces a row group's column chunks) or
    ``'ranged'`` (the footer's plan of byte ranges fetched in parallel, with
    retry and hedge per range); None or ``'auto'``: ``prebuffer`` on a
    remote store, ``serial`` on a local one."""
    _refuse_unported('make_reader', unported)
    autotune = resolve_autotune(autotune)
    retry, hedge, recovery = _resolve_resilience(retry, hedge,
                                                 worker_recovery)
    remote_read = resolve_remote_read(remote_read)
    path, filesystem_factory = _resolve_store('make_reader', dataset_url,
                                              storage_options)
    cur_shard, shard_count = _resolve_shard(cur_shard, shard_count,
                                            shard_by_jax_process, elastic)
    mode = 'ngram' if isinstance(schema_fields, NGram) else 'rows'
    cache = _make_cache(cache_type, cache_location, cache_size_limit,
                        cache_row_size_estimate, cache_extra_settings)
    tracer, trace_export = _make_tracer(trace)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                      ZeroCopySerializer(), zmq_copy_buffers,
                      profiling_enabled, tracer, recovery)
    return Reader(path, copy.deepcopy(schema_fields), mode=mode, pool=pool,
                  num_epochs=num_epochs,
                  shuffle_row_groups=shuffle_row_groups, seed=seed,
                  transform_spec=transform_spec, predicate=predicate,
                  filters=filters, rowgroup_selector=rowgroup_selector,
                  cur_shard=cur_shard, shard_count=shard_count,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  decode_hints=decode_hints, cache=cache,
                  io_readahead=io_readahead, on_decode_error=on_decode_error,
                  trace_export=trace_export,
                  metrics_interval=metrics_interval, metrics_out=metrics_out,
                  slo=slo, debug_port=debug_port, stall_timeout=stall_timeout,
                  flight_record_dir=flight_record_dir,
                  autotune_options=autotune, retry=retry, hedge=hedge,
                  filesystem_factory=filesystem_factory,
                  remote_read=remote_read)


def make_columnar_reader(dataset_url, schema_fields=None, num_epochs=1,
                         shuffle_row_groups=True, workers_count=10, seed=None,
                         transform_spec=None, predicate=None, filters=None,
                         rowgroup_selector=None, cur_shard=None,
                         shard_count=None, shard_by_jax_process=False,
                         shuffle_row_drop_partitions=1,
                         decode_hints=None, reader_pool_type='thread',
                         results_queue_size=50, zmq_copy_buffers=True,
                         profiling_enabled=False, cache_type='null',
                         cache_location=None, cache_size_limit=None,
                         cache_row_size_estimate=None,
                         cache_extra_settings=None, io_readahead=0,
                         on_decode_error='raise', trace=None,
                         metrics_interval=0, metrics_out=None, slo=None,
                         debug_port=None, stall_timeout=0,
                         flight_record_dir=None, autotune=None, retry=None,
                         hedge=None, worker_recovery=None,
                         storage_options=None, remote_read=None,
                         elastic=None, **unported):
    """Vectorized reader: one namedtuple of decoded numpy column arrays per
    row group (``batched_output``), over the transformed schema.
    ``transform_spec.func`` receives a dict of column arrays and runs on the
    workers; a ``device=True`` spec receives a dict of tensors instead: after
    the device decode when the reader plans one (see :class:`Reader`), else
    on the workers as CPU tensors. Selection,
    ``decode_hints``, the pool, readahead, the cache, lineage,
    ``on_decode_error``, the observability, health and autotune options as
    in :func:`make_reader` (a policy other than ``'raise'`` declines device
    decode); a whole row group's columns are cached after the transform,
    so a hit skips the decode and the transform. NGram is not
    supported. ``retry``, ``hedge``, ``worker_recovery``,
    ``storage_options`` and ``remote_read`` as in :func:`make_reader`."""
    _refuse_unported('make_columnar_reader', unported)
    autotune = resolve_autotune(autotune)
    retry, hedge, recovery = _resolve_resilience(retry, hedge,
                                                 worker_recovery)
    remote_read = resolve_remote_read(remote_read)
    if isinstance(schema_fields, NGram):
        raise ValueError('NGram is not supported by make_columnar_reader; use '
                         'make_reader for windowed sequence assembly')
    path, filesystem_factory = _resolve_store('make_columnar_reader',
                                              dataset_url, storage_options)
    cur_shard, shard_count = _resolve_shard(cur_shard, shard_count,
                                            shard_by_jax_process, elastic)
    cache = _make_cache(cache_type, cache_location, cache_size_limit,
                        cache_row_size_estimate, cache_extra_settings)
    tracer, trace_export = _make_tracer(trace)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                      ZeroCopySerializer(), zmq_copy_buffers,
                      profiling_enabled, tracer, recovery)
    return Reader(path, schema_fields, mode='columnar', pool=pool,
                  num_epochs=num_epochs, shuffle_row_groups=shuffle_row_groups,
                  seed=seed,
                  transform_spec=transform_spec, predicate=predicate,
                  filters=filters, rowgroup_selector=rowgroup_selector,
                  cur_shard=cur_shard, shard_count=shard_count,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  decode_hints=decode_hints, cache=cache,
                  io_readahead=io_readahead, on_decode_error=on_decode_error,
                  trace_export=trace_export,
                  metrics_interval=metrics_interval, metrics_out=metrics_out,
                  slo=slo, debug_port=debug_port, stall_timeout=stall_timeout,
                  flight_record_dir=flight_record_dir,
                  autotune_options=autotune, retry=retry, hedge=hedge,
                  filesystem_factory=filesystem_factory,
                  remote_read=remote_read)


def make_batch_reader(dataset_url_or_urls, schema_fields=None, seed=None,
                      shuffle_row_groups=True, predicate=None, num_epochs=1,
                      cur_shard=None, shard_count=None,
                      shard_by_jax_process=False, transform_spec=None,
                      filters=None, workers_count=10,
                      reader_pool_type='thread', results_queue_size=50,
                      zmq_copy_buffers=True, profiling_enabled=False,
                      cache_type='null', cache_location=None,
                      cache_size_limit=None, cache_row_size_estimate=None,
                      cache_extra_settings=None, io_readahead=0,
                      on_decode_error='raise', trace=None,
                      metrics_interval=0, metrics_out=None, slo=None,
                      debug_port=None, stall_timeout=0,
                      flight_record_dir=None, autotune=None, retry=None,
                      hedge=None, worker_recovery=None, storage_options=None,
                      remote_read=None, elastic=None, **unported):
    """Vectorized reader of any Parquet store, with or without petastorm
    metadata (a schema is inferred from the files and their hive partition
    directories), or of an explicit list of ``file://`` parquet file URLs
    (read in the caller's order; all on one filesystem). Yields one
    namedtuple of numpy column arrays per row group (``batched_output``),
    as arrow stores the columns: codecs are not decoded, a null-bearing
    integer column is float64 with NaN, a fixed-shape list column is
    ``(n, *shape)``.
    ``schema_fields``: a list of regexes or None. ``transform_spec.func``
    receives a pandas DataFrame, ``device=True`` or not. Selection by
    ``predicate``, ``filters`` and ``cur_shard``/``shard_count``, the pool,
    readahead, the cache, lineage, ``on_decode_error``, the observability,
    health and autotune options as in :func:`make_reader` (a process pool
    sends each row group's table as one Arrow IPC stream; the shared cache
    keeps it as one). ``retry``, ``hedge``, ``worker_recovery``,
    ``storage_options`` and ``remote_read`` as in :func:`make_reader`."""
    _refuse_unported('make_batch_reader', unported)
    autotune = resolve_autotune(autotune)
    retry, hedge, recovery = _resolve_resilience(retry, hedge,
                                                 worker_recovery)
    remote_read = resolve_remote_read(remote_read)
    path, filesystem_factory = _resolve_store(
        'make_batch_reader', dataset_url_or_urls, storage_options,
        single=False)
    cur_shard, shard_count = _resolve_shard(cur_shard, shard_count,
                                            shard_by_jax_process, elastic)
    if schema_fields is not None and not (
            isinstance(schema_fields, list)
            and all(isinstance(f, str) for f in schema_fields)):
        raise ValueError('make_batch_reader schema_fields must be a list of '
                         'regex strings (UnischemaField selection and NGram '
                         'are row-reader features)')
    cache = _make_cache(cache_type, cache_location, cache_size_limit,
                        cache_row_size_estimate, cache_extra_settings)
    tracer, trace_export = _make_tracer(trace)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                      ArrowTableSerializer(), zmq_copy_buffers,
                      profiling_enabled, tracer, recovery)
    return Reader(path, schema_fields, mode='batch', pool=pool,
                  num_epochs=num_epochs,
                  shuffle_row_groups=shuffle_row_groups, seed=seed,
                  transform_spec=transform_spec, predicate=predicate,
                  filters=filters, cur_shard=cur_shard,
                  shard_count=shard_count, cache=cache,
                  io_readahead=io_readahead, on_decode_error=on_decode_error,
                  trace_export=trace_export,
                  metrics_interval=metrics_interval, metrics_out=metrics_out,
                  slo=slo, debug_port=debug_port, stall_timeout=stall_timeout,
                  flight_record_dir=flight_record_dir,
                  autotune_options=autotune, retry=retry, hedge=hedge,
                  filesystem_factory=filesystem_factory,
                  remote_read=remote_read)


def _view(stored, schema_fields):
    if schema_fields is None:
        return stored
    if all(isinstance(f, str) for f in schema_fields):
        matched = match_unischema_fields(stored, schema_fields)
        if not matched:
            raise ValueError('schema_fields {} matched no fields'
                             .format(schema_fields))
        return stored.create_schema_view(matched)
    return stored.create_schema_view(schema_fields)


def _cast_partition(schema, field_name, value):
    field = schema.fields.get(field_name)
    return cast_partition_value(field.numpy_dtype if field is not None
                                else None, value)


class Reader:
    """Context manager and iterator over a store; see :func:`make_reader`,
    :func:`make_columnar_reader` and :func:`make_batch_reader`.

    ``schema`` is the schema of what the reader yields (the selected fields,
    after the transform, hinted spatial dims as wildcards),
    ``stored_schema`` the store's full schema (stored or inferred),
    ``ngram`` the resolved NGram of a window reader (else None),
    ``ngram_chunked`` whether its items are window chunks, ``pieces`` the
    row-group pieces this reader reads, after pruning and sharding.

    Device decode: ``device_decode_plans`` maps each column the workers
    ship raw (a ``(n, stride)`` uint8 grid) to its
    :class:`~petastorm_tpu_torch.ops.decode.DeviceColumnPlan`, and
    ``device_decode_declined`` maps each other column, or ``'*'`` for the
    whole reader, to why it decodes on the host. A loader that claims the
    plans decodes the grids on its device; otherwise :meth:`__next__`
    decodes them on the host and the reader yields decoded numpy, as
    without plans. With plans, a ``device=True`` ``TransformSpec`` runs
    after the decode, wherever it ran, on tensors; without, it runs on the
    workers over CPU tensors.

    ``lineage`` is the reader's
    :class:`~petastorm_tpu_torch.lineage.LineageTracker` (disabled, but
    there, under ``PETASTORM_TPU_LINEAGE=0``). ``stats``, ``diagnostics``,
    ``latency``, ``tracer`` and ``slo`` are the stats, latency and tracing
    planes; ``health``, ``watchdog`` and ``debug_port`` the health
    plane; ``autotune`` the controller (None without one) and
    ``calibration`` the roofline calibration of the last :meth:`profile`
    (None before)."""

    def __init__(self, dataset_path, schema_fields, *, mode, pool,
                 num_epochs, shuffle_row_groups, seed,
                 transform_spec=None, predicate=None, filters=None,
                 rowgroup_selector=None, cur_shard=None, shard_count=None,
                 shuffle_row_drop_partitions=1, decode_hints=None,
                 cache=None, io_readahead=0, on_decode_error='raise',
                 trace_export=None, metrics_interval=0, metrics_out=None,
                 slo=None, debug_port=None, stall_timeout=0,
                 flight_record_dir=None, autotune_options=None, retry=None,
                 hedge=None, filesystem_factory=None, remote_read=None):
        if stall_timeout and stall_timeout < 0:
            raise ValueError('stall_timeout must be >= 0, got '
                             '{!r}'.format(stall_timeout))
        if metrics_interval and not metrics_out:
            raise ValueError('metrics_interval needs a metrics_out path to '
                             'emit snapshots into')
        if slo:
            # a misspelt target fails here, not silently never breaching
            slo = validate_slo_targets(slo)
        validate_decode_error_policy(on_decode_error)
        cache = cache if cache is not None else NullCache()
        if predicate is not None and not isinstance(cache, NullCache):
            raise RuntimeError('Local cache is not supported together with '
                               'predicates (cached row groups would bypass '
                               'predicate evaluation)')
        io_readahead = _validate_io_readahead(io_readahead)
        #: the pool and cache kinds, as the profiler names them
        self._pool_type = {'ProcessPool': 'process', 'ThreadPool': 'thread',
                           'DummyPool': 'dummy'}.get(type(pool).__name__,
                                                     type(pool).__name__)
        self._cache_type = {'NullCache': 'null',
                            'LocalDiskCache': 'local-disk',
                            'SharedRowGroupCache': 'shared'}.get(
                                type(cache).__name__, type(cache).__name__)
        self._io_readahead = io_readahead
        # the controller owns the readahead where it has live actuators: a
        # readahead exists (dormant at depth 0) on every worker, and 'auto'
        # stops retuning itself (two tuners on one knob would oscillate)
        autotune_active = (autotune_options is not None
                           and self._pool_type in ('thread', 'process'))
        if autotune_options is not None and not autotune_active:
            logger.warning('autotune disabled: the %s pool has no live '
                           'actuators', self._pool_type)
        #: the :class:`~petastorm_tpu_torch.autotune.PipelineController`
        #: (None unless autotune is on over a thread or process pool)
        self._controller = None
        self._last_profile = None
        self._roofline_gauges = {}
        #: the roofline calibration the last :meth:`profile` judged by
        self.calibration = None
        # the device the profiler stages to: the controller's, else the
        # last profile()'s (None: CUDA)
        self._profile_device = (autotune_options or {}).get('device')
        if num_epochs is not None and num_epochs < 1:
            raise ValueError('num_epochs must be >= 1 or None')
        if shuffle_row_drop_partitions < 1:
            raise ValueError('shuffle_row_drop_partitions must be >= 1')
        _validate_shard_range(cur_shard, shard_count)
        #: the pipeline's :class:`~petastorm_tpu_torch.health.HealthMonitor`:
        #: the heartbeats of the ventilator, the pool's workers and their
        #: readahead threads, and of a staging thread given
        #: ``prefetch_to_device(..., health=reader.health)``
        self.health = HealthMonitor()
        #: the path of the store (or the list of its files) on its
        #: filesystem, as the URL gave it
        self.dataset_path = dataset_path
        if filesystem_factory is None:
            filesystem_factory = FilesystemFactory('file')
        #: the picklable maker of the store's filesystem (each worker calls
        #: it for its own)
        self._filesystem_factory = filesystem_factory
        filesystem = self._filesystem = filesystem_factory()
        self.stored_schema, was_stored = infer_or_load_unischema(
            dataset_path, filesystem)
        if mode != 'batch' and not was_stored:
            raise RuntimeError(
                'Dataset at {} is missing petastorm_tpu metadata. If this is '
                'a plain parquet store, use make_batch_reader instead.'.format(
                    dataset_path))
        stored = self.stored_schema
        self.ngram = schema_fields if mode == 'ngram' else None
        if (self.ngram is not None and not self.ngram.timestamp_overlap
                and shuffle_row_drop_partitions > 1):
            raise NotImplementedError(
                'shuffle_row_drop_partitions is not supported with '
                'timestamp_overlap=False')
        #: every item is a namedtuple of column arrays (one row group)
        self.batched_output = mode in ('columnar', 'batch')
        self._rows = []
        self._rows_seq = None
        #: tracker seq of the item last yielded from (None before the
        #: first, or with lineage off)
        self.last_seq = None
        #: payload-row offset of the row last yielded within its item (row
        #: readers; None for batched output)
        self.last_row_offset = None
        self._batches = None
        # the workers decode with the stored schema: a scaled decode picks
        # its denominator from the stored shape
        overrides = build_decode_overrides(stored, decode_hints)

        # footers read while listing a metadata-less store, kept for the
        # statistics pass of ``filters``
        self._footers = {}
        pieces = load_row_groups(dataset_path, footer_cache=self._footers,
                                 filesystem=filesystem)
        if not pieces:
            raise NoDataAvailableError('No row groups found at {}'.format(
                dataset_path))
        pieces, predicate, filters_predicate = self._filter_row_groups(
            pieces, predicate, rowgroup_selector, filters, cur_shard,
            shard_count)
        if not pieces:
            raise NoDataAvailableError(
                'No row groups left after predicate/selector/shard filtering '
                'at {}'.format(dataset_path))
        #: the row-group pieces this reader reads
        self.pieces = pieces

        ngram = self.ngram
        if ngram is not None:
            ngram.resolve_regex_field_names(stored)
            missing = [n for n in ngram.get_all_field_names()
                       if n not in stored.fields]
            if missing:
                raise ValueError('NGram fields {} are not in the store schema'
                                 .format(missing))
            view = stored.create_schema_view(
                [stored.fields[n] for n in ngram.get_all_field_names()])
        else:
            view = _view(stored, schema_fields)
        self._view = view
        self.schema = (transform_schema(view, transform_spec)
                       if transform_spec is not None else view)
        if decode_hints:
            self.schema = _relax_hinted_shapes(self.schema, decode_hints,
                                               stored)
        #: every published item is a columnar NGram window chunk: an NGram
        #: reader with no row predicate, residual filter or transform
        self.ngram_chunked = (ngram is not None and transform_spec is None
                              and predicate is None
                              and filters_predicate is None)
        names = list(view.fields)

        self.device_decode_plans, self.device_decode_declined = \
            plan_device_decode(
                view, has_predicate=(predicate is not None
                                     or filters_predicate is not None),
                has_ngram=ngram is not None, decode_hints=decode_hints,
                transform_spec=transform_spec,
                transformed_schema=self.schema,
                batched_output=self.batched_output,
                tolerant_decode=on_decode_error != 'raise',
                worker_supported=mode == 'columnar')
        # a device spec runs once a batch after the decode of the planned
        # columns: in the loader that claims the plans, else in __next__;
        # without plans it stays on the workers, over CPU tensors
        self._device_transform_spec = (
            transform_spec if self.device_decode_plans
            and transform_spec is not None and transform_spec.device
            else None)
        if self._device_transform_spec is not None:
            transform_spec = None
        self._device_decode_deferred = False
        if self.ngram_chunked:
            load = functools.partial(load_window_chunk, schema=stored,
                                     ngram=ngram, overrides=overrides)
            plan = functools.partial(plan_window_chunk, schema=stored,
                                     ngram=ngram)
        elif mode == 'batch':
            self._batches = BatchResultsReader(self.schema)
            load = functools.partial(
                load_batch_item, schema=view, full_schema=stored,
                transform_spec=transform_spec,
                transformed_schema=self.schema)
            plan = functools.partial(plan_batch, schema=view)
        elif mode == 'columnar':
            transform_key = (transform_fingerprint(transform_spec)
                             if transform_spec is not None else None)
            load = functools.partial(
                load_columnar, schema=stored, names=names,
                transform_spec=transform_spec,
                transformed_schema=self.schema, overrides=overrides,
                plans=self.device_decode_plans, transform_key=transform_key)
            plan = functools.partial(plan_columnar, schema=stored,
                                     names=names, transform_key=transform_key)
        else:
            load = functools.partial(
                load_row_item, schema=stored, names=names,
                transform_spec=transform_spec,
                transformed_schema=self.schema, ngram=ngram,
                overrides=overrides)
            plan = functools.partial(plan_rows, schema=stored, names=names)
        if io_readahead and not getattr(pool, 'supports_prefetch_hints',
                                        False):
            # a pool that hints nothing would count every read a miss
            logger.debug('io_readahead disabled: %s does not hint workers '
                         'about upcoming items', type(pool).__name__)
            io_readahead = 0
            self._io_readahead = 0
        # each worker holds its current item and up to `lookahead` more:
        # the in-flight bound widens by every worker's lookahead
        bound = {}
        if io_readahead:
            lookahead = (AUTO_MAX_DEPTH if io_readahead == 'auto'
                         else io_readahead)
            bound['max_in_flight'] = pool.workers_count * (2 + lookahead)
        items = []
        for piece_index, piece in enumerate(pieces):
            piece_predicate = predicate
            if filters_predicate is not None:
                specialized = filters_predicate.specialize(piece, stored)
                if specialized is not None:
                    piece_predicate = (
                        specialized if piece_predicate is None
                        else in_reduce([piece_predicate, specialized], all))
            items.extend(WorkItem(piece, piece_predicate,
                                  (p, shuffle_row_drop_partitions),
                                  piece_index)
                         for p in range(shuffle_row_drop_partitions))

        dataset = hashlib.md5(str(dataset_path).encode()).hexdigest()[:12]
        latency_on = getattr(pool.stats, 'latency', None) is not None
        tracer = getattr(pool, 'tracer', None)
        self.lineage = LineageTracker(
            enabled=lineage_enabled(), dataset_digest=dataset,
            shard=cur_shard if cur_shard is not None else -1,
            pieces=[(p.path, p.row_group, p.num_rows) for p in pieces],
            items=[(it.piece_index, it.drop_partition) for it in items],
            row_filtered=(predicate is not None
                          or filters_predicate is not None),
            # ventilation times start the e2e_batch latency: stamped only
            # when the latency plane reads them
            record_vent_ts=latency_on)
        #: ``e2e_batch`` is recorded at item delivery, once an item, unless
        #: a loader takes it over for its batches
        self._e2e_live = self.lineage.enabled and latency_on
        self._last_e2e_seq = None
        #: ``(piece_index, partition) -> WorkItem``: what replay runs
        self._replay_items = {(it.piece_index, it.drop_partition): it
                              for it in items}
        file_indexes = {}
        for piece in pieces:
            file_indexes.setdefault(piece.path, len(file_indexes))
        self._spec = PieceWorkerSpec(
            load, plan, cache, io_readahead,
            cache_key_format(dataset_path, view.fields, decode_hints,
                             self.device_decode_plans),
            lineage=self.lineage.enabled, on_decode_error=on_decode_error,
            shard=cur_shard if cur_shard is not None else -1,
            dataset=dataset, file_indexes=file_indexes,
            windows=ngram is not None, trace=tracer is not None,
            latency=latency_on, health=self.health.enabled,
            readahead_controlled=autotune_active,
            # the factory's resolved options (None: off)
            retry=retry, hedge=hedge, filesystem_factory=filesystem_factory,
            remote_read=remote_read, cwd=os.getcwd())
        on_ventilate = None
        if self.lineage.enabled:
            # the ventilation ledger is the audit's expected side: what
            # went out and never came back is a drop
            record = self.lineage.record_ventilated

            def on_ventilate(item):
                record(item.epoch, item.piece_index, item.drop_partition)
        if tracer is not None:
            untraced = on_ventilate

            def on_ventilate(item):
                with tracer.span('ventilate', 'ventilator'):
                    if untraced is not None:
                        untraced(item)
        self._num_epochs = num_epochs
        #: True once the last item of the ventilated epochs was consumed:
        #: only then may :meth:`reset` start another pass
        self.last_row_consumed = False
        self._pool = pool
        self._trace_export = trace_export
        self._metrics_emitter = None
        self._slo = None
        self._watchdog = None
        self._debug_server = None
        #: the loader's :class:`~petastorm_tpu_torch.goodput.GoodputMonitor`
        #: (None until a loader registers one): ``/goodput`` and the flight
        #: record's goodput section
        self._goodput = None
        self._flight_record_dir = flight_record_dir
        pool.lineage = self.lineage
        self._pool.start(self._spec, items, num_epochs=num_epochs,
                         shuffle=shuffle_row_groups, seed=seed,
                         on_ventilate=on_ventilate,
                         heartbeat=(self.health.beat if self.health.enabled
                                    else None), **bound)
        if metrics_interval:
            self._metrics_emitter = MetricsEmitter(
                self._stats_snapshot, metrics_interval, metrics_out)
            self._metrics_emitter.start()
        if slo:
            self._slo = SLOMonitor(slo, snapshot_fn=self._stats_snapshot,
                                   latency=pool.stats.latency)
        if autotune_active:
            self._start_controller(pool, autotune_options, slo)
        self._start_health(pool, debug_port, stall_timeout, cache)

    def _start_controller(self, pool, options, slo):
        """The autotune controller over the pool's live actuators (JAX
        :825-862). Its calibration (probes included, under
        ``calibrate='auto'`` or ``'force'``) runs on the controller's
        thread, staging to ``options['device']``."""
        io_readahead = self._io_readahead
        initial_depth = (AUTO_INITIAL_DEPTH if io_readahead == 'auto'
                         else int(io_readahead or 0))
        mode = options['calibrate']

        def calibration_fn():
            if not profiler.profiler_enabled():
                return None
            return profiler.get_calibration(
                self.dataset_path, self.pieces, self._view, mode=mode,
                device=options['device'], filesystem=self._filesystem)

        self._controller = PipelineController(
            ReaderActuators(pool, ventilator=pool.ventilation,
                            pool_type=self._pool_type,
                            resize_timeout_s=float(
                                options['resize_timeout_s']),
                            initial_readahead=initial_depth),
            self._stats_snapshot, calibration_fn=calibration_fn,
            latency=pool.stats.latency, slo_targets=slo or {},
            options=options,
            arbiter=HostArbiter(scratch_dir(options),
                                cpu_count=os.cpu_count() or 1,
                                tick_interval_s=options['tick_interval_s']))
        self._controller.start()

    def _start_health(self, pool, debug_port, stall_timeout, cache):
        """The watchdog and the debug server (JAX :862-933). With the pod
        plane on (``PETASTORM_TPU_PODOBS``), the server's
        ``/observe/snapshot`` serves this host's snapshot, and when
        ``PETASTORM_TPU_PODOBS_PEERS`` names the pod its ``/podmetrics``
        serves a :class:`~petastorm_tpu_torch.podobs.PodObserver`'s
        report. On-demand
        verdicts (``/healthz``) use :data:`~petastorm_tpu_torch.health.
        DEFAULT_STALL_AFTER_S` without a ``stall_timeout``; the watchdog's
        thread runs only with one (it fires the flight recorder and paces
        the SLO's burn accounting). A port already taken disables the
        endpoint with a warning: a job-wide ``PETASTORM_TPU_DEBUG_PORT``
        must not crash the job's second reader."""
        self.health.add_source(pool.heartbeats)
        port = resolve_debug_port(debug_port)
        if not stall_timeout and port is None:
            return
        self._watchdog = PipelineWatchdog(
            self.health.heartbeats, pool.stats.snapshot,
            stall_after_s=stall_timeout or DEFAULT_STALL_AFTER_S,
            on_stall=self._on_stall, slo_monitor=self._slo)
        if stall_timeout:
            self._watchdog.start()
        if port is None:
            return
        from petastorm_tpu_torch.goodput import goodput_enabled
        from petastorm_tpu_torch.podobs import podobs_enabled
        coverage_fn = (self.lineage.coverage_report if self.lineage.enabled
                       else None)
        slo_fn = self._slo.evaluate if self._slo is not None else None
        goodput_fn = self._goodput_route if goodput_enabled() else None
        observe_fn = podmetrics_fn = None
        if podobs_enabled():
            from petastorm_tpu_torch.podobs import (PodObserver,
                                                    make_observe_fn,
                                                    pod_peers_from_env)
            tracer = self.tracer
            observe_fn = make_observe_fn(
                snapshot_fn=self._stats_snapshot,
                health_fn=self._watchdog.evaluate, slo_fn=slo_fn,
                coverage_fn=coverage_fn,
                cache_counters_fn=getattr(cache, 'host_counters', None),
                span_tail_fn=tracer.tail if tracer is not None else None,
                goodput_fn=goodput_fn)
            peers = pod_peers_from_env()
            if peers:
                podmetrics_fn = PodObserver(peers).report
        self._debug_server = DebugServer(
            self._watchdog.evaluate, self._stats_snapshot,
            self.health.heartbeats, port=port, coverage_fn=coverage_fn,
            profile_fn=(self._profile_route if profiler.profiler_enabled()
                        else None),
            slo_fn=slo_fn,
            autotune_fn=(self._controller.report
                         if self._controller is not None else None),
            observe_fn=observe_fn, podmetrics_fn=podmetrics_fn,
            goodput_fn=goodput_fn)
        try:
            self._debug_server.start()
        except (OSError, OverflowError) as e:   # a taken or bad port
            logger.warning(
                'debug endpoint disabled: could not bind 127.0.0.1:%d '
                '(%s); pass debug_port=0 for an ephemeral port per '
                'reader', port, e)
            self._debug_server = None

    def _filter_row_groups(self, pieces, predicate, rowgroup_selector,
                           filters, cur_shard, shard_count):
        """``(pieces, worker predicate, filters predicate)``: the pieces left
        after pruning and sharding, the user's predicate where it needs the
        workers, and the row-exact residual of ``filters`` (None when the
        filters name partition keys only)."""
        stored = self.stored_schema
        # the selector's indexes number the pieces of the whole store
        indexed = list(enumerate(pieces))
        worker_predicate = filters_predicate = None
        partition_keys = set(pieces[0].partition_dict)
        if predicate is not None:
            fields = set(predicate.get_fields())
            unknown = fields - set(stored.fields)
            if unknown:
                raise ValueError('Predicate uses unknown fields: {}'.format(
                    sorted(unknown)))
            if fields and fields <= partition_keys:
                indexed = [(i, p) for i, p in indexed if predicate.do_include(
                    {f: _cast_partition(stored, f, p.partition_dict[f])
                     for f in fields})]
            else:
                worker_predicate = predicate

        conjunctions = normalize_filters(filters) if filters is not None \
            else None
        if conjunctions:
            filter_cols = set(filter_column_names(conjunctions))
            unknown = filter_cols - set(stored.fields) - partition_keys
            if unknown:
                raise ValueError('filters use unknown columns: {}'.format(
                    sorted(unknown)))
            validate_filter_types(conjunctions, stored, partition_keys)
            # exact on partition values first, so footers are read only
            # for the pieces that pass; then conservative on statistics,
            # with the row-exact residual run on the workers
            stats = RowGroupStatsEvaluator(stored,
                                           preloaded_footers=self._footers,
                                           filesystem=self._filesystem)
            indexed = [(i, p) for i, p in indexed
                       if stats.piece_maybe_matches(p, conjunctions,
                                                    partition_only=True)]
            if filter_cols - partition_keys:
                stats.prefetch_footers({p.path for _, p in indexed})
                indexed = [(i, p) for i, p in indexed
                           if stats.piece_maybe_matches(p, conjunctions)]
                filters_predicate = FiltersPredicate(conjunctions)

        if rowgroup_selector is not None:
            indexes = get_row_group_indexes(self.dataset_path,
                                            self._filesystem)
            missing = (set(rowgroup_selector.get_index_names())
                       - set(indexes))
            if missing:
                raise ValueError('Selector references unknown indexes: {}'
                                 .format(sorted(missing)))
            selected = rowgroup_selector.select_row_groups(indexes)
            indexed = [(i, p) for i, p in indexed if i in selected]

        pieces = [p for _, p in indexed]
        if cur_shard is not None:
            if len(pieces) < shard_count:
                raise NoDataAvailableError(
                    'Dataset has only {} row groups after pruning but {} '
                    'shards were requested; some shards would receive no '
                    'data'.format(len(pieces), shard_count))
            pieces = [p for i, p in enumerate(pieces)
                      if i % shard_count == cur_shard]
        return pieces, worker_predicate, filters_predicate

    def _next_item(self):
        """The next non-empty published item, its provenance registered
        (:attr:`last_seq`); StopIteration at the end."""
        while True:
            try:
                item = self._pool.get_results()
            except EmptyResultError:
                self.last_row_consumed = True
                raise StopIteration from None
            item, seq = unwrap_envelope(item, self.lineage)
            if item is not None and len(item):
                if seq is not None:
                    self.last_seq = seq
                return item

    def _note_e2e(self):
        """One ``e2e_batch`` observation for the item last yielded from, on
        its first row (JAX ``reader.py:1040-1048``): ventilation to
        delivery."""
        seq = self.last_seq
        if seq is not None and seq != self._last_e2e_seq:
            self._last_e2e_seq = seq
            ts = self.lineage.ventilated_ts(seq)
            if ts is not None:
                self._pool.stats.record_latency('e2e_batch',
                                                time.perf_counter() - ts)

    def _defer_e2e_to_loader(self):
        """Called by a loader that records ``e2e_batch`` at its own batch
        delivery: the reader then records none, so each delivered unit is
        observed once."""
        self._e2e_live = False

    def iter_ngram_chunks(self):
        """Window chunks, one per work item that has a valid window."""
        if not self.ngram_chunked:
            raise TypeError('iter_ngram_chunks needs a chunked NGram reader '
                            '(no row predicate, residual filters or '
                            'transform); iterate windows with next()')
        while True:
            try:
                yield self._next_item()
            except StopIteration:
                return

    def __iter__(self):
        return self

    def __next__(self):
        if self.ngram_chunked:
            raise TypeError('an NGram reader yields window chunks: iterate '
                            'iter_ngram_chunks() or batch it with '
                            'TorchDataLoader')
        if self._batches is not None:
            batch = self._batches.to_batch(self._next_item())
            if self._e2e_live:
                self._note_e2e()
            return batch
        if self.batched_output:
            columns = self._next_item()
            if self._e2e_live:
                self._note_e2e()
            if self.device_decode_plans and not self._device_decode_deferred:
                # the planned cells decode whole-column on the host
                self._pool.stats.add('rows_decoded_batched', sum(
                    len(columns[n]) for n in self.device_decode_plans
                    if n in columns))
                columns = self._host_decode_raw(columns)
            return self.schema.make_batch_namedtuple(**columns)
        # the last row (window) of an item first, as the JAX results reader
        # pops them
        if not self._rows:
            self._rows = self._next_item()
            self._rows_seq = self.last_seq
            if self._e2e_live:
                self._note_e2e()
        item = self._rows.pop()
        # after the pop, the length left is the popped row's offset
        self.last_seq = self._rows_seq
        self.last_row_offset = len(self._rows)
        if self.ngram is not None:
            return self.ngram.make_namedtuples(item, self.schema)
        return self.schema.make_namedtuple(**item)

    def _host_decode_raw(self, columns):
        """Decode a bytes-through item's raw planned columns on the host and
        run a device ``TransformSpec`` over the result: the consumer's path
        when no loader claimed the plans. The spec gets CPU tensors and its
        tensors come back as numpy
        (:func:`~petastorm_tpu_torch.transform.run_on_cpu_tensors`)."""
        columns = dict(columns)
        for name, plan in self.device_decode_plans.items():
            if name in columns:
                columns[name] = decode_raw_host(plan, columns[name])
        if self._device_transform_spec is None:
            return columns
        return apply_columnar_transform(self._device_transform_spec,
                                        self.schema, columns)

    def _defer_device_decode_to_loader(self):
        """Called by a loader that claims the plans: the raw grids then pass
        through :meth:`__next__` undecoded, and the loader decodes them on
        its device, then runs the device ``TransformSpec``. Returns
        ``(plans, device_transform_spec)``."""
        self._device_decode_deferred = True
        return self.device_decode_plans, self._device_transform_spec

    def discard_buffered(self):
        """Drop the rows (windows) buffered from a partly consumed item,
        the row results reader's part of :meth:`drain` (JAX
        ``readers/row_worker.py:92``): nothing stale reaches the next
        pass."""
        self._rows = []

    def drain(self):
        """Consume the rest of the stream without decoding or collating
        on the consumer's side (published items are dropped as they come),
        leaving the reader resettable (JAX ``reader.py:1122-1138``). The
        sharded loader's lockstep stop calls it on a rank with surplus
        batches. The dropped items still register their provenance, so the
        coverage audit counts them delivered (dropped on purpose is not
        lost)."""
        self.discard_buffered()
        try:
            while True:
                unwrap_envelope(self._pool.get_results(), self.lineage)
        except EmptyResultError:
            self.last_row_consumed = True

    def reset(self):
        """Restart iteration for another ``num_epochs`` pass, the row-group
        shuffle continuing from the same generator; only legal after the
        previous pass fully drained (JAX ``reader.py:1140-1151``)."""
        if not self.last_row_consumed:
            raise RuntimeError(
                'Reader.reset() is only supported after the previous epoch '
                'set was fully consumed (in-flight row groups cannot be '
                'recalled)')
        # epochs count on across passes: the new pass audits against
        # fresh per-epoch ledgers
        self.lineage.start_pass()
        self._pool.reset(self._num_epochs)
        self.last_row_consumed = False
        # a profile judged the pass that ended
        self._last_profile = None
        self._roofline_gauges = {}

    # -- the health plane ----------------------------------------------------

    def _on_stall(self, verdict):
        if self._slo is not None:
            # edge-triggered upstream: one episode a stall, however long
            self._slo.record_stall_episode()
        try:
            path = self.dump_flight_record(verdict=verdict)
            logger.error('pipeline stalled; flight record written to %s', path)
        except Exception:
            logger.exception('failed to write flight record')

    def dump_flight_record(self, path=None, verdict=None):
        """Write a flight record (the verdict, heartbeats, stats snapshot,
        queue occupancy, every thread's stack, the span tail when tracing,
        and the lineage, latency, SLO and goodput summaries) and return
        its path. The watchdog calls this on a stall; call it for a dump
        on demand. ``path=None`` names a file in ``flight_record_dir`` (or
        the temp directory). The last :meth:`profile`'s ``roofline``
        summary and the controller's ``autotune`` section join when there
        are any."""
        if verdict is None:
            if self._watchdog is not None:
                verdict = self._watchdog.evaluate()
            else:
                verdict = classify_pipeline(self.health.heartbeats(),
                                            self._pool.stats.snapshot())
        snapshot = self._pool.stats.snapshot()
        queues = {name: snapshot.get(name, 0) for name in (
            'queue_depth', 'queue_depth_max', 'shuffle_buffer_depth',
            'readahead_depth', 'prefetch_occupancy',
            'prefetch_occupancy_max')}
        latency = self._pool.stats.latency
        slo_verdict = None
        if self._slo is not None:
            try:
                slo_verdict = self._slo.evaluate()
            except Exception:
                logger.exception('SLO evaluation failed for flight record')
        record = build_flight_record(
            verdict, self.health.heartbeats(), snapshot, queues,
            tracer=self.tracer,
            lineage=(self.lineage.flight_summary() if self.lineage.enabled
                     else None),
            roofline=(profiler.roofline_summary(self._last_profile)
                      if self._last_profile is not None else None),
            latency=latency.flight_summary() if latency is not None else None,
            slo=slo_verdict,
            autotune=(self._controller.flight_summary()
                      if self._controller is not None else None),
            goodput=(self._goodput.flight_summary()
                     if self._goodput is not None else None))
        if path is None:
            out_dir = self._flight_record_dir or tempfile.gettempdir()
            path = os.path.join(out_dir, 'petastorm_tpu_flight_{}_{}.json'
                                .format(os.getpid(), int(time.time())))
        return write_flight_record(path, record)

    def register_goodput(self, monitor):
        """Attach a loader's :class:`~petastorm_tpu_torch.goodput.
        GoodputMonitor`: ``/goodput``, ``/diagnostics`` and flight records
        serve its per-step accounting. The port's loaders call this when
        made; the latest wins (one consumer loop a reader)."""
        self._goodput = monitor

    def _goodput_route(self):
        """``GET /goodput``: the monitor's summary once a loader registered
        one, else a not-yet-attached marker (the plane is on: a 404 would
        read as switched off)."""
        if self._goodput is None:
            return {'enabled': True, 'attached': False}
        return self._goodput.summary()

    @property
    def watchdog(self):
        """The :class:`~petastorm_tpu_torch.health.PipelineWatchdog` (None
        unless built with ``stall_timeout=`` or a debug port):
        ``reader.watchdog.evaluate()`` classifies the pipeline now."""
        return self._watchdog

    @property
    def debug_port(self):
        """The debug endpoint's bound port (None when no server runs; not
        the requested one when that was 0)."""
        return (self._debug_server.port if self._debug_server is not None
                else None)

    # -- lineage -------------------------------------------------------------

    @property
    def last_provenance(self):
        """The :class:`~petastorm_tpu_torch.lineage.Provenance` of the item
        last yielded from (None before the first, with lineage off, or
        once evicted from the ring)."""
        return self.lineage.resolve(self.last_seq)

    def explain_batch(self, batch=None):
        """Where a batch's rows came from. ``None``: the item last yielded
        (for batched output, that is the batch: one row group); a loader
        batch dict holding ``'_provenance'``, or a
        :class:`~petastorm_tpu_torch.lineage.BatchProvenance`: each source
        row group with its rows, selection and shuffle quality."""
        if batch is None:
            record = self.last_provenance
            if record is None:
                return {'enabled': self.lineage.enabled, 'sources': []}
            return {'enabled': True, 'rows': record.rows,
                    'sources': [dict(record._asdict(),
                                     selection=list(record.selection))]}
        if isinstance(batch, dict):
            batch = batch_provenance_of(batch) or batch
        if isinstance(batch, BatchProvenance):
            return dict(batch.summary(), enabled=True)
        raise TypeError('explain_batch needs None, a loader batch dict with '
                        "a '_provenance' entry, or a BatchProvenance; got "
                        '{!r}'.format(type(batch)))

    def replay(self, provenance):
        """The rows behind ``provenance`` (a
        :class:`~petastorm_tpu_torch.lineage.Provenance`, a registered seq,
        a ``BatchProvenance`` or a loader batch dict) fetched again through
        this reader's worker: a dict of numpy columns, bit for bit what was
        delivered where the decode and the transform are deterministic."""
        return _lineage_replay(self, provenance)

    def audit(self) -> CoverageAuditor:
        """A :class:`~petastorm_tpu_torch.lineage.CoverageAuditor` over this
        reader's ledgers (``audit().report()``, ``assert_complete()``)."""
        return CoverageAuditor(self.lineage)

    def _replay_worker(self):
        """A worker of this reader's load with no readahead, no cache and
        no lineage: what :func:`~petastorm_tpu_torch.lineage.replay` runs
        items on."""
        return self._spec.for_replay().make_worker()

    # -- the stats, latency and tracing planes -------------------------------

    @property
    def stats(self):
        """The pool's :class:`~petastorm_tpu_torch.workers.stats.ReaderStats`:
        the live per-stage telemetry (the loader and the staging record
        into it too)."""
        return self._pool.stats

    @property
    def diagnostics(self) -> dict:
        """The pool's accounting and a snapshot of :attr:`stats`."""
        return dict(self._pool.diagnostics)

    @property
    def latency(self):
        """The per-stage latency histograms
        (:class:`~petastorm_tpu_torch.latency.PipelineLatency`), None under
        ``PETASTORM_TPU_LATENCY=0``."""
        return self._pool.stats.latency

    @property
    def tracer(self):
        """The pool's :class:`~petastorm_tpu_torch.tracing.Tracer` (None
        unless built with ``trace=`` or ``PETASTORM_TPU_TRACE``):
        ``reader.tracer.export_chrome_trace(path)`` writes a timeline
        Perfetto opens; the loader and the staging record into it too."""
        return self._pool.tracer

    @property
    def slo(self):
        """The :class:`~petastorm_tpu_torch.latency.SLOMonitor` of ``slo=``
        (None without): ``reader.slo.evaluate()`` is a verdict now."""
        return self._slo

    def _stats_snapshot(self) -> dict:
        """What the metrics emitter, the SLO monitor, ``/metrics`` and the
        controller read (JAX :1244-1262): the stats snapshot, the
        device-decode fraction, the roofline gauges of the last
        :meth:`profile` (``stage_ceiling_*``, ``roofline_fraction``,
        ``binding_stage``) and the controller's gauges."""
        snapshot = self._pool.stats.snapshot()
        fraction = device_decode_fraction(snapshot)
        if fraction is not None:
            snapshot['device_decode_fraction'] = fraction
        if self._roofline_gauges:
            snapshot.update(self._roofline_gauges)
        if self._controller is not None:
            snapshot.update(self._controller.gauges())
        return snapshot

    # -- the roofline profiler and autotune ----------------------------------

    def profile(self, calibrate='auto', sample_row_groups: int = 3,
                samples_per_sec=None, device=None) -> dict:
        """The roofline profile of this reader now (JAX :1264-1303): the
        measured rate against the per-stage ceilings calibrated on this
        host, this dataset's view and ``device``, the binding stage,
        overlap-aware span attribution and the advisor's ranked knob
        moves.

        ``calibrate``: ``'cached'`` only loads a saved calibration (never
        probes), ``'auto'`` probes on a miss, ``'force'`` always probes;
        the probes run on the calling thread, against sampled row groups.
        ``device`` is where the staging probe stages (None: the
        controller's ``device`` option, else the last ``profile()``'s,
        else CUDA; ``'cpu'`` only when asked). ``samples_per_sec``
        overrides the measured rate when the caller measured it; otherwise
        it is the stats window's items/s times the calibrated rows per row
        group. Raises ``RuntimeError`` under ``PETASTORM_TPU_PROFILER=0``."""
        if not profiler.profiler_enabled():
            raise RuntimeError('the roofline profiler is disabled via {}=0'
                               .format(profiler.PROFILER_ENV_VAR))
        if device is not None:
            self._profile_device = device
        calibration = profiler.get_calibration(
            self.dataset_path, self.pieces, self._view, mode=calibrate,
            sample_row_groups=sample_row_groups,
            device=self._profile_device, filesystem=self._filesystem)
        self.calibration = calibration
        spans = self.tracer.spans() if self.tracer is not None else None
        result = profiler.build_profile(
            self._pool.stats.snapshot(), calibration, spans=spans,
            samples_per_sec=samples_per_sec,
            workers_count=self._pool.workers_count,
            io_readahead=self._io_readahead, pool_type=self._pool_type,
            cache_type=self._cache_type)
        self._last_profile = result
        self._roofline_gauges = profiler.roofline_gauges(result)
        return result

    def explain_throughput(self, calibrate='auto', device=None) -> str:
        """One sentence: "measured X samples/s = Y% of the binding stage's
        ceiling Z", and the advisor's top moves; runs :meth:`profile`."""
        return profiler.explain(self.profile(calibrate=calibrate,
                                             device=device))

    def _profile_route(self):
        """``GET /profile``: the last :meth:`profile` while there is one
        (a scrape must stay cheap), else a profile over a cached
        calibration (never probing), not kept while uncalibrated."""
        if self._last_profile is not None:
            return dict(self._last_profile, from_cache=True)
        fresh = self.profile(calibrate='cached')
        if not fresh.get('calibrated'):
            self._last_profile = None
            self._roofline_gauges = {}
        return fresh

    @property
    def autotune(self):
        """The :class:`~petastorm_tpu_torch.autotune.PipelineController`
        (None unless autotune resolved on, minus the kill switch, over a
        thread or process pool): ``reader.autotune.report()`` is what
        ``/autotune`` serves."""
        return self._controller

    # -- lifecycle -----------------------------------------------------------

    def next(self):
        """``next(reader)``, the name of original petastorm's reader API."""
        return self.__next__()

    def stop(self):
        """Stop the pool; the controller, the metrics emitter and the
        watchdog are told to stop first and the debug server is stopped
        after, even when the pool dies uncleanly: no monitoring thread
        outlives the pipeline. Idempotent."""
        if self._controller is not None:
            # a tick that lands mid-teardown must find the stop event
            self._controller.stop(join=False)
        if self._metrics_emitter is not None:
            self._metrics_emitter.stop(join=False)
        if self._watchdog is not None:
            self._watchdog.stop(join=False)
        try:
            self._pool.stop()
        finally:
            if self._debug_server is not None:
                self._debug_server.stop()

    def join(self, timeout=None):
        """Join the controller (a tick must not actuate a pool being torn
        down), the pool, then the metrics emitter (which writes its final
        snapshot), the watchdog and the debug server (each join bounded),
        then export the Chrome trace when ``trace`` named a file."""
        if self._controller is not None:
            self._controller.stop()
        try:
            self._pool.join(timeout)
        finally:
            if self._metrics_emitter is not None:
                self._metrics_emitter.stop()
            if self._watchdog is not None:
                self._watchdog.stop()
            if self._debug_server is not None:
                self._debug_server.stop()
        if self._trace_export and self.tracer is not None:
            try:
                self.tracer.export_chrome_trace(self._trace_export)
            except OSError:
                logger.exception('Failed to export chrome trace to %s',
                                 self._trace_export)

    def cleanup(self):
        """Nothing to release beyond :meth:`stop` and :meth:`join` (original
        petastorm's reader API)."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()
