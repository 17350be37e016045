"""Per-stage pipeline telemetry shared by every worker pool.

The port's copy of ``petastorm_tpu/workers/stats.py``: the same stage,
counter and gauge names (:data:`TIME_STAGES`, :data:`COUNTERS`,
:data:`GAUGES`, :data:`DERIVED`), so :func:`stage_keys` is the same tuple
and one scrape configuration reads both packages. The resilience counters
(``io_retries``, ``io_hedges``, ``io_hedge_wins``, ``io_hedge_losses``,
``io_permanent_failures``, ``worker_respawns``, ``items_redispatched``,
``poison_items_quarantined``) come from the workers' reads and the pools'
recovery; those whose producers come with later slices of the port
(``hosts_*``, ranged reads and the like) stay in the tuples at 0.

One :class:`ReaderStats` lives on each pool (``pool.stats``) and is read
through ``Reader.stats`` and ``Reader.diagnostics``. Worker times, counts,
gauges and latency deltas are accumulated on the worker
(:class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorker`) and
drained by the pool after each item: thread and dummy pools merge them
here directly, the process pool ships them in the item's ``ITEM_DONE``
control frame. numpy only: worker interpreters import it.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from petastorm_tpu_torch.latency import PipelineLatency, latency_enabled

#: Wall-time stages, in pipeline order. All are seconds.
TIME_STAGES = (
    'worker_io_s',       # storage stall inside the worker (inline reads +
                         # time blocked waiting on an unfinished prefetch)
    'readahead_io_s',    # parquet reads issued by the background readahead
                         # thread (overlaps worker_decode_s by construction)
    'readahead_wait_s',  # worker blocked on a prefetched-but-unfinished read
                         # (the un-hidden part of readahead_io_s; also
                         # counted in worker_io_s)
    'worker_decode_s',   # codec decode / transform inside the worker
    'worker_publish_wait_s',  # worker blocked on a full results queue
    'serialize_s',       # payload -> transport frames (process pools)
    'deserialize_s',     # transport frames -> payload (consumer side)
    'queue_wait_s',      # consumer blocked waiting for a result
    'device_stage_s',    # host -> device staging dispatch
    # goodput plane (docs/goodput.md): per-training-step decomposition summed
    # by the loader's GoodputMonitor. Additive seconds — pod aggregation sums
    # them and re-derives the fractions, never averages fractions.
    'goodput_total_s',   # consumer step wall (infeed wait + train wall)
    'goodput_stall_s',   # pure data stall (fetch wait not covered by h2d)
    'goodput_h2d_s',     # h2d staging seconds on the step's critical path
    'goodput_device_s',  # device compute (fence wait; whole train wall when
                         # unfenced)
    'goodput_host_s',    # host-side overhead inside the train wall (fenced
                         # steps only)
)

#: Monotonic counters.
COUNTERS = (
    'bytes_moved',       # payload bytes that crossed the worker->consumer hop
    'payload_copies',    # full-payload memcpys made by the transport
    'payload_frames',    # transport frames shipped (multipart parts)
    'items_out',         # results delivered to the consumer
    'readahead_hits',    # row-group reads served from the prefetch queue
    'readahead_misses',  # row-group reads that went inline (not prefetched)
    'rows_quarantined',  # rows dropped under on_decode_error='skip'/'quarantine'
    'items_quarantined',  # quarantine/skip events (items or row batches)
    'rows_decoded_batched',  # codec column cells decoded by the vectorized
                             # row-group path (docs/decode.md)
    'rows_decoded_percell',  # codec column cells that fell back to the
                             # per-cell loop (wildcard shapes, nulls,
                             # decode hints, punted/corrupt chunks)
    'rows_decoded_device',   # codec column cells decoded on the device
                             # from bytes-through raw payloads
                             # (ops/decode.py, docs/decode.md)
    'bytes_shipped_raw',     # raw (undecoded) payload bytes workers shipped
                             # for device-planned columns instead of
                             # host-decoding them
    'shared_hits',       # row groups served from the host-wide shared cache
    'shared_misses',     # shared-cache lookups that fell through to io+decode
    'shared_evictions',  # shared-cache segments evicted/spilled (this reader)
    'shared_put_failures',  # cache segment publications that failed
                            # (ENOSPC/serialization) and degraded to direct
                            # decode — a named degradation cause in /healthz
    'io_retries',        # row-group/prefetch reads re-attempted after a
                         # transient storage error (docs/robustness.md)
    'io_hedges',         # duplicate reads fired when the primary exceeded
                         # the live hedge threshold
    'io_hedge_wins',     # hedged reads where the DUPLICATE finished first
    'io_hedge_losses',   # hedged reads where the primary still won
    'io_permanent_failures',  # reads that failed with a non-retryable
                              # (request-shaped) error
    'worker_respawns',   # crashed workers replaced by the pool supervisor
    'items_redispatched',  # in-flight items re-ventilated after a worker
                           # crash (exactly-once: deficit-checked first)
    'poison_items_quarantined',  # items quarantined after killing workers
                                 # repeatedly (no crash loop)
    'peer_skipped_dead',  # peer-cache fetches skipped because the peer was
                          # inside its dead-peer cooldown window
    'hosts_joined',      # pod members admitted by the elasticity plane
                         # (podelastic; docs/robustness.md)
    'hosts_died',        # pod members declared dead (heartbeat expiry) —
                         # a named degradation cause in /healthz
    'leases_rebalanced',  # shard leases that moved to a different host
                          # after a membership change
    'rows_resumed',      # rows a takeover host resumed from a dead host's
                         # checkpointed lease cursor (never re-delivered)
)

#: Occupancy gauges; each also keeps a ``<name>_max`` high-water mark.
#: ``shared_cache_bytes`` samples the host-wide tiered cache's approximate
#: resident bytes (tier 0 + tier 1) as seen by this reader's workers.
#: ``prefetch_occupancy`` samples the device-prefetch ring's buffered-batch
#: count at every enqueue/dequeue — an empty ring at step boundaries is the
#: classic starving signal (docs/goodput.md).
GAUGES = ('queue_depth', 'shuffle_buffer_depth', 'readahead_depth',
          'shared_cache_bytes', 'prefetch_occupancy')

#: Derived keys added to every snapshot (not accumulated directly).
#: ``items_per_s``/``mb_per_s`` are rates over the snapshot window — the time
#: since construction or the last :meth:`ReaderStats.reset` — so benchmarks
#: that ``reset()`` after warmup read steady-state rates, and the metrics
#: emitter / throughput CLI stop recomputing them ad hoc. The ``*_p50_s`` /
#: ``*_p99_s`` keys are tail-latency estimates from the streaming histograms
#: (``docs/latency.md``); 0.0 when the latency plane is disabled or has no
#: observations yet.
DERIVED = ('io_overlap_fraction', 'window_s', 'items_per_s', 'mb_per_s',
           'queue_wait_p50_s', 'queue_wait_p99_s', 'e2e_latency_p99_s',
           'io_range_p99_s', 'peer_fetch_p99_s')

#: Conditionally-derived goodput keys (docs/goodput.md): present only once
#: the goodput plane has closed at least one step (``goodput_total_s > 0``)
#: — a snapshot must never read "0% goodput" for a pipeline that simply has
#: no training loop attached. Fractions are re-derived from the summed
#: seconds at every snapshot, never accumulated.
GOODPUT_DERIVED = ('goodput_fraction', 'data_stall_fraction')

#: Snapshot key carrying the raw per-stage histogram states (bucket-count
#: pairs + sum/count) when the latency plane is on — what ``/metrics``
#: renders as Prometheus histograms and flight records embed. Absent under
#: the ``PETASTORM_TPU_LATENCY=0`` kill switch.
LATENCY_HISTOGRAMS_KEY = '_latency_histograms'

_MB = 1024.0 * 1024.0


class ReaderStats:
    """Thread-safe per-stage accumulator. All keys exist from construction so
    ``snapshot()`` has a stable schema regardless of pool type."""

    __slots__ = ('_lock', '_times', '_counts', '_gauges', '_window_start',
                 'latency')

    def __init__(self):
        self._lock = threading.Lock()
        #: The per-stage tail-latency plane (:class:`PipelineLatency`), or
        #: ``None`` under the ``PETASTORM_TPU_LATENCY=0`` kill switch — every
        #: feed site is a single attribute test. Fed from the same timing
        #: sites as the stage sums (see ``docs/latency.md``).
        self.latency = PipelineLatency() if latency_enabled() else None
        self._init_locked()

    def _init_locked(self):
        self._times = {stage: 0.0 for stage in TIME_STAGES}
        self._counts = {name: 0 for name in COUNTERS}
        self._gauges = {}
        for name in GAUGES:
            self._gauges[name] = 0
            self._gauges[name + '_max'] = 0
        self._window_start = time.perf_counter()

    def reset(self) -> None:
        """Zero every stage/counter/gauge and restart the snapshot window.
        Benchmarks call this after warmup so the measured window excludes
        warmup decode/io (and the derived rates cover only what was
        measured)."""
        with self._lock:
            self._init_locked()
        if self.latency is not None:
            self.latency.reset()

    def record_latency(self, stage: str, seconds: float) -> None:
        """Record one per-observation duration against a latency stage
        (:data:`petastorm_tpu_torch.latency.STAGES`); no-op when the latency plane
        is disabled."""
        latency = self.latency
        if latency is not None:
            latency.record(stage, seconds)

    def merge_latency(self, deltas) -> None:
        """Absorb a worker's drained ``{stage: bucket-delta}`` mapping
        (shipped back in the accounting control message, exactly like
        :meth:`merge_counts` — a dead worker loses only unshipped deltas)."""
        latency = self.latency
        if latency is not None and deltas:
            latency.merge_deltas(deltas)

    def add_time(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._times[stage] = self._times.get(stage, 0.0) + seconds

    def merge_times(self, stage_seconds) -> None:
        """Accumulate a ``{stage: seconds}`` mapping (shipped back from a
        process worker)."""
        if not stage_seconds:
            return
        with self._lock:
            for stage, seconds in stage_seconds.items():
                self._times[stage] = self._times.get(stage, 0.0) + seconds

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._counts[counter] = self._counts.get(counter, 0) + n

    def merge_counts(self, counters) -> None:
        """Accumulate a ``{counter: n}`` mapping (shipped back from a process
        worker)."""
        if not counters:
            return
        with self._lock:
            for name, n in counters.items():
                self._counts[name] = self._counts.get(name, 0) + n

    def merge_gauges(self, gauges) -> None:
        """Apply a ``{gauge: value}`` mapping of fresh samples."""
        if not gauges:
            return
        for name, value in gauges.items():
            self.gauge(name, value)

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value
            key = name + '_max'
            if value > self._gauges.get(key, 0):
                self._gauges[key] = value

    @contextmanager
    def timed(self, stage: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add_time(stage, time.perf_counter() - start)

    def snapshot(self) -> dict:
        """One flat dict of every stage/counter/gauge (stable key set), plus
        the derived keys: ``io_overlap_fraction`` (share of readahead read
        time hidden behind decode, ``1 - readahead_wait_s / readahead_io_s``;
        0.0 when readahead is off), ``window_s`` (seconds since construction
        or the last :meth:`reset`), and the window rates ``items_per_s`` /
        ``mb_per_s`` (items and payload MB delivered per window second;
        ``mb_per_s`` is 0 for in-process pools, which move no transport
        bytes)."""
        with self._lock:
            out = dict(self._times)
            out.update(self._counts)
            out.update(self._gauges)
            window = time.perf_counter() - self._window_start
        ra_io = out.get('readahead_io_s', 0.0)
        ra_wait = out.get('readahead_wait_s', 0.0)
        out['io_overlap_fraction'] = (
            max(0.0, 1.0 - ra_wait / ra_io) if ra_io > 0 else 0.0)
        out['window_s'] = window
        out['items_per_s'] = out['items_out'] / window if window > 0 else 0.0
        out['mb_per_s'] = (out['bytes_moved'] / _MB / window
                           if window > 0 else 0.0)
        # tail-latency derived keys (computed outside the stats lock: the
        # histograms carry their own locks and are never nested under it)
        latency = self.latency
        if latency is not None:
            queue_wait = latency.histograms['queue_wait']
            e2e = latency.histograms['e2e_batch']
            out['queue_wait_p50_s'] = queue_wait.quantile(0.5) or 0.0
            out['queue_wait_p99_s'] = queue_wait.quantile(0.99) or 0.0
            out['e2e_latency_p99_s'] = e2e.quantile(0.99) or 0.0
            # read-plane tails (docs/pod_observability.md): lets the health
            # verdict NAME a slow object store / slow peer cache
            out['io_range_p99_s'] = (
                latency.histograms['io_range'].quantile(0.99) or 0.0)
            out['peer_fetch_p99_s'] = (
                latency.histograms['peer_fetch'].quantile(0.99) or 0.0)
            state = latency.export_state()
            if state:   # stages with observations only; never an empty key
                out[LATENCY_HISTOGRAMS_KEY] = state
        else:
            out['queue_wait_p50_s'] = 0.0
            out['queue_wait_p99_s'] = 0.0
            out['e2e_latency_p99_s'] = 0.0
            out['io_range_p99_s'] = 0.0
            out['peer_fetch_p99_s'] = 0.0
        # goodput fractions: only once a training step closed — no loader
        # (or the PETASTORM_TPU_GOODPUT=0 kill switch) means no keys at all
        fraction = goodput_fraction(out)
        if fraction is not None:
            out['goodput_fraction'] = fraction
            out['data_stall_fraction'] = data_stall_fraction(out)
        return out


def finalize_item_times(times: dict, elapsed: float,
                        transport_s: float = 0.0) -> dict:
    """Derive ``worker_decode_s`` for one processed item so the stages sum
    sanely: decode = total ``process()`` wall time minus transport time
    (serialize + publish wait) minus the already-itemized io read time.
    Mutates and returns ``times`` (the worker's drained stage dict). The one
    definition shared by the thread/process/dummy pools."""
    times['worker_decode_s'] = times.get('worker_decode_s', 0.0) \
        + max(0.0, elapsed - transport_s - times.get('worker_io_s', 0.0))
    return times


def stage_keys() -> tuple:
    """The stable key set of :meth:`ReaderStats.snapshot` (tests assert it)."""
    keys = list(TIME_STAGES) + list(COUNTERS)
    for name in GAUGES:
        keys.extend((name, name + '_max'))
    keys.extend(DERIVED)
    return tuple(keys)


def effective_io_s(snapshot: dict) -> float:
    """Total storage-read seconds in a snapshot: inline stall plus background
    readahead reads, minus the blocked wait that is counted in both
    ``worker_io_s`` and ``readahead_io_s``. The one definition every io:decode
    consumer (``recommend_io_readahead``, ``torch_utils.infeed_diagnosis``)
    shares."""
    return (snapshot.get('worker_io_s', 0.0)
            + snapshot.get('readahead_io_s', 0.0)
            - snapshot.get('readahead_wait_s', 0.0))


def progress_marker(snapshot: dict) -> tuple:
    """``(items_out, bytes_moved)`` of a snapshot — the monotone pair the
    :class:`~petastorm_tpu_torch.health.PipelineWatchdog` compares across
    ticks to report whether the pipeline made any global progress between
    evaluations (``items_out_delta`` in its verdict)."""
    return (snapshot.get('items_out', 0), snapshot.get('bytes_moved', 0))


def readahead_hit_rate(snapshot: dict) -> float:
    """Fraction of row-group reads served from the prefetch queue."""
    hits = snapshot.get('readahead_hits', 0)
    return hits / max(1, hits + snapshot.get('readahead_misses', 0))


def batched_decode_fraction(snapshot: dict):
    """Fraction of codec column cells decoded by the vectorized row-group
    path (``None`` when no codec cells were decoded at all — scalar-only
    views must not read as "0% batched"). A decode-bound pipeline showing
    a low fraction here is paying per-cell Python the batched path exists
    to remove — ``docs/troubleshooting.md`` has the triage."""
    batched = snapshot.get('rows_decoded_batched', 0)
    percell = snapshot.get('rows_decoded_percell', 0)
    total = batched + percell
    if not total:
        return None
    return round(batched / total, 4)


def device_decode_fraction(snapshot: dict):
    """Fraction of codec column cells decoded on the device
    (``None`` when no codec cells were decoded anywhere — same contract as
    :func:`batched_decode_fraction`). A bytes-through epoch on an all-
    eligible view reads ≈1.0; anything lower means columns declined to the
    host matrix (``docs/decode.md`` has the eligibility table) or raw
    chunks failed validation and were host-decoded + repacked."""
    device = snapshot.get('rows_decoded_device', 0)
    host = (snapshot.get('rows_decoded_batched', 0)
            + snapshot.get('rows_decoded_percell', 0))
    total = device + host
    if not total:
        return None
    return round(device / total, 4)


def goodput_fraction(snapshot: dict):
    """Fraction of consumer step wall time spent in device compute
    (``goodput_device_s / goodput_total_s``; ``None`` before any training
    step closed — an idle reader must not read as 0% goodput). Re-derived
    from the summed seconds so pod aggregation (which sums the seconds
    across hosts) yields the true pod fraction, not an average of per-host
    fractions. See ``docs/goodput.md``."""
    total = snapshot.get('goodput_total_s', 0.0)
    if not total or total <= 0.0:
        return None
    return round(snapshot.get('goodput_device_s', 0.0) / total, 4)


def data_stall_fraction(snapshot: dict):
    """Fraction of consumer step wall time the device (or the unfenced
    train loop) waited on data: pure pipeline stall plus the h2d staging
    seconds on the critical path, over the step wall. Same ``None``
    contract as :func:`goodput_fraction`."""
    total = snapshot.get('goodput_total_s', 0.0)
    if not total or total <= 0.0:
        return None
    stalled = (snapshot.get('goodput_stall_s', 0.0)
               + snapshot.get('goodput_h2d_s', 0.0))
    return round(stalled / total, 4)


def recommend_io_readahead(snapshot: dict, max_depth: int = 8) -> int:
    """Suggested ``io_readahead`` depth from a :meth:`ReaderStats.snapshot`.

    The worker-side ``depth='auto'`` controller applies the same formula to
    its live local measurements; this consumer-side variant lets users tune a
    fixed depth from ``reader.diagnostics`` after a profiling run. Effective
    read time (:func:`effective_io_s`) over decode time is the io:decode
    ratio; a pipeline needs roughly ``ceil(io / decode)`` reads in flight to
    keep decode fed."""
    import math
    io_s = effective_io_s(snapshot)
    decode_s = snapshot.get('worker_decode_s', 0.0)
    if io_s <= 0 or decode_s <= 0:
        return 1
    return int(min(max_depth, max(1, math.ceil(io_s / decode_s))))
