"""Tail-latency plane: mergeable streaming histograms and an SLO monitor.

The port's copy of ``petastorm_tpu/latency.py``, with its constants, bucket
scheme and key names, so histograms, deltas and Prometheus text of the two
packages are interchangeable. numpy only: worker interpreters import it.

- :class:`LatencyHistogram` (JAX :164): a log-bucketed streaming histogram
  over **fixed geometric bucket bounds** (module constants), so any two
  instances merge by adding bucket counts; quantiles interpolate
  geometrically inside the covering bucket, within
  :data:`QUANTILE_REL_ERROR_BOUND` of the exact sample quantile. Beside the
  cumulative counts it keeps a ring of per-interval counts: "p99 over the
  last 30 s".
- :class:`LatencyDeltas` (:350): a worker's accumulator; process workers
  ship ``{stage: delta}`` in the item's accounting frame.
- :class:`PipelineLatency` (:412): the consumer's per-stage histograms
  (:data:`STAGES`), owned by ``ReaderStats``.
- :func:`validate_slo_targets` (:536) and :class:`SLOMonitor` (:576):
  declarative targets with error-budget burn accounting.
- :func:`prometheus_histogram_lines` (:749): one histogram in Prometheus
  text form.

On by default; ``PETASTORM_TPU_LATENCY=0`` (the JAX package's variable)
creates no histogram anywhere.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

#: Environment variable gating the whole latency plane (default on).
#: ``0``/``false``/``off`` mean no histograms exist anywhere: ``ReaderStats``
#: carries ``latency=None``, workers get ``latency=False`` in their args, and
#: every record site is one attribute test.
LATENCY_ENV_VAR = 'PETASTORM_TPU_LATENCY'

#: Per-observation duration stages (seconds). ``io``/``decode`` are fed from
#: the worker's ``record_time`` sites (one observation per timed read/decode
#: section, not per item); ``queue_wait``/``deserialize`` from the consumer's
#: delivery path; ``infeed_wait``/``train_step`` from the loader's
#: iteration loop; ``device_stage`` from the staging helpers; ``e2e_batch``
#: is ventilate-timestamp → batch delivery, correlated through the lineage
#: seq (see ``docs/latency.md``); ``io_range`` is one planned object-store
#: range fetch (``ParallelRangeReader.fetch_range``, hedge+retry included);
#: ``peer_fetch`` is one shared-cache peer HTTP fetch attempt (see
#: ``docs/pod_observability.md``); ``device_step``/``host_overhead`` are the
#: goodput plane's per-step decomposition of the train wall (fence time vs
#: the rest — see ``docs/goodput.md``; ``host_overhead`` records only on
#: fenced steps, where the split was actually measured).
STAGES = ('io', 'decode', 'queue_wait', 'deserialize', 'infeed_wait',
          'train_step', 'device_stage', 'e2e_batch', 'io_range',
          'peer_fetch', 'device_step', 'host_overhead')

#: ``ReaderStats`` time-stage names → latency stage fed from the same
#: ``record_time`` call (worker-side observations).
TIME_STAGE_TO_LATENCY = {'worker_io_s': 'io', 'worker_decode_s': 'decode'}

#: Geometric bucket scheme. Boundaries are **fixed module-level constants**:
#: mergeability by bucket-count addition depends on every instance (and both
#: ends of the process boundary) agreeing on them, so they are never
#: configurable per instance. Bucket ``i`` counts observations
#: ``v <= BUCKET_BOUNDS_S[i]`` (and above the previous bound); one final
#: overflow bucket catches everything beyond the last bound (``+Inf``).
BUCKET_GROWTH = 2.0 ** 0.25          # ~1.189: 4 buckets per octave
FIRST_BUCKET_BOUND_S = 1e-6          # 1 µs
NUM_BUCKETS = 136                    # covers 1 µs .. ~1.4 h before overflow
BUCKET_BOUNDS_S = tuple(FIRST_BUCKET_BOUND_S * BUCKET_GROWTH ** i
                        for i in range(NUM_BUCKETS))

#: Worst-case relative error of :meth:`LatencyHistogram.quantile` against the
#: exact sample quantile: an observation can sit anywhere inside its covering
#: bucket, whose bounds differ by :data:`BUCKET_GROWTH` (~18.9%). Tests hold
#: the estimator to this bound on known distributions.
QUANTILE_REL_ERROR_BOUND = BUCKET_GROWTH - 1.0

#: Rolling-window defaults: a ring of ``DEFAULT_WINDOW_INTERVALS`` closed
#: interval snapshots of ``DEFAULT_INTERVAL_S`` each (+ the open interval)
#: answers "p99 over the last ~30s".
DEFAULT_INTERVAL_S = 5.0
DEFAULT_WINDOW_INTERVALS = 6

_LOG_GROWTH = math.log(BUCKET_GROWTH)
_LOG_FIRST = math.log(FIRST_BUCKET_BOUND_S)

_PERCENTILES = (('p50', 0.50), ('p90', 0.90), ('p99', 0.99), ('p999', 0.999))


def latency_enabled() -> bool:
    """The :data:`LATENCY_ENV_VAR` gate (default on)."""
    value = os.environ.get(LATENCY_ENV_VAR, '').strip().lower()
    return value not in ('0', 'false', 'off')


def bucket_index(seconds: float) -> int:
    """Index of the bucket counting ``seconds``: the smallest ``i`` with
    ``seconds <= BUCKET_BOUNDS_S[i]``, or :data:`NUM_BUCKETS` (overflow).
    Pure arithmetic — no search — because the bounds are geometric."""
    if seconds <= FIRST_BUCKET_BOUND_S:
        return 0
    index = int(math.ceil((math.log(seconds) - _LOG_FIRST) / _LOG_GROWTH
                          - 1e-9))
    if index >= NUM_BUCKETS:
        return NUM_BUCKETS
    # float log can land one bucket low at an exact boundary; nudge up
    if seconds > BUCKET_BOUNDS_S[index]:
        index += 1
    return min(index, NUM_BUCKETS)


def bucket_lower_bound(index: int) -> float:
    """Lower bound of bucket ``index`` (0 for the first bucket)."""
    if index <= 0:
        return 0.0
    return BUCKET_BOUNDS_S[min(index, NUM_BUCKETS) - 1]


def _quantile_from_counts(counts: np.ndarray, q: float) -> Optional[float]:
    """Estimate the ``q`` quantile from a bucket-count array (length
    ``NUM_BUCKETS + 1``, overflow last). Geometric interpolation inside the
    covering bucket; ``None`` when the histogram is empty. Overflow-bucket
    hits estimate at the last finite bound (the honest floor — the true
    value is *at least* that)."""
    total = int(counts.sum())
    if total == 0:
        return None
    rank = q * total
    cum = np.cumsum(counts)
    index = int(np.searchsorted(cum, rank, side='left'))
    if index >= NUM_BUCKETS:
        return BUCKET_BOUNDS_S[-1]
    in_bucket = int(counts[index])
    before = int(cum[index]) - in_bucket
    fraction = (rank - before) / in_bucket if in_bucket else 1.0
    fraction = min(1.0, max(0.0, fraction))
    lo = bucket_lower_bound(index)
    hi = BUCKET_BOUNDS_S[index]
    if lo <= 0.0:
        return hi * fraction
    # geometric interpolation: log-uniform within the bucket matches the
    # log-bucketed scheme (linear would bias estimates toward the upper edge)
    return lo * (hi / lo) ** fraction


class LatencyHistogram:
    """Thread-safe streaming histogram over the fixed geometric buckets.

    Holds cumulative counts since construction/:meth:`reset` plus a ring of
    closed per-interval count snapshots for rolling-window quantiles. All
    mutation is a lock + integer adds — cheap enough for per-observation
    calls on the sample path.

    ``interval_s``/``window_intervals`` size the rolling window;
    ``clock`` is injectable for tests (must be monotonic)."""

    __slots__ = ('_lock', '_counts', '_sum', '_count', '_interval_s',
                 '_window_intervals', '_clock', '_interval_counts',
                 '_interval_start', '_intervals')

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 window_intervals: int = DEFAULT_WINDOW_INTERVALS,
                 clock: Callable[[], float] = time.perf_counter):
        if interval_s <= 0:
            raise ValueError('interval_s must be positive, got '
                             '{!r}'.format(interval_s))
        if window_intervals < 1:
            raise ValueError('window_intervals must be >= 1, got '
                             '{!r}'.format(window_intervals))
        self._lock = threading.Lock()
        self._interval_s = interval_s
        self._window_intervals = window_intervals
        self._clock = clock
        self._init_locked()

    def _init_locked(self) -> None:
        # plain int lists, not numpy arrays: a scalar `list[i] += 1` is ~10x
        # cheaper than a numpy indexed increment, and record() is the hot
        # path — reads (quantiles, windows, exports) convert on demand
        self._counts = [0] * (NUM_BUCKETS + 1)
        self._sum = 0.0
        self._count = 0
        self._interval_counts = [0] * (NUM_BUCKETS + 1)
        self._interval_start = self._clock()
        # ring of closed interval count lists, newest last
        self._intervals: List[List[int]] = []

    def reset(self) -> None:
        with self._lock:
            self._init_locked()

    def _maybe_roll_locked(self, now: float) -> None:
        """Close elapsed intervals into the ring (empty intervals included —
        a quiet 20s must age old spikes out of the window)."""
        elapsed = now - self._interval_start
        if elapsed < self._interval_s:
            return
        steps = int(elapsed / self._interval_s)
        # first closed interval carries the accumulated counts ...
        self._intervals.append(self._interval_counts)
        # ... any further fully-elapsed intervals were silent
        empties = min(max(0, steps - 1), self._window_intervals)
        for _ in range(empties):
            self._intervals.append([0] * (NUM_BUCKETS + 1))
        if len(self._intervals) > self._window_intervals:
            del self._intervals[:len(self._intervals)
                                - self._window_intervals]
        self._interval_counts = [0] * (NUM_BUCKETS + 1)
        self._interval_start += steps * self._interval_s

    def record(self, seconds: float) -> None:
        """Record one observation."""
        if seconds < 0.0:
            seconds = 0.0
        index = bucket_index(seconds)
        with self._lock:
            self._maybe_roll_locked(self._clock())
            self._counts[index] += 1
            self._interval_counts[index] += 1
            self._sum += seconds
            self._count += 1

    def merge_delta(self, delta: dict) -> None:
        """Merge a shipped delta (``{'buckets': {index: n}, 'sum': s,
        'count': n}`` — what :meth:`LatencyDeltas.drain` produces). Pure
        bucket-count addition: the fixed boundaries make any two histograms
        (or a histogram and a delta) mergeable."""
        if not delta:
            return
        buckets = delta.get('buckets') or {}
        with self._lock:
            self._maybe_roll_locked(self._clock())
            for index, n in buckets.items():
                index = min(int(index), NUM_BUCKETS)
                self._counts[index] += n
                self._interval_counts[index] += n
            self._sum += float(delta.get('sum', 0.0))
            self._count += int(delta.get('count', 0))

    def merge(self, other: 'LatencyHistogram') -> None:
        """Merge another histogram's cumulative counts into this one."""
        with other._lock:
            counts = list(other._counts)
            total_sum, total_count = other._sum, other._count
        with self._lock:
            self._maybe_roll_locked(self._clock())
            for index, n in enumerate(counts):
                if n:
                    self._counts[index] += n
                    self._interval_counts[index] += n
            self._sum += total_sum
            self._count += total_count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum_s(self) -> float:
        with self._lock:
            return self._sum

    def counts(self) -> np.ndarray:
        """Copy of the cumulative bucket counts (overflow last)."""
        with self._lock:
            return np.asarray(self._counts, dtype=np.int64)

    def _window_counts_locked(self) -> np.ndarray:
        window = np.asarray(self._interval_counts, dtype=np.int64)
        for interval in self._intervals:
            window = window + np.asarray(interval, dtype=np.int64)
        return window

    def window_counts(self) -> np.ndarray:
        """Bucket counts over the rolling window (closed ring intervals plus
        the open one)."""
        with self._lock:
            self._maybe_roll_locked(self._clock())
            return self._window_counts_locked()

    def window_span_s(self) -> float:
        """The wall span the rolling window currently covers."""
        with self._lock:
            self._maybe_roll_locked(self._clock())
            now = self._clock()
            return (len(self._intervals) * self._interval_s
                    + max(0.0, now - self._interval_start))

    def quantile(self, q: float, window: bool = False) -> Optional[float]:
        """Estimated ``q`` quantile in seconds (``None`` when empty);
        ``window=True`` answers over the rolling window only."""
        if not 0.0 < q < 1.0:
            raise ValueError('q must be in (0, 1), got {!r}'.format(q))
        with self._lock:
            self._maybe_roll_locked(self._clock())
            counts = (self._window_counts_locked() if window
                      else np.asarray(self._counts, dtype=np.int64))
        return _quantile_from_counts(counts, q)

    def percentiles(self, window: bool = False) -> Dict[str, Optional[float]]:
        """``{'p50', 'p90', 'p99', 'p999'}`` in one pass."""
        with self._lock:
            self._maybe_roll_locked(self._clock())
            counts = (self._window_counts_locked() if window
                      else np.asarray(self._counts, dtype=np.int64))
        return {name: _quantile_from_counts(counts, q)
                for name, q in _PERCENTILES}

    def recent_interval_p99s(self) -> List[Optional[float]]:
        """Per-closed-interval p99 estimates, oldest first — the trend line a
        flight record embeds so a stall dump shows whether the tail blew up
        as a cliff or crept up over the whole window."""
        with self._lock:
            self._maybe_roll_locked(self._clock())
            intervals = [np.asarray(interval, dtype=np.int64)
                         for interval in self._intervals]
        return [_quantile_from_counts(interval, 0.99)
                for interval in intervals]

    def state(self) -> dict:
        """JSON-able export: nonzero ``(bucket_index, count)`` pairs plus
        ``sum``/``count`` — what Prometheus rendering and flight records
        consume (and what two processes could merge byte-for-byte)."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        return {'buckets': [[i, n] for i, n in enumerate(counts) if n],
                'sum': total_sum, 'count': total_count}


class LatencyDeltas:
    """Worker-side accumulator: buckets observations locally, drains compact
    deltas for the accounting message.

    Not locked: a worker records and drains on its own thread (the same
    single-writer discipline as ``WorkerBase.stage_times``), and the drained
    dict is immutable once shipped."""

    __slots__ = ('_stages',)

    def __init__(self):
        self._stages: Dict[str, dict] = {}

    def record(self, stage: str, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        entry = self._stages.get(stage)
        if entry is None:
            entry = self._stages[stage] = {'buckets': {}, 'sum': 0.0,
                                           'count': 0}
        index = bucket_index(seconds)
        buckets = entry['buckets']
        buckets[index] = buckets.get(index, 0) + 1
        entry['sum'] += seconds
        entry['count'] += 1

    def record_time_stage(self, stage: str, seconds: float) -> None:
        """Record against a ``ReaderStats`` time-stage name (``worker_io_s``
        → ``io``); non-latency stages are ignored."""
        mapped = TIME_STAGE_TO_LATENCY.get(stage)
        if mapped is not None:
            self.record(mapped, seconds)

    def absorb(self, deltas: Optional[Dict[str, dict]]) -> None:
        """Fold another drained ``{stage: delta}`` mapping into this
        accumulator (pure bucket-count addition). This is how a worker folds
        deltas drained from a component it owns (``ParallelRangeReader``,
        the shared cache) into its own per-message shipment — same
        single-writer discipline as :meth:`record`."""
        if not deltas:
            return
        for stage, delta in deltas.items():
            entry = self._stages.get(stage)
            if entry is None:
                entry = self._stages[stage] = {'buckets': {}, 'sum': 0.0,
                                               'count': 0}
            buckets = entry['buckets']
            for index, n in (delta.get('buckets') or {}).items():
                index = min(int(index), NUM_BUCKETS)
                buckets[index] = buckets.get(index, 0) + int(n)
            entry['sum'] += float(delta.get('sum', 0.0))
            entry['count'] += int(delta.get('count', 0))

    def drain(self) -> Optional[Dict[str, dict]]:
        """Return and reset the accumulated deltas (``None`` when empty), in
        the shape :meth:`PipelineLatency.merge_deltas` absorbs."""
        if not self._stages:
            return None
        stages, self._stages = self._stages, {}
        return stages


class PipelineLatency:
    """The consumer-side latency plane of one reader: a fixed set of
    per-stage :class:`LatencyHistogram`\\ s (:data:`STAGES`). Owned by
    ``ReaderStats`` (``stats.latency``); ``None`` there under the kill
    switch, so every feed site is a single attribute test."""

    __slots__ = ('histograms',)

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 window_intervals: int = DEFAULT_WINDOW_INTERVALS,
                 clock: Callable[[], float] = time.perf_counter):
        self.histograms: Dict[str, LatencyHistogram] = {
            stage: LatencyHistogram(interval_s=interval_s,
                                    window_intervals=window_intervals,
                                    clock=clock)
            for stage in STAGES}

    def record(self, stage: str, seconds: float) -> None:
        histogram = self.histograms.get(stage)
        if histogram is not None:
            histogram.record(seconds)

    def merge_deltas(self, deltas: Optional[Dict[str, dict]]) -> None:
        """Absorb a worker's drained ``{stage: delta}`` mapping (shipped in
        the accounting control message)."""
        if not deltas:
            return
        for stage, delta in deltas.items():
            histogram = self.histograms.get(stage)
            if histogram is not None:
                histogram.merge_delta(delta)

    def reset(self) -> None:
        for histogram in self.histograms.values():
            histogram.reset()

    def quantile(self, stage: str, q: float,
                 window: bool = False) -> Optional[float]:
        histogram = self.histograms.get(stage)
        return histogram.quantile(q, window=window) if histogram else None

    def window_p99s(self) -> Dict[str, float]:
        """Rolling-window p99 per stage, stages with window data only — the
        compact sensor view the autotune controller reads each tick (and a
        cheap answer to "what does the tail look like right now")."""
        out = {}
        for stage, histogram in self.histograms.items():
            p99 = histogram.quantile(0.99, window=True)
            if p99 is not None:
                out[stage] = p99
        return out

    def export_state(self) -> Dict[str, dict]:
        """``{stage: state}`` for stages with at least one observation —
        what rides under ``'_latency_histograms'`` in stats snapshots (and
        from there into ``/metrics`` histogram rendering and flight
        records)."""
        out = {}
        for stage, histogram in self.histograms.items():
            state = histogram.state()
            if state['count']:
                out[stage] = state
        return out

    def summary(self, window: bool = False) -> Dict[str, dict]:
        """Human-facing per-stage percentiles (stages with data only)."""
        out = {}
        for stage, histogram in self.histograms.items():
            count = histogram.count
            if not count:
                continue
            entry = {'count': count,
                     'sum_s': round(histogram.sum_s, 6)}
            for name, value in histogram.percentiles(window=window).items():
                entry[name + '_s'] = (round(value, 6)
                                      if value is not None else None)
            out[stage] = entry
        return out

    def flight_summary(self) -> dict:
        """The ``latency`` section of a flight record: lifetime + rolling
        window percentiles per stage, and the per-interval p99 trend (oldest
        first) so a stall dump distinguishes a cliff from a creep."""
        trend = {}
        for stage, histogram in self.histograms.items():
            p99s = histogram.recent_interval_p99s()
            if any(p is not None for p in p99s):
                trend[stage] = [round(p, 6) if p is not None else None
                                for p in p99s]
        return {'stages': self.summary(),
                'window': self.summary(window=True),
                'p99_trend': trend}


# -- SLO monitor --------------------------------------------------------------

#: Recognized SLO target keys (the ``slo=dict(...)`` factory knob).
SLO_TARGET_KEYS = ('p99_e2e_ms', 'p99_queue_wait_ms', 'min_samples_per_s',
                   'min_io_overlap_fraction', 'max_stall_episodes',
                   'min_goodput', 'error_budget', 'budget_window',
                   'fail_healthz', 'eval_interval_s', 'min_evaluations')

#: Fraction of evaluations allowed to breach before the budget is spent.
DEFAULT_ERROR_BUDGET = 0.01

#: Evaluation verdicts kept in the burn-accounting ring.
DEFAULT_BUDGET_WINDOW = 120

#: Minimum spacing between RECORDED burn samples. Evaluations inside the
#: interval still compute fresh checks but do not append to the ring, so the
#: burn rate is independent of how often observers look — a k8s probe every
#: 2s plus a Prometheus scrape every 5s advance the ring no faster than one
#: sample per interval (``error_budget`` keeps a fixed cadence to be a
#: budget *of*). ``eval_interval_s=0`` records every evaluation (tests).
DEFAULT_EVAL_INTERVAL_S = 5.0

#: Recorded evaluations required before ``hard_breach`` may assert: the
#: warmup grace. Without it, the FIRST evaluation of a cold pipeline (rates
#: still ramping) breaching ``min_samples_per_s`` reads as burn
#: ``1/error_budget`` and — under ``fail_healthz`` — 503s the pod into a
#: restart loop before it ever warms.
DEFAULT_MIN_EVALUATIONS = 10


def validate_slo_targets(targets: dict) -> dict:
    """Validate and normalize an ``slo=dict(...)`` knob at construction —
    a typo'd target name must fail the factory call, not silently never
    breach."""
    if not isinstance(targets, dict):
        raise ValueError('slo must be a dict of targets, got '
                         '{!r}'.format(type(targets)))
    unknown = set(targets) - set(SLO_TARGET_KEYS)
    if unknown:
        raise ValueError('unknown slo target(s) {}; valid keys: {}'.format(
            sorted(unknown), ', '.join(SLO_TARGET_KEYS)))
    out = dict(targets)
    budget = out.setdefault('error_budget', DEFAULT_ERROR_BUDGET)
    if not 0.0 < float(budget) <= 1.0:
        raise ValueError('error_budget must be in (0, 1], got '
                         '{!r}'.format(budget))
    window = out.setdefault('budget_window', DEFAULT_BUDGET_WINDOW)
    if int(window) < 1:
        raise ValueError('budget_window must be >= 1, got {!r}'.format(window))
    interval = out.setdefault('eval_interval_s', DEFAULT_EVAL_INTERVAL_S)
    if float(interval) < 0:
        raise ValueError('eval_interval_s must be >= 0, got '
                         '{!r}'.format(interval))
    min_evals = out.setdefault('min_evaluations', DEFAULT_MIN_EVALUATIONS)
    if int(min_evals) < 1:
        raise ValueError('min_evaluations must be >= 1, got '
                         '{!r}'.format(min_evals))
    out.setdefault('fail_healthz', False)
    for key in ('p99_e2e_ms', 'p99_queue_wait_ms', 'min_samples_per_s',
                'min_io_overlap_fraction', 'max_stall_episodes'):
        value = out.get(key)
        if value is not None and float(value) < 0:
            raise ValueError('{} must be >= 0, got {!r}'.format(key, value))
    goodput = out.get('min_goodput')
    if goodput is not None and not 0.0 <= float(goodput) <= 1.0:
        raise ValueError('min_goodput is a fraction in [0, 1], got '
                         '{!r}'.format(goodput))
    return out


class SLOMonitor:
    """Declarative SLO targets over the latency plane + stats snapshot, with
    error-budget burn accounting.

    Each :meth:`evaluate` compares the current rolling-window state against
    the targets; at most one pass/breach sample per ``eval_interval_s`` is
    RECORDED into a bounded ring (observers — ``/healthz`` probes, ``/slo``
    scrapes, ``/diagnostics`` — evaluate freely without advancing the burn
    accounting faster than the cadence, so the budget is probe-rate
    independent). The **burn rate** is the ring's breach fraction divided by
    the allowed ``error_budget`` (burn 1.0 = the budget is exactly spent;
    2.0 = breaching twice as often as allowed). ``hard_breach`` (burn >= 1,
    after at least ``min_evaluations`` recorded samples — the warmup grace)
    optionally flips ``/healthz`` to 503 when the ``fail_healthz`` target is
    set — the k8s hook for "this infeed is violating its SLO, recycle it".

    The watchdog thread drives periodic evaluations when armed
    (``stall_timeout=``); ``/slo`` and flight records evaluate on demand.

    Latency-based targets need the latency plane: under the kill switch (or
    before any observation) they report ``measured: None`` and **skip**
    rather than silently pass — the verdict carries ``skipped_checks`` so a
    disabled sensor is never mistaken for a green one.
    """

    def __init__(self, targets: dict,
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 latency: Optional[PipelineLatency] = None):
        self.targets = validate_slo_targets(targets)
        self._snapshot_fn = snapshot_fn
        self._latency = latency
        self._lock = threading.Lock()
        self._verdict_ring: List[bool] = []   # True = breached
        self._last_record_ts: Optional[float] = None
        self._stall_episodes = 0
        self.last_verdict: Optional[dict] = None

    @property
    def fail_healthz(self) -> bool:
        return bool(self.targets.get('fail_healthz'))

    def record_stall_episode(self) -> None:
        """Count one watchdog stall episode (edge-triggered upstream)."""
        with self._lock:
            self._stall_episodes += 1

    def _check_latency(self, checks, skipped, key, stage):
        target_ms = self.targets.get(key)
        if target_ms is None:
            return False
        measured = (self._latency.quantile(stage, 0.99, window=True)
                    if self._latency is not None else None)
        if measured is None:
            # no sensor (kill switch) or no data yet: skip, loudly
            checks[key] = {'target_ms': float(target_ms), 'measured_ms': None,
                           'ok': None}
            skipped.append(key)
            return False
        measured_ms = measured * 1000.0
        ok = measured_ms <= float(target_ms)
        checks[key] = {'target_ms': float(target_ms),
                       'measured_ms': round(measured_ms, 3), 'ok': ok}
        return not ok

    def evaluate(self, snapshot: Optional[dict] = None) -> dict:
        """One SLO evaluation: per-target verdicts, the breach list, and the
        updated burn accounting. JSON-able."""
        if snapshot is None and self._snapshot_fn is not None:
            snapshot = self._snapshot_fn()
        snapshot = snapshot or {}
        checks: Dict[str, dict] = {}
        skipped: List[str] = []
        breached = False

        breached |= self._check_latency(checks, skipped, 'p99_e2e_ms',
                                        'e2e_batch')
        breached |= self._check_latency(checks, skipped, 'p99_queue_wait_ms',
                                        'queue_wait')

        target = self.targets.get('min_samples_per_s')
        if target is not None:
            measured = snapshot.get('items_per_s')
            ok = measured is not None and measured >= float(target)
            checks['min_samples_per_s'] = {
                'target': float(target),
                'measured': round(measured, 3) if measured is not None
                else None,
                'ok': ok}
            breached |= not ok

        target = self.targets.get('min_io_overlap_fraction')
        if target is not None:
            measured = snapshot.get('io_overlap_fraction')
            ok = measured is not None and measured >= float(target)
            checks['min_io_overlap_fraction'] = {
                'target': float(target),
                'measured': round(measured, 4) if measured is not None
                else None,
                'ok': ok}
            breached |= not ok

        target = self.targets.get('min_goodput')
        if target is not None:
            # derived by ReaderStats.snapshot() once the goodput plane has
            # closed a step; None (plane kill-switched, or no loader steps
            # yet) skips loudly — same contract as the latency checks
            measured = snapshot.get('goodput_fraction')
            if measured is None:
                checks['min_goodput'] = {'target': float(target),
                                         'measured': None, 'ok': None}
                skipped.append('min_goodput')
            else:
                ok = measured >= float(target)
                checks['min_goodput'] = {'target': float(target),
                                         'measured': round(measured, 4),
                                         'ok': ok}
                breached |= not ok

        target = self.targets.get('max_stall_episodes')
        if target is not None:
            with self._lock:
                episodes = self._stall_episodes
            ok = episodes <= int(target)
            checks['max_stall_episodes'] = {'target': int(target),
                                            'measured': episodes, 'ok': ok}
            breached |= not ok

        budget = float(self.targets['error_budget'])
        window = int(self.targets['budget_window'])
        interval = float(self.targets['eval_interval_s'])
        min_evaluations = int(self.targets['min_evaluations'])
        now = time.perf_counter()
        with self._lock:
            # record at most one burn sample per interval: probe/scrape
            # frequency must not be able to flush (or multiply) breach
            # samples — the budget's cadence belongs to the monitor
            if (self._last_record_ts is None
                    or now - self._last_record_ts >= interval):
                self._last_record_ts = now
                self._verdict_ring.append(bool(breached))
                if len(self._verdict_ring) > window:
                    del self._verdict_ring[:len(self._verdict_ring) - window]
            evaluations = len(self._verdict_ring)
            breaches = sum(self._verdict_ring)
            episodes = self._stall_episodes
        breach_fraction = breaches / evaluations if evaluations else 0.0
        burn_rate = breach_fraction / budget if budget else 0.0
        verdict = {
            'targets': {k: v for k, v in self.targets.items()
                        if v is not None},
            'checks': checks,
            'breached': bool(breached),
            'breached_checks': sorted(k for k, c in checks.items()
                                      if c['ok'] is False),
            'skipped_checks': skipped,
            'stall_episodes': episodes,
            'evaluations': evaluations,
            'breached_evaluations': breaches,
            'error_budget': budget,
            'budget_window': window,
            'breach_fraction': round(breach_fraction, 4),
            'burn_rate': round(burn_rate, 4),
            # warmup grace: one cold-start breach must not read as a spent
            # budget (1/error_budget) and recycle the pod before it warms
            'hard_breach': (burn_rate >= 1.0
                            and evaluations >= min_evaluations),
            'min_evaluations': min_evaluations,
            'fail_healthz': self.fail_healthz,
        }
        self.last_verdict = verdict
        return verdict


def prometheus_histogram_lines(name: str, state: dict,
                               help_text: str = '') -> List[str]:
    """Render one histogram ``state`` (:meth:`LatencyHistogram.state`) in
    Prometheus text-exposition **histogram** form: cumulative ``_bucket``
    samples with ``le`` labels, the mandatory terminal ``le="+Inf"`` bucket,
    and ``_sum``/``_count``. Only buckets with observations are emitted
    (cumulative semantics make sparse ``le`` sets valid), keeping scrapes
    proportional to occupied buckets, not the 137-bucket scheme."""
    lines = []
    if help_text:
        lines.append('# HELP {} {}'.format(name, help_text))
    lines.append('# TYPE {} histogram'.format(name))
    cumulative = 0
    for index, count in state.get('buckets', ()):
        cumulative += count
        if index >= NUM_BUCKETS:
            break   # overflow folds into the +Inf terminal bucket
        lines.append('{}_bucket{{le="{:.9g}"}} {}'.format(
            name, BUCKET_BOUNDS_S[index], cumulative))
    lines.append('{}_bucket{{le="+Inf"}} {}'.format(name,
                                                    int(state.get('count',
                                                                  0))))
    lines.append('{}_sum {}'.format(name, repr(float(state.get('sum', 0.0)))))
    lines.append('{}_count {}'.format(name, int(state.get('count', 0))))
    return lines
