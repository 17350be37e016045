"""Live pipeline health of the port: heartbeats, the stall watchdog,
flight records and the HTTP debug endpoint.

The port's copy of ``petastorm_tpu/health.py``, with its constants,
entity and stage names, verdict wording and JSON keys:

- **Heartbeats.** Every long-lived entity of a reader's pipeline publishes
  a record ``{'stage', 'ts', 'items', 'pid'}``: each pool worker
  (``worker-<id>``, through its
  :class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorker`), each
  worker's readahead thread (``readahead-<id>``), the ventilator
  (``ventilator``) and the staging thread of
  :func:`~petastorm_tpu_torch.torch_utils.prefetch_to_device`
  (``loader-prefetch``). Thread and dummy pools read their workers'
  records live; a process worker ships them in its ``ITEM_DONE`` frame and
  in a liveness frame every 2 s (``process_pool.HEARTBEAT_INTERVAL_S``),
  so a wedged item still beats. ``ts`` is ``time.perf_counter()``, CLOCK_MONOTONIC on
  Linux, one clock for every local process.
  :class:`HeartbeatRegistry` stores records, :class:`HealthMonitor` (a
  reader's ``reader.health``) merges the registry with the pool's live
  records.
- **Classification.** :func:`classify_pipeline` gives ``healthy``,
  ``degraded``, ``starving`` or ``stalled`` from the records (an entity in
  an active stage past ``stall_after_s``) and a stats snapshot, through
  :func:`bottleneck_signals` (the classification
  :func:`~petastorm_tpu_torch.torch_utils.infeed_diagnosis` and
  :meth:`~petastorm_tpu_torch.goodput.GoodputMonitor.explain_step` share)
  and :func:`degradation_causes`.
- **Watchdog.** :class:`PipelineWatchdog` re-evaluates on a daemon thread
  and fires ``on_stall`` once per stall episode; a reader wires that to a
  flight record (:func:`build_flight_record`, :func:`write_flight_record`):
  the heartbeats, the stats, the queues, every thread's stack and the
  lineage, roofline, latency, SLO, autotune and goodput summaries.
- **Debug endpoint.** :class:`DebugServer` serves ``/healthz``, ``/slo``,
  ``/metrics``, ``/diagnostics``, ``/coverage``, ``/profile``,
  ``/autotune``, ``/goodput`` and ``/stacks`` on ``127.0.0.1``; a route
  whose source is not wired answers 404 with JAX's text, and so do
  ``/observe/snapshot`` and ``/podmetrics`` (the pod plane is not
  ported).

Heartbeats are on by default (a few assignments an item);
``PETASTORM_TPU_HEALTH=0`` turns every beat off. The watchdog thread and
the server exist only when asked for (``stall_timeout=``, ``debug_port=``
or ``PETASTORM_TPU_DEBUG_PORT``). Nothing here touches torch or CUDA: the
health threads must never synchronise the card they observe, and worker
interpreters import this module.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from petastorm_tpu_torch.workers.stats import effective_io_s

logger = logging.getLogger(__name__)

#: Environment variable gating heartbeat publication (default on).
#: ``0``/``false``/``off`` disable every beat call site.
HEALTH_ENV_VAR = 'PETASTORM_TPU_HEALTH'

#: Environment variable naming the debug-endpoint port when the
#: ``debug_port=`` kwarg is left at its default. ``0`` binds an ephemeral
#: port (read it back from ``reader.debug_port``).
DEBUG_PORT_ENV_VAR = 'PETASTORM_TPU_DEBUG_PORT'

#: Default stall threshold (seconds an entity may sit in an active stage
#: without progress before the pipeline is classified ``stalled``). Used for
#: on-demand verdicts (``/healthz`` with no ``stall_timeout=``); a row-group
#: decode on a cold store can legitimately take tens of seconds.
DEFAULT_STALL_AFTER_S = 120.0

#: Pipeline states, from best to worst.
HEALTHY, DEGRADED, STARVING, STALLED = ('healthy', 'degraded', 'starving',
                                        'stalled')

#: Stages that mean "waiting for work, not doing it": age in these stages
#: is never a stall. ``backpressured`` is an entity blocked on a bound
#: downstream of it (the stall, if any, is downstream); ``starting`` covers
#: the gap between an entity's construction and its first work item.
IDLE_STAGES = frozenset({'idle', 'done', 'stopped', 'backpressured',
                         'starting'})

#: Range-fetch p99 at or above which the object store is named the slow
#: side of the read plane.
SLOW_RANGE_FETCH_P99_S = 1.0

#: Peer-cache fetch p99 at or above which a peer cache host is named slow.
SLOW_PEER_FETCH_P99_S = 0.25

#: JAX's 404 text of ``/profile`` and ``/autotune`` when no source is wired
#: (``PETASTORM_TPU_PROFILER=0``, a reader without a controller).
PROFILE_UNWIRED = ('the roofline profiler is disabled for this reader '
                   '(PETASTORM_TPU_PROFILER=0 or no profile source wired)\n')
AUTOTUNE_UNWIRED = ('no autotune controller runs for this reader (pass '
                    'autotune=True to the factory, or set '
                    'PETASTORM_TPU_AUTOTUNE=1)\n')

#: JAX's routes of the pod plane, which the port does not have: each
#: answers 404 with the text JAX gives when it is unwired.
UNWIRED_ROUTES = {
    '/observe/snapshot': 'the pod observability plane is off or unwired '
                         'for this reader (PETASTORM_TPU_PODOBS=0)\n',
    '/podmetrics': 'this host is not a pod aggregator (set '
                   'PETASTORM_TPU_PODOBS_PEERS to a host:port list, or run '
                   'petastorm-tpu-podstat)\n',
}


def heartbeats_enabled() -> bool:
    """The :data:`HEALTH_ENV_VAR` gate (default on)."""
    value = os.environ.get(HEALTH_ENV_VAR, '').strip().lower()
    return value not in ('0', 'false', 'off')


def resolve_debug_port(debug_port) -> Optional[int]:
    """Resolve the ``debug_port=`` kwarg against :data:`DEBUG_PORT_ENV_VAR`.

    ``None`` defers to the env var (unset/empty → no server); an int is the
    port to bind (``0`` = ephemeral). Returns ``None`` when no server should
    run. A malformed env value disables the endpoint with a warning instead
    of raising: a job-wide observability env var must never kill the
    pipeline it observes (an explicit bad ``debug_port=`` kwarg still
    raises — that is a programming error at the call site)."""
    if debug_port is None:
        value = os.environ.get(DEBUG_PORT_ENV_VAR, '').strip()
        if not value:
            return None
        try:
            port = int(value)
            if not 0 <= port <= 65535:
                raise ValueError(port)
        except ValueError:
            logger.warning('debug endpoint disabled: %s=%r is not a port '
                           'number', DEBUG_PORT_ENV_VAR, value)
            return None
        return port
    return int(debug_port)


class HeartbeatRegistry:
    """Thread-safe store of per-entity heartbeat records.

    A record is ``{'stage': str, 'ts': float, 'items': int, 'pid': int}``
    with ``ts`` a ``time.perf_counter()`` reading; :meth:`snapshot` adds the
    derived ``age_s``."""

    __slots__ = ('_lock', '_records')

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[str, dict] = {}

    def beat(self, entity: str, stage: str, items: Optional[int] = None,
             pid: Optional[int] = None) -> None:
        """Record progress for ``entity``: it is now in ``stage`` and (when
        given) has completed ``items`` work items."""
        record = {'stage': stage, 'ts': time.perf_counter(),
                  'pid': os.getpid() if pid is None else pid}
        with self._lock:
            prev = self._records.get(entity)
            record['items'] = (items if items is not None
                               else (prev or {}).get('items', 0))
            self._records[entity] = record

    def update(self, records: Dict[str, dict]) -> None:
        """Replace entity records wholesale (records shipped back from a
        process worker already carry their own ``ts``/``pid``)."""
        if not records:
            return
        with self._lock:
            self._records.update(records)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Point-in-time copy of every record with ``age_s`` derived."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            records = {entity: dict(record)
                       for entity, record in self._records.items()}
        for record in records.values():
            record['age_s'] = max(0.0, now - record['ts'])
        return records


class HealthMonitor:
    """Aggregates the heartbeat sources of one reader pipeline.

    Non-pool entities (ventilator, loader prefetch thread) :meth:`beat`
    directly into the monitor's own registry; the pool contributes a live
    source callable (``pool.heartbeats``) merged at :meth:`heartbeats` time,
    so in-process worker records are read fresh rather than forwarded."""

    def __init__(self):
        self._registry = HeartbeatRegistry()
        self._sources: List[Callable[[], Dict[str, dict]]] = []
        self.enabled = heartbeats_enabled()

    def beat(self, entity: str, stage: str,
             items: Optional[int] = None) -> None:
        if self.enabled:
            self._registry.beat(entity, stage, items=items)

    def add_source(self, source: Callable[[], Dict[str, dict]]) -> None:
        """Register a callable returning ``{entity: record}`` (records carry
        their own ``ts``; ``age_s`` is derived here)."""
        self._sources.append(source)

    def heartbeats(self) -> Dict[str, dict]:
        """Merged per-entity records across the registry and every source,
        each with derived ``age_s``."""
        now = time.perf_counter()
        merged = self._registry.snapshot(now)
        for source in self._sources:
            try:
                records = source()
            except Exception:  # a dying pool must not break health reporting
                logger.debug('heartbeat source %r failed', source,
                             exc_info=True)
                continue
            for entity, record in (records or {}).items():
                record = dict(record)
                record['age_s'] = max(0.0, now - record.get('ts', now))
                merged[entity] = record
        return merged


def bottleneck_signals(snapshot: dict) -> dict:
    """Classify the io / decode / consumer bottleneck of a ``ReaderStats``
    snapshot: ``{'bottleneck', 'hint', 'io_s', 'decode_s'}`` plus the
    queue-wait tail keys.

    The consumer wait's distribution separates two regimes the sums cannot:
    steady back-pressure (p50 near p99: the reader is slower than the
    consumer) and tail stalls (p50 near zero, p99 large: most batches are
    ready at once, yet every Nth delivery stalls the device), reported as
    ``tail_stall: True`` with its own hint."""
    io_s = effective_io_s(snapshot)
    decode_s = snapshot.get('worker_decode_s', 0.0)
    publish_wait_s = snapshot.get('worker_publish_wait_s', 0.0)
    qw_p50 = snapshot.get('queue_wait_p50_s', 0.0)
    qw_p99 = snapshot.get('queue_wait_p99_s', 0.0)
    # tail stall: the p99 consumer wait dwarfs the median and is large
    # enough to matter (>= 50 ms)
    tail_stall = bool(qw_p99 >= 0.05 and qw_p99 > 10.0 * max(qw_p50, 1e-4))
    busy = io_s + decode_s
    if tail_stall:
        bottleneck = 'tail-stall'
        hint = ('queue-wait p99 ({:.3f}s) dwarfs p50 ({:.4f}s): most '
                'batches arrive instantly but every Nth delivery stalls '
                'the consumer — look at the /slo burn, the flight-record '
                'p99 trend and per-stage histograms, not the means '
                '(docs/latency.md)'.format(qw_p99, qw_p50))
    elif publish_wait_s > busy:
        bottleneck = 'consumer'
        hint = ('workers outrun the consumer (publish_wait > io+decode): '
                'the training step / consumer loop is the ceiling')
    elif io_s > decode_s * 1.5:
        bottleneck = 'io'
        hint = ('storage stall dominates: raise io_readahead (or pass '
                "io_readahead='auto') before raising workers_count")
    elif decode_s > io_s * 1.5:
        bottleneck = 'decode'
        hint = ('decode dominates and reads are hidden: raise workers_count '
                'or cut decode work (decode_hints, lighter transforms)')
    else:
        bottleneck = 'balanced'
        hint = ('io and decode are comparable: io_readahead overlaps them '
                'for up to 2x; workers_count scales both')
    # the read plane's own latency stages name its slow side
    io_range_p99 = snapshot.get('io_range_p99_s') or 0.0
    peer_fetch_p99 = snapshot.get('peer_fetch_p99_s') or 0.0
    slow_object_store = bool(io_range_p99 >= SLOW_RANGE_FETCH_P99_S)
    slow_peer_cache = bool(peer_fetch_p99 >= SLOW_PEER_FETCH_P99_S)
    if slow_object_store and bottleneck in ('io', 'balanced'):
        hint = ('the OBJECT STORE is the slow side: range-fetch p99 is '
                '{:.3f}s (>= {:.2f}s) — check the store/network before '
                'touching pipeline knobs; hedging (hedge_ms) clips this '
                'tail (docs/object_store.md)'.format(
                    io_range_p99, SLOW_RANGE_FETCH_P99_S))
    if slow_peer_cache:
        hint += ('; a PEER CACHE host is slow: peer-fetch p99 is {:.3f}s '
                 '(>= {:.2f}s) — use /podmetrics to see which host, and '
                 'peer_hedge_s to route around it '
                 '(docs/pod_observability.md)'.format(
                     peer_fetch_p99, SLOW_PEER_FETCH_P99_S))
    return {'bottleneck': bottleneck, 'hint': hint, 'io_s': io_s,
            'decode_s': decode_s, 'queue_wait_p50_s': qw_p50,
            'queue_wait_p99_s': qw_p99, 'tail_stall': tail_stall,
            'io_range_p99_s': io_range_p99,
            'peer_fetch_p99_s': peer_fetch_p99,
            'slow_object_store': slow_object_store,
            'slow_peer_cache': slow_peer_cache}


def degradation_causes(snapshot: dict) -> List[str]:
    """Named fault-plane degradations evident in a stats snapshot: the
    pipeline delivers correct data, but something it relies on failed and
    was routed around. Plain retries and hedges are not causes. The port
    raises none of these counters before its resilience, object-store and
    pod slices; the classification is whole, so a snapshot's verdict is
    JAX's."""
    causes = []
    n = snapshot.get('shared_put_failures', 0)
    if n:
        causes.append('cache-degraded: {} shared-cache segment '
                      'publication(s) failed (ENOSPC/serialization); '
                      'serving direct decode'.format(n))
    n = snapshot.get('worker_respawns', 0)
    if n:
        causes.append('worker-respawns: {} crashed worker(s) replaced; '
                      'in-flight items re-ventilated exactly once'.format(n))
    n = snapshot.get('poison_items_quarantined', 0)
    if n:
        causes.append('poison-items: {} item(s) quarantined after '
                      'repeatedly killing workers'.format(n))
    n = snapshot.get('io_permanent_failures', 0)
    if n:
        causes.append('io-permanent-failures: {} read(s) failed with '
                      'non-retryable errors'.format(n))
    n = snapshot.get('hosts_died', 0)
    if n:
        dead = snapshot.get('dead_hosts') or ()
        who = ' ({})'.format(', '.join(dead)) if dead else ''
        causes.append('host-death: {} pod member(s) died{}; their shard '
                      'leases were rebalanced onto survivors '
                      '(docs/robustness.md)'.format(n, who))
    n = snapshot.get('leases_rebalanced', 0)
    if n and not snapshot.get('hosts_died', 0):
        causes.append('lease-rebalance: {} shard lease(s) moved after a '
                      'pod membership change (host join)'.format(n))
    return causes


def classify_pipeline(heartbeats: Dict[str, dict],
                      snapshot: Optional[dict] = None,
                      stall_after_s: float = DEFAULT_STALL_AFTER_S) -> dict:
    """Classify a pipeline from its heartbeat records (as returned by
    ``HealthMonitor.heartbeats()``) and an optional stats snapshot.

    - ``stalled`` — some entity has sat in an **active** (non-idle) stage
      for longer than ``stall_after_s`` without progress; the verdict names
      every such entity and its stage.
    - ``degraded`` — no entity over the threshold, but at least one active
      entity is past half of it (the early warning the watchdog logs) — OR
      the fault plane routed around a failure (:func:`degradation_causes`:
      cache ENOSPC fell through to direct decode, a crashed worker was
      respawned, a poison item was quarantined, reads hit permanent
      errors); the named causes ride out as ``degraded_causes``.
    - ``starving`` — entities are healthy but the io bottleneck signal fires
      with an empty result queue: storage cannot feed the consumer (the
      device is starving, not the pipeline wedged).
    - ``healthy`` — everything else, including a fully idle pipeline.
    """
    now = time.perf_counter()
    stalled, slow = [], []
    for entity, record in sorted(heartbeats.items()):
        stage = record.get('stage', 'idle')
        if stage in IDLE_STAGES:
            continue
        age = record.get('age_s')
        if age is None:
            # raw records (straight off a pool or registry) carry only the
            # beat timestamp; derive the age here so classification works on
            # any heartbeat source
            age = max(0.0, now - record.get('ts', now))
        brief = {'entity': entity, 'stage': stage, 'age_s': round(age, 3)}
        if age > stall_after_s:
            stalled.append(brief)
        elif age > stall_after_s / 2.0:
            slow.append(brief)
    verdict = {
        'state': HEALTHY,
        'stall_after_s': stall_after_s,
        'entities': len(heartbeats),
        'stalled_entities': stalled,
        'slow_entities': slow,
    }
    if stalled:
        verdict['state'] = STALLED
        verdict['hint'] = ('no progress from {} for > {:.0f}s: dump stacks '
                           '(/stacks or the flight record) to see where it '
                           'is wedged'.format(
                               ', '.join(e['entity'] for e in stalled),
                               stall_after_s))
        return verdict
    if slow:
        verdict['state'] = DEGRADED
        verdict['hint'] = ('{} past half the stall threshold: a stall dump '
                           'fires at {:.0f}s'.format(
                               ', '.join(e['entity'] for e in slow),
                               stall_after_s))
        return verdict
    if snapshot:
        signals = bottleneck_signals(snapshot)
        verdict['bottleneck'] = signals['bottleneck']
        if (signals['bottleneck'] == 'io'
                and snapshot.get('queue_depth', 0) == 0
                and snapshot.get('items_out', 0) > 0):
            verdict['state'] = STARVING
            verdict['hint'] = ('storage cannot feed the consumer (io-bound, '
                               'result queue empty): ' + signals['hint'])
        else:
            verdict['hint'] = signals['hint']
        causes = degradation_causes(snapshot)
        if causes:
            verdict['degraded_causes'] = causes
            if verdict['state'] == HEALTHY:
                verdict['state'] = DEGRADED
                verdict['hint'] = ('fault plane routed around a failure: '
                                   + '; '.join(causes))
    return verdict


def thread_stacks() -> Dict[str, str]:
    """Faulthandler-style stack dumps of every thread in this process,
    keyed ``'<thread name> (tid)'`` — what the flight recorder and the
    ``/stacks`` endpoint serve. Pure stdlib (``sys._current_frames``), no
    signal handling, safe to call from any thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for tid, frame in sys._current_frames().items():
        label = '{} ({})'.format(names.get(tid, '<unknown>'), tid)
        stacks[label] = ''.join(traceback.format_stack(frame))
    return stacks


def build_flight_record(verdict: dict, heartbeats: Dict[str, dict],
                        snapshot: Optional[dict] = None,
                        queues: Optional[dict] = None,
                        tracer=None, span_tail: int = 500,
                        lineage: Optional[dict] = None,
                        roofline: Optional[dict] = None,
                        latency: Optional[dict] = None,
                        slo: Optional[dict] = None,
                        autotune: Optional[dict] = None,
                        goodput: Optional[dict] = None) -> dict:
    """The flight-recorder artifact: what diagnoses a stall after the
    process is gone, JSON-able by construction. ``lineage`` (a tracker's
    ``flight_summary()``) adds the coverage audit and recent quarantine
    records: what data the model had seen and what was dropped.
    ``roofline`` (the profiler's ``roofline_summary()``) records how far
    below its calibrated ceiling the pipeline ran. ``latency``
    (``PipelineLatency.flight_summary()``) adds per-stage percentiles and
    the recent p99 trend (a cliff or a creep); ``slo`` (an
    ``SLOMonitor.evaluate()`` verdict) the burn state at the stall;
    ``autotune`` (``PipelineController.flight_summary()``) the controller's
    recent knob moves and their grades, so a stall that follows a move is
    attributable to it; ``goodput`` (``GoodputMonitor.flight_summary()``)
    the per-step goodput and the last step rings: whether the card was fed
    when the pipeline stalled. JAX's ``elastic`` section (pod membership)
    is not ported; a record leaves it out, as JAX's does when unwired."""
    record = {
        'kind': 'petastorm_tpu_flight_record',
        # deliberate wall clock: a human-facing artifact timestamp, never
        # compared against monotonic readings
        'written_at': time.time(),  # petalint: disable=monotonic-clock
        'pid': os.getpid(),
        'verdict': verdict,
        'heartbeats': heartbeats,
        'stats': snapshot or {},
        'queues': queues or {},
        'stacks': thread_stacks(),
    }
    if tracer is not None:
        record['span_tail'] = tracer.tail(span_tail)
        record['spans_dropped'] = tracer.dropped
    if lineage is not None:
        record['lineage'] = lineage
    if roofline is not None:
        record['roofline'] = roofline
    if latency is not None:
        record['latency'] = latency
    if slo is not None:
        record['slo'] = slo
    if autotune is not None:
        record['autotune'] = autotune
    if goodput is not None:
        record['goodput'] = goodput
    return record


def write_flight_record(path: str, record: dict) -> str:
    """Write one flight record as JSON; returns ``path``. Atomic
    (:func:`~petastorm_tpu_torch.utils.atomic_write`): a crash mid-dump
    cannot leave truncated JSON."""
    from petastorm_tpu_torch.utils import atomic_write
    return atomic_write(path, lambda f: json.dump(
        record, f, indent=2, sort_keys=True, default=str))


class PipelineWatchdog:
    """Background stall detector over a pipeline's heartbeats.

    :meth:`evaluate` is cheap and callable on demand (the ``/healthz``
    endpoint does); :meth:`start` adds a daemon thread re-evaluating every
    ``interval_s`` that fires ``on_stall(verdict)`` once per stall episode
    (edge-triggered: it re-arms when the pipeline recovers). Lifecycle
    mirrors ``MetricsEmitter``: ``stop(join=True)`` joins with a timeout and
    is idempotent, so ``Reader.stop()/join()`` can always call it — even
    when the pool died uncleanly.
    """

    def __init__(self, heartbeats_fn: Callable[[], Dict[str, dict]],
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 stall_after_s: float = DEFAULT_STALL_AFTER_S,
                 interval_s: Optional[float] = None,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 slo_monitor=None):
        if stall_after_s <= 0:
            raise ValueError('stall_after_s must be positive, got '
                             '{!r}'.format(stall_after_s))
        self._heartbeats_fn = heartbeats_fn
        self._snapshot_fn = snapshot_fn
        self._stall_after_s = stall_after_s
        #: Optional :class:`~petastorm_tpu_torch.latency.SLOMonitor`: the
        #: watchdog thread drives its periodic evaluations (burn accounting
        #: needs a steady cadence, not just on-demand ``/slo`` probes).
        self._slo_monitor = slo_monitor
        # default tick: a quarter of the threshold, clamped so tiny test
        # thresholds do not busy-spin and huge ones still tick regularly
        self._interval = (interval_s if interval_s is not None
                          else min(5.0, max(0.05, stall_after_s / 4.0)))
        self._on_stall = on_stall
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stall_fired = False
        self._last_items_out = 0
        #: The most recent verdict (from the thread or an explicit
        #: :meth:`evaluate` call); ``None`` until the first evaluation.
        self.last_verdict: Optional[dict] = None

    @property
    def stall_after_s(self) -> float:
        return self._stall_after_s

    def evaluate(self, _advance_progress_window: bool = False) -> dict:
        """Classify the pipeline right now; updates :attr:`last_verdict`.

        ``items_out_delta`` is progress since the watchdog thread's previous
        tick. Only the thread advances that baseline
        (``_advance_progress_window``): on-demand callers (``/healthz``, a
        k8s probe every few seconds) must not reset it, or the delta in a
        stall's flight record would cover whatever arbitrary window the last
        probe left behind — and concurrent probes would race the counter."""
        snapshot = (self._snapshot_fn() if self._snapshot_fn is not None
                    else None)
        verdict = classify_pipeline(self._heartbeats_fn(), snapshot,
                                    self._stall_after_s)
        if snapshot is not None:
            from petastorm_tpu_torch.workers.stats import progress_marker
            items_out, _ = progress_marker(snapshot)
            verdict['items_out'] = items_out
            verdict['items_out_delta'] = items_out - self._last_items_out
            if _advance_progress_window:
                self._last_items_out = items_out
        self.last_verdict = verdict
        return verdict

    # -- background thread ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='petastorm-tpu-watchdog')
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_event.wait(self._interval):
            try:
                verdict = self.evaluate(_advance_progress_window=True)
            except Exception:
                logger.exception('watchdog evaluation failed')
                continue
            if self._slo_monitor is not None:
                try:
                    self._slo_monitor.evaluate()
                except Exception:
                    logger.exception('SLO evaluation failed')
            if verdict['state'] == STALLED:
                if not self._stall_fired:
                    self._stall_fired = True
                    logger.error('pipeline stalled: %s',
                                 verdict.get('hint', verdict))
                    if self._on_stall is not None:
                        try:
                            self._on_stall(verdict)
                        except Exception:
                            logger.exception('on_stall callback failed')
            else:
                self._stall_fired = False

    def stop(self, join: bool = True) -> None:
        """Signal the thread to stop; with ``join`` also wait for it.
        Idempotent."""
        self._stop_event.set()
        if not join:
            return
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
            self._thread = None


class DebugServer:
    """Opt-in HTTP debug endpoint over one pipeline's health surfaces.

    Binds ``127.0.0.1:<port>`` (``port=0``: ephemeral; read :attr:`port`
    after :meth:`start`) and serves:

    - ``GET /healthz``: the watchdog verdict as JSON; 200, or 503 when the
      pipeline is ``stalled`` (a liveness probe's target). With an SLO
      monitor whose targets set ``fail_healthz``, a spent error budget
      (``hard_breach``) also gives 503, the SLO verdict embedded.
    - ``GET /slo``: the SLO monitor's verdict
      (:meth:`~petastorm_tpu_torch.latency.SLOMonitor.evaluate`); 404
      without ``slo=`` targets.
    - ``GET /metrics``: the stats snapshot as Prometheus text
      (:func:`~petastorm_tpu_torch.tracing.prometheus_text`, the metrics
      emitter's formatter).
    - ``GET /diagnostics``: ``{verdict, stats, heartbeats}`` as JSON, with
      the coverage audit, the SLO verdict and the goodput summary where
      wired.
    - ``GET /coverage``: the lineage coverage audit
      (:meth:`~petastorm_tpu_torch.lineage.LineageTracker.coverage_report`);
      404 with lineage off.
    - ``GET /goodput``: the per-step goodput summary
      (:meth:`~petastorm_tpu_torch.goodput.GoodputMonitor.summary`); 404
      with the plane off (``PETASTORM_TPU_GOODPUT=0``),
      ``{'attached': False}`` until a loader registers its monitor.
    - ``GET /stacks``: a plain-text stack dump of every thread.
    - ``GET /profile``: the roofline profile (the reader's last
      ``profile()``, else one from a cached calibration); 404 with the
      profiler off (``PETASTORM_TPU_PROFILER=0``).
    - ``GET /autotune``: the autotune controller's report
      (:meth:`~petastorm_tpu_torch.autotune.PipelineController.report`);
      404 without a controller.
    - ``GET /observe/snapshot`` and ``/podmetrics`` (the pod plane): 404
      with the text JAX gives when they are unwired.

    Requests are served on daemon threads (``ThreadingHTTPServer``);
    :meth:`stop` shuts the accept loop down, closes the socket and joins the
    server thread. Idempotent. The handlers call the wired sources only:
    nothing here touches the card.
    """

    def __init__(self, evaluate_fn: Callable[[], dict],
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 heartbeats_fn: Optional[Callable[[], Dict[str, dict]]] = None,
                 port: int = 0, prefix: str = 'petastorm_tpu',
                 coverage_fn: Optional[Callable[[], dict]] = None,
                 profile_fn: Optional[Callable[[], dict]] = None,
                 slo_fn: Optional[Callable[[], dict]] = None,
                 autotune_fn: Optional[Callable[[], dict]] = None,
                 goodput_fn: Optional[Callable[[], dict]] = None):
        self._evaluate_fn = evaluate_fn
        self._profile_fn = profile_fn
        self._autotune_fn = autotune_fn
        self._snapshot_fn = snapshot_fn or (lambda: {})
        self._heartbeats_fn = heartbeats_fn or (lambda: {})
        self._coverage_fn = coverage_fn
        self._slo_fn = slo_fn
        self._goodput_fn = goodput_fn
        self._requested_port = port
        self._prefix = prefix
        self._server = None
        self._thread: Optional[threading.Thread] = None
        #: The bound port (differs from the requested one when it was 0).
        self.port: Optional[int] = None

    def start(self) -> 'DebugServer':
        if self._server is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                logger.debug('debug endpoint: ' + fmt, *args)

            def _reply(self, status: int, content_type: str, body: str):
                payload = body.encode('utf-8')
                self.send_response(status)
                self.send_header('Content-Type', content_type)
                self.send_header('Content-Length', str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):  # noqa: N802 - http.server API
                try:
                    route = self.path.split('?', 1)[0].rstrip('/') or '/'
                    if route == '/healthz':
                        verdict = outer._evaluate_fn()
                        status = (503 if verdict.get('state') == STALLED
                                  else 200)
                        if outer._slo_fn is not None:
                            # a spent error budget is a liveness failure only
                            # when the operator opted in (fail_healthz): an
                            # SLO is a contract, 503 is a recycle signal
                            slo_verdict = outer._slo_fn()
                            verdict = dict(verdict, slo=slo_verdict)
                            if (slo_verdict.get('fail_healthz')
                                    and slo_verdict.get('hard_breach')):
                                status = 503
                        self._reply(status, 'application/json',
                                    json.dumps(verdict, default=str))
                    elif route == '/slo':
                        if outer._slo_fn is None:
                            self._reply(404, 'text/plain',
                                        'no SLO targets configured for this '
                                        'reader (pass slo=dict(...) to the '
                                        'factory)\n')
                        else:
                            self._reply(200, 'application/json',
                                        json.dumps(outer._slo_fn(),
                                                   default=str))
                    elif route == '/metrics':
                        from petastorm_tpu_torch.tracing import prometheus_text
                        self._reply(200, 'text/plain; version=0.0.4',
                                    prometheus_text(outer._snapshot_fn(),
                                                    prefix=outer._prefix))
                    elif route == '/diagnostics':
                        blob = {'verdict': outer._evaluate_fn(),
                                'stats': outer._snapshot_fn(),
                                'heartbeats': outer._heartbeats_fn()}
                        if outer._coverage_fn is not None:
                            blob['coverage'] = outer._coverage_fn()
                        if outer._slo_fn is not None:
                            blob['slo'] = outer._slo_fn()
                        if outer._goodput_fn is not None:
                            blob['goodput'] = outer._goodput_fn()
                        self._reply(200, 'application/json',
                                    json.dumps(blob, default=str))
                    elif route == '/coverage':
                        if outer._coverage_fn is None:
                            self._reply(404, 'text/plain',
                                        'lineage is disabled for this '
                                        'reader (PETASTORM_TPU_LINEAGE=0)\n')
                        else:
                            self._reply(200, 'application/json',
                                        json.dumps(outer._coverage_fn(),
                                                   default=str))
                    elif route in ('/profile', '/autotune'):
                        source = (outer._profile_fn if route == '/profile'
                                  else outer._autotune_fn)
                        if source is None:
                            self._reply(404, 'text/plain',
                                        PROFILE_UNWIRED if route == '/profile'
                                        else AUTOTUNE_UNWIRED)
                        else:
                            self._reply(200, 'application/json',
                                        json.dumps(source(), default=str))
                    elif route in UNWIRED_ROUTES:
                        self._reply(404, 'text/plain', UNWIRED_ROUTES[route])
                    elif route == '/goodput':
                        if outer._goodput_fn is None:
                            self._reply(404, 'text/plain',
                                        'the goodput plane is off for this '
                                        'reader (PETASTORM_TPU_GOODPUT=0)\n')
                        else:
                            self._reply(200, 'application/json',
                                        json.dumps(outer._goodput_fn(),
                                                   default=str))
                    elif route == '/stacks':
                        stacks = thread_stacks()
                        body = '\n'.join('== {} ==\n{}'.format(name, stack)
                                         for name, stack in sorted(
                                             stacks.items()))
                        self._reply(200, 'text/plain', body)
                    else:
                        self._reply(404, 'text/plain',
                                    'unknown route {}; try /healthz /metrics '
                                    '/diagnostics /coverage /profile /slo '
                                    '/autotune /observe/snapshot /podmetrics '
                                    '/goodput /stacks\n'.format(route))
                except Exception as e:  # report, never kill the serve loop
                    logger.exception('debug endpoint request failed')
                    try:
                        self._reply(500, 'text/plain', 'error: {}\n'.format(e))
                    except OSError:
                        pass

        self._server = ThreadingHTTPServer(('127.0.0.1', self._requested_port),
                                           Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={'poll_interval': 0.1},
                                        daemon=True,
                                        name='petastorm-tpu-debug-http')
        self._thread.start()
        logger.info('petastorm_tpu_torch debug endpoint on '
                    'http://127.0.0.1:%d (/healthz /metrics /diagnostics '
                    '/profile /slo /stacks)',
                    self.port)
        return self

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
