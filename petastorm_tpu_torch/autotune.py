"""The port's pipeline autotuner: a sense → predict → actuate loop over a
live reader.

The port's copy of ``petastorm_tpu/autotune.py``, with its constants,
option keys, knob names, action-record keys, report and gauge keys and
log wording. A :class:`PipelineController` thread ticks every
``tick_interval_s``:

- **Sense.** A ``ReaderStats`` snapshot delta (rates over the tick
  window), the latency plane's window p99s, ``bottleneck_signals`` and the
  cached roofline calibration (:mod:`petastorm_tpu_torch.profiler`).
- **Predict.** :func:`petastorm_tpu_torch.profiler.predict_throughput`
  over the neighbours of the current configuration (workers ±1, readahead
  depth ±1) with the measured per-worker efficiency, so the model can
  predict negative scaling. A move is taken only when its predicted gain
  clears the hysteresis and the (crude) latency model does not predict a
  breach of the reader's ``p99_e2e_ms`` SLO target. The ventilation window
  follows worker and readahead moves as a companion actuation; the
  results-queue bound moves on a tail-stall verdict, and readahead on a
  data-stalled consumer (sensor moves).
- **Actuate.** ``ThreadPool.resize`` / ``ProcessPool.resize`` (clean
  retirement: the lineage audit stays exactly-once),
  ``RowGroupReadahead.set_depth`` (through the process pool's control
  channel), ``VentilationJob.set_max_in_flight`` and
  ``set_results_queue_bound``.

Every action lands in a bounded ring with its sensor evidence and
predicted delta; the tick after a move grades it, :meth:`PipelineController.
report` aggregates the model's error, and a move whose measured throughput
drops past ``revert_pct`` is undone and its (knob, direction) quarantined.
Controllers of one host, JAX's and the port's alike, split its cores
through records in a shared scratch directory (:class:`HostArbiter`, the
same directory and record format as JAX's).

The port adds one option, ``device`` (default ``None``: CUDA): the device
the controller's calibration stages to. Off by default: ``autotune=True``
(or an options dict) on a factory, or ``PETASTORM_TPU_AUTOTUNE=1``;
``PETASTORM_TPU_AUTOTUNE=0`` wins over everything (no thread, no files).
This module imports no torch: the calibration's staging probe imports it
when it runs.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

from petastorm_tpu_torch import profiler
from petastorm_tpu_torch.health import bottleneck_signals

logger = logging.getLogger(__name__)

#: Environment variable: ``1``/``true``/``on`` enables the controller for
#: every reader in the job; ``0``/``false``/``off`` is the kill switch and
#: overrides even an explicit ``autotune=`` kwarg (no thread, no files).
AUTOTUNE_ENV_VAR = 'PETASTORM_TPU_AUTOTUNE'

#: Environment variable naming the arbitration scratch directory (default:
#: ``<tempdir>/petastorm_tpu_autotune``). Only created once a controller
#: actually starts.
AUTOTUNE_DIR_ENV_VAR = 'PETASTORM_TPU_AUTOTUNE_DIR'

#: The knobs the controller may move.
KNOBS = ('workers_count', 'io_readahead', 'vent_window',
         'results_queue_bound')

#: Recognized ``autotune=dict(...)`` option keys (typos fail the factory,
#: the ``slo=`` discipline).
AUTOTUNE_OPTION_KEYS = ('tick_interval_s', 'hysteresis_pct', 'cooldown_ticks',
                        'revert_pct', 'quarantine_ticks', 'max_workers',
                        'calibrate', 'scratch_dir', 'actions_ring',
                        'grade_ticks_max', 'resize_timeout_s', 'device')

_DEFAULT_OPTIONS = {
    'tick_interval_s': 5.0,     # sense→predict→actuate cadence
    'hysteresis_pct': 10.0,     # min predicted gain before a move is taken
    'cooldown_ticks': 2,        # per-knob rest after any move on it
    'revert_pct': 10.0,         # measured drop that triggers the revert
    'quarantine_ticks': 10,     # (knob, direction) lockout after a revert
    'max_workers': None,        # None = host cpu budget (arbitrated)
    'calibrate': 'auto',        # get_calibration mode for the model input
    'scratch_dir': None,        # None = AUTOTUNE_DIR_ENV_VAR / tempdir
    'actions_ring': 256,        # bounded action-record ring
    'grade_ticks_max': 3,       # give up grading a move after this many
                                # item-less ticks (no revert, no error)
    'resize_timeout_s': 15.0,   # bound on each pool-resize quiesce
    'device': None,             # the calibration's staging device (CUDA)
}

#: Ventilation-window slack beyond ``workers * (1 + lookahead)`` — the same
#: constant the reader applies at construction (reader.py).
VENT_EXTRA = 2

#: Windowed ``data_stall_fraction`` (goodput plane) above which the sensor
#: path proposes deepening io readahead: the device spent most of the tick
#: window waiting on data, so widen the host side regardless of what the
#: throughput model predicts.
DATA_STALL_SENSOR_THRESHOLD = 0.5


def resolve_autotune(autotune) -> Optional[dict]:
    """Resolve the ``autotune=`` kwarg against :data:`AUTOTUNE_ENV_VAR` into
    a validated options dict, or ``None`` when no controller must exist.

    The kill switch (env ``0``/``false``/``off``) wins over an explicit
    kwarg: a job-wide "stop self-tuning NOW" must not require touching
    every call site."""
    env = os.environ.get(AUTOTUNE_ENV_VAR, '').strip().lower()
    if env in ('0', 'false', 'off'):
        return None
    # an EMPTY options dict means "on, all defaults" (the bool-or-options
    # contract); every other falsy value — False, None, 0, '' — means off
    # and defers to the env var (autotune=0 must never START a controller)
    explicitly_on = isinstance(autotune, dict) or bool(autotune)
    if not explicitly_on and env not in ('1', 'true', 'on'):
        return None
    options = dict(_DEFAULT_OPTIONS)
    if isinstance(autotune, dict):
        unknown = set(autotune) - set(AUTOTUNE_OPTION_KEYS)
        if unknown:
            raise ValueError('unknown autotune option(s) {}; valid keys: {}'
                             .format(sorted(unknown),
                                     ', '.join(AUTOTUNE_OPTION_KEYS)))
        options.update(autotune)
    if float(options['tick_interval_s']) <= 0:
        raise ValueError('tick_interval_s must be positive, got {!r}'
                         .format(options['tick_interval_s']))
    for key in ('hysteresis_pct', 'revert_pct'):
        if float(options[key]) < 0:
            raise ValueError('{} must be >= 0, got {!r}'.format(
                key, options[key]))
    for key in ('cooldown_ticks', 'quarantine_ticks', 'actions_ring',
                'grade_ticks_max'):
        if int(options[key]) < 1:
            raise ValueError('{} must be >= 1, got {!r}'.format(
                key, options[key]))
    if options['calibrate'] not in ('cached', 'auto', 'force'):
        raise ValueError("calibrate must be 'cached', 'auto' or 'force', "
                         'got {!r}'.format(options['calibrate']))
    return options


def scratch_dir(options: Optional[dict] = None) -> str:
    """The arbitration scratch directory (not created here)."""
    if options and options.get('scratch_dir'):
        return str(options['scratch_dir'])
    env = os.environ.get(AUTOTUNE_DIR_ENV_VAR, '').strip()
    if env:
        return env
    return os.path.join(tempfile.gettempdir(), 'petastorm_tpu_autotune')


class HostArbiter:
    """Minimal-viable multi-reader arbitration through a shared scratch dir.

    Each controller atomically publishes one record per tick —
    ``{id, pid, ts, deficit, workers}`` — and reads its peers' records back.
    A record is *fresh* while its ``ts`` is within three tick intervals
    (wall clock, deliberately: the records cross process boundaries, where
    ``perf_counter`` readings are incomparable). The host CPU budget is
    split proportionally to each fresh controller's measured **deficit**
    (how far below its best-predicted rate it runs), floored at one worker
    each — so a saturated reader cedes cores to a starving one instead of
    both oscillating at the shared ceiling.
    """

    def __init__(self, directory: str, cpu_count: int,
                 tick_interval_s: float, controller_id: Optional[str] = None):
        self._dir = directory
        self._cpu = max(1, int(cpu_count))
        self._tick = float(tick_interval_s)
        self.controller_id = controller_id or uuid.uuid4().hex[:12]
        self._path = os.path.join(
            self._dir, 'controller-{}.json'.format(self.controller_id))

    def publish(self, deficit: float, workers: int) -> None:
        """Atomically publish this controller's record (creates the scratch
        dir on first use — i.e. only once a controller actually runs)."""
        from petastorm_tpu_torch.utils import atomic_write
        os.makedirs(self._dir, exist_ok=True)
        record = {
            'id': self.controller_id,
            'pid': os.getpid(),
            # deliberate wall clock: freshness is judged across processes,
            # where monotonic readings are incomparable
            'ts': time.time(),
            'deficit': round(max(0.0, min(1.0, float(deficit))), 4),
            'workers': int(workers),
        }
        atomic_write(self._path, lambda f: json.dump(record, f))

    def peers(self) -> List[dict]:
        """Fresh peer records (this controller's own record included once
        published)."""
        # deliberate wall clock: see publish()
        now = time.time()
        records = []
        try:
            names = os.listdir(self._dir)
        except OSError:
            return records
        for name in sorted(names):
            if not (name.startswith('controller-')
                    and name.endswith('.json')):
                continue
            try:
                with open(os.path.join(self._dir, name)) as f:
                    record = json.load(f)
            except (OSError, ValueError):
                continue
            if now - float(record.get('ts', 0)) <= 3.0 * self._tick:
                records.append(record)
        return records

    def worker_cap(self, own_deficit: float) -> int:
        """This controller's share of the host CPU budget."""
        peers = self.peers()
        others = [p for p in peers if p.get('id') != self.controller_id]
        if not others:
            return self._cpu
        deficits = {p['id']: max(0.0, float(p.get('deficit', 0.0)))
                    for p in others}
        deficits[self.controller_id] = max(0.0, float(own_deficit))
        total = sum(deficits.values())
        n = len(deficits)
        if total <= 0:
            share = self._cpu / n
        else:
            share = self._cpu * deficits[self.controller_id] / total
        return max(1, min(self._cpu, int(round(share))))

    def cleanup(self) -> None:
        """Remove this controller's record (stop path)."""
        try:
            os.remove(self._path)
        except OSError:
            pass


class ReaderActuators:
    """The live knobs of one reader pipeline, duck-typed over the pool and
    ventilator. Built by the ``Reader``; the controller only ever talks to
    this adapter (tests substitute a fake)."""

    def __init__(self, pool, ventilator=None, pool_type: str = 'thread',
                 resize_timeout_s: float = 15.0, initial_readahead: int = 0):
        self._pool = pool
        self._ventilator = ventilator
        self.pool_type = pool_type
        self._resize_timeout_s = resize_timeout_s
        self._readahead_depth = initial_readahead

    # every getter returns the current value; every setter returns the
    # value actually in effect afterwards (a failed actuation returns the
    # old value, which the controller records as a no-op)

    def get_workers(self) -> int:
        return self._pool.workers_count

    def set_workers(self, n: int) -> int:
        resize = getattr(self._pool, 'resize', None)
        if resize is None:
            return self.get_workers()
        return resize(n, timeout_s=self._resize_timeout_s)

    def get_readahead(self) -> int:
        return self._readahead_depth

    def set_readahead(self, depth: int) -> int:
        setter = getattr(self._pool, 'set_readahead_depth', None)
        if setter is None:
            return self._readahead_depth
        setter(depth)
        self._readahead_depth = depth
        return depth

    def get_vent_window(self) -> Optional[int]:
        vent = self._ventilator
        return getattr(vent, 'max_in_flight', None) if vent else None

    def set_vent_window(self, bound: int) -> Optional[int]:
        vent = self._ventilator
        setter = getattr(vent, 'set_max_in_flight', None) if vent else None
        if setter is None:
            return self.get_vent_window()
        setter(bound)
        return bound

    def get_queue_bound(self) -> Optional[int]:
        return getattr(self._pool, 'results_queue_bound', None)

    def set_queue_bound(self, bound: int) -> Optional[int]:
        setter = getattr(self._pool, 'set_results_queue_bound', None)
        if setter is None:
            return self.get_queue_bound()
        setter(bound)
        return bound

    def reap(self) -> None:
        """Join any retired workers (the off-hot-path join)."""
        reap = getattr(self._pool, 'reap_retired', None)
        if reap is not None:
            reap(timeout_s=1.0)


class PipelineController:
    """The sense→predict→actuate loop over one reader's live actuators.

    Fully injectable for tests: ``snapshot_fn`` supplies ``ReaderStats``
    snapshots, ``calibration_fn`` the (possibly cached) roofline
    calibration, ``latency`` the ``PipelineLatency`` (window p99s),
    ``clock`` the timebase. :meth:`tick` is the public single step the
    thread loops over.
    """

    def __init__(self, actuators, snapshot_fn: Callable[[], dict],
                 calibration_fn: Optional[Callable[[], Optional[dict]]] = None,
                 latency=None, slo_targets: Optional[dict] = None,
                 options: Optional[dict] = None,
                 arbiter: Optional[HostArbiter] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self._actuators = actuators
        self._snapshot_fn = snapshot_fn
        self._calibration_fn = calibration_fn
        self._latency = latency
        self._slo_targets = dict(slo_targets or {})
        self.options = dict(_DEFAULT_OPTIONS)
        self.options.update(options or {})
        self._arbiter = arbiter
        self._clock = clock
        self._lock = threading.Lock()
        self._actions = deque(maxlen=int(self.options['actions_ring']))
        self._ticks = 0
        self._actions_total = 0
        self._reverts_total = 0
        self._calibration = None
        self._calibration_missing_logged = False
        self._prev_snapshot: Optional[dict] = None
        self._prev_ts: Optional[float] = None
        self._last_rates: Dict[str, float] = {}
        self._last_data_stall: Optional[float] = None
        # anti-flap state: knob -> tick until which it rests; (knob, dir) ->
        # tick until which that direction is quarantined
        self._cooldowns: Dict[str, int] = {}
        self._quarantine: Dict[tuple, int] = {}
        # the single in-flight ungraded action (plus its grading budget)
        self._pending: Optional[dict] = None
        self._pending_grade_ticks = 0
        self._worker_cap = None
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> 'PipelineController':
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='petastorm-torch-autotune')
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = float(self.options['tick_interval_s'])
        while not self._stop_event.wait(interval):
            try:
                self.tick()
            except Exception:
                # the controller observes and nudges; it must never be able
                # to kill the pipeline it tunes
                logger.exception('autotune tick failed')

    def stop(self, join: bool = True) -> None:
        """Signal the thread to stop; with ``join`` also wait for it and
        drop the arbitration record. Idempotent."""
        self._stop_event.set()
        if self._arbiter is not None:
            self._arbiter.cleanup()
        if not join:
            return
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
            self._thread = None

    # -- sensing ---------------------------------------------------------------

    _DELTA_KEYS = ('items_out', 'worker_io_s', 'readahead_io_s',
                   'readahead_wait_s', 'worker_decode_s',
                   'worker_publish_wait_s', 'queue_wait_s', 'bytes_moved',
                   # goodput plane seconds: windowed so the
                   # data_stall_fraction sensor reflects the CURRENT epoch,
                   # not an hours-old cumulative average
                   'goodput_total_s', 'goodput_stall_s', 'goodput_h2d_s',
                   'goodput_device_s')

    def _sense(self) -> dict:
        now = self._clock()
        snapshot = self._snapshot_fn() or {}
        prev = self._prev_snapshot or {}
        window = (now - self._prev_ts) if self._prev_ts is not None else None
        delta = {key: max(0.0, (snapshot.get(key) or 0)
                          - (prev.get(key) or 0))
                 for key in self._DELTA_KEYS}
        self._prev_snapshot = snapshot
        self._prev_ts = now
        items = delta['items_out']
        rate = (items / window) if window and window > 0 else 0.0
        # window p99s from the latency plane beat the cumulative snapshot
        # keys: an hours-old histogram can never move again
        p50 = p99 = e2e_p99 = None
        if self._latency is not None:
            p99s = self._latency.window_p99s()
            p99 = p99s.get('queue_wait')
            e2e_p99 = p99s.get('e2e_batch')
            p50 = self._latency.quantile('queue_wait', 0.5, window=True)
        delta['queue_wait_p50_s'] = (p50 if p50 is not None
                                     else snapshot.get('queue_wait_p50_s',
                                                       0.0))
        delta['queue_wait_p99_s'] = (p99 if p99 is not None
                                     else snapshot.get('queue_wait_p99_s',
                                                       0.0))
        signals = bottleneck_signals(delta)
        from petastorm_tpu_torch.workers.stats import data_stall_fraction
        return {
            'window_s': window,
            'items_delta': items,
            'items_per_s': rate,
            'e2e_p99_s': e2e_p99,
            'signals': signals,
            'data_stall_fraction': data_stall_fraction(delta),
            'snapshot_delta': delta,
        }

    def _get_calibration(self) -> Optional[dict]:
        if self._calibration is not None:
            return self._calibration
        if self._calibration_fn is None:
            return None
        try:
            self._calibration = self._calibration_fn()
        except Exception:
            logger.exception('autotune calibration failed; model moves '
                             'disabled until it succeeds')
            self._calibration = None
        if self._calibration is None and not self._calibration_missing_logged:
            self._calibration_missing_logged = True
            logger.info('autotune: no roofline calibration available — '
                        'model-predicted moves disabled, sensor-driven '
                        'moves (queue bound on tail stalls) stay active')
        return self._calibration

    # -- prediction ------------------------------------------------------------

    def _predict(self, calibration: dict, workers: int, readahead: int,
                 worker_efficiency: float) -> Optional[float]:
        ceilings = dict(calibration.get('ceilings') or {})
        return profiler.predict_throughput(
            ceilings, workers=workers,
            cpu_count=calibration.get('cpu_count') or 1,
            io_overlap=readahead > 0,
            in_process=self._actuators.pool_type != 'process',
            worker_efficiency=worker_efficiency)

    def _rows_per_group(self) -> float:
        cal = self._calibration or {}
        return float(cal.get('rows_per_group') or 0.0)

    def _predicted_p99_breach(self, base_predicted, cand_predicted,
                              capacity_scale: float, sense: dict) -> bool:
        """The (crude, documented) latency constraint: scale the measured
        window p99 by the predicted throughput ratio and any buffering
        capacity growth; block the move when the result breaches the
        reader's ``p99_e2e_ms`` SLO target. No measurement → no constraint
        (the revert path is the backstop)."""
        target_ms = self._slo_targets.get('p99_e2e_ms')
        measured = sense.get('e2e_p99_s')
        if target_ms is None or measured is None:
            return False
        scale = float(capacity_scale)
        if base_predicted and cand_predicted:
            scale *= base_predicted / cand_predicted
        return measured * scale * 1000.0 > float(target_ms)

    def _candidates(self, sense: dict) -> List[dict]:
        calibration = self._get_calibration()
        if calibration is None:
            return []
        workers = self._actuators.get_workers()
        readahead = self._actuators.get_readahead()
        rows_per_group = self._rows_per_group()
        measured_rows = sense['items_per_s'] * rows_per_group
        decode_ceiling = (calibration.get('ceilings') or {}).get('decode')
        efficiency = None
        if sense['signals']['bottleneck'] == 'decode':
            efficiency = profiler.measured_worker_efficiency(
                measured_rows, decode_ceiling, workers)
        efficiency = 1.0 if efficiency is None else efficiency
        base = self._predict(calibration, workers, readahead, efficiency)
        if not base:
            return []
        cap = self._worker_cap or (calibration.get('cpu_count') or 1)
        out = []

        def consider(knob, direction, value, predicted, capacity_scale=1.0):
            if predicted is None:
                return
            gain_pct = 100.0 * (predicted - base) / base
            if self._predicted_p99_breach(base, predicted, capacity_scale,
                                          sense):
                return
            out.append({'knob': knob, 'direction': direction, 'to': value,
                        'predicted_samples_per_s': predicted,
                        'predicted_gain_pct': gain_pct,
                        'worker_efficiency': efficiency,
                        'policy': 'model'})

        if workers + 1 <= cap:
            consider('workers_count', 'up', workers + 1,
                     self._predict(calibration, workers + 1, readahead,
                                   efficiency))
        if workers - 1 >= 1:
            consider('workers_count', 'down', workers - 1,
                     self._predict(calibration, workers - 1, readahead,
                                   efficiency))
        from petastorm_tpu_torch.readers.readahead import (
            AUTO_INITIAL_DEPTH, AUTO_MAX_DEPTH)
        # depth 1 cannot overlap anything: by the time the worker consumes
        # the head read no further read is scheduled, so the minimum USEFUL
        # depth is 2 (= AUTO_INITIAL_DEPTH) — 'up' from below jumps straight
        # there, and 'down' from there goes straight to off
        ra_up = (readahead + 1 if readahead >= AUTO_INITIAL_DEPTH
                 else AUTO_INITIAL_DEPTH)
        if readahead < ra_up <= AUTO_MAX_DEPTH:
            consider('io_readahead', 'up', ra_up,
                     self._predict(calibration, workers, ra_up, efficiency),
                     capacity_scale=(workers * (1 + ra_up) + VENT_EXTRA)
                     / max(1, workers * (1 + readahead) + VENT_EXTRA))
        if readahead > 0:
            ra_down = (readahead - 1 if readahead > AUTO_INITIAL_DEPTH
                       else 0)
            consider('io_readahead', 'down', ra_down,
                     self._predict(calibration, workers, ra_down,
                                   efficiency))
        return out

    def _sensor_candidates(self, sense: dict) -> List[dict]:
        """Moves the throughput model has no term for, driven directly by
        sensor evidence: a tail-stall verdict (queue-wait p99 dwarfing p50)
        asks for a deeper results queue to absorb the bursts, and a
        data-stalled consumer (the goodput plane's windowed
        ``data_stall_fraction`` — the device waited on data for most of
        the window) asks for deeper io readahead to widen the host side."""
        out = []
        signals = sense['signals']
        bound = self._actuators.get_queue_bound()
        if signals.get('tail_stall') and bound:
            new_bound = min(1024, max(bound + 1, bound * 3 // 2))
            if new_bound > bound:
                capacity_scale = new_bound / bound
                if not self._predicted_p99_breach(None, None, capacity_scale,
                                                  sense):
                    out.append({'knob': 'results_queue_bound',
                                'direction': 'up', 'to': new_bound,
                                'predicted_samples_per_s': None,
                                'predicted_gain_pct': None,
                                'policy': 'sensor',
                                'evidence': signals['bottleneck']})
        stall = sense.get('data_stall_fraction')
        if stall is not None and stall >= DATA_STALL_SENSOR_THRESHOLD:
            from petastorm_tpu_torch.readers.readahead import (
                AUTO_INITIAL_DEPTH, AUTO_MAX_DEPTH)
            readahead = self._actuators.get_readahead()
            ra_up = (readahead + 1 if readahead >= AUTO_INITIAL_DEPTH
                     else AUTO_INITIAL_DEPTH)
            if readahead < ra_up <= AUTO_MAX_DEPTH:
                out.append({'knob': 'io_readahead', 'direction': 'up',
                            'to': ra_up,
                            'predicted_samples_per_s': None,
                            'predicted_gain_pct': None,
                            'policy': 'sensor',
                            'evidence': 'data_stall_fraction={}'.format(
                                round(stall, 4))})
        return out

    # -- actuation -------------------------------------------------------------

    def _apply(self, candidate: dict) -> dict:
        knob = candidate['knob']
        to = candidate['to']
        before = after = None
        companion = None
        if knob == 'workers_count':
            before = self._actuators.get_workers()
            after = self._actuators.set_workers(to)
        elif knob == 'io_readahead':
            before = self._actuators.get_readahead()
            after = self._actuators.set_readahead(to)
        elif knob == 'vent_window':
            before = self._actuators.get_vent_window()
            after = self._actuators.set_vent_window(to)
        elif knob == 'results_queue_bound':
            before = self._actuators.get_queue_bound()
            after = self._actuators.set_queue_bound(to)
        if knob in ('workers_count', 'io_readahead') and after == to:
            # companion actuation: keep the ventilation window covering
            # every worker's prefetch horizon (the construction formula)
            workers = self._actuators.get_workers()
            lookahead = self._actuators.get_readahead()
            window = workers * (1 + lookahead) + VENT_EXTRA
            if self._actuators.set_vent_window(window) == window:
                companion = {'vent_window': window}
        return {'from': before, 'applied': after, 'companion': companion}

    def _record(self, action: dict) -> None:
        with self._lock:
            self._actions.append(action)
            self._actions_total += 1

    def _revert(self, action: dict, sense: dict) -> None:
        knob = action['knob']
        inverse = {'knob': knob, 'direction': 'revert', 'to': action['from']}
        applied = self._apply(inverse)
        quarantine_until = self._ticks + int(self.options['quarantine_ticks'])
        with self._lock:
            self._quarantine[(knob, action['direction'])] = quarantine_until
            self._reverts_total += 1
        self._record({
            'tick': self._ticks,
            'knob': knob,
            'direction': 'revert',
            'from': action['to'],
            'to': action['from'],
            'applied': applied['applied'],
            'policy': 'revert',
            'reverts_tick': action['tick'],
            'measured_samples_per_s': sense['items_per_s'],
            'evidence': {'measured_delta_pct':
                         action.get('measured_delta_pct')},
            'quarantined_until_tick': quarantine_until,
        })
        logger.warning(
            'autotune reverted %s %s->%s: measured throughput dropped '
            '%.1f%% after the move (predicted %+.1f%%); direction '
            'quarantined for %d ticks', knob, action['from'], action['to'],
            -(action.get('measured_delta_pct') or 0.0),
            action.get('predicted_gain_pct') or 0.0,
            int(self.options['quarantine_ticks']))
        # the undo actuation can stall the pipeline too: restart the sense
        # baseline so the next window measures post-revert flow only
        self._prev_snapshot = self._snapshot_fn() or {}
        self._prev_ts = self._clock()

    def _grade_pending(self, sense: dict) -> None:
        action = self._pending
        if action is None:
            return
        if sense['items_delta'] < 1:
            # nothing flowed this tick: a rate of zero says "idle consumer",
            # not "the move was bad" — extend the grading window
            self._pending_grade_ticks += 1
            if self._pending_grade_ticks >= int(
                    self.options['grade_ticks_max']):
                with self._lock:   # the dict is in the ring; readers copy it
                    action['graded'] = 'no-data'
                self._pending = None
            return
        pre = action.get('pre_samples_per_s') or 0.0
        post = sense['items_per_s']
        grade = {'measured_samples_per_s': round(post, 3)}
        measured_delta = None
        if pre > 0:
            measured_delta = 100.0 * (post - pre) / pre
            grade['measured_delta_pct'] = round(measured_delta, 1)
            predicted = action.get('predicted_gain_pct')
            if predicted is not None:
                grade['prediction_error_pct'] = round(
                    predicted - measured_delta, 1)
            grade['graded'] = 'measured'
        else:
            grade['graded'] = 'no-baseline'
        with self._lock:
            # the action dict already sits in the ring: mutate it under the
            # same lock actions()/report() copy it under, or a concurrent
            # /autotune scrape hits "dict changed size during iteration"
            action.update(grade)
        self._pending = None
        if measured_delta is not None \
                and measured_delta < -float(self.options['revert_pct']):
            self._revert(action, sense)

    # -- the loop --------------------------------------------------------------

    def tick(self) -> Optional[dict]:
        """One sense→predict→actuate step; returns the action taken (or
        ``None``). The background thread calls this every
        ``tick_interval_s``; tests call it directly."""
        self._ticks += 1
        self._actuators.reap()
        sense = self._sense()
        if sense['window_s'] is None:
            return None     # first tick: baseline only
        self._grade_pending(sense)
        self._last_rates = {'items_per_s': sense['items_per_s']}
        self._last_data_stall = sense.get('data_stall_fraction')
        # arbitration: publish our deficit, read back our CPU share
        calibration = self._get_calibration()
        cap = None
        if self._arbiter is not None:
            deficit = 0.0
            if calibration is not None:
                best = self._predict(
                    calibration,
                    int(self.options.get('max_workers')
                        or calibration.get('cpu_count') or 1),
                    1, 1.0)
                measured_rows = sense['items_per_s'] * self._rows_per_group()
                if best:
                    deficit = max(0.0, 1.0 - measured_rows / best)
            try:
                self._arbiter.publish(deficit, self._actuators.get_workers())
                cap = self._arbiter.worker_cap(deficit)
            except OSError:
                # an unwritable scratch dir (another user owns the shared
                # default under /tmp) must cost the arbitration layer, not
                # the whole controller — drop to solo operation, loudly
                logger.warning(
                    'autotune: arbitration scratch dir unusable; '
                    'continuing without multi-reader arbitration',
                    exc_info=True)
                self._arbiter = None
        max_workers = self.options.get('max_workers')
        if max_workers:
            cap = min(cap, int(max_workers)) if cap else int(max_workers)
        if cap is not None:
            self._worker_cap = cap
        if self._pending is not None:
            return None     # one ungraded move at a time (anti-flap)
        if sense['items_delta'] < 1:
            return None     # no flow: nothing to optimize, nothing to grade
        candidates = self._candidates(sense) + self._sensor_candidates(sense)
        hysteresis = float(self.options['hysteresis_pct'])
        viable = []
        for candidate in candidates:
            key = (candidate['knob'], candidate['direction'])
            if self._cooldowns.get(candidate['knob'], 0) > self._ticks:
                continue
            if self._quarantine.get(key, 0) > self._ticks:
                continue
            gain = candidate['predicted_gain_pct']
            if gain is not None and gain < hysteresis:
                continue
            viable.append(candidate)
        if not viable:
            return None
        # best predicted gain first; sensor moves (no prediction) rank last
        viable.sort(key=lambda c: -(c['predicted_gain_pct'] or -1e-9))
        chosen = viable[0]
        applied = self._apply(chosen)
        action = dict(chosen)
        action.update({
            'tick': self._ticks,
            'from': applied['from'],
            'applied': applied['applied'],
            'companion': applied['companion'],
            'pre_samples_per_s': round(sense['items_per_s'], 3),
            'evidence': {
                'bottleneck': sense['signals']['bottleneck'],
                'items_per_s': round(sense['items_per_s'], 3),
                'queue_wait_p99_s': round(
                    sense['snapshot_delta']['queue_wait_p99_s'] or 0.0, 6),
                'e2e_p99_s': sense['e2e_p99_s'],
                'worker_cap': self._worker_cap,
            },
        })
        if action['predicted_samples_per_s'] is not None:
            action['predicted_samples_per_s'] = round(
                action['predicted_samples_per_s'], 1)
        if action['predicted_gain_pct'] is not None:
            action['predicted_gain_pct'] = round(
                action['predicted_gain_pct'], 1)
        self._record(action)
        self._cooldowns[chosen['knob']] = (
            self._ticks + int(self.options['cooldown_ticks']))
        if applied['applied'] == chosen['to']:
            self._pending = action
            self._pending_grade_ticks = 0
            # actuation can stall the pipeline it is measuring (a process
            # shrink quiesces for seconds): restart the sense baseline so
            # the grading window covers only post-move flow, not the stall
            # the move itself caused
            self._prev_snapshot = self._snapshot_fn() or {}
            self._prev_ts = self._clock()
        else:
            with self._lock:   # the dict is in the ring; readers copy it
                action['graded'] = 'actuation-failed'
        logger.info('autotune: %s %s -> %s (%s, predicted %+s%%)',
                    chosen['knob'], applied['from'], applied['applied'],
                    chosen['policy'], chosen.get('predicted_gain_pct'))
        return action

    # -- observation surfaces --------------------------------------------------

    def actions(self) -> List[dict]:
        """The bounded action ring, oldest first (JSON-able copies)."""
        with self._lock:
            return [dict(a) for a in self._actions]

    def gauges(self) -> dict:
        """Flat numeric gauges merged into the reader's stats snapshot
        (``/metrics`` and the metrics emitter pick them up), plus the
        string-valued ``autotune_last_knob`` (label-exported, the
        ``binding_stage`` idiom)."""
        with self._lock:
            last = self._actions[-1] if self._actions else None
            out = {
                'autotune_ticks': self._ticks,
                'autotune_actions_total': self._actions_total,
                'autotune_reverts_total': self._reverts_total,
            }
        out['autotune_workers'] = self._actuators.get_workers()
        out['autotune_readahead_depth'] = self._actuators.get_readahead()
        if self._last_data_stall is not None:
            out['autotune_data_stall_fraction'] = self._last_data_stall
        if self._worker_cap is not None:
            out['autotune_worker_cap'] = self._worker_cap
        if last is not None:
            out['autotune_last_knob'] = '{}:{}'.format(last['knob'],
                                                       last['direction'])
            if last.get('predicted_gain_pct') is not None:
                out['autotune_last_predicted_delta_pct'] = \
                    last['predicted_gain_pct']
            if last.get('measured_delta_pct') is not None:
                out['autotune_last_measured_delta_pct'] = \
                    last['measured_delta_pct']
        return out

    def report(self) -> dict:
        """The controller grading its own predictions: every ringed action,
        the aggregate model error (mean absolute predicted-vs-measured
        delta), and the direction hit rate — measured-vs-predicted error is
        how we know the model is honest. What ``/autotune`` serves and
        flight records embed."""
        actions = self.actions()
        graded = [a for a in actions
                  if a.get('prediction_error_pct') is not None]
        direction_hits = sum(
            1 for a in graded
            if (a.get('measured_delta_pct') or 0.0) * (
                a.get('predicted_gain_pct') or 0.0) > 0)
        with self._lock:
            quarantined = [
                {'knob': knob, 'direction': direction,
                 'until_tick': until}
                for (knob, direction), until in sorted(
                    self._quarantine.items())
                if until > self._ticks]
        report = {
            'ticks': self._ticks,
            'actions_total': self._actions_total,
            'reverts_total': self._reverts_total,
            'actions': actions,
            'quarantined': quarantined,
            'config': {
                'workers_count': self._actuators.get_workers(),
                'io_readahead': self._actuators.get_readahead(),
                'vent_window': self._actuators.get_vent_window(),
                'results_queue_bound': self._actuators.get_queue_bound(),
                'worker_cap': self._worker_cap,
                'pool_type': self._actuators.pool_type,
            },
            'options': {k: v for k, v in self.options.items()
                        if v is not None},
            'prediction': {
                'graded': len(graded),
                'mean_abs_error_pct': round(
                    sum(abs(a['prediction_error_pct']) for a in graded)
                    / len(graded), 1) if graded else None,
                'direction_hits': direction_hits,
                'direction_accuracy': round(direction_hits / len(graded), 3)
                if graded else None,
            },
            'last_rates': dict(self._last_rates),
        }
        if self._arbiter is not None:
            report['arbitration'] = {
                'controller_id': self._arbiter.controller_id,
                'peers': self._arbiter.peers(),
                'worker_cap': self._worker_cap,
            }
        return report

    def flight_summary(self) -> dict:
        """The compact ``autotune`` section of a flight record: the recent
        action tail plus the grading aggregate (a stall that follows a
        controller move must be attributable to it)."""
        report = self.report()
        return {
            'ticks': report['ticks'],
            'actions_total': report['actions_total'],
            'reverts_total': report['reverts_total'],
            'recent_actions': report['actions'][-10:],
            'prediction': report['prediction'],
            'config': report['config'],
        }
