"""Per-step goodput accounting of the port: where each training step's wall
time goes, measured at the loader.

The port's copy of ``petastorm_tpu/goodput.py`` (``goodput_enabled`` :72,
``classify_step`` :78, ``GoodputMonitor`` :96-436). Every step the consumer
loop takes splits into

    total_s = infeed_wait_s + train_wall_s
    infeed_wait_s = stall_s + h2d_stage_s          (data-path cost)
    train_wall_s  = device_step_s + host_overhead_s (with the step fence)

from the loader's own timing sites (``TorchLoaderBase.__iter__`` times the
blocking fetch and the suspended train wall; :func:`prefetch_to_device
<petastorm_tpu_torch.torch_utils.prefetch_to_device>` reports each staging
dispatch through :meth:`GoodputMonitor.note_stage`) and an opt-in fence,
:meth:`GoodputMonitor.fence`: a CUDA event recorded after the step's outputs
and waited on. Without the fence the whole train wall counts as device
time and the step records ``fenced=False``.

The monitor keeps a bounded per-step ring and summed seconds; each ring
entry keeps its batch's lineage provenance (``batch['_provenance']``), and
:meth:`GoodputMonitor.explain_step` names the step's first source row
group (JAX ``goodput.py:140-153, 190-222, 380-389, 431-456``). Each closed
step is exported into the reader's planes (JAX :233-260): the summed
``goodput_*_s`` stages of ``stats``, the ``device_step`` and
``host_overhead`` latencies, and one ``'step'`` span of the ``tracer``
with the verdict in its args; a data stall's culprit chain walks
:func:`~petastorm_tpu_torch.health.bottleneck_signals` of a stats
snapshot (JAX :360-375).

On by default; ``PETASTORM_TPU_GOODPUT=0`` (the JAX package's variable)
leaves loaders with no monitor at all.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from petastorm_tpu_torch.health import bottleneck_signals

__all__ = ['GOODPUT_ENV_VAR', 'GoodputMonitor', 'goodput_enabled',
           'classify_step', 'DATA_STALL', 'COMPUTE_BOUND', 'HOST_OVERHEAD',
           'BALANCED']

#: Kill switch (default on): ``0`` / ``false`` / ``off`` gives loaders no
#: monitor.
GOODPUT_ENV_VAR = 'PETASTORM_TPU_GOODPUT'

#: Verdicts: the dominant component of a step's wall time, when one
#: dominates.
DATA_STALL = 'data-stall'
COMPUTE_BOUND = 'compute-bound'
HOST_OVERHEAD = 'host-overhead'
BALANCED = 'balanced'

#: A component must carry at least this fraction of the step wall to be
#: named the verdict.
DOMINANCE_THRESHOLD = 0.4

#: Per-step ring bound: explain_step() reaches this far back.
DEFAULT_STEP_RING = 512

#: Rolling goodput window (steps) for :meth:`GoodputMonitor.summary`.
DEFAULT_WINDOW_STEPS = 32


def goodput_enabled() -> bool:
    """The goodput plane's kill switch (default on)."""
    return os.environ.get(GOODPUT_ENV_VAR, '1').lower() not in (
        '0', 'false', 'off')


def classify_step(entry: dict) -> str:
    """The verdict for one ring entry: the dominant wall-time component
    (data stall / device compute / host overhead) when one carries at
    least :data:`DOMINANCE_THRESHOLD` of the step, else ``balanced``."""
    total = entry.get('total_s') or 0.0
    if total <= 0.0:
        return BALANCED
    stall_f = (entry.get('stall_s', 0.0)
               + entry.get('h2d_stage_s', 0.0)) / total
    device_f = entry.get('device_step_s', 0.0) / total
    host_f = entry.get('host_overhead_s', 0.0) / total
    best, verdict = stall_f, DATA_STALL
    if device_f > best:
        best, verdict = device_f, COMPUTE_BOUND
    if host_f > best:
        best, verdict = host_f, HOST_OVERHEAD
    return verdict if best >= DOMINANCE_THRESHOLD else BALANCED


def _first_cuda_tensor(outputs):
    if torch.is_tensor(outputs):
        return outputs if outputs.is_cuda else None
    if isinstance(outputs, dict):
        outputs = list(outputs.values())
    if isinstance(outputs, (list, tuple)):
        for x in outputs:
            found = _first_cuda_tensor(x)
            if found is not None:
                return found
    return None


class GoodputMonitor:
    """Per-step goodput accounting for one consumer loop.

    Built by ``TorchLoaderBase`` when :func:`goodput_enabled`; the loader
    drives :meth:`note_fetch` / :meth:`finish_step` from its ``__iter__``
    and the staging sites drive :meth:`note_stage` (from the prefetch
    thread: the pending sums are lock-protected; the monitor starts no
    thread).

    ``stats`` and ``tracer`` are the reader's planes (either may be None):
    each closed step adds its seconds to the ``goodput_*_s`` stages and its
    ``device_step`` (and, fenced, ``host_overhead``) to the latency
    histograms of ``stats``, and one ``'step'`` span (category
    ``'goodput'``, the verdict and stall in its args) to ``tracer``. A
    monitor without ``stats`` records its latencies into ``latency`` (a
    :class:`~petastorm_tpu_torch.latency.PipelineLatency`) when given."""

    def __init__(self, stats=None, tracer=None, latency=None,
                 ring_size: int = DEFAULT_STEP_RING,
                 window_steps: int = DEFAULT_WINDOW_STEPS,
                 host: Optional[str] = None):
        self.stats = stats
        self.tracer = tracer
        self.latency = latency
        self._host = host
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=ring_size)
        self._window_steps = max(1, int(window_steps))
        self._steps = 0
        self._fenced_steps = 0
        # summed seconds
        self._total_s = 0.0
        self._stall_s = 0.0
        self._h2d_s = 0.0
        self._device_s = 0.0
        self._host_s = 0.0
        # the step in flight
        self._pending_infeed_s = 0.0
        self._pending_h2d_s = 0.0
        self._pending_fence_s = 0.0
        self._pending_fenced = False
        self._pending_provenance = None
        self._step_open = False

    # -- hooks of the loader and the staging sites ---------------------------

    def note_fetch(self, infeed_wait_s: float, batch=None) -> None:
        """The loader fetched a batch after blocking ``infeed_wait_s``
        seconds; opens the step the consumer is about to run."""
        provenance = None
        if isinstance(batch, dict):
            provenance = batch.get('_provenance')
        with self._lock:
            self._pending_infeed_s = max(0.0, float(infeed_wait_s))
            self._pending_provenance = provenance
            self._pending_fence_s = 0.0
            self._pending_fenced = False
            self._step_open = True

    def note_stage(self, elapsed_s: float) -> None:
        """``elapsed_s`` seconds of host-to-device staging happened; they
        are attributed to the next step to finish (staging may run ahead on
        the prefetch thread: attribution, not measurement)."""
        with self._lock:
            self._pending_h2d_s += max(0.0, float(elapsed_s))

    def fence(self, outputs):
        """The step fence, the port's ``block_until_ready``: a CUDA event
        recorded on the current stream after the step's ``outputs`` (a
        tensor or a nest of dicts, lists and tuples), waited on, the wait
        timed on the host. The train wall then splits into device time (the
        wait) and host overhead (the rest). Outputs on the CPU have nothing
        to wait for. Returns ``outputs``."""
        start = time.perf_counter()
        tensor = _first_cuda_tensor(outputs)
        if tensor is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(tensor.device))
            event.synchronize()
        elapsed = time.perf_counter() - start
        with self._lock:
            self._pending_fence_s += elapsed
            self._pending_fenced = True
        return outputs

    def finish_step(self, train_wall_s: float) -> Optional[dict]:
        """Close the step the consumer just ran (``train_wall_s`` is the
        yield-to-next-fetch wall the loader measured). Returns the ring
        entry, or ``None`` when no step was open."""
        train_wall_s = max(0.0, float(train_wall_s))
        with self._lock:
            if not self._step_open:
                return None
            infeed = self._pending_infeed_s
            h2d = self._pending_h2d_s
            fence_s = self._pending_fence_s
            fenced = self._pending_fenced
            provenance = self._pending_provenance
            self._pending_infeed_s = 0.0
            self._pending_h2d_s = 0.0
            self._pending_fence_s = 0.0
            self._pending_fenced = False
            self._pending_provenance = None
            self._step_open = False
            step = self._steps
            self._steps += 1
            # the staging seconds on the critical path are at most the time
            # the consumer waited; the rest overlapped compute
            h2d_attrib = min(h2d, infeed)
            stall = infeed - h2d_attrib
            if fenced:
                device = min(fence_s, train_wall_s)
                host = train_wall_s - device
                self._fenced_steps += 1
            else:
                device = train_wall_s
                host = 0.0
            total = infeed + train_wall_s
            entry = {
                'step': step,
                'total_s': total,
                'infeed_wait_s': infeed,
                'stall_s': stall,
                'h2d_stage_s': h2d_attrib,
                'device_step_s': device,
                'host_overhead_s': host,
                'fenced': fenced,
                'provenance': provenance,
            }
            self._ring.append(entry)
            self._total_s += total
            self._stall_s += stall
            self._h2d_s += h2d_attrib
            self._device_s += device
            self._host_s += host
        self._record(entry)
        return entry

    def _record(self, entry: dict) -> None:
        """Export one closed step to the planes (outside the lock: they
        take their own)."""
        stats = self.stats
        if stats is not None:
            stats.add_time('goodput_total_s', entry['total_s'])
            stats.add_time('goodput_stall_s', entry['stall_s'])
            stats.add_time('goodput_h2d_s', entry['h2d_stage_s'])
            stats.add_time('goodput_device_s', entry['device_step_s'])
            stats.add_time('goodput_host_s', entry['host_overhead_s'])
            stats.record_latency('device_step', entry['device_step_s'])
            if entry['fenced']:
                stats.record_latency('host_overhead',
                                     entry['host_overhead_s'])
        elif self.latency is not None:
            self.latency.record('device_step', entry['device_step_s'])
            if entry['fenced']:
                self.latency.record('host_overhead',
                                    entry['host_overhead_s'])
        tracer = self.tracer
        if tracer is not None:
            now = time.perf_counter()
            stall_ms = (entry['stall_s'] + entry['h2d_stage_s']) * 1000.0
            tracer.add_span('step', 'goodput', now - entry['total_s'],
                            entry['total_s'],
                            args={'step': entry['step'],
                                  'verdict': classify_step(entry),
                                  'stall_ms': round(stall_ms, 3),
                                  'fenced': entry['fenced']})

    # -- read side -----------------------------------------------------------

    def steps(self) -> List[dict]:
        """The bounded per-step ring, oldest first (copies)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def step(self, n: int) -> Optional[dict]:
        """Ring entry for step ``n`` (``None`` when evicted or unknown)."""
        with self._lock:
            for entry in reversed(self._ring):
                if entry['step'] == n:
                    return dict(entry)
        return None

    def state(self) -> dict:
        """Summed seconds and step counts."""
        with self._lock:
            return {
                'steps': self._steps,
                'fenced_steps': self._fenced_steps,
                'total_s': self._total_s,
                'stall_s': self._stall_s,
                'h2d_s': self._h2d_s,
                'device_s': self._device_s,
                'host_s': self._host_s,
            }

    def window(self, steps: Optional[int] = None) -> dict:
        """Rolling goodput over the last ``steps`` ring entries."""
        limit = steps or self._window_steps
        with self._lock:
            tail = list(self._ring)[-limit:]
        total = sum(e['total_s'] for e in tail)
        if not tail or total <= 0.0:
            return {'steps': len(tail), 'goodput_fraction': None,
                    'data_stall_fraction': None}
        stall = sum(e['stall_s'] + e['h2d_stage_s'] for e in tail)
        device = sum(e['device_step_s'] for e in tail)
        return {
            'steps': len(tail),
            'goodput_fraction': round(device / total, 4),
            'data_stall_fraction': round(stall / total, 4),
        }

    def summary(self) -> dict:
        """Cumulative and rolling-window goodput."""
        state = self.state()
        total = state['total_s']
        out = {
            'enabled': True,
            'steps': state['steps'],
            'fenced_steps': state['fenced_steps'],
            'goodput_fraction': (round(state['device_s'] / total, 4)
                                 if total > 0 else None),
            'data_stall_fraction': (
                round((state['stall_s'] + state['h2d_s']) / total, 4)
                if total > 0 else None),
            'window': self.window(),
            'state': state,
        }
        if self._host is not None:
            out['host'] = self._host
        return out

    def flight_summary(self) -> dict:
        """The summary and the last 8 ring entries, each with its
        verdict."""
        tail = self.steps()[-8:]
        for entry in tail:
            entry['verdict'] = classify_step(entry)
        return dict(self.summary(), recent_steps=tail)

    def explain_step(self, n: Optional[int] = None,
                     snapshot: Optional[dict] = None,
                     heartbeats=None) -> dict:
        """The verdict of step ``n`` (the latest when ``None``) and the
        component that dominated it; for a data stall, the culprit chain
        walked through :func:`~petastorm_tpu_torch.health.
        bottleneck_signals` of a stats ``snapshot`` (``reader.diagnostics``)
        and the prefetch ring's occupancy there. ``heartbeats`` is accepted
        for parity with the JAX package, which reserves it and does not
        read it either."""
        if n is None:
            entries = self.steps()
            entry = entries[-1] if entries else None
        else:
            entry = self.step(n)
        if entry is None:
            return {'enabled': True, 'step': n, 'verdict': None,
                    'explanation': 'no such step in the ring '
                                   '(evicted or never recorded)'}
        verdict = classify_step(entry)
        total = entry['total_s'] or 0.0
        stall_s = entry['stall_s'] + entry['h2d_stage_s']
        chain: List[str] = []
        if verdict == DATA_STALL:
            chain.append('h2d_stage' if entry['h2d_stage_s'] > entry['stall_s']
                         else 'infeed_wait')
            if snapshot:
                signals = bottleneck_signals(snapshot)
                if signals.get('tail_stall'):
                    chain.append('queue_wait p99 tail')
                if signals.get('slow_object_store'):
                    chain.append('io_range')
                elif signals.get('slow_peer_cache'):
                    chain.append('peer_fetch')
                elif not signals.get('tail_stall'):
                    bottleneck = signals.get('bottleneck')
                    if bottleneck and bottleneck != 'none':
                        chain.append(bottleneck)
        elif verdict == HOST_OVERHEAD:
            chain.append('host_overhead')
        elif verdict == COMPUTE_BOUND:
            chain.append('device_step')
        provenance = entry.get('provenance')
        provenance = provenance.summary() if provenance is not None else None
        if chain and provenance and provenance.get('sources'):
            source = provenance['sources'][0]
            where = source.get('path')
            if where:
                suffix = where.rsplit('/', 1)[-1]
                chain[-1] = '{} ({} rg{})'.format(
                    chain[-1], suffix, source.get('row_group'))
        occupancy = snapshot.get('prefetch_occupancy') if snapshot else None
        if verdict == DATA_STALL:
            explanation = 'step {} stalled {:.0f}ms on {}'.format(
                entry['step'], stall_s * 1000.0, ' → '.join(chain))
        elif verdict == COMPUTE_BOUND:
            explanation = ('step {} spent {:.0f}ms of {:.0f}ms in device '
                           'compute — the input pipeline kept up'.format(
                               entry['step'],
                               entry['device_step_s'] * 1000.0,
                               total * 1000.0))
        elif verdict == HOST_OVERHEAD:
            explanation = ('step {} spent {:.0f}ms in host-side work '
                           'between fetch and device completion'.format(
                               entry['step'],
                               entry['host_overhead_s'] * 1000.0))
        else:
            explanation = ('step {} is balanced: no component carries '
                           '{:.0%} of the wall'.format(
                               entry['step'], DOMINANCE_THRESHOLD))
        out: Dict[str, Any] = {
            'enabled': True,
            'step': entry['step'],
            'verdict': verdict,
            'explanation': explanation,
            'chain': chain,
            'stall_ms': round(stall_s * 1000.0, 3),
            'decomposition': {
                'total_s': entry['total_s'],
                'infeed_wait_s': entry['infeed_wait_s'],
                'stall_s': entry['stall_s'],
                'h2d_stage_s': entry['h2d_stage_s'],
                'device_step_s': entry['device_step_s'],
                'host_overhead_s': entry['host_overhead_s'],
                'fenced': entry['fenced'],
            },
        }
        if occupancy is not None:
            out['prefetch_occupancy'] = occupancy
        if provenance is not None:
            out['provenance'] = provenance
        if self._host is not None:
            out['host'] = self._host
        return out
