"""Infeed/compute overlap of real training steps (JAX
``benchmark/infeed.py``): samples/sec and the infeed-stall share.

For each training step the wall time splits into *stall* (waiting on the
input pipeline for the next batch) and *compute* (the step's dispatch,
plus the wait on the device for a step that leaves the ``dispatch_ahead``
window). ``overlap = compute / (compute + stall)``: 1.0 means the pipeline
always had a batch ready when the device finished, i.e. the infeed was
hidden behind compute.

Where JAX blocks on a step's output (``jax.block_until_ready``), the port
records a CUDA event on the current stream after the step and waits on it
(``Event.synchronize``) when the step leaves the window. The contract is
JAX's: the host runs at most ``dispatch_ahead`` steps ahead of the card,
and every step is fenced before the report closes. A step whose output
holds no CUDA tensor (the CPU) is complete when it returns and has no
fence.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable, Optional


@dataclasses.dataclass
class InfeedReport:
    steps: int
    samples: int
    total_time_s: float
    stall_time_s: float
    compute_time_s: float
    #: companion overlap measured with ``dispatch_ahead=0`` (fence every
    #: step) on the same warm pipeline, set by :func:`attach_sync_probe`:
    #: carrying both figures keeps a report comparable with one taken under
    #: the blocking protocol.
    overlap_pct_sync: Optional[float] = None

    @property
    def overlap(self) -> float:
        busy = self.compute_time_s + self.stall_time_s
        return self.compute_time_s / busy if busy else 1.0

    @property
    def stall_fraction(self) -> float:
        return 1.0 - self.overlap

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.total_time_s if self.total_time_s else 0.0

    def as_dict(self):
        out = {'steps': self.steps, 'samples': self.samples,
               'samples_per_sec': round(self.samples_per_sec, 2),
               'infeed_stall_pct': round(100.0 * self.stall_fraction, 2),
               'overlap_pct': round(100.0 * self.overlap, 2)}
        if self.overlap_pct_sync is not None:
            out['overlap_pct_sync'] = round(self.overlap_pct_sync, 2)
        return out


#: default length of the dispatch_ahead=0 probe window and its warmup;
#: bench runners that pre-budget a finite loader's epochs must reserve
#: SYNC_PROBE_STEPS + SYNC_PROBE_WARMUP extra steps
SYNC_PROBE_STEPS = 20
SYNC_PROBE_WARMUP = 6


def attach_sync_probe(report: 'InfeedReport', batch_iterator, step_fn,
                      num_steps: int = SYNC_PROBE_STEPS,
                      count_fn: Optional[Callable] = None) -> 'InfeedReport':
    """Measure a short ``dispatch_ahead=0`` window on the (already warm)
    pipeline and attach its overlap to ``report`` as ``overlap_pct_sync``,
    the blocking-protocol companion figure (see ``InfeedReport``).

    The probe has its own short warmup: the main run's in-flight drain lets
    prefetch buffers refill, and a probe that starts on a refilled buffer
    would read several zero-stall steps and inflate the sync figure on
    production-bound pipelines."""
    probe = measure_infeed_overlap(batch_iterator, step_fn,
                                   num_steps=num_steps,
                                   warmup_steps=SYNC_PROBE_WARMUP,
                                   count_fn=count_fn, dispatch_ahead=0)
    report.overlap_pct_sync = 100.0 * probe.overlap
    return report


def step_fence(out):
    """The fence of one step's output: an event recorded on the current
    stream of the device its CUDA tensor lives on (a tensor, or one in a
    dict, list or tuple), or None when the output holds no CUDA tensor
    and the step is complete when it returns."""
    from petastorm_tpu_torch.goodput import _first_cuda_tensor
    tensor = _first_cuda_tensor(out)
    if tensor is None:
        return None
    import torch
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensor.device))
    return event


def _wait(fence):
    if fence is not None:
        fence.synchronize()


def measure_infeed_overlap(batch_iterator: Iterable, step_fn: Callable,
                           num_steps: int = 100, warmup_steps: int = 5,
                           count_fn: Optional[Callable] = None,
                           dispatch_ahead: int = 0) -> InfeedReport:
    """Drive ``step_fn(batch)`` over ``batch_iterator`` and time stalls.

    :param step_fn: one training/inference step; its output is fenced
        (:func:`step_fence`) so compute time is the device's.
    :param count_fn: ``batch -> int`` sample counter (default: len of the
        first value of a dict batch / first field of a tuple).
    :param dispatch_ahead: number of steps the host may run ahead of the
        device before it waits (0 = wait every step). A training loop does
        not wait per step (CUDA launches are asynchronous; the host syncs
        when it reads a metric), so a small window (1-2) measures the loop
        users run: short infeed bursts are absorbed by the steps in flight
        instead of being charged as stall. Every step is still fenced
        before the report closes.
    """
    iterator = iter(batch_iterator)

    def batch_size_of(batch):
        if count_fn is not None:
            return count_fn(batch)
        if isinstance(batch, dict):
            first = next(v for k, v in batch.items() if k != '_host')
        else:
            first = batch[0]
        return int(first.shape[0])

    for _ in range(warmup_steps):
        _wait(step_fence(step_fn(next(iterator))))

    stall = compute = 0.0
    samples = 0
    steps = 0
    inflight = collections.deque()
    start = time.perf_counter()
    for _ in range(num_steps):
        t0 = time.perf_counter()
        try:
            batch = next(iterator)
        except StopIteration:
            break
        t1 = time.perf_counter()
        inflight.append(step_fence(step_fn(batch)))
        if len(inflight) > dispatch_ahead:
            _wait(inflight.popleft())
        t2 = time.perf_counter()
        stall += t1 - t0
        compute += t2 - t1
        samples += batch_size_of(batch)
        steps += 1
    t0 = time.perf_counter()
    while inflight:
        _wait(inflight.popleft())
    compute += time.perf_counter() - t0
    total = time.perf_counter() - start
    return InfeedReport(steps=steps, samples=samples, total_time_s=total,
                        stall_time_s=stall, compute_time_s=compute)
