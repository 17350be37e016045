"""The port's goodput monitor against the JAX package's.

One call sequence (fetch waits, staging seconds, fences and train walls
injected through a ticking clock, never measured) goes into both monitors:
their ring entries, ``state``, ``window``, ``summary``, ``flight_summary``,
verdicts and ``explain_step`` must be equal. The kill switch is the same
variable; a loader records one entry a batch, with the staging time
``prefetch_to_device`` reports. What the port has no plane for yet
(stats, tracer, latency, a stats snapshot) raises. On the card, the fence
waits for the step's kernels.
"""

import numpy as np
import pytest
import torch

from petastorm_tpu import goodput as jgoodput
from petastorm_tpu_torch import goodput as tgoodput
from petastorm_tpu_torch import torch_utils
from petastorm_tpu_torch.torch_utils import TorchDataLoader


class _Clock:
    """``time`` stand-in: each ``perf_counter()`` call advances ``tick``."""

    def __init__(self, tick):
        self.now = 0.0
        self.tick = tick

    def perf_counter(self):
        self.now += self.tick
        return self.now


# (infeed wait, staging seconds, fences (each one clock tick), train wall)
SEQUENCE = [
    (0.001, 0.0, 1, 0.030),      # compute-bound, fenced
    (0.040, 0.010, 1, 0.020),    # data stall, staging under the wait
    (0.002, 0.050, 0, 0.010),    # staging beyond the wait, unfenced
    (0.001, 0.0, 1, 0.040),      # host overhead: fence of one tick only
    (0.0, 0.0, 0, 0.0),          # an empty step
    (0.010, 0.0, 2, 0.025),      # two fences summed
    (0.015, 0.002, 1, 0.030),    # balanced
]


def _drive(module, monkeypatch, tick):
    monkeypatch.setattr(module, 'time', _Clock(tick))
    monitor = module.GoodputMonitor(ring_size=5, window_steps=3,
                                    host='host-0')
    assert monitor.finish_step(0.1) is None          # no step open
    for i, (wait, staged, fences, wall) in enumerate(SEQUENCE):
        if i == 3:
            tick_before = module.time.tick
            module.time.tick = 0.005
        monitor.note_fetch(wait, {'x': np.zeros(2)})
        if staged:
            monitor.note_stage(staged)
        for _ in range(fences):
            monitor.fence(np.zeros(3))
        monitor.finish_step(wall)
        if i == 3:
            module.time.tick = tick_before
    return monitor


@pytest.mark.parametrize('tick', [0.004, 0.02])
def test_one_call_sequence_gives_jax_numbers(monkeypatch, tick):
    ref = _drive(jgoodput, monkeypatch, tick)
    got = _drive(tgoodput, monkeypatch, tick)
    assert got.steps() == ref.steps()
    assert len(got.steps()) == 5                     # ring bound
    assert got.step(2) == ref.step(2) and got.step(1) is None is ref.step(1)
    assert got.state() == ref.state()
    assert got.window() == ref.window() and got.window(5) == ref.window(5)
    assert got.summary() == ref.summary()
    assert got.flight_summary() == ref.flight_summary()
    verdicts = [tgoodput.classify_step(e) for e in got.steps()]
    assert verdicts == [jgoodput.classify_step(e) for e in ref.steps()]
    for n in (None, 2, 3, 4, 5, 6, 99):
        assert got.explain_step(n) == ref.explain_step(n)


def test_verdict_vocabulary_matches_jax():
    for name in ('DATA_STALL', 'COMPUTE_BOUND', 'HOST_OVERHEAD', 'BALANCED',
                 'DOMINANCE_THRESHOLD', 'DEFAULT_STEP_RING',
                 'DEFAULT_WINDOW_STEPS', 'GOODPUT_ENV_VAR'):
        assert getattr(tgoodput, name) == getattr(jgoodput, name)
    for entry in ({}, {'total_s': 1.0, 'stall_s': 0.5},
                  {'total_s': 1.0, 'h2d_stage_s': 0.3, 'device_step_s': 0.3},
                  {'total_s': 1.0, 'host_overhead_s': 0.39}):
        assert tgoodput.classify_step(entry) == jgoodput.classify_step(entry)


@pytest.mark.parametrize('value', [None, '0', 'false', 'OFF', '1', 'yes'])
def test_kill_switch_matches_jax(monkeypatch, tmp_path, value):
    if value is None:
        monkeypatch.delenv(tgoodput.GOODPUT_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(tgoodput.GOODPUT_ENV_VAR, value)
    assert tgoodput.goodput_enabled() == jgoodput.goodput_enabled()
    loader = TorchDataLoader(_ListReader(2), batch_size=2, device='cpu')
    assert (loader.goodput is None) == (not jgoodput.goodput_enabled())
    assert len(list(loader)) == 2


def test_unported_planes_raise():
    for kw in ({'stats': object()}, {'tracer': object()},
               {'latency': object()}):
        with pytest.raises(NotImplementedError, match='tracing and health'):
            tgoodput.GoodputMonitor(**kw)
    monitor, ref = tgoodput.GoodputMonitor(), jgoodput.GoodputMonitor()
    assert monitor.stats is monitor.tracer is monitor.latency is None
    for m in (monitor, ref):
        m.note_fetch(0.5)
        m.finish_step(0.1)
    with pytest.raises(NotImplementedError, match='health slice'):
        monitor.explain_step(snapshot={'io_s': 1.0})
    assert monitor.explain_step(snapshot={}) == ref.explain_step(snapshot={})


class _ListReader:
    """A batched reader of ``n`` items of two float columns."""
    ngram = None
    batched_output = True

    def __init__(self, n):
        from collections import namedtuple
        self.item = namedtuple('Item', ['x', 'y'])
        self.n = n

    def __iter__(self):
        return (self.item(np.full((2, 3), i, np.float32), np.arange(2))
                for i in range(self.n))

    def stop(self):
        pass

    def join(self):
        pass


def test_loader_records_one_entry_a_batch_with_staging(monkeypatch):
    monkeypatch.delenv(tgoodput.GOODPUT_ENV_VAR, raising=False)
    loader = TorchDataLoader(_ListReader(6), batch_size=2, device='cpu')
    monitor = loader.goodput
    staged = []
    real = monitor.note_stage
    monkeypatch.setattr(monitor, 'note_stage',
                        lambda s: staged.append(s) or real(s))
    seen = 0
    for batch in torch_utils.prefetch_to_device(iter(loader), size=2,
                                                device='cpu',
                                                goodput=monitor):
        assert torch.is_tensor(batch['x'])
        monitor.fence(batch['x'] * 2)
        seen += 1
    entries = monitor.steps()
    assert seen == len(entries) == len(staged) == 6
    assert [e['step'] for e in entries] == list(range(6))
    assert all(e['total_s'] == pytest.approx(e['infeed_wait_s']
                                             + e['device_step_s']
                                             + e['host_overhead_s'])
               for e in entries)
    assert monitor.state()['fenced_steps'] >= 1
    # iterated directly, the train wall is the consumer's own step
    loader = TorchDataLoader(_ListReader(3), batch_size=1, device='cpu')
    for batch in loader:
        loader.goodput.fence(batch['x'])
    assert [e['fenced'] for e in loader.goodput.steps()] == [True] * 6


@pytest.mark.cuda
def test_cuda_fence_waits_for_the_kernels():
    """A fence after a ~20 ms sleep kernel records at least 10 ms of device
    time, and the step's output is complete after it."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the fence waits on a CUDA event')
    monitor = tgoodput.GoodputMonitor()
    out = torch.zeros(4, device='cuda')
    torch.cuda.synchronize()
    monitor.note_fetch(0.0)
    torch.cuda._sleep(40_000_000)
    out = out + 1
    monitor.fence({'loss': out, 'meta': [1, 'a']})
    entry = monitor.finish_step(1.0)
    assert entry['fenced'] and entry['device_step_s'] >= 0.01
    assert float(out.sum()) == 4.0
