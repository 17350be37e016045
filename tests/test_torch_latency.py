"""The port's latency plane against the JAX package's.

The same seeded numpy durations go into both packages' histograms, deltas
and SLO monitors, under one injected clock where a rolling window is
involved. Every comparison is exact: bucket counts, quantiles, states,
summaries, Prometheus lines, verdicts and error words.
"""

import numpy as np
import pytest

from petastorm_tpu import latency as jlat
from petastorm_tpu.workers import stats as jstats

import petastorm_tpu_torch
from petastorm_tpu_torch import latency as tlat
from petastorm_tpu_torch.workers import stats as tstats

PACKAGES = (jlat, tlat)


class _Clock:
    """A settable monotonic clock shared by both packages' histograms."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _durations(seed, n=2000):
    """Log-uniform durations from 0.1 us to 100 s, bucket bounds and the
    overflow included."""
    rng = np.random.default_rng(seed)
    values = 10.0 ** rng.uniform(-7, 2, n)
    edges = [0.0, -1.0, jlat.FIRST_BUCKET_BOUND_S, jlat.BUCKET_BOUNDS_S[7],
             jlat.BUCKET_BOUNDS_S[-1], 1e9]
    return [float(v) for v in values] + edges


def test_constants_match_jax():
    for name in ('LATENCY_ENV_VAR', 'STAGES', 'TIME_STAGE_TO_LATENCY',
                 'BUCKET_GROWTH', 'FIRST_BUCKET_BOUND_S', 'NUM_BUCKETS',
                 'BUCKET_BOUNDS_S', 'QUANTILE_REL_ERROR_BOUND',
                 'DEFAULT_INTERVAL_S', 'DEFAULT_WINDOW_INTERVALS',
                 'SLO_TARGET_KEYS', 'DEFAULT_ERROR_BUDGET',
                 'DEFAULT_BUDGET_WINDOW', 'DEFAULT_EVAL_INTERVAL_S',
                 'DEFAULT_MIN_EVALUATIONS'):
        assert getattr(tlat, name) == getattr(jlat, name), name


def test_public_names():
    from petastorm_tpu_torch import LatencyHistogram, SLOMonitor
    assert LatencyHistogram is tlat.LatencyHistogram
    assert SLOMonitor is tlat.SLOMonitor
    assert {'LatencyHistogram', 'SLOMonitor'} <= set(
        petastorm_tpu_torch.__all__)


@pytest.mark.parametrize('seed', [0, 1])
def test_bucket_index_and_bounds_match_jax(seed):
    for v in _durations(seed):
        assert tlat.bucket_index(v) == jlat.bucket_index(v)
    for i in range(-1, tlat.NUM_BUCKETS + 2):
        assert tlat.bucket_lower_bound(i) == jlat.bucket_lower_bound(i)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_quantile_from_counts_matches_jax(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, tlat.NUM_BUCKETS + 1) * (
        rng.random(tlat.NUM_BUCKETS + 1) < 0.2)
    for q in (0.01, 0.5, 0.9, 0.99, 0.999):
        assert (tlat._quantile_from_counts(counts, q)
                == jlat._quantile_from_counts(counts, q))
    empty = np.zeros(tlat.NUM_BUCKETS + 1, dtype=np.int64)
    assert tlat._quantile_from_counts(empty, 0.5) is None


def _fed_histograms(seed, interval_s=1.0, window=3):
    """Both packages' histograms fed the same durations, the clock moving
    on by a seeded step between observations (quiet gaps included)."""
    clock = _Clock()
    hists = [m.LatencyHistogram(interval_s=interval_s,
                                window_intervals=window, clock=clock)
             for m in PACKAGES]
    rng = np.random.default_rng(seed + 100)
    states = []
    for i, v in enumerate(_durations(seed, n=600)):
        clock.now += float(rng.choice([0.0, 0.01, 0.4, 2.5]))
        for h in hists:
            h.record(v)
        if i % 97 == 0:
            states.append([h.window_counts().tolist() for h in hists])
    return clock, hists, states


@pytest.mark.parametrize('seed', [0, 3])
def test_histograms_and_rolling_windows_match_jax(seed):
    """Tolerance: exact (bucket counts and quantile floats)."""
    clock, (ref, got), states = _fed_histograms(seed)
    for want, have in states:
        assert have == want
    assert got.counts().tolist() == ref.counts().tolist()
    assert got.count == ref.count and got.sum_s == ref.sum_s
    for window in (False, True):
        for q in (0.001, 0.5, 0.9, 0.99, 0.999):
            assert got.quantile(q, window) == ref.quantile(q, window)
        assert got.percentiles(window) == ref.percentiles(window)
    assert got.recent_interval_p99s() == ref.recent_interval_p99s()
    assert got.window_span_s() == ref.window_span_s()
    assert got.state() == ref.state()
    clock.now += 100.0          # a quiet spell ages every spike out
    assert got.window_counts().sum() == ref.window_counts().sum() == 0
    assert got.quantile(0.99, window=True) is None
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError) as e_t:
            got.quantile(bad)
        with pytest.raises(ValueError) as e_j:
            ref.quantile(bad)
        assert str(e_t.value) == str(e_j.value)
    got.reset()
    assert got.count == 0 and got.state()['buckets'] == []


def test_constructor_errors_match_jax():
    for kw in ({'interval_s': 0}, {'window_intervals': 0}):
        words = []
        for m in PACKAGES:
            with pytest.raises(ValueError) as e:
                m.LatencyHistogram(**kw)
            words.append(str(e.value))
        assert words[0] == words[1]


@pytest.mark.parametrize('seed', [0, 1])
def test_quantiles_stay_within_the_error_bound(seed):
    rng = np.random.default_rng(seed)
    values = rng.lognormal(-5, 1.5, 5000)
    h = tlat.LatencyHistogram()
    for v in values:
        h.record(float(v))
    for q in (0.5, 0.9, 0.99):
        exact = float(np.quantile(values, q))
        assert (abs(h.quantile(q) - exact) / exact
                <= tlat.QUANTILE_REL_ERROR_BOUND)


def _deltas(module, seed):
    rng = np.random.default_rng(seed)
    deltas = module.LatencyDeltas()
    assert deltas.drain() is None
    for v in rng.lognormal(-4, 2, 50):
        deltas.record(str(rng.choice(['io', 'decode', 'queue_wait'])),
                      float(v))
    deltas.record_time_stage('worker_io_s', 0.25)
    deltas.record_time_stage('serialize_s', 0.25)     # not a latency stage
    return deltas.drain()


def _fold(module, parts):
    acc = module.LatencyDeltas()
    for part in parts:
        acc.absorb(part)
    return acc.drain()


def test_delta_merge_is_associative_as_jax():
    """(a + b) + c == a + (b + c) in both packages, and the sums, the
    histograms they merge into and their exports are equal (exact)."""
    out = []
    for m in PACKAGES:
        a, b, c = (_deltas(m, s) for s in (0, 1, 2))
        left = _fold(m, [_fold(m, [a, b]), c])
        right = _fold(m, [a, _fold(m, [b, c])])
        assert left == right
        plane = m.PipelineLatency()
        for part in (a, b, c):
            plane.merge_deltas(part)
        histogram = m.LatencyHistogram()
        histogram.merge_delta(left['io'])
        twin = m.LatencyHistogram()
        twin.merge(histogram)
        assert twin.state() == histogram.state()
        out.append((left, plane.export_state(), plane.summary(),
                    plane.window_p99s(), histogram.state()))
    assert out[0] == out[1]


def test_pipeline_latency_views_match_jax():
    clock = _Clock()
    planes = [m.PipelineLatency(interval_s=1.0, window_intervals=2,
                                clock=clock) for m in PACKAGES]
    rng = np.random.default_rng(7)
    for stage in tlat.STAGES[:6]:
        for v in rng.lognormal(-6, 1, 40):
            clock.now += 0.3
            for p in planes:
                p.record(stage, float(v))
    for p in planes:
        p.record('no-such-stage', 1.0)
    ref, got = planes
    assert got.export_state() == ref.export_state()
    assert got.summary() == ref.summary()
    assert got.summary(window=True) == ref.summary(window=True)
    assert got.flight_summary() == ref.flight_summary()
    assert got.window_p99s() == ref.window_p99s()
    assert got.quantile('io', 0.5) == ref.quantile('io', 0.5)
    assert got.quantile('nope', 0.5) is None


@pytest.mark.parametrize('seed', [0, 1])
def test_prometheus_histogram_lines_match_jax(seed):
    _, (ref, got), _ = _fed_histograms(seed)
    name = 'petastorm_tpu_latency_io_seconds'
    assert (tlat.prometheus_histogram_lines(name, got.state(), 'help')
            == jlat.prometheus_histogram_lines(name, ref.state(), 'help'))
    assert (tlat.prometheus_histogram_lines(name, {})
            == jlat.prometheus_histogram_lines(name, {}))


BAD_TARGETS = [
    [1, 2], {'p99_e2e': 5}, {'error_budget': 0}, {'error_budget': 1.5},
    {'budget_window': 0}, {'eval_interval_s': -1}, {'min_evaluations': 0},
    {'p99_e2e_ms': -1}, {'min_samples_per_s': -2}, {'min_goodput': 1.5},
]


@pytest.mark.parametrize('targets', BAD_TARGETS, ids=repr)
def test_validate_slo_targets_raises_jax_words(targets):
    words = []
    for m in PACKAGES:
        with pytest.raises(ValueError) as e:
            m.validate_slo_targets(targets)
        words.append(str(e.value))
    assert words[0] == words[1]


def test_validate_slo_targets_defaults_match_jax():
    for targets in ({}, {'p99_e2e_ms': 50, 'min_samples_per_s': 10},
                    {'error_budget': 0.5, 'fail_healthz': True}):
        assert (tlat.validate_slo_targets(targets)
                == jlat.validate_slo_targets(targets))


def test_slo_monitor_verdicts_match_jax():
    """One sequence of snapshots and latency observations into both
    monitors gives equal verdict dicts at every evaluation (exact)."""
    clock = _Clock()
    targets = {'p99_e2e_ms': 20.0, 'p99_queue_wait_ms': 5.0,
               'min_samples_per_s': 100.0, 'min_io_overlap_fraction': 0.5,
               'max_stall_episodes': 1, 'min_goodput': 0.6,
               'error_budget': 0.25, 'budget_window': 4,
               'eval_interval_s': 0, 'min_evaluations': 2}
    monitors = []
    for m in PACKAGES:
        plane = m.PipelineLatency(clock=clock)
        monitors.append((m.SLOMonitor(targets, latency=plane), plane))
    rng = np.random.default_rng(11)
    for i in range(8):
        clock.now += 1.0
        snapshot = {'items_per_s': float(rng.uniform(50, 150)),
                    'io_overlap_fraction': float(rng.uniform(0, 1))}
        if i >= 3:
            snapshot['goodput_fraction'] = float(rng.uniform(0.3, 0.9))
        for v in rng.lognormal(-5, 1, 5):
            for _, plane in monitors:
                plane.record('e2e_batch', float(v))
        if i == 5:
            for monitor, _ in monitors:
                monitor.record_stall_episode()
                monitor.record_stall_episode()
        verdicts = [monitor.evaluate(snapshot) for monitor, _ in monitors]
        assert verdicts[1] == verdicts[0]
    assert verdicts[1]['skipped_checks'] == ['p99_queue_wait_ms']
    assert monitors[1][0].last_verdict == verdicts[1]
    # no latency plane and no snapshot function: the latency checks skip
    bare = [m.SLOMonitor({'p99_e2e_ms': 1.0, 'eval_interval_s': 0})
            for m in PACKAGES]
    assert bare[1].evaluate() == bare[0].evaluate()


def test_slo_monitor_reads_its_snapshot_function():
    calls = []

    def snapshot():
        calls.append(1)
        return {'items_per_s': 5.0}
    monitor = tlat.SLOMonitor({'min_samples_per_s': 10.0,
                               'eval_interval_s': 0}, snapshot_fn=snapshot)
    verdict = monitor.evaluate()
    assert calls and verdict['breached_checks'] == ['min_samples_per_s']
    assert not monitor.fail_healthz


def test_kill_switch_creates_no_latency_state(monkeypatch, tmp_path):
    """``PETASTORM_TPU_LATENCY=0``: no histogram in either package, workers
    record none, no ventilation is stamped and snapshots carry no
    histogram key."""
    from test_torch_lineage import _write
    url = _write(str(tmp_path / 'store'))
    for value in ('0', 'false', 'off'):
        monkeypatch.setenv(tlat.LATENCY_ENV_VAR, value)
        assert not tlat.latency_enabled() and not jlat.latency_enabled()
        assert tstats.ReaderStats().latency is None
        assert jstats.ReaderStats().latency is None
    import petastorm_tpu
    for module in (petastorm_tpu, petastorm_tpu_torch):
        with module.make_columnar_reader(url, reader_pool_type='dummy',
                                         num_epochs=1) as reader:
            items = list(reader)
            assert items and reader.latency is None
            assert reader.stats.latency is None
            snapshot = reader.diagnostics
            assert tstats.LATENCY_HISTOGRAMS_KEY not in snapshot
            assert snapshot['queue_wait_p99_s'] == 0.0
            assert reader.lineage.ventilated_ts(0) is None
    with petastorm_tpu_torch.make_columnar_reader(
            url, reader_pool_type='dummy', num_epochs=1) as reader:
        worker = reader._pool._worker
        next(reader)
        assert worker.latency is None and worker.drain_latency() is None
        assert not reader.lineage._vent_ts
    monkeypatch.setenv(tlat.LATENCY_ENV_VAR, '1')
    with petastorm_tpu_torch.make_columnar_reader(
            url, reader_pool_type='dummy', num_epochs=1) as reader:
        next(reader)
        assert reader.latency is not None
        assert reader.lineage.ventilated_ts(0) is not None
