"""The port's tracing plane against the JAX package's.

The same spans (seeded numpy start times and durations) go into both
packages' tracers; the same snapshots into both Prometheus formatters.
Every comparison is exact: Chrome trace events are identical apart from
the pid and thread id of each track, Prometheus text is identical, error
words are identical. Tests that start a metrics emitter or worker
processes carry a ``timeout`` mark.
"""

import json
import os

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu import tracing as jtr
from petastorm_tpu.workers import stats as jstats

import petastorm_tpu_torch
from petastorm_tpu_torch import tracing as ttr
from petastorm_tpu_torch.workers import stats as tstats

from test_torch_lineage import _write

PACKAGES = (jtr, ttr)


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp('tracing') / 'store'))


def test_constants_match_jax():
    for name in ('TRACE_ENV_VAR', 'DEFAULT_CAPACITY', 'GOODPUT_STEP_CAT'):
        assert getattr(ttr, name) == getattr(jtr, name), name


@pytest.mark.parametrize('trace,env', [
    (None, None), (None, ''), (None, '0'), (None, 'off'), (None, 'FALSE'),
    (None, '1'), (None, 'on'), (None, 'true'), (None, '/tmp/t.json'),
    (True, '0'), (False, '1'), ('/tmp/x.json', None), (0, None)])
def test_resolve_trace_matches_jax(trace, env, monkeypatch):
    if env is None:
        monkeypatch.delenv(ttr.TRACE_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(ttr.TRACE_ENV_VAR, env)
    assert ttr.resolve_trace(trace) == jtr.resolve_trace(trace)


def test_tracer_capacity_error_matches_jax():
    words = []
    for m in PACKAGES:
        with pytest.raises(ValueError) as e:
            m.Tracer(capacity=0)
        words.append(str(e.value))
    assert words[0] == words[1]


def _spans(seed, n=40):
    """Seeded spans on two worker tracks and the consumer's, with goodput
    step spans, one of them a data stall."""
    rng = np.random.default_rng(seed)
    names = ['parquet_read', 'decode_columns', 'queue_wait', 'train_step']
    out = []
    for i in range(n):
        out.append((str(rng.choice(names)), str(rng.choice(['io', 'decode',
                                                             ''])),
                    float(rng.uniform(0, 10)), float(rng.uniform(-1e-3, 1)),
                    int(rng.choice([101, 202])), int(rng.integers(1, 4)),
                    {'row_group': i} if i % 5 == 0 else None))
    out.append(('step', jtr.GOODPUT_STEP_CAT, 3.0, 0.5, 101, 1,
                {'step': 0, 'verdict': 'data-stall', 'stall_ms': 12.5,
                 'fenced': True}))
    out.append(('step', jtr.GOODPUT_STEP_CAT, 4.0, 0.5, 101, 1,
                {'step': 1, 'verdict': 'compute-bound', 'stall_ms': 0.1,
                 'fenced': True}))
    return out


def _tracers(seed, capacity=jtr.DEFAULT_CAPACITY):
    tracers = [m.Tracer(capacity=capacity) for m in PACKAGES]
    spans = _spans(seed)
    for t in tracers:
        t.merge(spans[:10])
        for span in spans[10:]:
            t.add_span(*span)
        t.add_span('ventilate', 'ventilator', 0.5, 0.001)    # this process
        with t.span('local', 'consumer', args={'k': 1}):
            pass
    return tracers


def _without_tracks(events, origin):
    """Events with the pid and tid of the consumer's own spans (this
    process, this thread) replaced by markers, and the durations of the
    ``local`` span zeroed: measured, not injected."""
    out = []
    for e in events:
        e = dict(e)
        if e.get('pid') == origin:
            e['pid'] = 'consumer'
            e['tid'] = 'consumer-thread' if e.get('ph') == 'X' else e['tid']
            if e.get('ph') == 'M':
                e['args'] = {'name': e['args']['name'].split(' (pid')[0]}
        if e.get('name') == 'local':
            e['ts'] = e['dur'] = 0.0
        out.append(e)
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_chrome_trace_events_match_jax_apart_from_tracks(seed):
    """Tolerance: exact, apart from the pid and thread id of the spans this
    process recorded (and the measured ``local`` span's times)."""
    ref, got = _tracers(seed)
    origin = os.getpid()
    want = _without_tracks(ref.chrome_trace_events(), origin)
    have = _without_tracks(got.chrome_trace_events(), origin)
    assert have == want
    markers = [e for e in have if e['ph'] == 'i']
    assert [m['name'] for m in markers] == ['data-stall 12.5ms']
    assert len(got) == len(ref) and got.dropped == ref.dropped == 0
    assert _without_tracks(got.tail(7), origin) == _without_tracks(
        ref.tail(7), origin)
    assert got.tail(0) == ref.tail(0) == []
    for span in (jtr.make_span('a', 'b', 1.0, 2.0, pid=3, tid=4),
                 jtr.make_span('a', 'b', 1.0, 2.0)):
        assert ttr.make_span(*span) == span


def test_ring_bound_and_reset_match_jax():
    ref, got = _tracers(2, capacity=16)
    assert len(got) == len(ref) == 16
    assert got.dropped == ref.dropped > 0
    origin = os.getpid()
    assert (_without_tracks(got.chrome_trace_events(), origin)
            == _without_tracks(ref.chrome_trace_events(), origin))
    for t in (ref, got):
        t.reset()
        assert len(t) == 0 and t.dropped == 0 and t.spans() == []


def test_step_stall_marker_matches_jax():
    for span in _spans(3)[-2:]:
        event = {'name': span[0], 'cat': span[1], 'ph': 'X', 'ts': 1.0,
                 'dur': 2.0, 'pid': 5, 'tid': 6, 'args': span[6]}
        assert ttr.step_stall_marker(event) == jtr.step_stall_marker(event)
    assert ttr.step_stall_marker({'cat': 'x'}) is None


def test_export_chrome_trace_matches_jax(tmp_path):
    ref, got = _tracers(4)
    paths = [str(tmp_path / name) for name in ('jax.json', 'torch.json')]
    counts = [t.export_chrome_trace(p) for t, p in zip((ref, got), paths)]
    assert counts[0] == counts[1] == sum(
        1 for e in got.chrome_trace_events() if e['ph'] == 'X')
    docs = [json.load(open(p)) for p in paths]
    origin = os.getpid()
    assert docs[1]['displayTimeUnit'] == docs[0]['displayTimeUnit'] == 'ms'
    assert (_without_tracks(docs[1]['traceEvents'], origin)
            == _without_tracks(docs[0]['traceEvents'], origin))
    assert not [f for f in os.listdir(tmp_path) if '.tmp.' in f]


def _snapshot(seed):
    """A stats snapshot of both packages fed the same observations, with
    the special and non-finite keys the formatter handles."""
    snaps = []
    for module in (jstats, tstats):
        rng = np.random.default_rng(seed)
        stats = module.ReaderStats()
        for name in ('items_out', 'bytes_moved', 'rows_quarantined'):
            stats.add(name, int(rng.integers(0, 100)))
        for _ in range(30):
            stats.record_latency('queue_wait', float(rng.lognormal(-6, 1)))
            stats.record_latency('e2e_batch', float(rng.lognormal(-3, 1)))
        stats.add_time('worker_io_s', 1.5)
        stats.gauge('queue_depth', 3)
        snap = stats.snapshot()
        for key in ('window_s', 'items_per_s', 'mb_per_s'):
            snap[key] = 1.25
        snap.update(binding_stage='decode', autotune_last_knob='workers:up',
                    nan_ratio=float('nan'), inf_ratio=float('inf'),
                    neg_ratio=float('-inf'), flag=True, note='text')
        snaps.append(snap)
    return snaps


@pytest.mark.parametrize('seed', [0, 1])
def test_prometheus_text_matches_jax(seed):
    """Tolerance: identical text, histograms included."""
    ref, got = _snapshot(seed)
    text = ttr.prometheus_text(got)
    assert text == jtr.prometheus_text(ref)
    assert 'petastorm_tpu_latency_queue_wait_seconds_bucket{le="+Inf"} 30' \
        in text
    assert 'petastorm_tpu_binding_stage{stage="decode"} 1' in text
    assert 'petastorm_tpu_nan_ratio NaN' in text
    assert ttr.prometheus_text(got, prefix='x') == jtr.prometheus_text(
        ref, prefix='x')


def test_metrics_emitter_errors_match_jax(tmp_path):
    for kw in ({'interval_s': 0}, {'interval_s': 1, 'fmt': 'xml'}):
        words = []
        for m in PACKAGES:
            args = dict(snapshot_fn=dict, path=str(tmp_path / 'm'), **kw)
            with pytest.raises(ValueError) as e:
                m.MetricsEmitter(**args)
            words.append(str(e.value))
        assert words[0] == words[1]


@pytest.mark.timeout(60)
@pytest.mark.parametrize('suffix', ['.jsonl', '.prom'])
def test_metrics_emitter_writes_and_stops(tmp_path, suffix):
    stats = tstats.ReaderStats()
    stats.add('items_out', 3)
    stats.record_latency('queue_wait', 0.001)
    path = str(tmp_path / ('m' + suffix))
    emitter = ttr.MetricsEmitter(stats.snapshot, 0.05, path)
    emitter.start()
    emitter.start()                  # idempotent
    import time
    deadline = time.monotonic() + 20
    while emitter.emit_count < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    emitter.stop()
    emitter.stop()                   # idempotent: one final snapshot
    assert emitter._thread is None and emitter.emit_count >= 3
    text = open(path).read()
    if suffix == '.prom':
        assert 'petastorm_tpu_items_out 3' in text
        assert 'petastorm_tpu_latency_queue_wait_seconds_count 1' in text
    else:
        lines = [json.loads(line) for line in text.splitlines()]
        assert len(lines) == emitter.emit_count
        assert all(line['items_out'] == 3 and 'ts' in line
                   and tstats.LATENCY_HISTOGRAMS_KEY not in line
                   for line in lines)


def _span_names(reader):
    names = {}
    for span in reader.tracer.spans():
        names[span[0]] = names.get(span[0], 0) + 1
    return names


@pytest.mark.timeout(120)
@pytest.mark.parametrize('factory', ['make_reader', 'make_columnar_reader',
                                     'make_batch_reader'])
def test_reader_trace_file_and_metrics_as_jax(store, tmp_path, factory):
    """A traced, metered dummy-pool reader writes the same span counts into
    its Chrome trace as JAX's, and a Prometheus file naming items_out; the
    emitter's thread is gone after join."""
    counts = {}
    for name, module in (('jax', petastorm_tpu),
                         ('torch', petastorm_tpu_torch)):
        trace = str(tmp_path / (name + '.json'))
        prom = str(tmp_path / (name + '.prom'))
        with getattr(module, factory)(store, reader_pool_type='dummy',
                                      num_epochs=1, trace=trace,
                                      metrics_interval=0.05,
                                      metrics_out=prom) as reader:
            rows = sum(1 for _ in reader)
        doc = json.load(open(trace))
        spans = [e for e in doc['traceEvents'] if e['ph'] == 'X']
        names = {}
        for e in spans:
            names[e['name']] = names.get(e['name'], 0) + 1
        counts[name] = (rows, names, reader.stats.snapshot()['items_out'])
        assert 'petastorm_tpu_items_out' in open(prom).read()
        assert reader._metrics_emitter._thread is None
    assert counts['torch'] == counts['jax']
    assert counts['torch'][1]['process_item'] == counts['torch'][2] > 0


@pytest.mark.timeout(60)
def test_metrics_interval_needs_metrics_out_as_jax(store):
    words = []
    for module in (petastorm_tpu, petastorm_tpu_torch):
        for factory in ('make_reader', 'make_columnar_reader',
                        'make_batch_reader'):
            with pytest.raises(ValueError) as e:
                getattr(module, factory)(store, metrics_interval=0.5)
            words.append(str(e.value))
    assert len(set(words)) == 1
    assert 'metrics_out' in words[0]


def test_trace_env_var_traces_a_reader(store, tmp_path, monkeypatch):
    path = str(tmp_path / 'env.json')
    monkeypatch.setenv(ttr.TRACE_ENV_VAR, path)
    with petastorm_tpu_torch.make_columnar_reader(
            store, reader_pool_type='dummy', num_epochs=1) as reader:
        list(reader)
        assert reader.tracer is not None
    assert json.load(open(path))['traceEvents']
    monkeypatch.setenv(ttr.TRACE_ENV_VAR, '0')
    with petastorm_tpu_torch.make_columnar_reader(
            store, reader_pool_type='dummy', num_epochs=1) as reader:
        assert reader.tracer is None


@pytest.mark.timeout(120)
def test_process_workers_spans_keep_their_pids(store):
    """Spans recorded in worker interpreters arrive with the workers' pids
    and one per item, on the consumer's clock."""
    import time
    start = time.perf_counter()
    with petastorm_tpu_torch.make_columnar_reader(
            store, reader_pool_type='process', workers_count=2,
            num_epochs=1, trace=True) as reader:
        list(reader)
        pids = {p.pid for p in reader._pool._processes}
        spans = reader.tracer.spans()
        snapshot = reader.diagnostics
    end = time.perf_counter()
    worker = [s for s in spans if s[0] in ('process_item', 'serialize',
                                           'parquet_read', 'decode_columns')]
    assert worker and {s[4] for s in worker} <= pids
    assert all(start <= s[2] <= end for s in worker)
    consumer = [s for s in spans if s[0] in ('queue_wait', 'deserialize')]
    assert {s[4] for s in consumer} == {os.getpid()}
    names = _span_names(reader)
    assert (names['process_item'] == names['ventilate']
            == snapshot['items_out'] == snapshot['items_produced'])
    assert snapshot['payload_frames'] >= snapshot['items_out']
    assert snapshot['bytes_moved'] > 0
