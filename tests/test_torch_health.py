"""The port's live health plane against the JAX package's.

Units, each on the same inputs in both packages: the constants,
``heartbeats_enabled`` and ``resolve_debug_port`` on the same environment
values (a malformed port warns in both); ``classify_pipeline`` and
``degradation_causes`` on seeded heartbeat records and stats snapshots
(equal verdicts, JAX's wording); scripted ``HeartbeatRegistry`` and
``HealthMonitor`` sequences with a dying source; the key sets of
``build_flight_record`` and a round trip through ``write_flight_record``;
``PipelineWatchdog`` (one ``on_stall`` an episode, re-armed on recovery;
an on-demand ``evaluate`` leaves the progress baseline alone); and
``DebugServer`` on port 0 under the same wiring (every route's status
equal, ``/healthz`` 200 -> 503 -> 200, ``fail_healthz``).

The slice as a whole, both packages' readers on one store: the heartbeat
entities and stages on the dummy and thread pools, a worker wedged by a
file gate in its transform on the thread and process pools (the stalled
entity and stage, one flight record, ``infeed_diagnosis(heartbeats=)``,
recovery), the ``PETASTORM_TPU_HEALTH=0`` kill switch, a taken
``debug_port``, the routes a reader serves, and the ``loader-prefetch``
stage sequence of the staging thread on the CPU. Tests that start a
server, a watchdog or worker processes carry a ``timeout`` mark.
"""

import json
import logging
import os
import socket
import threading
import time
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

import petastorm_tpu
from petastorm_tpu import health as jhealth
from petastorm_tpu import jax_utils
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.tracing import Tracer as JTracer
from petastorm_tpu.transform import TransformSpec as JTransformSpec

import petastorm_tpu_torch
from petastorm_tpu_torch import health as thealth
from petastorm_tpu_torch import materialize_dataset, torch_utils
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.tracing import Tracer as TTracer
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

PACKAGES = {'jax': jhealth, 'torch': thealth}
ROWS = 48
GROUP = 8                       # rows a row group: 6 row groups
TOKEN_LEN = 16
#: the file gate holds the rows of the store's third row group
GATED = (2 * GROUP, 3 * GROUP)

_GATE_MODULE = '''
import os
import time


class FileGate:
    """A row transform that blocks on the rows whose ``step`` lies in
    ``[lo, hi)`` until the file ``path`` exists."""

    def __init__(self, path, lo, hi):
        self.path, self.lo, self.hi = path, lo, hi

    def __call__(self, row):
        if self.lo <= int(row['step']) < self.hi:
            deadline = time.monotonic() + 120
            while (not os.path.exists(self.path)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        return row
'''


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('health') / 'tokens')
    schema = Unischema('Tokens', [
        UnischemaField('step', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (TOKEN_LEN,), NdarrayCodec(),
                       False)])
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 500, (ROWS, TOKEN_LEN), dtype=np.int32)
    with materialize_dataset('file://' + path, schema,
                             row_group_size_mb=1,
                             rows_per_file=GROUP) as w:
        w.write_rows({'step': np.int64(i), 'tokens': tokens[i]}
                     for i in range(ROWS))
    return 'file://' + path


@pytest.fixture
def gate_module(tmp_path, monkeypatch):
    """The :class:`FileGate` in a module of its own, importable by worker
    interpreters of both packages (they inherit ``sys.path``)."""
    (tmp_path / 'health_gate_module.py').write_text(_GATE_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    import health_gate_module
    return health_gate_module


def _wait_for(predicate, timeout=30.0, what='condition'):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError('timed out waiting for {}'.format(what))


def _get(port, route):
    conn = HTTPConnection('127.0.0.1', port, timeout=10)
    try:
        conn.request('GET', route)
        response = conn.getresponse()
        return response.status, response.read().decode('utf-8')
    finally:
        conn.close()


# -- constants and switches --------------------------------------------------

def test_constants_match_jax():
    for name in ('HEALTH_ENV_VAR', 'DEBUG_PORT_ENV_VAR',
                 'DEFAULT_STALL_AFTER_S', 'HEALTHY', 'DEGRADED', 'STARVING',
                 'STALLED', 'IDLE_STAGES', 'SLOW_RANGE_FETCH_P99_S',
                 'SLOW_PEER_FETCH_P99_S'):
        assert getattr(thealth, name) == getattr(jhealth, name), name
    assert thealth.DEFAULT_STALL_AFTER_S == 120.0


@pytest.mark.parametrize('value', ['', '0', 'false', 'OFF', ' off ', '1',
                                   'true', 'yes'])
def test_heartbeats_enabled_as_jax(monkeypatch, value):
    monkeypatch.setenv('PETASTORM_TPU_HEALTH', value)
    assert thealth.heartbeats_enabled() == jhealth.heartbeats_enabled()


@pytest.mark.parametrize('kwarg,env', [
    (None, None), (None, ''), (None, '0'), (None, '8123'), (None, ' 9000 '),
    (None, 'abc'), (None, '-1'), (None, '70000'), (0, 'abc'), (5, None),
    (7, '8123')])
def test_resolve_debug_port_as_jax(monkeypatch, caplog, kwarg, env):
    if env is None:
        monkeypatch.delenv('PETASTORM_TPU_DEBUG_PORT', raising=False)
    else:
        monkeypatch.setenv('PETASTORM_TPU_DEBUG_PORT', env)
    got = {}
    for name, module in PACKAGES.items():
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            port = module.resolve_debug_port(kwarg)
        warned = [r.getMessage() for r in caplog.records
                  if 'debug endpoint disabled' in r.getMessage()]
        got[name] = (port, warned)
    assert got['torch'] == got['jax']
    malformed = kwarg is None and env in ('abc', '-1', '70000')
    assert bool(got['torch'][1]) == malformed


# -- classification ----------------------------------------------------------

STAGES = ('idle', 'done', 'stopped', 'backpressured', 'starting', 'io',
          'decode', 'processing', 'staging', 'worker_io', 'ventilate')


def _records(rng):
    names = ['worker-%d' % i for i in range(int(rng.integers(0, 5)))]
    names += ['ventilator', 'loader-prefetch', 'readahead-0'][
        :int(rng.integers(0, 4))]
    records = {}
    for name in names:
        age = float(rng.choice([0.0, 0.2, 0.7, 1.3, 5.0, 200.0]))
        records[name] = {'stage': str(rng.choice(STAGES)), 'ts': 0.0,
                         'items': int(rng.integers(0, 9)), 'pid': 7,
                         'age_s': age}
    return records


def _snapshot(rng):
    snap = {'worker_io_s': float(rng.exponential(1.0)),
            'worker_decode_s': float(rng.exponential(1.0)),
            'worker_publish_wait_s': float(rng.exponential(0.5)),
            'queue_wait_p50_s': float(rng.choice([0.0, 0.001, 0.02])),
            'queue_wait_p99_s': float(rng.choice([0.0, 0.01, 0.3])),
            'queue_depth': int(rng.integers(0, 3)),
            'items_out': int(rng.integers(0, 3)),
            'io_range_p99_s': float(rng.choice([0.0, 2.0])),
            'peer_fetch_p99_s': float(rng.choice([0.0, 0.5]))}
    for key in ('shared_put_failures', 'worker_respawns',
                'poison_items_quarantined', 'io_permanent_failures',
                'hosts_died', 'leases_rebalanced'):
        snap[key] = int(rng.choice([0, 0, 0, 2]))
    if snap['hosts_died'] and rng.random() < 0.5:
        snap['dead_hosts'] = ['host-a', 'host-b']
    return snap


@pytest.mark.parametrize('seed', range(32))
def test_classify_pipeline_as_jax(seed):
    rng = np.random.default_rng(seed)
    records = _records(rng)
    snapshot = _snapshot(rng) if seed % 4 else None
    stall = float(rng.choice([1.0, 2.0, 120.0]))
    got = thealth.classify_pipeline(records, snapshot, stall)
    assert got == jhealth.classify_pipeline(records, snapshot, stall)
    if snapshot is not None:
        assert (thealth.degradation_causes(snapshot)
                == jhealth.degradation_causes(snapshot))


def test_classify_pipeline_states_and_wording():
    """Every state of the classification, JAX's wording word for word; raw
    records without ``age_s`` age from their ``ts``."""
    now = time.perf_counter()
    cases = [
        ({'worker-0': {'stage': 'decode', 'ts': now - 10.0}}, None),
        ({'worker-0': {'stage': 'io', 'ts': now - 0.7}}, None),
        ({'worker-0': {'stage': 'idle', 'ts': now - 99.0}},
         {'worker_io_s': 5.0, 'worker_decode_s': 1.0, 'queue_depth': 0,
          'items_out': 3}),
        ({}, {'worker_respawns': 2, 'hosts_died': 1,
              'dead_hosts': ['h1']}),
        ({}, {'leases_rebalanced': 1}),
        ({}, None),
    ]
    states = []
    for records, snapshot in cases:
        got = thealth.classify_pipeline(records, snapshot, 1.0)
        ref = jhealth.classify_pipeline(records, snapshot, 1.0)
        for verdict in (got, ref):
            for entity in verdict['stalled_entities'] + \
                    verdict['slow_entities']:
                entity.pop('age_s')
        assert got == ref
        states.append(got['state'])
    assert states == ['stalled', 'degraded', 'starving', 'degraded',
                      'degraded', 'healthy']


# -- registry and monitor ----------------------------------------------------

def _script(module):
    registry = module.HeartbeatRegistry()
    registry.beat('worker-0', 'starting')
    registry.beat('worker-0', 'io', items=2)
    registry.beat('worker-0', 'decode')           # items carried over
    registry.beat('ventilator', 'ventilate', pid=1234)
    registry.update({'worker-9': {'stage': 'idle', 'ts': 0.0, 'items': 5,
                                  'pid': 42}})
    registry.update({})
    monitor = module.HealthMonitor()
    monitor.beat('loader-prefetch', 'staging', items=1)
    calls = []

    def live():
        calls.append(1)
        return {'worker-1': {'stage': 'io', 'ts': time.perf_counter(),
                             'items': 3, 'pid': 9}}

    def dying():
        raise RuntimeError('the pool is gone')

    monitor.add_source(live)
    monitor.add_source(dying)
    monitor.add_source(lambda: None)
    merged = monitor.heartbeats()

    def brief(records):
        return {k: (v['stage'], v['items'], v['pid'], 'age_s' in v)
                for k, v in records.items()}

    return brief(registry.snapshot()), brief(merged), len(calls), \
        monitor.enabled


def test_registry_and_monitor_scripts_as_jax(monkeypatch):
    monkeypatch.delenv('PETASTORM_TPU_HEALTH', raising=False)
    got, ref = _script(thealth), _script(jhealth)
    assert got == ref
    assert got[0]['worker-0'] == ('decode', 2, os.getpid(), True)
    assert got[1]['worker-1'] == ('io', 3, 9, True)
    monkeypatch.setenv('PETASTORM_TPU_HEALTH', '0')
    for module in PACKAGES.values():
        monitor = module.HealthMonitor()
        monitor.beat('ventilator', 'ventilate')
        assert not monitor.enabled and monitor.heartbeats() == {}


@pytest.mark.parametrize('order', ['in_order', 'out_of_order'])
def test_process_pool_merge_keeps_the_newest_record(order):
    """A worker's liveness frame (taken mid-item) and its ITEM_DONE frame
    ride two sockets, so the older can arrive last: the port keeps each
    entity's newest record. In order, both packages' merges agree."""
    from petastorm_tpu.workers.process_pool import ProcessPool as JPool
    from petastorm_tpu_torch.workers.process_pool import ProcessPool as TPool
    active = {'worker-0': {'stage': 'decode', 'ts': 5.0, 'items': 3,
                           'pid': 7}}
    done = {'worker-0': {'stage': 'idle', 'ts': 6.0, 'items': 4, 'pid': 7},
            'readahead-0': {'stage': 'idle', 'ts': 5.5, 'items': 2,
                            'pid': 7}}
    frames = [active, done] if order == 'in_order' else [done, active]
    merged = {}
    for name, cls in (('jax', JPool), ('torch', TPool)):
        pool = cls(1)
        for records in frames:
            pool._merge_heartbeats(records)
        merged[name] = dict(pool._heartbeats)
    assert merged['torch']['worker-0']['stage'] == 'idle'
    assert merged['torch'] == done
    if order == 'in_order':
        assert merged['torch'] == merged['jax']


# -- flight records ----------------------------------------------------------

@pytest.mark.parametrize('sections', [False, True])
def test_flight_record_keys_and_round_trip_as_jax(tmp_path, sections):
    verdict = {'state': 'stalled', 'stalled_entities': []}
    beats = {'worker-0': {'stage': 'decode', 'ts': 1.0, 'items': 0,
                          'pid': 3, 'age_s': 9.0}}
    records = {}
    for name, module, tracer_cls in (('jax', jhealth, JTracer),
                                     ('torch', thealth, TTracer)):
        kw = {}
        if sections:
            tracer = tracer_cls()
            tracer.add_span('decode', 'worker', 1.0, 0.5)
            kw = dict(queues={'queue_depth': 1}, tracer=tracer,
                      lineage={'epochs': []}, latency={'stages': {}},
                      slo={'breached': False}, goodput={'steps': 2})
        records[name] = module.build_flight_record(
            verdict, beats, {'items_out': 4}, **kw)
    assert set(records['torch']) == set(records['jax'])
    assert records['torch']['kind'] == 'petastorm_tpu_flight_record'
    if sections:
        assert records['torch']['span_tail'] == records['jax']['span_tail']
    path = thealth.write_flight_record(str(tmp_path / 'f.json'),
                                       records['torch'])
    with open(path) as f:
        back = json.load(f)
    assert back == json.loads(json.dumps(records['torch'], default=str))
    assert any('test_flight_record_keys' in stack
               for stack in back['stacks'].values())
    assert os.listdir(str(tmp_path)) == ['f.json']


def test_thread_stacks_name_the_threads():
    release = threading.Event()
    thread = threading.Thread(target=release.wait, name='held-by-a-test')
    thread.start()
    try:
        for module in PACKAGES.values():
            stacks = module.thread_stacks()
            [label] = [k for k in stacks if k.startswith('held-by-a-test')]
            assert label == 'held-by-a-test ({})'.format(thread.ident)
            assert 'wait' in stacks[label]
    finally:
        release.set()
        thread.join()


# -- the watchdog -------------------------------------------------------------

@pytest.mark.timeout(60)
@pytest.mark.parametrize('name', ['jax', 'torch'])
def test_watchdog_fires_once_an_episode_and_rearms(name):
    module = PACKAGES[name]
    records = {'worker-0': {'stage': 'decode', 'ts': time.perf_counter() - 99,
                            'items': 0, 'pid': 0}}
    stalls = []
    watchdog = module.PipelineWatchdog(lambda: dict(records),
                                       stall_after_s=0.1, interval_s=0.02,
                                       on_stall=stalls.append)
    watchdog.start()
    try:
        _wait_for(lambda: stalls, what='the first stall')
        time.sleep(0.2)
        assert len(stalls) == 1
        assert stalls[0]['stalled_entities'][0]['entity'] == 'worker-0'
        records['worker-0'] = {'stage': 'idle', 'ts': time.perf_counter(),
                               'items': 1, 'pid': 0}
        _wait_for(lambda: watchdog.last_verdict['state'] == 'healthy',
                  what='recovery')
        records['worker-0'] = {'stage': 'io', 'ts': time.perf_counter() - 99,
                               'items': 1, 'pid': 0}
        _wait_for(lambda: len(stalls) == 2, what='the re-armed stall')
    finally:
        watchdog.stop()
    assert watchdog._thread is None
    watchdog.stop()                                  # idempotent


def test_watchdog_interval_and_validation_as_jax():
    for stall in (0.01, 0.4, 2.0, 30.0, 120.0):
        got = thealth.PipelineWatchdog(dict, stall_after_s=stall)
        ref = jhealth.PipelineWatchdog(dict, stall_after_s=stall)
        assert got._interval == ref._interval
        assert got.stall_after_s == stall
    for module in PACKAGES.values():
        with pytest.raises(ValueError, match='stall_after_s must be '
                                             'positive'):
            module.PipelineWatchdog(dict, stall_after_s=0)


def test_on_demand_evaluate_leaves_the_progress_baseline():
    """Only the watchdog's tick advances ``items_out_delta``'s baseline; a
    probe's evaluation reports the delta since the last tick."""
    deltas = {}
    for name, module in PACKAGES.items():
        snap = {'items_out': 0}
        watchdog = module.PipelineWatchdog(dict, lambda: dict(snap),
                                           stall_after_s=1.0)
        out = []
        for items, tick in ((3, False), (5, False), (6, True), (9, False),
                            (9, True), (10, False)):
            snap['items_out'] = items
            verdict = watchdog.evaluate(_advance_progress_window=tick)
            out.append((verdict['items_out'], verdict['items_out_delta']))
        deltas[name] = out
    assert deltas['torch'] == deltas['jax']
    assert deltas['torch'] == [(3, 3), (5, 5), (6, 6), (9, 3), (9, 3),
                               (10, 1)]


# -- the debug endpoint -------------------------------------------------------

ROUTES = ('/healthz', '/slo', '/metrics', '/diagnostics', '/coverage',
          '/profile', '/autotune', '/observe/snapshot', '/podmetrics',
          '/goodput', '/stacks', '/nope', '/healthz/', '/metrics?x=1')


def _wired(flag):
    # every source but the pod routes', which stay unwired in both
    # packages (tests/test_torch_podobs.py wires them)
    fn = (lambda: {'ok': True}) if flag else None
    return dict(coverage_fn=fn, slo_fn=fn, goodput_fn=fn, profile_fn=fn,
                autotune_fn=fn)


@pytest.mark.timeout(60)
@pytest.mark.parametrize('wired', [False, True])
def test_route_statuses_as_jax(wired):
    statuses, bodies = {}, {}
    for name, module in PACKAGES.items():
        server = module.DebugServer(lambda: {'state': 'healthy'},
                                    lambda: {'items_out': 3},
                                    lambda: {}, port=0, **_wired(wired))
        server.start()
        try:
            got = {r: _get(server.port, r) for r in ROUTES}
        finally:
            server.stop()
            server.stop()                            # idempotent
        statuses[name] = {r: s for r, (s, _) in got.items()}
        bodies[name] = {r: b for r, (s, b) in got.items()
                        if s == 404 or r == '/metrics'}
    assert statuses['torch'] == statuses['jax']
    assert bodies['torch'] == bodies['jax']
    assert 'petastorm_tpu_items_out 3' in bodies['torch']['/metrics']
    assert statuses['torch']['/coverage'] == (200 if wired else 404)
    assert all(statuses['torch'][r] == 404 for r in thealth.UNWIRED_ROUTES)
    assert statuses['torch']['/nope'] == 404


@pytest.mark.timeout(60)
def test_healthz_flips_and_fail_healthz_as_jax():
    for module in PACKAGES.values():
        state = {'state': 'healthy'}
        slo = {'fail_healthz': False, 'hard_breach': False}
        server = module.DebugServer(lambda: dict(state), port=0,
                                    slo_fn=lambda: dict(slo))
        server.start()
        try:
            seen = []
            for s in ('healthy', 'stalled', 'degraded'):
                state['state'] = s
                seen.append(_get(server.port, '/healthz')[0])
            assert seen == [200, 503, 200]
            slo['hard_breach'] = True
            assert _get(server.port, '/healthz')[0] == 200
            slo['fail_healthz'] = True
            status, body = _get(server.port, '/healthz')
            assert status == 503 and json.loads(body)['slo']['hard_breach']
        finally:
            server.stop()


# -- readers of both packages on one store ----------------------------------

def _factory(name):
    return (petastorm_tpu if name == 'jax' else petastorm_tpu_torch)


def _beats(reader):
    return reader.health.heartbeats()


@pytest.mark.timeout(120)
def test_dummy_pool_entities_and_stages_as_jax(store, monkeypatch):
    monkeypatch.delenv('PETASTORM_TPU_HEALTH', raising=False)
    got = {}
    for name in PACKAGES:
        with _factory(name).make_reader(store, reader_pool_type='dummy',
                                        seed=0, num_epochs=1) as reader:
            first = next(reader)
            mid = _beats(reader)['worker-0']
            rows = 1 + sum(1 for _ in reader)
            end = _beats(reader)
        got[name] = ((mid['stage'], mid['items']),
                     {k: (v['stage'], v['items'], v['pid'])
                      for k, v in end.items()}, rows, int(first.step) >= 0)
    assert got['torch'] == got['jax']
    assert got['torch'][1] == {
        'ventilator': ('done', 0, os.getpid()),
        'worker-0': ('idle', ROWS // GROUP, os.getpid())}


@pytest.mark.timeout(120)
def test_thread_pool_entities_as_jax(store):
    """One worker with readahead: the ventilator, the worker and its
    readahead thread beat in both packages; after the pass every stage is
    idle-class (the port's worker thread ends with its pass: ``stopped``
    where JAX's waits ``idle``)."""
    got = {}
    for name in PACKAGES:
        with _factory(name).make_reader(store, workers_count=1, seed=0,
                                        io_readahead=1) as reader:
            rows = sum(1 for _ in reader)
            beats = _beats(reader)
        got[name] = beats
        assert rows == ROWS
        assert all(v['stage'] in thealth.IDLE_STAGES for v in beats.values())
        assert beats['ventilator']['stage'] == 'done'
        assert beats['worker-0']['items'] == ROWS // GROUP
    assert set(got['torch']) == set(got['jax']) == {
        'ventilator', 'worker-0', 'readahead-0'}
    assert (got['torch']['readahead-0']['stage']
            == got['jax']['readahead-0']['stage'])


@pytest.mark.timeout(120)
def test_kill_switch_as_jax(store, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_HEALTH', '0')
    for name in PACKAGES:
        for pool in ('dummy', 'thread'):
            with _factory(name).make_reader(store, reader_pool_type=pool,
                                            workers_count=2) as reader:
                assert sum(1 for _ in reader) == ROWS
                assert not reader.health.enabled
                assert _beats(reader) == {}


def _wedge(name, url, gate_module, pool, kind, tmp_path, stall):
    """A reader (rows, or NGram windows as the LM line reads them) whose
    transform blocks the store's third row group until a gate file
    appears: what the watchdog, the flight recorder and
    ``infeed_diagnosis`` say, and that the pass then completes."""
    gate = str(tmp_path / ('gate-' + name + '-' + pool))
    out_dir = tmp_path / ('flight-' + name + '-' + pool)
    out_dir.mkdir()
    spec_cls = JTransformSpec if name == 'jax' else TransformSpec
    diagnosis = (jax_utils if name == 'jax' else torch_utils).infeed_diagnosis
    kw = {}
    if kind == 'ngram':
        ngram_cls = JNGram if name == 'jax' else NGram
        kw['schema_fields'] = ngram_cls({0: ['step', 'tokens'],
                                         1: ['tokens']}, 1, 'step')
    reader = _factory(name).make_reader(
        url, reader_pool_type=pool, workers_count=2, seed=0,
        transform_spec=spec_cls(gate_module.FileGate(gate, *GATED)),
        stall_timeout=stall, flight_record_dir=str(out_dir), **kw)
    rows = []

    def consume():
        for row in reader:
            rows.append(int(row[0].step if kind == 'ngram' else row.step))

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    try:
        verdict = _wait_for(
            lambda: (reader.watchdog.last_verdict
                     if reader.watchdog.last_verdict is not None
                     and reader.watchdog.last_verdict['state'] == 'stalled'
                     else None), what='%s %s stall' % (name, pool))
        files = _wait_for(lambda: os.listdir(str(out_dir)),
                          what='the flight record')
        diag = diagnosis(reader.diagnostics,
                         heartbeats=reader.health.heartbeats(),
                         stall_after_s=stall)
        time.sleep(3 * stall / 4)            # a few more ticks: no 2nd dump
        files = os.listdir(str(out_dir))
        with open(str(out_dir / files[0])) as f:
            record = json.load(f)
    finally:
        with open(gate, 'w') as f:
            f.write('open')
    consumer.join(60)
    assert not consumer.is_alive()
    _wait_for(lambda: reader.watchdog.evaluate()['state'] == 'healthy',
              what='recovery')
    reader.stop()
    reader.join()
    [stalled] = verdict['stalled_entities']
    stacks = '\n'.join(record['stacks'].values())
    return {'entity': stalled['entity'].split('-')[0],
            'stage': stalled['stage'], 'files': len(files),
            'record_entity': record['heartbeats'][stalled['entity']]['stage'],
            'bottleneck': diag['bottleneck'],
            'pipeline_state': diag['pipeline_state'],
            'gate_in_stack': ('health_gate_module' in stacks
                              or pool == 'process'),
            'rows': sorted(rows), 'pid': record['heartbeats'][
                stalled['entity']]['pid'] != os.getpid()}


@pytest.mark.timeout(180)
@pytest.mark.parametrize('pool,kind', [('thread', 'rows'),
                                       ('thread', 'ngram'),
                                       ('process', 'rows')])
def test_wedged_worker_as_jax(store, gate_module, tmp_path, pool, kind):
    pytest.importorskip('zmq')
    stall = 0.6 if pool == 'thread' else 1.0
    got = {name: _wedge(name, store, gate_module, pool, kind, tmp_path,
                        stall)
           for name in PACKAGES}
    assert got['torch'] == got['jax']
    assert got['torch']['stage'] == 'decode'
    assert got['torch']['entity'] == 'worker'
    assert got['torch']['files'] == 1
    assert got['torch']['bottleneck'] == 'stalled'
    assert got['torch']['gate_in_stack']
    # a window of 2 never spans two row groups: 7 windows a group
    starts = [s for s in range(ROWS)
              if kind == 'rows' or s % GROUP != GROUP - 1]
    assert got['torch']['rows'] == starts
    assert got['torch']['pid'] == (pool == 'process')


@pytest.mark.timeout(120)
def test_taken_debug_port_warns_as_jax(store, caplog):
    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    sock.listen(1)
    port = sock.getsockname()[1]
    try:
        for name in PACKAGES:
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                with _factory(name).make_reader(
                        store, reader_pool_type='dummy',
                        debug_port=port) as reader:
                    assert reader.debug_port is None
                    assert reader.watchdog is not None
                    assert sum(1 for _ in reader) == ROWS
            assert any('could not bind 127.0.0.1:%d' % port in r.getMessage()
                       for r in caplog.records), name
    finally:
        sock.close()


def test_negative_stall_timeout_raises_as_jax(store):
    for name in PACKAGES:
        with pytest.raises(ValueError, match='stall_timeout must be >= 0'):
            _factory(name).make_reader(store, stall_timeout=-1)


@pytest.mark.timeout(120)
def test_reader_routes_as_jax(store, monkeypatch):
    """Under the same wiring (the profiler and the pod plane off in both
    packages) a reader's routes answer alike; ``/metrics`` holds
    ``items_out`` and ``/coverage`` a complete epoch."""
    monkeypatch.setenv('PETASTORM_TPU_PROFILER', '0')
    monkeypatch.setenv('PETASTORM_TPU_PODOBS', '0')
    got = {}
    for name in PACKAGES:
        with _factory(name).make_reader(
                store, reader_pool_type='dummy', debug_port=0,
                slo={'p99_e2e_ms': 10000.0}) as reader:
            assert sum(1 for _ in reader) == ROWS
            replies = {r: _get(reader.debug_port, r) for r in ROUTES}
        got[name] = {r: s for r, (s, _) in replies.items()}
        metrics = replies['/metrics'][1]
        assert 'petastorm_tpu_items_out %d' % (ROWS // GROUP) in metrics
        coverage = json.loads(replies['/coverage'][1])
        assert coverage['complete'] and len(coverage['epochs']) == 1
        assert json.loads(replies['/goodput'][1]) == {'enabled': True,
                                                      'attached': False}
        blob = json.loads(replies['/diagnostics'][1])
        assert set(blob) == {'verdict', 'stats', 'heartbeats', 'coverage',
                             'slo', 'goodput'}
    assert got['torch'] == got['jax']
    assert got['torch']['/healthz'] == 200


# -- the staging thread ------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.stages = []

    def beat(self, entity, stage, items=None):
        assert entity == 'loader-prefetch'
        self.stages.append(stage)


def _batches(n):
    return ({'x': np.full((2, 3), i, np.float32)} for i in range(n))


def _staged(name, size, n, slow):
    recorder = _Recorder()
    if name == 'jax':
        it = jax_utils.prefetch_to_device(_batches(n), size,
                                          health=recorder)
    else:
        it = torch_utils.prefetch_to_device(_batches(n), size, device='cpu',
                                            health=recorder)
    values = []
    for batch in it:
        if slow:
            time.sleep(0.05)
        values.append(float(np.asarray(batch['x'])[0, 0]))
    assert values == list(range(n))
    return recorder.stages


@pytest.mark.timeout(60)
def test_loader_prefetch_stage_sequence_as_jax():
    n = 5
    got, ref = _staged('torch', n + 1, n, False), _staged('jax', n + 1, n,
                                                          False)
    assert got == ref == ['staging', 'idle'] * n + ['done']
    # a slow consumer fills a ring of one: both beat backpressured; the port
    # waits for the slot before it stages, JAX after, so the orders differ
    got, ref = _staged('torch', 1, n, True), _staged('jax', 1, n, True)
    assert 'backpressured' in got and 'backpressured' in ref
    drop = [s for s in got if s != 'backpressured']
    assert drop == [s for s in ref if s != 'backpressured']


@pytest.mark.timeout(120)
def test_loader_health_and_goodput_registration(store):
    """A loader's ``health`` is its reader's, its goodput monitor is
    registered with the reader, and ``iter_prefetched`` beats the staging
    thread into the reader's monitor."""
    with petastorm_tpu_torch.make_reader(store, reader_pool_type='dummy',
                                         debug_port=0) as reader:
        loader = petastorm_tpu_torch.TorchDataLoader(reader, batch_size=8,
                                                     device='cpu')
        assert loader.health is reader.health
        assert reader._goodput is loader.goodput
        n = sum(1 for _ in loader.iter_prefetched())
        assert n == ROWS // 8
        beats = reader.health.heartbeats()
        assert beats['loader-prefetch']['stage'] == 'done'
        goodput = json.loads(_get(reader.debug_port, '/goodput')[1])
        assert goodput['steps'] == n


@pytest.mark.cuda
def test_watched_batches_stage_to_the_card(store):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the loader stages to the card')
    with petastorm_tpu_torch.make_reader(store, workers_count=2,
                                         stall_timeout=5.0,
                                         debug_port=0) as reader:
        loader = petastorm_tpu_torch.TorchDataLoader(reader, batch_size=8)
        stages = []
        for batch in loader.iter_prefetched():
            assert batch['tokens'].is_cuda
            stages.append(reader.health.heartbeats()['loader-prefetch'][
                'stage'])
            assert _get(reader.debug_port, '/healthz')[0] == 200
        assert len(stages) == ROWS // 8
        assert reader.health.heartbeats()['loader-prefetch']['stage'] == \
            'done'
        assert reader.watchdog.evaluate()['state'] == 'healthy'
