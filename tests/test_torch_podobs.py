"""The port's pod observability plane against the JAX package's.

Units, each on the same seeded inputs in both packages and compared
exactly: the constants, the switch and peer parsing; ``merge_counters``,
``merge_histogram_states``, ``state_percentiles``, ``merge_health``,
``check_pod_certificate`` (with and without elastic totals),
``check_pod_goodput`` and ``PodObserver.merge`` over simulated hosts, a
dead one included (``partial_pod``); ``make_observe_fn``; the stitched
pod trace. Over HTTP on 127.0.0.1: the port's ``DebugServer`` routes and
their headers, each package's observer polling the other's hosts, both
packages' readers serving ``/observe/snapshot`` and ``/podmetrics`` with
the same keys, the trace id riding a real peer fetch (port to port and
JAX to port), ``io_attempt`` spans under ``transient-errors`` equal to
JAX's, the ``podstat`` command's report and exit codes, and the kill
switch. Last, phase 23 (b) of ``chip_smoke.py`` on the CPU at a small
size. Tests that serve HTTP carry a ``timeout`` mark.
"""

import argparse
import copy
import io
import json
import threading
from contextlib import redirect_stdout
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

import petastorm_tpu
from petastorm_tpu import faultfs as jfaultfs
from petastorm_tpu import health as jhealth
from petastorm_tpu import latency as jlatency
from petastorm_tpu import podobs as jpodobs
from petastorm_tpu import sharedcache as jshared
from petastorm_tpu import tracing as jtracing

import petastorm_tpu_torch
from petastorm_tpu_torch import faultfs as tfaultfs
from petastorm_tpu_torch import health as thealth
from petastorm_tpu_torch import latency as tlatency
from petastorm_tpu_torch import materialize_dataset
from petastorm_tpu_torch import podobs as tpodobs
from petastorm_tpu_torch import sharedcache as tshared
from petastorm_tpu_torch import tracing as ttracing
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

PODOBS = {'jax': jpodobs, 'torch': tpodobs}
HEALTH = {'jax': jhealth, 'torch': thealth}
SHARED = {'jax': jshared, 'torch': tshared}
FACTORY = {'jax': petastorm_tpu, 'torch': petastorm_tpu_torch}
STAGES = ('io_range', 'peer_fetch', 'decode')


def _http_get(port, route, headers=None):
    conn = HTTPConnection('127.0.0.1', port, timeout=10)
    try:
        conn.request('GET', route, headers=headers or {})
        response = conn.getresponse()
        return (response.status, response.read().decode('utf-8'),
                dict(response.getheaders()))
    finally:
        conn.close()


def _states(rng, scale):
    """Per-stage histogram states of lognormal samples (JAX's recorder)."""
    out = {}
    for stage in STAGES:
        histogram = jlatency.LatencyHistogram()
        for seconds in rng.lognormal(-6.0, 2.0, int(rng.integers(1, 300))):
            histogram.record(float(seconds) * scale)
        out[stage] = histogram.state()
    return out


def _snapshots(seed, hosts=3):
    """Simulated hosts' ``/observe/snapshot`` payloads, as polled."""
    rng = np.random.default_rng(seed)
    states = ('healthy', 'degraded', 'starving', 'stalled', 'weird')
    snaps = []
    for i in range(hosts):
        total = float(rng.uniform(1.0, 10.0))
        snaps.append({
            '_peer': '10.0.0.{}:8000'.format(i), 'host': 'host{}'.format(i),
            'pid': 100 + i, '_rtt_s': float(rng.uniform(0, 0.01)),
            '_clock_offset_s': float(rng.normal(0, 0.5)),
            'health': {'state': str(rng.choice(states)), 'hint': 'h%d' % i,
                       'degraded_causes': ['cause-%d' % j for j in range(
                           int(rng.integers(0, 3)))]},
            'stats': {'items_out': int(rng.integers(0, 100)),
                      'rows_out': int(rng.integers(0, 1000)),
                      'window_s': 5.0, 'io_range_p99_s': 0.1,
                      'decode_fraction': 0.5, 'io_overlap_fraction': 0.2,
                      'epoch': 1, '_private': 3, 'flag': True,
                      'binding_stage': 'decode',
                      'read_s': float(rng.uniform(0, 2))},
            'latency_histograms': _states(rng, i + 1),
            'cache': {'fills': int(rng.integers(0, 5)),
                      'peer_hits': int(rng.integers(0, 9)),
                      'peer_misses': int(rng.integers(0, 3)),
                      'peer_errors': int(rng.integers(0, 2))},
            'elastic': {'batches_delivered': int(rng.integers(0, 20)),
                        'batches_skipped_claimed': int(rng.integers(0, 2)),
                        'leases_rebalanced': int(rng.integers(0, 3)),
                        'rows_resumed': int(rng.integers(0, 64)),
                        'expected_batches': 40, 'epoch': 0,
                        'held_leases': 2},
            'goodput': {'state': {'steps': int(rng.integers(1, 50)),
                                  'fenced_steps': 3, 'total_s': total,
                                  'stall_s': total * float(rng.uniform(0, .3)),
                                  'h2d_s': total * 0.1,
                                  'device_s': total * 0.5,
                                  'host_s': total * 0.1}},
            'slo': {'burn_rate': float(rng.uniform(0, 3)),
                    'hard_breach': bool(rng.integers(0, 2))},
            'coverage': {'complete': bool(rng.integers(0, 2))},
            'span_tail': [{'name': 'decode', 'cat': 'worker',
                           'ts': float(rng.uniform(0, 1e6)), 'dur': 10.0,
                           'pid': 100 + i, 'tid': 7, 'args': None}],
        })
    return snaps


def _both(fn, *args, **kwargs):
    """``fn(module, *args, **kwargs)`` on each package with deep copies."""
    return {name: fn(module, *copy.deepcopy(args), **copy.deepcopy(kwargs))
            for name, module in PODOBS.items()}


# -- constants, the switch, peers --------------------------------------------

def test_constants_as_jax():
    for name in ('PODOBS_ENV_VAR', 'PODOBS_PEERS_ENV_VAR', 'TRACE_HEADER',
                 'CLOCK_HEADER', 'SNAPSHOT_ROUTE', 'PODMETRICS_ROUTE',
                 'PARTIAL_POD', 'VERDICT_ORDER', '_NON_ADDITIVE_KEYS',
                 '_NON_ADDITIVE_SUFFIXES', 'DEFAULT_TIMEOUT_S'):
        assert getattr(tpodobs, name) == getattr(jpodobs, name), name
    assert tpodobs.VERDICT_ORDER == (thealth.HEALTHY, thealth.DEGRADED,
                                     thealth.STARVING, thealth.STALLED)
    assert set(thealth.UNWIRED_ROUTES) == {tpodobs.SNAPSHOT_ROUTE,
                                           tpodobs.PODMETRICS_ROUTE}
    # one switch: the latency plane keeps no copy of it
    assert not hasattr(tlatency, 'pod_observations_enabled')
    assert not hasattr(tlatency, 'PODOBS_ENV_VAR')


@pytest.mark.parametrize('value', [None, '', '1', 'on', '0', 'false', 'off',
                                   ' OFF ', 'no'])
def test_switch_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv('PETASTORM_TPU_PODOBS', raising=False)
    else:
        monkeypatch.setenv('PETASTORM_TPU_PODOBS', value)
    assert tpodobs.podobs_enabled() == jpodobs.podobs_enabled()


@pytest.mark.parametrize('spec', ['a:1, b:2,,', ['h:1', ' g:2 '], None, '',
                                  'just-a-host', ['a:1', 'b']])
def test_parse_peers_as_jax(monkeypatch, spec):
    out = {}
    for name, module in PODOBS.items():
        try:
            out[name] = module.parse_peers(spec)
        except ValueError as e:
            out[name] = str(e)
    assert out['torch'] == out['jax']
    if isinstance(spec, str):
        monkeypatch.setenv('PETASTORM_TPU_PODOBS_PEERS', spec)
        if 'just' not in spec:
            assert (tpodobs.pod_peers_from_env()
                    == jpodobs.pod_peers_from_env())
    assert len(tpodobs.new_trace_id()) == len(jpodobs.new_trace_id()) == 32


# -- merge rules --------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_merges_as_jax(seed):
    snaps = _snapshots(seed)
    for key in ('stats', 'cache', 'elastic'):
        got = _both(lambda m, s: m.merge_counters(s),
                    [x[key] for x in snaps] + [None])
        assert got['torch'] == got['jax']
    got = _both(lambda m, s: m.merge_histogram_states(s),
                [x['latency_histograms'] for x in snaps] + [None, {}])
    assert got['torch'] == got['jax']
    for stage, state in got['torch'].items():
        assert (tpodobs.state_percentiles(state)
                == jpodobs.state_percentiles(state)), stage
    health = {x['_peer']: x['health'] for x in snaps}
    health['dead:1'] = None
    got = _both(lambda m, h: m.merge_health(h), health)
    assert got['torch'] == got['jax']


def test_pod_histogram_equals_direct_recording():
    """Bucket addition of three hosts' port histograms equals one
    histogram that recorded every observation, in any merge order."""
    rng = np.random.default_rng(7)
    samples = [rng.lognormal(-6.0, 2.0, 400) * (i + 1) for i in range(3)]
    direct = tlatency.LatencyHistogram()
    states = []
    for host in samples:
        histogram = tlatency.LatencyHistogram()
        for seconds in host:
            histogram.record(float(seconds))
            direct.record(float(seconds))
        states.append({'x': histogram.state()})
    merged = tpodobs.merge_histogram_states(states)['x']
    reverse = tpodobs.merge_histogram_states(states[::-1])['x']
    assert merged['buckets'] == direct.state()['buckets']
    assert merged['buckets'] == reverse['buckets']
    assert tpodobs.state_percentiles(merged) == direct.percentiles()


@pytest.mark.parametrize('fills,expected,unreachable,delivered,batches', [
    (4, 4, (), None, None), (5, 4, (), None, None), (3, 4, (), None, None),
    (4, 4, ('x:1',), None, None), (0, None, (), None, None),
    (2, None, (), 10, 10), (2, None, (), 11, 10), (2, None, (), 9, 10),
    (4, 4, (), 9, 10), (4, 4, ('y:2', 'x:1'), 10, 10),
    (1, None, (), 3, None)])
def test_pod_certificate_as_jax(fills, expected, unreachable, delivered,
                                batches):
    cache = {'fills': fills, 'peer_hits': 2 * fills, 'peer_misses': 1}
    elastic = (None if delivered is None else
               {'batches_delivered': delivered, 'leases_rebalanced': 2,
                'batches_skipped_claimed': 1, 'rows_resumed': 16})
    got = _both(lambda m: m.check_pod_certificate(
        cache, expected, unreachable=unreachable, elastic_totals=elastic,
        expected_batches=batches))
    assert got['torch'] == got['jax']


@pytest.mark.parametrize('seed,floor,dead', [(0, None, ()), (1, 0.9, ()),
                                             (2, 0.1, ()), (3, 0.5, ('d:1',)),
                                             (4, None, ('d:1',))])
def test_pod_goodput_as_jax(seed, floor, dead):
    snaps = _snapshots(seed)
    by_host = {x['_peer']: x['goodput'] for x in snaps}
    by_host['idle:1'] = {'state': {'total_s': 0.0}}
    by_host['none:1'] = None
    got = _both(lambda m: m.check_pod_goodput(by_host, min_goodput=floor,
                                              unreachable=dead))
    assert got['torch'] == got['jax']


@pytest.mark.parametrize('seed,dead', [(0, False), (1, True), (2, False)])
def test_observer_merge_as_jax(seed, dead):
    snaps = _snapshots(seed)
    unreachable = ([{'peer': '10.0.0.9:8000', 'error': 'URLError: refused'}]
                   if dead else None)
    reports, raised = {}, {}
    for name, module in PODOBS.items():
        observer = module.PodObserver(
            [s['_peer'] for s in snaps] + ['10.0.0.9:8000'],
            expected_row_groups=7, expected_batches=40, min_goodput=0.4,
            trace_id='t' * 32)
        reports[name] = observer.merge(copy.deepcopy(snaps),
                                       copy.deepcopy(unreachable))
        assert observer.last_report is reports[name]
        try:
            observer.assert_certificate(reports[name])
            raised[name] = None
        except AssertionError as e:
            assert isinstance(e, module.PodCertificateError)
            raised[name] = str(e)
    assert reports['torch'] == reports['jax']
    assert raised['torch'] == raised['jax']
    if dead:
        assert reports['torch']['verdict'] == tpodobs.PARTIAL_POD
        assert tpodobs.PARTIAL_POD in raised['torch']


def test_unarmed_certificate_as_jax():
    raised = {}
    for name, module in PODOBS.items():
        observer = module.PodObserver('x:1')
        report = observer.merge([{'host': 'a', 'cache': {'fills': 1}}])
        with pytest.raises(module.PodCertificateError) as info:
            observer.assert_certificate(report)
        raised[name] = str(info.value)
        with pytest.raises(ValueError, match='at least one'):
            module.PodObserver('')
    assert raised['torch'] == raised['jax']
    assert 'unchecked' in raised['torch']


def test_observe_fn_as_jax():
    def broken():
        raise ValueError('sensor down')
    out = {}
    for name, module in PODOBS.items():
        state = jlatency.LatencyHistogram()
        state.record(0.02)
        observe = module.make_observe_fn(
            snapshot_fn=lambda: {'items_out': 5, '_latency_histograms': {
                'io_range': state.state()}},
            health_fn=lambda: {'state': 'healthy'}, slo_fn=broken,
            coverage_fn=lambda: {'complete': True},
            cache_counters_fn=lambda: {'fills': 2},
            span_tail_fn=lambda: [{'name': 'x'}],
            elastic_fn=lambda: {'hosts_died': 1},
            goodput_fn=lambda: {'state': {}}, host='sim')
        snap = observe()
        assert isinstance(snap.pop('clock_s'), float)
        out[name] = snap
        out[name + '-bare'] = module.make_observe_fn(host='bare')()
        out[name + '-bare'].pop('clock_s')
    assert out['torch'] == out['jax']
    assert out['torch-bare'] == out['jax-bare']
    assert out['torch']['slo'] == {'error': 'ValueError: sensor down'}
    assert out['torch']['latency_histograms']['io_range']['count'] == 1


def test_stitched_trace_as_jax(tmp_path):
    tracks = [
        {'host': 'a:1', 'pid': 10, 'clock_offset_s': 0.25, 'spans': [
            {'name': 'decode', 'cat': 'worker', 'ts': 1e6, 'dur': 5.0,
             'pid': 10, 'tid': 3, 'args': {'rows': 4}},
            {'name': 'step', 'cat': 'goodput', 'ts': 2e6, 'dur': 9.0,
             'pid': 10, 'tid': 1, 'args': {'verdict': 'data-stall',
                                           'stall_ms': 12.5}},
            {'name': 'read', 'ts': 3e6, 'dur': -1.0, 'pid': 11}]},
        {'host': 'b:1', 'pid': 10, 'clock_offset_s': None, 'spans': [
            {'name': 'peer_fetch', 'cat': 'io', 'ts': 1.5e6, 'dur': 2.0,
             'pid': 10, 'tid': 4, 'args': {'outcome': 'hit'}}]},
        {'host': 'c:1', 'spans': []}]
    got = {}
    for name, module in (('jax', jtracing), ('torch', ttracing)):
        path = str(tmp_path / (name + '.json'))
        assert module.stitch_pod_trace(copy.deepcopy(tracks), path) == path
        with open(path) as f:
            got[name] = json.load(f)
    assert got['torch'] == got['jax']
    names = [e['args']['name'] for e in got['torch']['traceEvents']
             if e['ph'] == 'M']
    assert len(names) == 3                      # (a, 10), (a, 11), (b, 10)


# -- HTTP --------------------------------------------------------------------

def _host(module_name, snapshot, cache, host, health='healthy'):
    module = PODOBS[module_name]
    observe = module.make_observe_fn(
        snapshot_fn=lambda: copy.deepcopy(snapshot),
        health_fn=lambda: {'state': health},
        cache_counters_fn=lambda: dict(cache),
        span_tail_fn=lambda: [{'name': 'decode', 'ts': 1.0, 'dur': 2.0,
                               'pid': 1, 'tid': 2}], host=host)
    return HEALTH[module_name].DebugServer(
        lambda: {'state': health}, observe_fn=observe).start()


@pytest.mark.timeout(60)
def test_snapshot_route_and_headers():
    histogram = tlatency.LatencyHistogram()
    histogram.record(0.02)
    server = _host('torch', {'items_out': 5, '_latency_histograms': {
        'io_range': histogram.state()}}, {'fills': 2}, 'sim_host')
    try:
        trace_id = tpodobs.new_trace_id()
        status, body, headers = _http_get(server.port, '/observe/snapshot',
                                          {tpodobs.TRACE_HEADER: trace_id})
        assert status == 200
        blob = json.loads(body)
        assert blob['kind'] == 'petastorm_tpu.observe_snapshot'
        assert blob['host'] == 'sim_host' and blob['stats'] == {
            'items_out': 5}
        assert blob['latency_histograms']['io_range']['count'] == 1
        assert blob['cache'] == {'fills': 2}
        float(headers[tpodobs.CLOCK_HEADER])
        assert headers[tpodobs.TRACE_HEADER] == trace_id
        # no trace id sent: none echoed, the clock still stamped
        _, _, headers = _http_get(server.port, '/observe/snapshot')
        assert tpodobs.TRACE_HEADER not in headers
        assert tpodobs.CLOCK_HEADER in headers
        # not an aggregator: JAX's 404 text, no pod headers
        status, body, headers = _http_get(server.port, '/podmetrics',
                                          {tpodobs.TRACE_HEADER: trace_id})
        assert (status, body) == (404, thealth.UNWIRED_ROUTES['/podmetrics'])
        assert tpodobs.CLOCK_HEADER not in headers
    finally:
        server.stop()


@pytest.mark.timeout(120)
def test_observers_poll_each_others_hosts():
    """Two port hosts and one JAX host, polled by each package's observer
    with a dead peer added: equal merges (the volatile round trips
    aside), the dead peer named, and the certificate refused alike."""
    rng = np.random.default_rng(3)
    servers = [
        _host('torch', {'items_out': 10, '_latency_histograms':
                        _states(rng, 1)}, {'fills': 3, 'peer_hits': 0}, 'a'),
        _host('torch', {'items_out': 20, '_latency_histograms':
                        _states(rng, 2)}, {'fills': 1, 'peer_hits': 3}, 'b',
              health='degraded'),
        _host('jax', {'items_out': 5, '_latency_histograms':
                      _states(rng, 3)}, {'fills': 0, 'peer_hits': 4}, 'c')]
    front = None
    try:
        peers = ['127.0.0.1:{}'.format(s.port) for s in servers]
        reports, raised = {}, {}
        for name, module in PODOBS.items():
            observer = module.PodObserver(peers + ['127.0.0.1:9'],
                                          timeout_s=0.5,
                                          expected_row_groups=4,
                                          trace_id='f' * 32)
            report = observer.report()
            with pytest.raises(module.PodCertificateError) as info:
                observer.assert_certificate(report)
            raised[name] = str(info.value)
            assert all(isinstance(h.pop('rtt_s'), float)
                       and abs(h.pop('clock_offset_s')) < 1.0
                       for h in report['hosts'])
            for track in report['trace_tracks']:
                track.pop('clock_offset_s')
            for u in report['unreachable']:
                u.pop('error')
            reports[name] = report
        assert reports['torch'] == reports['jax']
        assert raised['torch'] == raised['jax']
        report = reports['torch']
        assert report['verdict'] == tpodobs.PARTIAL_POD
        assert report['unreachable'] == [{'peer': '127.0.0.1:9'}]
        assert report['counters']['items_out'] == 35
        assert report['cache']['totals'] == {'fills': 4, 'peer_hits': 7}
        assert report['health']['state'] == 'degraded'
        # the aggregate on /podmetrics of a port host, echoing the trace id
        observer = tpodobs.PodObserver(peers, expected_row_groups=4)
        front = thealth.DebugServer(lambda: {'state': 'healthy'},
                                    podmetrics_fn=observer.report).start()
        status, body, headers = _http_get(front.port, '/podmetrics',
                                          {tpodobs.TRACE_HEADER: 'abc'})
        blob = json.loads(body)
        assert status == 200 and headers[tpodobs.TRACE_HEADER] == 'abc'
        assert blob['kind'] == 'petastorm_tpu.podmetrics'
        assert blob['certificate']['ok'] is True
        assert blob['hosts_reporting'] == 3
    finally:
        for server in servers:
            server.stop()
        if front is not None:
            front.stop()


GROUPS = 4
ROWS = GROUPS * 8


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('podobs') / 'ds')
    schema = Unischema('Pod', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (16,), NdarrayCodec(), False)])
    with materialize_dataset(url, schema, rows_per_file=8) as w:
        w.write_rows({'idx': np.int64(i), 'vec': np.full(16, i, np.float32)}
                     for i in range(ROWS))
    return url


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _keys(blob):
    """Top-level keys with the keys of each dict section (a section keyed
    by host, by the count of its hosts)."""
    return {k: (len(v) if k == 'coverage' else sorted(v))
            if isinstance(v, dict) else type(v).__name__
            for k, v in blob.items()}


@pytest.mark.timeout(120)
def test_reader_pod_routes_as_jax(store, monkeypatch):
    """Each package's reader on one store serves ``/observe/snapshot`` and,
    with ``PETASTORM_TPU_PODOBS_PEERS`` naming it, ``/podmetrics``: the
    same keys, the pod headers, and the stats counters of one epoch."""
    monkeypatch.delenv('PETASTORM_TPU_PODOBS', raising=False)
    got = {}
    for name, module in FACTORY.items():
        port = _free_port()
        monkeypatch.setenv('PETASTORM_TPU_PODOBS_PEERS',
                           '127.0.0.1:{}'.format(port))
        with module.make_reader(store, reader_pool_type='dummy',
                                debug_port=port, trace=True) as reader:
            assert sum(1 for _ in reader) == ROWS
            snap = _http_get(port, '/observe/snapshot', {
                tpodobs.TRACE_HEADER: 'r1'})
            pod = _http_get(port, '/podmetrics', {tpodobs.TRACE_HEADER: 'r2'})
        for status, _, headers in (snap, pod):
            assert status == 200
            float(headers[tpodobs.CLOCK_HEADER])
        assert (snap[2][tpodobs.TRACE_HEADER],
                pod[2][tpodobs.TRACE_HEADER]) == ('r1', 'r2')
        snap, pod = json.loads(snap[1]), json.loads(pod[1])
        got[name] = (_keys(snap), sorted(snap['stats']),
                     sorted(snap['latency_histograms']),
                     snap['stats']['items_out'], snap['span_tail'] != [],
                     # the health state is a timing verdict: not compared
                     _keys(pod), pod['verdict'] != tpodobs.PARTIAL_POD,
                     pod['hosts_reporting'], sorted(pod['certificate']))
    assert got['torch'] == got['jax']
    assert got['torch'][3] == GROUPS


@pytest.mark.timeout(120)
def test_trace_id_rides_a_peer_fetch(tmp_path, monkeypatch):
    """A port cache fetching from a port root and a JAX cache fetching from
    the same root: every request the serving side answers is recorded
    under the fetching cache's trace id, and each reply echoes it."""
    monkeypatch.delenv('PETASTORM_TPU_PODOBS', raising=False)
    served = tshared.SharedRowGroupCache(str(tmp_path / 'a'), 1 << 24,
                                         mem_dir=str(tmp_path / 'a_mem'))
    fetchers = []
    try:
        payload = {'a': np.arange(512, dtype=np.int64)}
        for i in range(3):
            served.get('rg{}'.format(i), lambda: payload)
        port = served.serve_peers()
        status, _, headers = _http_get(port, '/peercache/deadbeef',
                                       {tpodobs.TRACE_HEADER: 'probe'})
        assert status == 404 and headers[tpodobs.TRACE_HEADER] == 'probe'
        float(headers[tpodobs.CLOCK_HEADER])
        for name in ('torch', 'jax'):
            fetcher = SHARED[name].SharedRowGroupCache(
                str(tmp_path / name), 1 << 24,
                mem_dir=str(tmp_path / (name + '_mem')),
                peers=['127.0.0.1:{}'.format(port)])
            fetchers.append(fetcher)
            for key in ('rg0', 'rg1', 'rg9'):
                got = fetcher.get(key, lambda: payload)
                np.testing.assert_array_equal(got['a'], payload['a'])
            trace_id = getattr(fetcher, 'trace_id', None) or \
                fetcher._trace_id
            spans = fetcher.take_spans()
            assert [s[4]['outcome'] for s in spans] == ['hit', 'hit', 'miss']
            assert served._peer_server.traces[trace_id] == len(spans)
        assert served._peer_server.traces['probe'] == 1
        assert len(set(served._peer_server.traces)) == 3
    finally:
        for fetcher in fetchers:
            fetcher.close()
        served.close()


def _attempts(name, store):
    module = FACTORY[name]
    with module.make_reader(store, reader_pool_type='dummy', trace=True,
                            hedge=30.0, shuffle_row_groups=False) as reader:
        rows = sorted(int(r.idx) for r in reader)
        spans = [(s[0], s[6].get('attempt'), s[6].get('won'))
                 for s in reader.tracer.spans() if s[0] == 'io_attempt']
        counters = {k: v for k, v in reader.stats.snapshot().items()
                    if k.startswith(('io_retries', 'io_hedge'))}
    return rows, spans, counters


@pytest.mark.timeout(120)
@pytest.mark.parametrize('spec', ['transient-errors:101',
                                  'transient-errors:7:error_rate=0.5', None])
def test_io_attempt_spans_as_jax(store, monkeypatch, spec):
    monkeypatch.delenv('PETASTORM_TPU_PODOBS', raising=False)
    if spec is None:
        monkeypatch.delenv('PETASTORM_TPU_CHAOS', raising=False)
    else:
        monkeypatch.setenv('PETASTORM_TPU_CHAOS', spec)
    got = {}
    for name in FACTORY:
        jfaultfs.reset_chaos_cache()
        tfaultfs.reset_chaos_cache()
        got[name] = _attempts(name, store)
    jfaultfs.reset_chaos_cache()
    tfaultfs.reset_chaos_cache()
    assert got['torch'] == got['jax']
    rows, spans, _ = got['torch']
    assert rows == list(range(ROWS))
    assert len(spans) >= GROUPS and spans[0][0] == 'io_attempt'
    if spec is not None:
        assert got['torch'][2]['io_retries'] >= 1
    # the pod plane off: the same reads, no span
    monkeypatch.setenv('PETASTORM_TPU_PODOBS', '0')
    tfaultfs.reset_chaos_cache()
    rows_off, spans_off, _ = _attempts('torch', store)
    tfaultfs.reset_chaos_cache()
    assert rows_off == rows and spans_off == []


@pytest.mark.timeout(120)
def test_podstat_as_jax(capsys):
    servers = [_host('torch', {'items_out': 3}, {'fills': 2, 'peer_hits': 1},
                     'a'),
               _host('jax', {'items_out': 4}, {'fills': 0, 'peer_hits': 2},
                     'b')]
    peers = ','.join('127.0.0.1:{}'.format(s.port) for s in servers)
    cases = [[peers], [peers, '--expect-row-groups', '2'],
             [peers, '--expect-row-groups', '3', '--compact'],
             [peers + ',127.0.0.1:9', '--timeout', '0.5'],
             [peers, '--min-goodput', '0.5']]
    try:
        for argv in cases:
            out = {}
            for name, module in PODOBS.items():
                stdout = io.StringIO()
                with redirect_stdout(stdout):
                    code = module.main(list(argv))
                report = json.loads(stdout.getvalue())
                out[name] = (code, report['verdict'], report['certificate'],
                             report['counters'], report['goodput'])
            assert out['torch'] == out['jax'], argv
        for name, module in PODOBS.items():
            with pytest.raises(SystemExit) as info:
                module.main([])
            assert info.value.code == 2
    finally:
        for server in servers:
            server.stop()


@pytest.mark.timeout(120)
def test_kill_switch(tmp_path, monkeypatch, store):
    """``PETASTORM_TPU_PODOBS=0``: a reader's pod routes 404 with JAX's
    text, caches carry no trace id and replies no pod header, no span or
    latency of the pod plane, no thread, no file."""
    monkeypatch.setenv('PETASTORM_TPU_PODOBS', '0')
    threads_before = threading.active_count()
    with petastorm_tpu_torch.make_reader(store, reader_pool_type='dummy',
                                         debug_port=0) as reader:
        list(reader)
        for route, text in thealth.UNWIRED_ROUTES.items():
            status, body, headers = _http_get(reader.debug_port, route)
            assert (status, body) == (404, text)
            assert tpodobs.CLOCK_HEADER not in headers
    served = tshared.SharedRowGroupCache(str(tmp_path / 'a'), 1 << 24,
                                         mem_dir=str(tmp_path / 'a_mem'))
    fetcher = None
    try:
        served.get('rg0', lambda: {'a': np.zeros(8, dtype=np.int64)})
        port = served.serve_peers()
        _, _, headers = _http_get(port, '/peercache/deadbeef',
                                  {tpodobs.TRACE_HEADER: 'x'})
        assert tpodobs.TRACE_HEADER not in headers
        assert tpodobs.CLOCK_HEADER not in headers
        fetcher = tshared.SharedRowGroupCache(
            str(tmp_path / 'b'), 1 << 24, mem_dir=str(tmp_path / 'b_mem'),
            peers=['127.0.0.1:{}'.format(port)])
        assert fetcher.trace_id == ''
        fetcher.get('rg0', lambda: pytest.fail('must peer-hit'))
        assert fetcher.take_spans() == [] and fetcher.take_latency() is None
        assert served._peer_server.traces == {}
    finally:
        if fetcher is not None:
            fetcher.close()
        served.close()
    observer = tpodobs.PodObserver(['127.0.0.1:9'], timeout_s=0.2)
    observer.merge([{'host': 'a', 'cache': {'fills': 1}}])
    assert threading.active_count() == threads_before
    assert [p for p in tmp_path.rglob('*')
            if 'podobs' in p.name or p.suffix == '.trace'] == []


def test_public_names():
    assert petastorm_tpu_torch.PodObserver is tpodobs.PodObserver
    assert 'PodObserver' in petastorm_tpu_torch.__all__


# -- phase 23 (b) of chip_smoke.py on the CPU --------------------------------

@pytest.mark.timeout(300)
def test_chip_smoke_pod_obs_line_on_cpu(tmp_path, monkeypatch):
    import chip_smoke
    from petastorm_tpu_torch.ops import kernels
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    monkeypatch.delenv('PETASTORM_TPU_PODOBS', raising=False)
    launches = chip_smoke.pod_obs_line(
        torch, np, kernels, argparse.Namespace(seed=0), device='cpu',
        rows=64, batch=8, size=32)
    assert launches['normalize'] == 0       # the CPU runs K4's twin
