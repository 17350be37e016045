"""The shared cache's pod tier on the port, against the JAX package's.

JAX's four peer-cache cases (``tests/test_objectstore.py::TestPeerCache``)
on the port's caches; a JAX cache serving a port cache and the reverse
(one segment format: dicts of arrays and arrow tables); the dead-peer
cooldown, the hedged pod fill's once-gate, the server's 400 and 404
answers and its thread stopped by ``close``; equal counters and
``peer_fetch`` observations for one call sequence in both packages; the
peer options surviving a pickle; and three readers, each over its own root
with the other two as peers, whose roots' counters sum to one fill per row
group and two peer hits per row group, as JAX's do. Every test here
serves HTTP on 127.0.0.1 and carries a ``timeout`` mark.
"""

import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu
from petastorm_tpu import sharedcache as jshared

import petastorm_tpu_torch
from petastorm_tpu_torch import materialize_dataset
from petastorm_tpu_torch import sharedcache as tshared
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

SHARED = {'jax': jshared, 'torch': tshared}
pytestmark = pytest.mark.timeout(120)


def _mk(tmp_path, name, pkg='torch', **kwargs):
    return SHARED[pkg].SharedRowGroupCache(
        str(tmp_path / name), 1 << 24, mem_dir=str(tmp_path / (name + '_mem')),
        **kwargs)


def _payload(i):
    return {'a': np.full(1000, i, dtype=np.int64)}


def _never_fill():
    raise AssertionError('a peer hit must not decode locally')


# -- JAX's four cases on the port -------------------------------------------

def test_peer_fetch_skips_the_local_fill(tmp_path):
    served = _mk(tmp_path, 'host_a')
    try:
        value = served.get('rg0', lambda: _payload(7))
        np.testing.assert_array_equal(value['a'], _payload(7)['a'])
        port = served.serve_peers()
        assert served.serve_peers() == port, 'serve_peers is idempotent'
        fetcher = _mk(tmp_path, 'host_b', peers=['127.0.0.1:{}'.format(port)])
        try:
            got = fetcher.get('rg0', _never_fill)
            np.testing.assert_array_equal(got['a'], _payload(7)['a'])
            counters = fetcher.counters()
            assert counters['peer_hits'] == 1
            assert counters['fills'] == 0
            assert counters['peer_bytes'] > 0
            # republished locally: the next read attaches, no pod request
            fetcher.get('rg0', _never_fill)
            assert fetcher.counters()['peer_hits'] == 1
        finally:
            fetcher.close()
    finally:
        served.close()


def test_peer_404_is_an_honest_miss(tmp_path):
    served = _mk(tmp_path, 'host_a')
    try:
        port = served.serve_peers()
        fetcher = _mk(tmp_path, 'host_b', peers=['127.0.0.1:{}'.format(port)])
        try:
            got = fetcher.get('missing', lambda: _payload(3))
            np.testing.assert_array_equal(got['a'], _payload(3)['a'])
            counters = fetcher.counters()
            assert counters['peer_misses'] == 1
            assert counters['peer_errors'] == 0
            assert counters['fills'] == 1
        finally:
            fetcher.close()
    finally:
        served.close()


def test_dead_peer_degrades_to_local_fill(tmp_path):
    fetcher = _mk(tmp_path, 'host_b', peer_timeout_s=0.5,
                  peers=['127.0.0.1:9'])    # nothing listens there
    try:
        got = fetcher.get('rg0', lambda: _payload(5))
        np.testing.assert_array_equal(got['a'], _payload(5)['a'])
        counters = fetcher.counters()
        assert counters['peer_errors'] == 1
        assert counters['fills'] == 1
        # inside the cooldown the dead peer is skipped without a request
        fetcher.get('rg1', lambda: _payload(6))
        counters = fetcher.counters()
        assert counters['peer_errors'] == 1
        assert counters['peer_skipped_dead'] == 1
        assert counters['fills'] == 2
    finally:
        fetcher.close()


def test_global_counters_sum_the_pod_certificate(tmp_path):
    served = _mk(tmp_path, 'host_a')
    fetcher = None
    try:
        served.get('rg0', lambda: _payload(1))
        port = served.serve_peers()
        fetcher = _mk(tmp_path, 'host_b', peers=['127.0.0.1:{}'.format(port)])
        fetcher.get('rg0', lambda: _payload(1))
    finally:
        if fetcher is not None:
            fetcher.close()
        served.close()
    pod = {}
    for name in ('host_a', 'host_b'):
        for key, n in tshared.SharedRowGroupCache.global_counters(
                str(tmp_path / name)).items():
            pod[key] = pod.get(key, 0) + n
    assert pod['fills'] == 1, 'one decode pod-wide'
    assert pod['peer_hits'] == 1


# -- across packages -----------------------------------------------------------

def _table(i):
    return pa.table({'x': np.arange(50, dtype=np.int32) + i,
                     's': ['v{}'.format(k + i) for k in range(50)]})


@pytest.mark.parametrize('server,client', [('jax', 'torch'),
                                           ('torch', 'jax')])
def test_packages_serve_each_other(tmp_path, server, client):
    served = _mk(tmp_path, 'host_a', server)
    fetcher = None
    try:
        served.get('rg-dict', lambda: _payload(9))
        served.get('rg-table', lambda: _table(4))
        port = served.serve_peers()
        fetcher = _mk(tmp_path, 'host_b', client,
                      peers=['127.0.0.1:{}'.format(port)])
        got = fetcher.get('rg-dict', _never_fill)
        np.testing.assert_array_equal(got['a'], _payload(9)['a'])
        assert not got['a'].flags.writeable        # a view of the segment
        table = fetcher.get('rg-table', _never_fill)
        assert table.equals(_table(4))
        missed = fetcher.get('rg-none', lambda: _payload(2))
        np.testing.assert_array_equal(missed['a'], _payload(2)['a'])
        counters = fetcher.counters()
        assert (counters['peer_hits'], counters['peer_misses'],
                counters['fills']) == (2, 1, 1)
        # the republished bytes are the server's, byte for byte
        digest = fetcher._digest('rg-dict')
        assert fetcher.segment_bytes(digest) == served.segment_bytes(digest)
    finally:
        if fetcher is not None:
            fetcher.close()
        served.close()


def _sequence(tmp_path, pkg):
    """One call sequence: a served root, a fetcher with a dead peer first
    and the live one second; its counters and observations."""
    root = tmp_path / pkg
    root.mkdir()
    served = _mk(root, 'host_a', pkg)
    try:
        for i in range(3):
            served.get('rg{}'.format(i), lambda i=i: _payload(i))
        port = served.serve_peers()
        fetcher = _mk(root, 'host_b', pkg, peer_timeout_s=0.5,
                      peers=['127.0.0.1:9', '127.0.0.1:{}'.format(port)])
        try:
            for key in ('rg0', 'rg1', 'rg9', 'rg2', 'rg0'):
                fetcher.get(key, lambda: _payload(99))
            events = fetcher.take_events()
            spans = fetcher.take_spans()
            latency = fetcher.take_latency()
            counters = fetcher.counters()
        finally:
            fetcher.close()
    finally:
        served.close()
    return (counters, {k: v for k, v in events.items() if v},
            [(s[0], s[1], s[4]['outcome']) for s in spans],
            latency['peer_fetch']['count'])


def test_counters_and_observations_as_jax(tmp_path):
    got, want = _sequence(tmp_path, 'torch'), _sequence(tmp_path, 'jax')
    got_counters = {k: v for k, v in got[0].items() if k != 'peer_bytes'}
    want_counters = {k: v for k, v in want[0].items() if k != 'peer_bytes'}
    assert got_counters == want_counters
    assert got[1:] == want[1:]
    assert got[0]['peer_hits'] == 3 and got[0]['peer_skipped_dead'] == 3
    assert got[0]['peer_bytes'] == want[0]['peer_bytes']


def test_hedged_pod_fill_fills_once(tmp_path):
    """A peer that never answers in time: the local fill starts after
    ``peer_hedge_s`` and wins; the once-gate keeps it to one fill."""
    stall = threading.Event()

    def slow_segment(self, digest):
        stall.wait(1.0)
        return None
    served = _mk(tmp_path, 'host_a')
    fills = []
    try:
        port = served.serve_peers()
        served.segment_bytes = slow_segment.__get__(served)
        fetcher = _mk(tmp_path, 'host_b', peer_hedge_s=0.05,
                      peer_timeout_s=5.0,
                      peers=['127.0.0.1:{}'.format(port)])
        try:
            got = fetcher.get('rg0', lambda: fills.append(1) or _payload(8))
            np.testing.assert_array_equal(got['a'], _payload(8)['a'])
            stall.set()
        finally:
            fetcher.close()
        counters = fetcher.counters()
        assert fills == [1] and counters['fills'] == 1
        assert counters['peer_hedges'] == 1
    finally:
        stall.set()
        served.close()


def _get(port, route):
    try:
        with urllib.request.urlopen('http://127.0.0.1:{}{}'.format(
                port, route), timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_answers_and_stops(tmp_path):
    cache = _mk(tmp_path, 'host_a')
    cache.get('rg0', lambda: _payload(1))
    port = cache.serve_peers()
    digest = cache._digest('rg0')
    status, body = _get(port, '/peercache/' + digest)
    assert status == 200 and body == cache.segment_bytes(digest)
    assert _get(port, '/peercache/' + 'f' * 32)[0] == 404
    assert _get(port, '/peercache/../../etc/passwd')[0] == 400
    assert _get(port, '/peercache/ABC')[0] == 400
    assert _get(port, '/other')[0] == 404
    cache.close()
    assert not [t for t in threading.enumerate()
                if t.name == 'petastorm-torch-peercache-http' and t.is_alive()]
    with pytest.raises(OSError):
        urllib.request.urlopen('http://127.0.0.1:{}/peercache/{}'.format(
            port, digest), timeout=2)


def test_peer_options_survive_a_pickle(tmp_path):
    cache = _mk(tmp_path, 'host_a', peers=['127.0.0.1:1', '127.0.0.1:2'],
                peer_timeout_s=0.25, peer_hedge_s=0.5,
                peer_dead_cooldown_s=3.0)
    try:
        copy = pickle.loads(pickle.dumps(cache))
        assert copy.__getstate__() == cache.__getstate__()
        assert set(cache.__getstate__()) == set(
            _mk(tmp_path, 'host_j', 'jax').__getstate__())
        copy.close()
    finally:
        cache.close()


# -- readers on a pod of three roots ----------------------------------------

GROUPS = 6


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('pod') / 'ds')
    schema = Unischema('Pod', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (32,), NdarrayCodec(), False)])
    with materialize_dataset(url, schema, rows_per_file=10) as w:
        w.write_rows({'idx': np.int64(i),
                      'vec': np.full(32, i, np.float32)}
                     for i in range(GROUPS * 10))
    return url


def _pod_pass(pkg, url, tmp_path):
    mod = petastorm_tpu_torch if pkg == 'torch' else petastorm_tpu
    roots = [tmp_path / pkg / 'host{}'.format(i) for i in range(3)]
    caches = [_mk(r.parent, r.name, pkg) for r in roots]
    ports = [c.serve_peers() for c in caches]
    rows = []

    def read(i):
        peers = ['127.0.0.1:{}'.format(p) for j, p in enumerate(ports)
                 if j != i]
        with getattr(mod, 'make_columnar_reader')(
                url, workers_count=2, cache_type='shared',
                cache_location=str(roots[i]), cache_size_limit=1 << 26,
                cache_extra_settings={'mem_dir': str(roots[i]) + '_mem',
                                      'peers': peers}) as reader:
            rows.append(sorted(int(x) for b in reader for x in b.idx))
    try:
        read(0)                                   # the cold host
        threads = [threading.Thread(target=read, args=(i,)) for i in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        for c in caches:
            c.close()
    totals = {}
    for root in roots:
        for k, n in SHARED[pkg].SharedRowGroupCache.global_counters(
                str(root)).items():
            totals[k] = totals.get(k, 0) + n
    return rows, totals


def test_pod_of_readers_decodes_once_as_jax(store, tmp_path):
    rows, totals = _pod_pass('torch', store, tmp_path)
    jrows, jtotals = _pod_pass('jax', store, tmp_path)
    assert rows == jrows and len(rows) == 3
    assert all(r == list(range(GROUPS * 10)) for r in rows)
    assert totals['fills'] == jtotals['fills'] == GROUPS
    assert totals['peer_hits'] == jtotals['peer_hits'] == 2 * GROUPS
    assert totals['peer_errors'] == jtotals['peer_errors'] == 0
