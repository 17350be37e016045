"""The port's readers over the three read planes against the JAX package's,
on the CPU.

One store: 48 rows of ``idx``, an ``NdarrayCodec`` vector and a png image
in 6 files of 2 row groups. The three ``remote_read`` modes x the thread,
process and dummy pools x ``io_readahead`` 0 and 2 give JAX's rows; on the
dummy pool the ``io_range_*`` counters equal JAX's, the ``io_range``
latency holds one observation a range fetch, and a ``prebuffer`` or
``serial`` pass counts no range; ``memory://`` stores read under each mode
on the thread and dummy pools as JAX reads them; the automatic mode is
JAX's (``serial`` on a local protocol, a chaos-wrapped one too, and
``prebuffer`` on a remote one); ``transient-errors`` retried per range and ``read-hangs``
hedged per range give JAX's rows; a same-seed ``trace-replay`` ranged pass
injects what JAX's does, with the same replayed latency; ``storage_options``
reach the workers' filesystem and a typo in ``remote_read`` fails all three
factories with JAX's words. Tests that start interpreters carry a
``timeout`` mark.
"""

import uuid

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu import faultfs as jfaultfs

import petastorm_tpu_torch
from petastorm_tpu_torch import faultfs as tfaultfs
from petastorm_tpu_torch import materialize_dataset
from petastorm_tpu_torch.codecs import (CompressedImageCodec, NdarrayCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS = 48
MODES = ['serial', 'prebuffer', 'ranged']
RANGE_COUNTERS = ('io_range_requests', 'io_range_bytes', 'io_ranged_reads',
                  'io_range_wasted_bytes', 'io_range_fallbacks')

SCHEMA = Unischema('Remote', [
    UnischemaField('idx', np.int64, (), ScalarCodec(), False),
    UnischemaField('vec', np.float32, (6,), NdarrayCodec(), False),
    UnischemaField('image', np.uint8, (8, 6, 3), CompressedImageCodec('png'),
                   False)])


def _write(url):
    rng = np.random.default_rng(5)
    with materialize_dataset(url, SCHEMA, rows_per_file=8,
                             row_group_size_mb=0.0015) as w:
        w.write_rows({'idx': np.int64(i),
                      'vec': rng.random(6).astype(np.float32),
                      'image': rng.integers(0, 255, (8, 6, 3),
                                            dtype=np.uint8)}
                     for i in range(ROWS))


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('remote') / 'ds')
    _write(url)
    return url


@pytest.fixture
def chaos_env(monkeypatch):
    """Arm ``PETASTORM_TPU_CHAOS`` with both packages' injector caches
    fresh, so each run replays from occurrence 0."""
    def arm(value):
        jfaultfs.reset_chaos_cache()
        tfaultfs.reset_chaos_cache()
        monkeypatch.setenv(tfaultfs.CHAOS_ENV_VAR, value)
    yield arm
    jfaultfs.reset_chaos_cache()
    tfaultfs.reset_chaos_cache()


def _pass(pkg, url, factory='make_columnar_reader', **kw):
    """``({idx: (vec bytes, image bytes)}, stats snapshot, reader)``."""
    kw.setdefault('workers_count', 2)
    mod = petastorm_tpu_torch if pkg == 'torch' else petastorm_tpu
    rows = {}
    with getattr(mod, factory)(url, **kw) as reader:
        for item in reader:
            if factory == 'make_reader':
                rows[int(item.idx)] = (np.asarray(item.vec).tobytes(),
                                       np.asarray(item.image).tobytes())
                continue
            for i in range(len(item.idx)):
                rows[int(item.idx[i])] = (
                    np.asarray(item.vec[i]).tobytes(),
                    np.asarray(item.image[i]).tobytes())
        snapshot = reader.stats.snapshot() if pkg == 'torch' \
            else reader.diagnostics
    return rows, snapshot, reader


_JAX_ROWS = {}


def _jax_rows(url, mode):
    key = (url, mode)
    if key not in _JAX_ROWS:
        _JAX_ROWS[key] = _pass('jax', url, remote_read=mode,
                               reader_pool_type='dummy')[0]
    return _JAX_ROWS[key]


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('pool', ['thread', 'dummy'])
@pytest.mark.parametrize('readahead', [0, 2])
def test_modes_on_in_process_pools_as_jax(store, mode, pool, readahead):
    got, snap, _ = _pass('torch', store, remote_read=mode,
                         reader_pool_type=pool, io_readahead=readahead)
    assert got == _jax_rows(store, mode) and len(got) == ROWS
    if mode == 'ranged':
        assert snap['io_range_requests'] > 0 and snap['io_ranged_reads'] > 0
        assert snap['io_range_p99_s'] > 0
    else:
        assert not any(snap.get(k) for k in RANGE_COUNTERS)


@pytest.mark.timeout(240)
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('readahead', [0, 2])
def test_modes_on_the_process_pool_as_jax(store, mode, readahead):
    pytest.importorskip('zmq')
    got, snap, _ = _pass('torch', store, remote_read=mode,
                         reader_pool_type='process', io_readahead=readahead)
    assert got == _jax_rows(store, mode) and len(got) == ROWS
    if mode == 'ranged':
        assert snap['io_range_requests'] > 0 and snap['io_ranged_reads'] > 0
    else:
        assert not snap.get('io_range_requests')


@pytest.mark.parametrize('factory', ['make_reader', 'make_columnar_reader'])
@pytest.mark.parametrize('readahead', [0, 2])
def test_range_counters_equal_jax_on_the_dummy_pool(store, factory,
                                                    readahead):
    kw = dict(remote_read='ranged', reader_pool_type='dummy',
              shuffle_row_groups=False, io_readahead=readahead)
    got, snap, reader = _pass('torch', store, factory, **kw)
    want, jsnap, _ = _pass('jax', store, factory, **kw)
    assert got == want
    assert {k: snap.get(k, 0) for k in RANGE_COUNTERS} == \
        {k: jsnap.get(k, 0) for k in RANGE_COUNTERS}
    assert snap['io_ranged_reads'] == len(reader.pieces)
    histogram = reader.latency.histograms['io_range']
    assert histogram.count == snap['io_range_requests']


def test_batch_reader_modes_as_jax(store):
    for mode in MODES:
        got = _pass('torch', store, 'make_batch_reader', remote_read=mode,
                    reader_pool_type='dummy', shuffle_row_groups=False)
        want = _pass('jax', store, 'make_batch_reader', remote_read=mode,
                     reader_pool_type='dummy', shuffle_row_groups=False)
        assert got[0] == want[0] and len(got[0]) == ROWS
        assert got[1].get('io_range_requests', 0) == \
            want[1].get('io_range_requests', 0)


@pytest.fixture(scope='module')
def memory_store():
    url = 'memory://remote-{}/ds'.format(uuid.uuid4().hex[:8])
    _write(url)
    return url


@pytest.mark.parametrize('mode', [None] + MODES)
@pytest.mark.parametrize('pool', ['thread', 'dummy'])
def test_memory_store_modes_as_jax(memory_store, mode, pool):
    got, snap, _ = _pass('torch', memory_store, remote_read=mode,
                         reader_pool_type=pool, io_readahead=2)
    assert got == _jax_rows(memory_store, mode) and len(got) == ROWS
    assert bool(snap.get('io_range_requests')) == (mode == 'ranged')


def _worker_modes(url, **kw):
    with petastorm_tpu_torch.make_columnar_reader(
            url, reader_pool_type='thread', workers_count=2, **kw) as reader:
        list(reader)
        return {w.remote_read for w in reader._pool.workers}


class _RemoteFs:
    """A filesystem that names a remote protocol (nothing is opened)."""

    def __init__(self, protocol):
        self.protocol = protocol


@pytest.mark.parametrize('protocol,mode', [
    ('file', None), ('memory', None), ('local', None), ('s3', None),
    (('gcs', 'gs'), None), ('hdfs', None), ('', None), ('s3', 'serial'),
    ('file', 'prebuffer'), ('memory', 'ranged')])
def test_automatic_mode_as_jax(protocol, mode):
    from petastorm_tpu.readers import piece_worker as jpiece_worker
    from petastorm_tpu_torch.cache import NullCache
    from petastorm_tpu_torch.readers import piece_worker
    assert piece_worker._LOCAL_PROTOCOLS == jpiece_worker._LOCAL_PROTOCOLS
    spec = piece_worker.PieceWorkerSpec(
        None, None, NullCache(), 0, '{}', health=False,
        filesystem_factory=lambda: _RemoteFs(protocol), remote_read=mode)
    name = protocol[0] if isinstance(protocol, tuple) else protocol
    want = mode or ('serial' if name in jpiece_worker._LOCAL_PROTOCOLS
                    else 'prebuffer')
    worker = spec.make_worker()
    assert worker.remote_read == want
    assert (worker.range_reader is not None) == (want == 'ranged')


def test_automatic_mode_of_readers(store, memory_store, chaos_env):
    assert _worker_modes(store) == {'serial'}
    assert _worker_modes(memory_store) == {'serial'}     # a local protocol
    assert _worker_modes(store, remote_read='auto') == {'serial'}
    assert _worker_modes(memory_store, remote_read='ranged') == {'ranged'}
    # a chaos wrapper forwards its filesystem's protocol
    chaos_env('tail-latency:1:tail_rate=0,base_latency_s=0')
    assert _worker_modes(store) == {'serial'}


@pytest.mark.parametrize('factory', ['make_reader', 'make_columnar_reader',
                                     'make_batch_reader'])
def test_remote_read_typo_fails_the_factory_as_jax(store, factory):
    errors = []
    for mod in (petastorm_tpu_torch, petastorm_tpu):
        with pytest.raises(ValueError) as info:
            getattr(mod, factory)(store, remote_read='coalesced')
        errors.append(str(info.value))
    assert errors[0] == errors[1] and 'remote_read' in errors[0]


def test_storage_options_reach_the_workers(memory_store):
    options = {'skip_instance_cache': True}
    with petastorm_tpu_torch.make_columnar_reader(
            memory_store, storage_options=options, workers_count=1,
            remote_read='ranged') as reader:
        assert len({int(i) for b in reader for i in b.idx}) == ROWS
        factory = reader._filesystem_factory
        worker = reader._pool.workers[0]
    assert factory.protocol == 'memory' and factory.storage_options == options
    assert type(worker._filesystem).__name__ == 'MemoryFileSystem'


@pytest.mark.parametrize('pool', ['thread', 'dummy'])
@pytest.mark.parametrize('readahead', [0, 2])
def test_per_range_retry_as_jax(store, chaos_env, pool, readahead):
    chaos_env('transient-errors:101')
    got, snap, _ = _pass('torch', store, remote_read='ranged',
                         reader_pool_type=pool, io_readahead=readahead,
                         retry=dict(initial_backoff_s=0.001))
    injected = dict(tfaultfs.chaos_from_env().injected)
    chaos_env('transient-errors:101')
    want, jsnap, _ = _pass('jax', store, remote_read='ranged',
                           reader_pool_type=pool, io_readahead=readahead,
                           retry=dict(initial_backoff_s=0.001))
    assert got == want and len(got) == ROWS
    assert injected.get('transient_error', 0) > 0
    assert snap['io_retries'] > 0 and snap['io_permanent_failures'] == 0
    assert jsnap['io_retries'] > 0


@pytest.mark.timeout(120)
def test_per_range_hedge_as_jax(store, chaos_env):
    spec = 'read-hangs:404:hang_rate=0.2,hang_s=0.2'
    chaos_env(spec)
    got, snap, _ = _pass('torch', store, remote_read='ranged',
                         reader_pool_type='dummy', hedge=0.02)
    chaos_env(spec)
    want, jsnap, _ = _pass('jax', store, remote_read='ranged',
                           reader_pool_type='dummy', hedge=0.02)
    assert got == want and len(got) == ROWS
    assert snap['io_hedges'] >= 1 and jsnap['io_hedges'] >= 1
    # the range reader's hedges: a whole-row-group read is never hedged
    assert snap['io_range_requests'] > len(got) // 8


@pytest.mark.parametrize('readahead', [0, 2])
def test_trace_replay_tally_as_jax(store, chaos_env, readahead):
    spec = ('trace-replay:7:trace=s3-us-east-1,latency_scale=0.002,'
            'bandwidth_scale=500')
    tallies = []
    for pkg, faultfs in (('torch', tfaultfs), ('jax', jfaultfs)):
        chaos_env(spec)
        rows, snap, _ = _pass(pkg, store, remote_read='ranged',
                              reader_pool_type='dummy', io_readahead=readahead)
        injector = faultfs.chaos_from_env()
        tallies.append((rows, dict(injector.injected),
                        round(injector.injected_s['trace_latency_s'], 6),
                        snap['io_range_requests']))
    assert tallies[0] == tallies[1]
    assert tallies[0][1]['trace_reads'] > 0


@pytest.mark.parametrize('mode', ['serial', 'prebuffer'])
@pytest.mark.parametrize('factory', ['make_reader', 'make_columnar_reader',
                                     'make_batch_reader'])
def test_whole_row_group_reads_as_jax(store, chaos_env, mode, factory):
    """A ``serial`` or ``prebuffer`` row-group read issues JAX's ``read()``
    calls (pyarrow's defaults under ``serial``, as JAX opens the file), so a
    seeded ``transient-errors`` run fails the same reads and retries as
    often in both packages."""
    got = {}
    for pkg, faults in (('jax', jfaultfs), ('torch', tfaultfs)):
        chaos_env('transient-errors:101')
        rows, stats, _ = _pass(pkg, store, factory, remote_read=mode,
                               reader_pool_type='dummy')
        got[pkg] = (sorted(rows), stats.get('io_retries'),
                    dict(faults.chaos_from_env().injected),
                    sorted(faults.chaos_from_env()._occurrences.items()))
    assert got['torch'] == got['jax']
    assert got['torch'][1] >= 1
