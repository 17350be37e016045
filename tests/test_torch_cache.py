"""The port's row-group caches against the JAX package's, on the CPU.

The shared cache's segment format (round trip, truncated and garbage
segments refused, ``write_segment``'s bytes equal to JAX's); misses, hits as
read-only views, attachment from a second instance and from a pickled copy,
arrow tables, ``contains`` and events, a truncated segment refilled, an
idempotent ``close``; spill to disk and promotion, a pinned segment kept,
the pins of a dead pid and of a killed process expired; single flight
across threads and processes and a stale lock stolen; many more worker
threads than cores on one root under a short switch interval; the kill
switch;
``LocalDiskCache`` eviction as JAX's. Readers: every factory takes every
``cache_type`` and gives the uncached rows; ``_make_cache``'s and the
predicate's errors are JAX's words; a root filled by one package serves
the other's columnar and batch readers with no fill and equal values, and
the two packages build equal keys; a loader over a shared-cache reader
gives the uncached loader's batches, device decode on and off, and copies
every read-only column of a hit. Tests that
start interpreters carry a ``timeout`` mark.
"""

import hashlib
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import petastorm_tpu
from petastorm_tpu import cache as jcache
from petastorm_tpu import reader as jreader
from petastorm_tpu import sharedcache as jshared
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.predicates import in_lambda as jin_lambda
from petastorm_tpu.transform import TransformSpec as JTransformSpec

import petastorm_tpu_torch
from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                 materialize_dataset)
from petastorm_tpu_torch import cache as tcache
from petastorm_tpu_torch import reader as treader
from petastorm_tpu_torch import sharedcache as tshared
from petastorm_tpu_torch.codecs import (CompressedImageCodec, NdarrayCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.readers.columnar_worker import transform_fingerprint
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.sharedcache import (KIND_PICKLE5,
                                             CorruptSegmentError,
                                             SharedRowGroupCache,
                                             _PinRegistry, read_segment,
                                             write_segment)

REPO = Path(__file__).resolve().parent.parent
ROWS = 48          # 6 files of one 8-row group each


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('cache') / 'ds')
    schema = Unischema('Cached', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (12, 10, 3),
                       CompressedImageCodec('png'), False),
        UnischemaField('vec', np.float32, (6,), NdarrayCodec(), False)])
    rng = np.random.default_rng(3)
    with materialize_dataset(url, schema, rows_per_file=8) as w:
        w.write_rows({'idx': np.int64(i),
                      'image': rng.integers(0, 255, (12, 10, 3),
                                            dtype=np.uint8),
                      'vec': rng.random(6).astype(np.float32)}
                     for i in range(ROWS))
    return url


def _mk(tmp_path, name='root', **kwargs):
    kwargs.setdefault('mem_dir', str(tmp_path / (name + '_mem')))
    return SharedRowGroupCache(str(tmp_path / name), 1 << 24, **kwargs)


def _digest(key):
    return hashlib.md5(key.encode()).hexdigest()


def _blob(i, n=20_000):
    return {'a': np.full(n, i, dtype=np.int64),
            'meta': {'i': i, 's': 'label_{}'.format(i)}}


def _dead_pid():
    child = subprocess.Popen([sys.executable, '-c', 'pass'])
    child.wait(timeout=60)
    return child.pid


def _run_child(code, timeout=60):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, '-c', code], env=env, cwd=str(REPO),
                          capture_output=True, text=True, timeout=timeout)


# -- segment format -----------------------------------------------------------

def test_segment_round_trips_and_its_bytes_are_jax_s(tmp_path):
    frames = [b'meta', np.arange(1000, dtype=np.int64).tobytes(), b'x' * 7]
    path = str(tmp_path / 's.seg')
    size = write_segment(path, KIND_PICKLE5, frames)
    kind, views, _m = read_segment(path)
    assert kind == KIND_PICKLE5 and bytes(views[0]) == b'meta'
    np.testing.assert_array_equal(np.frombuffer(views[1], dtype=np.int64),
                                  np.arange(1000))
    assert all(v.readonly for v in views)
    jpath = str(tmp_path / 'j.seg')
    assert jshared.write_segment(jpath, KIND_PICKLE5, frames) == size
    assert open(path, 'rb').read() == open(jpath, 'rb').read()
    jkind, jviews, _jm = jshared.read_segment(path)
    assert jkind == kind and [bytes(v) for v in jviews] == \
        [bytes(v) for v in views]


@pytest.mark.parametrize('cut', [0, 3, 40, -3])
def test_truncated_segment_is_refused(tmp_path, cut):
    path = str(tmp_path / 's.seg')
    write_segment(path, KIND_PICKLE5, [b'meta', b'x' * 4096])
    data = open(path, 'rb').read()
    with open(path, 'wb') as f:
        f.write(data[:cut])
    with pytest.raises(CorruptSegmentError):
        read_segment(path)


def test_garbage_segment_is_refused(tmp_path):
    path = str(tmp_path / 's.seg')
    with open(path, 'wb') as f:
        f.write(b'not a segment at all' * 10)
    with pytest.raises(CorruptSegmentError):
        read_segment(path)


# -- the shared cache ---------------------------------------------------------

def test_miss_then_hit_is_a_read_only_view(tmp_path):
    cache = _mk(tmp_path)
    calls = []
    v1 = cache.get('k', lambda: calls.append(1) or _blob(7))
    v2 = cache.get('k', lambda: calls.append(1) or _blob(7))
    assert calls == [1]
    np.testing.assert_array_equal(v1['a'], v2['a'])
    assert v2['meta'] == {'i': 7, 's': 'label_7'}
    assert v1['a'].flags.writeable and not v2['a'].flags.writeable
    assert cache.counters()['fills'] == 1 and cache.counters()['hits'] == 1


def test_second_instance_and_pickled_copy_attach(tmp_path):
    a = _mk(tmp_path)
    a.get('k', lambda: _blob(1))
    b = _mk(tmp_path)
    v = b.get('k', lambda: pytest.fail('second instance must attach'))
    np.testing.assert_array_equal(v['a'], _blob(1)['a'])
    clone = pickle.loads(pickle.dumps(a))
    v = clone.get('k', lambda: pytest.fail('the copy must attach'))
    np.testing.assert_array_equal(v['a'], _blob(1)['a'])
    clone.close()


def test_arrow_table_segments(tmp_path):
    table = pa.table({'x': np.arange(500),
                      'y': ['s%d' % i for i in range(500)]})
    _mk(tmp_path).get('t', lambda: table)
    got = _mk(tmp_path).get('t', lambda: pytest.fail('must attach'))
    assert got.equals(table)


def test_contains_and_events(tmp_path):
    cache = _mk(tmp_path)
    assert not cache.contains('k')
    cache.get('k', lambda: _blob(0))
    assert cache.contains('k')
    cache.get('k', lambda: pytest.fail('hit expected'))
    events = cache.take_events()
    assert events['shared_misses'] == 1 and events['shared_hits'] == 1
    assert cache.take_events()['shared_hits'] == 0
    assert cache.occupancy_bytes() > 0
    assert cache.tier_bytes()[0] == cache.size_bytes() > 0


def test_truncated_segment_is_refilled_not_served(tmp_path):
    _mk(tmp_path).get('k', lambda: _blob(3))
    seg = tmp_path / 'root_mem' / (_digest('k') + '.seg')
    data = seg.read_bytes()
    seg.write_bytes(data[:len(data) // 2])
    fresh = _mk(tmp_path)
    assert fresh.get('k', lambda: {'refilled': True}) == {'refilled': True}
    assert fresh.counters()['corrupt_dropped'] == 1


def test_close_is_idempotent_and_releases_pins(tmp_path):
    cache = _mk(tmp_path)
    cache.get('k', lambda: _blob(1))
    cache.get('k', lambda: None)          # attach: a pin
    pins = tmp_path / 'root' / 'pins'
    assert any(n.endswith('.pin') for n in os.listdir(pins))
    cache.close()
    cache.close()
    assert not any(n.endswith('.pin') for n in os.listdir(pins))
    assert SharedRowGroupCache.global_counters(
        str(tmp_path / 'root'))['fills'] == 1


def test_eviction_spills_to_disk_and_promotes_back(tmp_path):
    cache = _mk(tmp_path, mem_size_limit_bytes=400_000)
    for i in range(8):
        cache.get('k%d' % i, lambda i=i: _blob(i))
    disk = tmp_path / 'root' / 'disk'
    spilled = {n for n in os.listdir(disk) if n.endswith('.seg')}
    assert spilled and cache.counters()['spills'] > 0
    digest = next(iter(spilled))[:-len('.seg')]
    key = next('k%d' % i for i in range(8) if _digest('k%d' % i) == digest)
    v = cache.get(key, lambda: pytest.fail('a disk-tier hit expected'))
    assert v['a'][0] == int(key[1:])
    assert not (disk / (digest + '.seg')).exists()
    assert (tmp_path / 'root_mem' / (digest + '.seg')).exists()
    for i in range(8):            # every key is still served, exactly
        v = cache.get('k%d' % i, lambda: pytest.fail('tiered lookup'))
        assert v['a'][0] == i and v['a'][-1] == i


def test_pinned_segment_survives_pressure(tmp_path):
    cache = _mk(tmp_path, mem_size_limit_bytes=400_000)
    cache.get('pinned', lambda: _blob(0))
    held = cache.get('pinned', lambda: None)   # attach: a live pin
    for i in range(10):
        cache.get('k%d' % i, lambda i=i: _blob(i))
    assert (tmp_path / 'root_mem' / (_digest('pinned') + '.seg')).exists()
    assert cache.counters()['evictions'] > 0
    assert cache.take_events()['shared_evictions'] > 0
    assert held['a'][0] == 0


@pytest.mark.timeout(120)
def test_a_dead_pid_s_pin_expires(tmp_path):
    pins = _PinRegistry(str(tmp_path / 'pins'))
    marker = tmp_path / 'pins' / '{}.{}.deadbeef.pin'.format(_digest('k'),
                                                             _dead_pid())
    marker.write_text('')
    assert not pins.is_pinned(_digest('k'))
    assert not marker.exists()


@pytest.mark.timeout(120)
def test_a_killed_process_s_pins_expire(tmp_path):
    out = _run_child(
        'import os, numpy as np\n'
        'from petastorm_tpu_torch.sharedcache import SharedRowGroupCache\n'
        'c = SharedRowGroupCache(%r, 1 << 24, mem_dir=%r)\n'
        'c.get("k", lambda: {"a": np.arange(1000)})\n'
        'c.get("k", lambda: None)\n'
        'os._exit(17)\n' % (str(tmp_path / 'root'),
                            str(tmp_path / 'root_mem')))
    assert out.returncode == 17, out.stderr
    pins = tmp_path / 'root' / 'pins'
    assert [n for n in os.listdir(pins) if n.endswith('.pin')]
    assert not _PinRegistry(str(pins)).is_pinned(_digest('k'))


def test_single_flight_across_instances_and_threads(tmp_path):
    calls, lock = [], threading.Lock()

    def slow_fill():
        with lock:
            calls.append(1)
        time.sleep(0.2)
        return _blob(9)

    caches = [_mk(tmp_path), _mk(tmp_path)]
    shared = caches[0]               # thread-pool workers share one instance
    results, errors = [], []

    def run(cache):
        try:
            results.append(cache.get('k', slow_fill))
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,))
               for c in (caches[0], caches[1], shared, shared)]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(calls) == 1 and len(results) == 4
    for r in results:
        np.testing.assert_array_equal(r['a'], _blob(9)['a'])
    assert sum(c.counters()['lock_waits'] for c in caches) >= 1


@pytest.mark.timeout(120)
def test_single_flight_across_processes(tmp_path):
    root, mem = str(tmp_path / 'root'), str(tmp_path / 'root_mem')
    child = subprocess.Popen([sys.executable, '-c', (
        'import time, numpy as np\n'
        'from petastorm_tpu_torch.sharedcache import SharedRowGroupCache\n'
        'c = SharedRowGroupCache(%r, 1 << 24, mem_dir=%r)\n'
        'def fill():\n'
        '    time.sleep(1.5)\n'
        '    return {"a": np.arange(5000)}\n'
        'c.get("k", fill)\n'
        'c.close()\n' % (root, mem))],
        env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=str(REPO))
    try:
        lock = Path(root) / 'locks' / (_digest('k') + '.lock')
        deadline = time.monotonic() + 60
        while not lock.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lock.exists(), 'the child never took the fill lock'
        cache = SharedRowGroupCache(root, 1 << 24, mem_dir=mem)
        v = cache.get('k', lambda: pytest.fail('the child fills it'))
        np.testing.assert_array_equal(v['a'], np.arange(5000))
        assert cache.counters()['lock_waits'] == 1
    finally:
        assert child.wait(timeout=60) == 0
    cache.close()
    totals = SharedRowGroupCache.global_counters(root)
    assert totals['fills'] == 1 and totals['hits'] == 1


@pytest.mark.timeout(120)
def test_a_stale_lock_of_a_dead_process_is_stolen(tmp_path):
    cache = _mk(tmp_path)
    lock = tmp_path / 'root' / 'locks' / (_digest('k') + '.lock')
    lock.write_text(str(_dead_pid()))
    start = time.perf_counter()
    assert cache.get('k', lambda: _blob(2))['a'][0] == 2
    assert time.perf_counter() - start < 5.0
    assert cache.counters()['lock_steals'] == 1


def test_tier_zero_lives_where_jax_puts_it():
    for path in ('/data/cache', '/tmp/x/y'):
        assert SharedRowGroupCache._default_mem_dir(path) == \
            jshared.SharedRowGroupCache._default_mem_dir(path)


def test_local_disk_cache_evicts_as_jax(tmp_path):
    left = []
    for name, module in (('jax', jcache), ('torch', tcache)):
        cache = module.LocalDiskCache(str(tmp_path / name), 70_000)
        for i in range(6):
            cache.get('k%d' % i, lambda i=i: np.full(2000, i, np.int64))
            time.sleep(0.01)                     # distinct mtimes
        assert cache.size_bytes() <= 70_000
        left.append(sorted(
            k for k in ('k%d' % i for i in range(6))
            if os.path.exists(cache._key_path(k))))
        hit = cache.get('k5', lambda: pytest.fail('k5 is cached'))
        assert hit[0] == 5
    assert left[0] == left[1] and 'k0' not in left[1] and 'k5' in left[1]


# -- readers ------------------------------------------------------------------

def _values(package, factory, url, **kw):
    """``{idx: (vec bytes, image bytes)}`` of one pass."""
    kw.setdefault('workers_count', 2)
    if factory == 'ngram':
        ngram = (JNGram if package is petastorm_tpu else NGram)(
            {0: ['idx', 'vec'], 1: ['idx']}, 1, 'idx')
        with package.make_reader(url, schema_fields=ngram, **kw) as reader:
            return {int(c.columns['idx'][s]): c.columns['vec'][s].tobytes()
                    for c in reader.iter_ngram_chunks() for s in c.starts}
    make = getattr(package, {'rows': 'make_reader',
                             'columnar': 'make_columnar_reader',
                             'batch': 'make_batch_reader'}[factory])
    out = {}
    with make(url, **kw) as reader:
        for item in reader:
            item = item._asdict()
            if factory == 'rows':
                item = {k: [v] for k, v in item.items()}
            for i, vec, image in zip(item['idx'], item['vec'],
                                     item['image']):
                out[int(i)] = (np.asarray(vec).tobytes(),
                               np.asarray(image).tobytes())
    return out


def _cache_kw(tmp_path, cache_type):
    if cache_type == 'null':
        return dict(cache_type='null')
    if cache_type == 'local-disk':
        return dict(cache_type='local-disk',
                    cache_location=str(tmp_path / 'local'),
                    cache_size_limit=1 << 26)
    return dict(cache_type='shared', cache_location=str(tmp_path / 'shared'),
                cache_size_limit=1 << 26,
                cache_extra_settings={'mem_dir': str(tmp_path / 'mem')})


@pytest.mark.parametrize('cache_type', ['null', 'local-disk', 'shared'])
@pytest.mark.parametrize('factory', ['rows', 'columnar', 'batch'])
def test_every_factory_takes_every_cache_type(store, tmp_path, factory,
                                              cache_type):
    want = _values(petastorm_tpu_torch, factory, store)
    kw = _cache_kw(tmp_path, cache_type)
    assert _values(petastorm_tpu_torch, factory, store, **kw) == want
    assert _values(petastorm_tpu_torch, factory, store, io_readahead=2,
                   **kw) == want
    if cache_type == 'shared':
        totals = SharedRowGroupCache.global_counters(str(tmp_path / 'shared'))
        assert totals['fills'] == ROWS // 8 and totals['hits'] == ROWS // 8


def test_ngram_windows_from_the_cache_equal_uncached(store, tmp_path):
    want = _values(petastorm_tpu_torch, 'ngram', store)
    kw = _cache_kw(tmp_path, 'local-disk')
    assert _values(petastorm_tpu_torch, 'ngram', store, **kw) == want
    assert _values(petastorm_tpu_torch, 'ngram', store, **kw) == want
    assert len(want) == ROWS - ROWS // 8


def test_make_cache_errors_are_jax_s_words(tmp_path):
    cases = [('bogus', None, None), ('shared', None, None),
             ('shared', str(tmp_path / 'c'), None),
             ('local-disk', None, 100), ('local-disk', str(tmp_path), 0)]
    for cache_type, location, limit in cases:
        messages = []
        for module in (jreader, treader):
            with pytest.raises(ValueError) as e:
                module._make_cache(cache_type, location, limit, None, None)
            messages.append(str(e.value))
        assert messages[0] == messages[1], cache_type
    assert treader.CACHE_TYPES == jreader.CACHE_TYPES


def test_predicate_with_a_cache_is_refused_with_jax_s_words(store, tmp_path):
    messages = []
    for package, pred in ((petastorm_tpu, jin_lambda),
                          (petastorm_tpu_torch, in_lambda)):
        with pytest.raises(RuntimeError) as e:
            package.make_columnar_reader(
                store, predicate=pred(['idx'], lambda v: True),
                **_cache_kw(tmp_path, 'local-disk'))
        messages.append(str(e.value))
    assert messages[0] == messages[1] and 'cache' in messages[1]


def test_kill_switch_leaves_no_file(store, tmp_path, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_SHARED_CACHE', '0')
    assert not tshared.shared_cache_enabled()
    location = tmp_path / 'killed'
    assert isinstance(treader._make_cache('shared', str(location), 1 << 20,
                                          None, None), tcache.NullCache)
    want = _values(petastorm_tpu_torch, 'columnar', store)
    assert _values(petastorm_tpu_torch, 'columnar', store,
                   cache_type='shared', cache_location=str(location),
                   cache_size_limit=1 << 26) == want
    assert not location.exists()
    assert not os.path.exists(
        SharedRowGroupCache._default_mem_dir(str(location)))


def _fills(root):
    return SharedRowGroupCache.global_counters(root).get('fills', 0)


@pytest.mark.parametrize('factory', ['columnar', 'batch'])
@pytest.mark.parametrize('filler', ['jax', 'torch'])
def test_a_root_filled_by_one_package_serves_the_other(store, tmp_path,
                                                       factory, filler):
    kw = dict(_cache_kw(tmp_path, 'shared'), shuffle_row_groups=False)
    first, second = ((petastorm_tpu, petastorm_tpu_torch) if filler == 'jax'
                     else (petastorm_tpu_torch, petastorm_tpu))
    filled = _values(first, factory, store, **kw)
    root = str(tmp_path / 'shared')
    assert _fills(root) == ROWS // 8
    served = _values(second, factory, store, **kw)
    assert _fills(root) == ROWS // 8, 'the second package filled again'
    assert served == filled == _values(petastorm_tpu_torch, factory, store)


def _double(columns):
    return dict(columns, vec=columns['vec'] * 2)


def test_the_two_packages_build_equal_keys(store, tmp_path):
    jspec = JTransformSpec(_double,
                           edit_fields=[('vec', np.float32, (6,), False)])
    tspec = TransformSpec(_double,
                          edit_fields=[('vec', np.float32, (6,), False)])
    from petastorm_tpu.readers.columnar_worker import \
        transform_fingerprint as jfingerprint
    assert transform_fingerprint(tspec) == jfingerprint(jspec)
    cases = [('columnar', 'columnar', {}, {}),
             ('columnar', 'columnar', {'schema_fields': ['idx', 'vec']}, {}),
             ('columnar', 'columnar_tx:' + jfingerprint(jspec),
              {'transform_spec': jspec}, {'transform_spec': tspec}),
             ('columnar', 'columnar',
              {'decode_hints': {'image': {'scale': 2}}}, {}),
             ('rows', 'rowgroup', {}, {}),
             ('batch', 'batch', {}, {})]
    for factory, prefix, jkw, tkw in cases:
        tkw = dict(jkw, **tkw)
        make = {'rows': 'make_reader', 'columnar': 'make_columnar_reader',
                'batch': 'make_batch_reader'}[factory]
        with getattr(petastorm_tpu, make)(store, workers_count=1,
                                          **jkw) as jr, \
                getattr(petastorm_tpu_torch, make)(store, workers_count=1,
                                                   **tkw) as tr:
            jworker = jr._pool._workers[0]
            tworker = tr._pool.workers[0]
            assert set(jr.device_decode_plans) == set(tr.device_decode_plans)
            for jp, tp in zip(jr._pieces, tr.pieces):
                jkey = jworker._cache_key(prefix, jp)
                assert jkey == tworker.cache_key(prefix, tp), jkey
    fields = {0: ['idx', 'vec'], 1: ['idx']}
    with petastorm_tpu.make_reader(store, workers_count=1,
                                   schema_fields=JNGram(fields, 1, 'idx')) \
            as jr, petastorm_tpu_torch.make_reader(
                store, workers_count=1,
                schema_fields=NGram(fields, 1, 'idx')) as tr:
        assert jr._pool._workers[0]._cache_key('ngram_cols', jr._pieces[0]) \
            == tr._pool.workers[0].cache_key('ngram_cols', tr.pieces[0])


@pytest.mark.parametrize('switch', ['on', 'off'])
def test_loader_over_a_shared_cache_gives_the_uncached_batches(
        store, tmp_path, monkeypatch, switch):
    monkeypatch.setenv(DEVICE_DECODE_ENV_VAR, switch)

    def batches(**kw):
        with petastorm_tpu_torch.make_columnar_reader(
                store, workers_count=1, shuffle_row_groups=False,
                schema_fields=['idx', 'vec'], **kw) as reader:
            assert bool(reader.device_decode_plans) == (switch == 'on')
            loader = TorchDataLoader(reader, batch_size=5, device='cpu')
            passes = [list(loader), list(loader)]
        return passes

    want = batches()[0]
    kw = _cache_kw(tmp_path, 'shared')
    got = batches(**kw) + batches(**kw)
    for p in got:
        assert len(p) == len(want)
        for b, w in zip(p, want):
            assert b.keys() == w.keys()
            for k in w:
                assert torch.equal(b[k], w[k])
    # the hits' tensors are the loader's own copies, writable without
    # touching the segments
    got[-1][0]['vec'] += 1
    again = batches(**kw)[0]
    assert torch.equal(again[0]['vec'], want[0]['vec'])
    assert _fills(str(tmp_path / 'shared')) == ROWS // 8


def test_the_loader_copies_every_read_only_hit_column(tmp_path):
    """A hit's numeric and string columns are views of the mapping; what the
    loader makes of them (and what its caches keep) shares no memory with
    it."""
    from petastorm_tpu_torch.torch_utils import _to_tensor
    cache = _mk(tmp_path)
    value = {'s': np.array(['label_%04d' % i for i in range(1000)]),
             'x': np.arange(1000, dtype=np.int64)}
    cache.get('k', lambda: value)
    hit = cache.get('k', lambda: pytest.fail('hit expected'))
    for name in ('s', 'x'):
        assert not hit[name].flags.writeable
        out = _to_tensor(hit[name], False)
        out = out.numpy() if torch.is_tensor(out) else out
        assert out.flags.writeable and not np.shares_memory(out, hit[name])
        np.testing.assert_array_equal(out, value[name])


@pytest.mark.timeout(120)
def test_many_threads_fill_each_group_once_under_a_short_switch(store,
                                                               tmp_path):
    """More worker threads than cores, reading ahead, on one shared root
    with a short GIL switch interval, two items a row group (row-drop
    partitions: both want the same key at once): each row group is
    filled once, every other load hits, and both passes give the uncached
    values (a lost update of the counters, a second fill or a torn segment
    would show)."""
    want = _values(petastorm_tpu_torch, 'columnar', store)
    kw = dict(_cache_kw(tmp_path, 'shared'), workers_count=2 * (
        os.cpu_count() or 4) + 1, io_readahead=2,
        shuffle_row_drop_partitions=2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        passes = [_values(petastorm_tpu_torch, 'columnar', store, **kw)
                  for _ in range(2)]
    finally:
        sys.setswitchinterval(interval)
    assert passes[0] == passes[1] == want
    totals = SharedRowGroupCache.global_counters(str(tmp_path / 'shared'))
    assert totals['fills'] == ROWS // 8
    assert totals['hits'] == 3 * ROWS // 8 and totals['misses'] == ROWS // 8
