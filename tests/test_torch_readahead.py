"""The port's row-group readahead against the JAX package's, on the CPU.

Unit parity with ``tests/test_readahead.py``: the file-handle LRU and the
prefetch queue (hits, misses, a desync that cancels and heals, errors on
``take``, duplicate keys in FIFO order, ``'auto'`` depth, refused depths)
run the same script on both packages. Readers: every factory with
``io_readahead=2`` on one worker gives the rows in the serial order and
equal to JAX's, and on four workers the same set; the NGram chunk path,
row-drop partitions and predicate items (which are not prefetched); the
dummy pool turns readahead off; a second pass (``reset``) with prefetches
outstanding under the thread and the process pool; bad values raise JAX's
words. The tallies are read from the workers' readahead objects.
"""

import time

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.predicates import in_lambda as jin_lambda
from petastorm_tpu.readers import piece_worker as jpiece
from petastorm_tpu.readers import readahead as jreadahead

import petastorm_tpu_torch
from petastorm_tpu_torch import materialize_dataset
from petastorm_tpu_torch.codecs import (CompressedImageCodec, NdarrayCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.readers import piece_worker as tpiece
from petastorm_tpu_torch.readers import readahead as treadahead
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS = 64          # 8 files of one 8-row group each

PACKAGES = {'jax': (jpiece, jreadahead), 'torch': (tpiece, treadahead)}


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('readahead') / 'ds')
    schema = Unischema('Ra', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (12, 10, 3),
                       CompressedImageCodec('png'), False),
        UnischemaField('vec', np.float32, (6,), NdarrayCodec(), False)])
    rng = np.random.default_rng(7)
    with materialize_dataset(url, schema, rows_per_file=8) as w:
        w.write_rows({'idx': np.int64(i),
                      'image': rng.integers(0, 255, (12, 10, 3),
                                            dtype=np.uint8),
                      'vec': rng.random(6).astype(np.float32)}
                     for i in range(ROWS))
    return url


# -- file handles -------------------------------------------------------------

class _FakeHandle:
    def __init__(self, path):
        self.path = path
        self.closed = False

    def close(self):
        self.closed = True


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_file_handle_cache_reuses_evicts_closes_as_jax(package):
    cache_cls = PACKAGES[package][0].FileHandleCache
    opened = []

    def open_fn(path):
        opened.append(_FakeHandle(path))
        return opened[-1]

    cache = cache_cls(open_fn, max_size=2)
    assert cache.get('a') is cache.get('a') and len(opened) == 1
    b = cache.get('b')
    cache.get('a')              # refresh 'a': 'b' is the LRU entry
    cache.get('c')              # evicts and closes 'b'
    assert b.closed and len(cache) == 2
    assert 'b' not in cache and 'a' in cache and 'c' in cache
    cache.close_all()
    assert all(h.closed for h in opened) and len(cache) == 0
    with pytest.raises(ValueError, match='max_size'):
        cache_cls(open_fn, max_size=0)


# -- the prefetch queue -------------------------------------------------------

def _plan(key):
    return (key, 'piece-' + str(key), ['col'])


class _Recorder:
    def __init__(self):
        self.times, self.counts = {}, {}

    def record_time(self, stage, seconds):
        self.times[stage] = self.times.get(stage, 0.0) + seconds

    def record_count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def record_gauge(self, name, value):
        pass


def _tallies(ra):
    """Hits, misses and read seconds: JAX's drained into a recorder, the
    port's as they stand on the object."""
    if hasattr(ra, 'tallies'):
        t = ra.tallies()
        return t['readahead_hits'], t['readahead_misses'], \
            t['readahead_io_s']
    rec = _Recorder()
    ra.drain_stats_into(rec)
    return (rec.counts.get('readahead_hits', 0),
            rec.counts.get('readahead_misses', 0),
            rec.times.get('readahead_io_s', 0.0))


def _script_hits(mod):
    ra = mod.RowGroupReadahead(lambda piece, columns: ('table', piece), 2)
    try:
        ra.sync([_plan(1), _plan(2), _plan(3)])   # depth 2: reads 1 and 2
        out = [ra.take(1)]
        ra.sync([_plan(2), _plan(3)])
        out += [ra.take(2), ra.take(3)]
        return out, _tallies(ra)
    finally:
        ra.stop()


def _script_miss(mod):
    ra = mod.RowGroupReadahead(lambda piece, columns: 'x', 2)
    try:
        return ra.take(99), _tallies(ra)[:2]
    finally:
        ra.stop()


def _script_desync(mod):
    ra = mod.RowGroupReadahead(lambda piece, columns: piece, 2)
    try:
        ra.sync([_plan(1), _plan(2)])
        ra.sync([_plan(5), _plan(6)])     # not a prefix: 1 and 2 cancelled
        return [ra.take(5), ra.take(1)]
    finally:
        ra.stop()


def _script_duplicates(mod):
    served = []
    ra = mod.RowGroupReadahead(
        lambda piece, columns: served.append(piece) or len(served), 3)
    try:
        ra.sync([_plan(7)] * 3)
        return [ra.take(7) for _ in range(3)]
    finally:
        ra.stop()


@pytest.mark.parametrize('script', [_script_hits, _script_miss,
                                    _script_desync, _script_duplicates])
def test_readahead_scripts_give_jax_results(script):
    jax_out, torch_out = script(jreadahead), script(treadahead)
    if script is _script_hits:
        (jv, (jh, jm, jio)), (tv, (th, tm, tio)) = jax_out, torch_out
        assert jv == tv == [('table', 'piece-%d' % k) for k in (1, 2, 3)]
        assert (jh, jm) == (th, tm) == (3, 0) and jio > 0 and tio > 0
    else:
        assert jax_out == torch_out
    if script is _script_miss:
        assert torch_out == (None, (0, 1))
    if script is _script_desync:
        assert torch_out == ['piece-5', None]


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_read_errors_surface_on_take(package):
    def read_fn(piece, columns):
        raise OSError('storage gone')

    ra = PACKAGES[package][1].RowGroupReadahead(read_fn, 1)
    try:
        ra.sync([_plan(1)])
        with pytest.raises(OSError, match='storage gone'):
            ra.take(1)
    finally:
        ra.stop()


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_auto_depth_follows_the_read_to_decode_ratio(package):
    mod = PACKAGES[package][1]

    def slow_read(piece, columns):
        time.sleep(0.02)
        return piece

    ra = mod.RowGroupReadahead(slow_read, 'auto')
    try:
        assert ra.depth == mod.AUTO_INITIAL_DEPTH == 2
        keys = list(range(12))
        for i in keys:
            ra.sync([_plan(k) for k in keys[i:i + mod.AUTO_MAX_DEPTH]])
            ra.take(i)
            time.sleep(0.005)             # the "decode"
        assert 3 <= ra.depth <= mod.AUTO_MAX_DEPTH == 8
    finally:
        ra.stop()


@pytest.mark.parametrize('depth', [-1, 'warp', 1.5])
def test_bad_depths_are_refused_with_jax_words(depth):
    messages = []
    for mod in (jreadahead, treadahead):
        with pytest.raises(ValueError) as e:
            mod.RowGroupReadahead(lambda p, c: None, depth)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    idle = treadahead.RowGroupReadahead(lambda p, c: None, 0)
    assert idle.depth == 0 and idle.take('k') is None
    assert idle.tallies()['readahead_misses'] == 0    # nothing was planned
    idle.stop()


# -- readers ------------------------------------------------------------------

def _read(package, factory, url, **kw):
    """``(idx in delivery order, {idx: (vec bytes, image bytes)}, the
    reader's workers)``; the workers are read before the reader ends."""
    kw.setdefault('shuffle_row_groups', False)
    kw.setdefault('num_epochs', 1)
    make = getattr(package, {'rows': 'make_reader',
                             'columnar': 'make_columnar_reader',
                             'batch': 'make_batch_reader'}[factory])
    order, values = [], {}
    with make(url, **kw) as reader:
        for item in reader:
            if factory == 'rows':
                item = {k: [v] for k, v in item._asdict().items()}
            else:
                item = item._asdict()
            for i, vec, image in zip(item['idx'], item['vec'],
                                     item['image']):
                order.append(int(i))
                values[int(i)] = (np.asarray(vec).tobytes(),
                                  np.asarray(image).tobytes())
        workers = list(getattr(getattr(reader, '_pool', None), 'workers',
                               []))
    return order, values, workers


def _hits(workers):
    tallies = [w.readahead.tallies() for w in workers
               if getattr(w, 'readahead', None) is not None]
    return (sum(t['readahead_hits'] for t in tallies),
            sum(t['readahead_misses'] for t in tallies))


@pytest.mark.parametrize('factory', ['rows', 'columnar', 'batch'])
def test_one_worker_keeps_the_serial_order_and_jax_rows(store, factory):
    jorder, jvalues, _ = _read(petastorm_tpu, factory, store,
                               workers_count=1, io_readahead=2)
    order, values, _ = _read(petastorm_tpu_torch, factory, store,
                             workers_count=1)
    ra_order, ra_values, workers = _read(petastorm_tpu_torch, factory, store,
                                         workers_count=1, io_readahead=2)
    assert ra_order == order == jorder and len(order) == ROWS
    assert ra_values == values == jvalues
    hits, misses = _hits(workers)
    assert hits == ROWS // 8 and misses == 0


@pytest.mark.parametrize('factory', ['rows', 'columnar', 'batch'])
def test_four_workers_give_the_same_set(store, factory):
    _, want, _ = _read(petastorm_tpu_torch, factory, store, workers_count=4)
    order, values, workers = _read(petastorm_tpu_torch, factory, store,
                                   workers_count=4, io_readahead='auto',
                                   shuffle_row_groups=True, seed=1)
    assert sorted(order) == list(range(ROWS)) and values == want
    assert len(workers) == 4 and _hits(workers)[0] > 0


def test_ngram_chunk_path_reads_ahead_as_jax(store):
    fields = {0: ['idx', 'vec'], 1: ['idx']}

    def windows(package, ngram_cls, **kw):
        with package.make_reader(store, schema_fields=ngram_cls(
                fields, 1, 'idx'), workers_count=1, shuffle_row_groups=False,
                **kw) as reader:
            out = [(int(c.columns['idx'][s]),
                    c.columns['vec'][s].tobytes())
                   for c in reader.iter_ngram_chunks() for s in c.starts]
            return out, list(getattr(reader._pool, 'workers', []))

    want, _ = windows(petastorm_tpu, JNGram, io_readahead=2)
    got, workers = windows(petastorm_tpu_torch, NGram, io_readahead=2)
    assert got == want and len(got) == ROWS - ROWS // 8
    assert _hits(workers) == (ROWS // 8, 0)


def test_row_drop_partitions_read_each_group_twice(store):
    jorder, jvalues, _ = _read(petastorm_tpu, 'rows', store, workers_count=1,
                               shuffle_row_drop_partitions=2)
    order, values, workers = _read(petastorm_tpu_torch, 'rows', store,
                                   workers_count=1, io_readahead=2,
                                   shuffle_row_drop_partitions=2)
    assert sorted(order) == sorted(jorder) == list(range(ROWS))
    assert values == jvalues
    # two items a row group, each prefetched: duplicate keys in FIFO order
    assert _hits(workers) == (2 * ROWS // 8, 0)


def test_predicate_items_are_not_prefetched(store):
    jorder, _, _ = _read(petastorm_tpu, 'columnar', store, workers_count=1,
                         predicate=jin_lambda(['idx'],
                                              lambda v: v['idx'] % 3 == 0))
    order, _, workers = _read(petastorm_tpu_torch, 'columnar', store,
                              workers_count=1, io_readahead=2,
                              predicate=in_lambda(
                                  ['idx'], lambda v: v['idx'] % 3 == 0))
    assert order == jorder == list(range(0, ROWS, 3))
    assert _hits(workers)[0] == 0    # read in dependent steps: inline


def test_dummy_pool_turns_readahead_off(store):
    with petastorm_tpu_torch.make_reader(store, reader_pool_type='dummy',
                                         io_readahead=4) as reader:
        assert sum(1 for _ in reader) == ROWS
        assert reader._pool._worker.readahead is None
    with petastorm_tpu_torch.make_reader(store, workers_count=1,
                                         io_readahead=4) as reader:
        assert reader._pool.workers[0].readahead.depth == 4
        assert sum(1 for _ in reader) == ROWS


@pytest.mark.timeout(120)
@pytest.mark.parametrize('pool', ['thread', 'process'])
def test_second_pass_with_prefetches_outstanding(store, pool):
    """``reset`` starts the next pass on the same workers, whose
    readahead may still hold reads of the last pass: they are either a
    prefix of the new hints or cancelled. Every pass gives every row once,
    and with one thread the order is the dummy pool's for the seed."""
    kw = dict(workers_count=1 if pool == 'thread' else 2,
              reader_pool_type=pool, io_readahead=3, seed=5,
              shuffle_row_groups=True)
    passes = []
    with petastorm_tpu_torch.make_columnar_reader(store, **kw) as reader:
        for _ in range(3):
            passes.append([int(i) for b in reader for i in b.idx])
            if len(passes) < 3:
                reader.reset()
        workers = list(getattr(reader._pool, 'workers', []))
    assert all(sorted(p) == list(range(ROWS)) for p in passes)
    if pool == 'thread':
        with petastorm_tpu_torch.make_columnar_reader(
                store, reader_pool_type='dummy', seed=5) as reader:
            serial = []
            for i in range(3):
                serial.append([int(i) for b in reader for i in b.idx])
                if i < 2:
                    reader.reset()
        assert passes == serial
        hits, misses = _hits(workers)
        assert hits == 3 * ROWS // 8 and misses == 0


def test_bad_io_readahead_raises_jax_words(store):
    for bad in (-1, 'fast', 2.5):
        messages = []
        for package in (petastorm_tpu, petastorm_tpu_torch):
            with pytest.raises(ValueError) as e:
                package.make_reader(store, io_readahead=bad)
            messages.append(str(e.value))
        assert messages[0] == messages[1]
        assert 'io_readahead' in messages[1]


def test_thread_pool_hints_a_strict_fifo():
    """With a lookahead of 2 the worker is hinted the whole pending FIFO,
    the current item first, and runs the items in ventilation order."""
    from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                         ThreadPool)

    class Worker:
        prefetch_lookahead = 2

        def __init__(self):
            self.hints, self.ran = [], []

        def prefetch_hint(self, upcoming):
            self.hints.append(list(upcoming))

        def __call__(self, item):
            assert self.hints[-1][0] == item
            self.ran.append(item)
            return item

    worker = Worker()

    class Spec:
        @staticmethod
        def make_worker():
            return worker

    pool = ThreadPool(1)
    pool.start(Spec(), list(range(10)), shuffle=False, max_in_flight=4)
    got = []
    try:
        while True:
            got.append(pool.get_results())
    except EmptyResultError:
        pass
    finally:
        pool.stop()
        pool.join()
    assert got == worker.ran == list(range(10))
    assert all(h == list(range(h[0], min(h[0] + len(h), 10)))
               for h in worker.hints)
    assert max(len(h) for h in worker.hints) == 3
