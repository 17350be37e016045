"""The port's object-store read plane against the JAX package's, on the CPU.

Same inputs into both packages: ``resolve_remote_read`` over a table of
values; ``RangePlanner`` ranges, merges, splits and wasted bytes for
forged footers (dictionary pages, bogus offsets, empty chunks, column
selection) and for the footers of real files over several column sets,
gap sizes and split sizes; ``RangeBuffer`` reads, seeks and fetches over
one scripted call sequence; ``ParallelRangeReader`` row groups equal to
``pq.read_row_group`` and to JAX's, with equal event counts (a long footer
and a single fetch thread included), its footer cache, the planned bytes,
the errors, the ``range_fetch`` spans and ``io_range`` latency; per-range
retry under ``transient-errors``; a same-seed ``trace-replay`` ranged pass
with JAX's injected counts and replayed latency; and the worker's handle
cache keyed on the filesystem's identity.
"""

import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import faultfs as jfaultfs
from petastorm_tpu import objectstore as jobjectstore
from petastorm_tpu import resilience as jresilience
from petastorm_tpu.readers.piece_worker import \
    FileHandleCache as JFileHandleCache

from petastorm_tpu_torch import faultfs as tfaultfs
from petastorm_tpu_torch import objectstore as tobjectstore
from petastorm_tpu_torch import resilience as tresilience
from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM
from petastorm_tpu_torch.readers.piece_worker import FileHandleCache

PKG = {'jax': (jobjectstore, jfaultfs, jresilience),
       'torch': (tobjectstore, tfaultfs, tresilience)}


def _outcome(fn, *args, **kwargs):
    try:
        return ('ok', fn(*args, **kwargs))
    except Exception as e:   # the error and its words are the result
        return ('raise', type(e).__name__, str(e))


@pytest.mark.parametrize('value', [None, 'auto', 'ranged', 'prebuffer',
                                   'serial', 'rangedd', 'coalesced', '',
                                   'RANGED', 3])
def test_resolve_remote_read_as_jax(value):
    assert _outcome(tobjectstore.resolve_remote_read, value) == \
        _outcome(jobjectstore.resolve_remote_read, value)


# -- the planner over forged footers -------------------------------------------

class _Chunk:
    def __init__(self, path_in_schema, data_page_offset,
                 dictionary_page_offset, total_compressed_size):
        self.path_in_schema = path_in_schema
        self.data_page_offset = data_page_offset
        self.dictionary_page_offset = dictionary_page_offset
        self.total_compressed_size = total_compressed_size


class _RowGroup:
    def __init__(self, chunks):
        self._chunks = chunks
        self.num_columns = len(chunks)

    def column(self, i):
        return self._chunks[i]


class _Meta:
    def __init__(self, chunks):
        self._rg = _RowGroup(chunks)

    def row_group(self, _i):
        return self._rg


FORGED = [
    # dictionary page before the data pages, a bogus (after) and an absent
    # dictionary offset, an empty chunk, a nested column path, gaps of
    # every size around the 64 KiB default
    _Meta([_Chunk('a', 1000, 400, 900), _Chunk('b', 5000, 6000, 100),
           _Chunk('c', 7000, None, 300), _Chunk('d', 9000, 0, 0),
           _Chunk('e.list.item', 9100, None, 50)]),
    _Meta([_Chunk('x', 4, None, 1 << 20),
           _Chunk('y', (1 << 20) + 4 + 65536, None, 10),
           _Chunk('z', (1 << 20) + 4 + 65536 + 10 + 65537, None, 10)]),
    _Meta([_Chunk('big', 100, 50, 20 * (1 << 20)),
           _Chunk('tail', 20 * (1 << 20) + 150, None, 7)]),
]
COLUMN_SETS = [None, ['a', 'c'], ['e'], ['x', 'z'], ['big'], ['none'], []]
PLANNERS = [dict(), dict(gap_bytes=0), dict(gap_bytes=65536),
            dict(gap_bytes=1 << 30, max_range_bytes=1 << 20),
            dict(max_range_bytes=1000)]


@pytest.mark.parametrize('meta', range(len(FORGED)))
@pytest.mark.parametrize('options', PLANNERS)
def test_planner_on_forged_footers_as_jax(meta, options):
    md = FORGED[meta]
    t = tobjectstore.RangePlanner(**options)
    j = jobjectstore.RangePlanner(**options)
    for columns in COLUMN_SETS:
        chunks = t.column_chunk_ranges(md, 0, columns)
        assert chunks == j.column_chunk_ranges(md, 0, columns)
        plan = t.plan(md, 0, columns)
        assert plan == j.plan(md, 0, columns)
        assert t.merge(list(reversed(chunks))) == plan
        assert t.wasted_bytes(chunks, plan) == j.wasted_bytes(chunks, plan)


def test_planner_rules():
    md = FORGED[0]
    # a chunk starts at its dictionary page when one precedes its data
    assert tobjectstore.RangePlanner.column_chunk_ranges(md, 0, ['a']) == \
        [(400, 900)]
    # a bogus dictionary offset (after the data) and an empty chunk
    assert tobjectstore.RangePlanner.column_chunk_ranges(md, 0, ['b', 'd']) \
        == [(5000, 100)]
    for options in ({'gap_bytes': -1}, {'max_range_bytes': 0}):
        assert _outcome(tobjectstore.RangePlanner, **options) == \
            _outcome(jobjectstore.RangePlanner, **options)


# -- real files ----------------------------------------------------------------

@pytest.fixture(scope='module')
def parquet_path(tmp_path_factory):
    """One file of 3 row groups: a dictionary-encoded string column,
    numerics, a fixed list column and a nullable one."""
    path = tmp_path_factory.mktemp('objectstore') / 'part_0.parquet'
    n = 60
    rng = np.random.default_rng(0)
    table = pa.table({
        'idx': np.arange(n, dtype=np.int64),
        'value': np.arange(n, dtype=np.float64) * 0.5,
        'label': pa.array(['label_{}'.format(i % 7) for i in range(n)]),
        'vec': pa.array([rng.random(16).astype(np.float32).tolist()
                         for _ in range(n)], pa.list_(pa.float32())),
        'maybe': pa.array([None if i % 3 else i for i in range(n)],
                          pa.int32()),
        'blob': pa.array([rng.bytes(200 + i) for i in range(n)]),
    })
    pq.write_table(table, str(path), row_group_size=20)
    return str(path)


REAL_COLUMNS = [None, ['label'], ['idx', 'blob'], ['vec', 'maybe'],
                ['value', 'label', 'vec']]


@pytest.mark.parametrize('options', PLANNERS)
def test_planner_on_real_footers_as_jax(parquet_path, options):
    md = pq.ParquetFile(parquet_path).metadata
    t = tobjectstore.RangePlanner(**options)
    j = jobjectstore.RangePlanner(**options)
    for rg in range(md.num_row_groups):
        for columns in REAL_COLUMNS:
            chunks = t.column_chunk_ranges(md, rg, columns)
            assert chunks == j.column_chunk_ranges(md, rg, columns)
            assert t.plan(md, rg, columns) == j.plan(md, rg, columns)


def _buffer_script(mod, data):
    """One scripted call sequence over a RangeBuffer: every return value
    and every fallback fetch, in order."""
    fetched, fallbacks, out = [], [], []

    def fetch(offset, length):
        fetched.append((offset, length))
        return data[offset:offset + length]
    buf = mod.RangeBuffer(len(data), fetch, on_fallback=fallbacks.append)
    buf.insert(10, data[10:30])
    buf.insert(50, data[50:60])
    buf.insert(10, data[10:20])          # shorter duplicate: kept longer
    buf.insert(50, data[50:70])          # longer duplicate: replaces
    for op in [('seek', 0, 0), ('read', 15), ('tell',), ('read', 50),
               ('seek', -5, 2), ('read', -1), ('seek', 3, 1),
               ('seek', 200, 0), ('read', 4), ('seek', 12, 0),
               ('read', 8), ('seek', 55, 0), ('read', None), ('size',),
               ('readable',), ('seekable',), ('writable',), ('closed',),
               ('close',), ('closed',)]:
        name, args = op[0], op[1:]
        if name == 'closed':
            out.append(buf.closed)
        else:
            out.append(_outcome(getattr(buf, name), *args))
    return out, fetched, fallbacks


def test_range_buffer_as_jax():
    data = bytes(range(100))
    assert _buffer_script(tobjectstore, data) == \
        _buffer_script(jobjectstore, data)
    out, fetched, fallbacks = _buffer_script(tobjectstore, data)
    assert ('ok', data[0:15]) in out           # covered and fetched spans
    assert fetched and sum(n for _, n in fetched) == sum(fallbacks)


def test_range_buffer_serves_pyarrow(parquet_path):
    """pyarrow reads a row group from a buffer holding only the planned
    ranges and the footer, fetching nothing else."""
    data = open(parquet_path, 'rb').read()
    md = pq.ParquetFile(parquet_path).metadata
    fetched = []

    def fetch(offset, length):
        fetched.append((offset, length))
        return data[offset:offset + length]
    buf = tobjectstore.RangeBuffer(len(data), fetch)
    for offset, length in tobjectstore.RangePlanner().plan(md, 1):
        buf.insert(offset, data[offset:offset + length])
    tail = 64 * 1024
    buf.insert(len(data) - min(tail, len(data)), data[-tail:])
    table = pq.ParquetFile(buf, metadata=md).read_row_group(1)
    assert table.equals(pq.ParquetFile(parquet_path).read_row_group(1))
    assert fetched == []


class _Clean:
    """A counting, faultless wrapper over each package's filesystem."""

    @staticmethod
    def make(name):
        import fsspec
        objectstore, faultfs, _ = PKG[name]
        inner = LOCAL_FILESYSTEM if name == 'torch' \
            else fsspec.filesystem('file')
        return faultfs.FaultyFilesystem(inner,
                                        faultfs.FaultInjector('none', seed=0))


def _read_all(name, path, columns=None, **kwargs):
    objectstore = PKG[name][0]
    fs = _Clean.make(name)
    reader = objectstore.ParallelRangeReader(fs, **kwargs)
    tables = [reader.read_row_group(path, rg, columns=columns)
              for rg in range(3)]
    return tables, reader.take_events(), fs


@pytest.mark.parametrize('columns', REAL_COLUMNS)
@pytest.mark.parametrize('kwargs', [dict(), dict(max_in_flight=1),
                                    dict(footer_bytes=16),
                                    dict(gap_bytes=0, max_range_bytes=512)])
def test_ranged_row_groups_as_jax(parquet_path, columns, kwargs):
    got, got_events, got_fs = _read_all('torch', parquet_path, columns,
                                        **kwargs)
    want, want_events, want_fs = _read_all('jax', parquet_path, columns,
                                           **kwargs)
    plain = pq.ParquetFile(parquet_path)
    for rg, (t, j) in enumerate(zip(got, want)):
        assert t.equals(plain.read_row_group(rg, columns=columns))
        assert t.equals(j)
    assert got_events == want_events
    assert got_events['io_ranged_reads'] == 3
    assert got_fs.bytes_read == want_fs.bytes_read


def test_footer_cache_and_planned_bytes(parquet_path):
    fs = _Clean.make('torch')
    reader = tobjectstore.ParallelRangeReader(fs)
    size, md, (tail_offset, tail) = reader.file_metadata(parquet_path)
    calls = fs.read_calls
    assert reader.file_metadata(parquet_path)[0] == size
    assert fs.read_calls == calls, 'the footer must be cached'
    assert tail_offset + len(tail) == size and md.num_row_groups == 3
    jreader = jobjectstore.ParallelRangeReader(_Clean.make('jax'))
    for rg in range(3):
        assert reader.fetch_row_group_bytes(parquet_path, rg, ['blob']) == \
            jreader.fetch_row_group_bytes(parquet_path, rg, ['blob']) > 0


def test_errors_as_jax(parquet_path, tmp_path):
    bogus = tmp_path / 'not_parquet.bin'
    bogus.write_bytes(b'not a parquet file at all' * 10)

    class Exploding:
        def __init__(self, inner):
            self.inner, self.allow = inner, 1

        def open(self, *args, **kwargs):
            self.allow -= 1
            if self.allow < 0:
                raise OSError('store exploded')
            return self.inner.open(*args, **kwargs)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    for name in PKG:
        objectstore = PKG[name][0]
        fs = _Clean.make(name)
        with pytest.raises(IOError, match='bad trailing magic'):
            objectstore.ParallelRangeReader(fs).file_metadata(str(bogus))
        with pytest.raises(OSError, match='store exploded'):
            objectstore.ParallelRangeReader(Exploding(fs)).read_row_group(
                parquet_path, 0)
        with pytest.raises(ValueError, match='max_in_flight'):
            objectstore.ParallelRangeReader(fs, max_in_flight=0)


def test_spans_and_latency_as_jax(parquet_path):
    def run(name):
        objectstore = PKG[name][0]
        reader = objectstore.ParallelRangeReader(
            _Clean.make(name), observe_spans=True, observe_latency=True)
        for rg in range(3):
            reader.read_row_group(parquet_path, rg)
        spans = reader.take_spans()
        latency = reader.take_latency()
        return ([(s[0], s[1], s[4]['offset'], s[4]['length'])
                 for s in sorted(spans, key=lambda s: s[4]['offset'])],
                latency['io_range']['count'], reader.take_spans(),
                reader.take_latency())
    got, want = run('torch'), run('jax')
    assert got == want
    assert got[1] == len(got[0]) > 3 and got[2] == [] and got[3] is None
    quiet = tobjectstore.ParallelRangeReader(_Clean.make('torch'))
    quiet.read_row_group(parquet_path, 0)
    assert quiet.take_spans() == [] and quiet.take_latency() is None


def _retry_run(name, path):
    objectstore, faultfs, resilience = PKG[name]
    injector = faultfs.FaultInjector('transient-errors', seed=3,
                                     error_rate=1.0)
    fs = faultfs.FaultyFilesystem(_Clean.make(name)._inner, injector)
    io = resilience.ResilientIO(dict(resilience.resolve_retry(True),
                                     initial_backoff_s=0.001))
    reader = objectstore.ParallelRangeReader(fs, resilience=io,
                                             max_in_flight=1)
    tables = [reader.read_row_group(path, rg) for rg in range(3)]
    return (tables, dict(injector.injected), io.take_events(),
            reader.take_events())


def test_per_range_retry_recovers_as_jax(parquet_path):
    got, want = _retry_run('torch', parquet_path), \
        _retry_run('jax', parquet_path)
    plain = pq.ParquetFile(parquet_path)
    for rg in range(3):
        assert got[0][rg].equals(plain.read_row_group(rg))
    assert got[1] == want[1] and got[1]['transient_error'] >= 1
    assert got[2] == want[2] and got[2]['io_retries'] >= 1
    assert got[3] == want[3]


def _trace_run(name, path, seed, in_flight):
    objectstore, faultfs, _ = PKG[name]
    injector = faultfs.FaultInjector('trace-replay', seed=seed,
                                     trace='s3-us-east-1',
                                     latency_scale=0.001,
                                     bandwidth_scale=1000.0)
    reader = objectstore.ParallelRangeReader(
        faultfs.FaultyFilesystem(_Clean.make(name)._inner, injector),
        max_in_flight=in_flight, gap_bytes=0, max_range_bytes=2048)
    for rg in range(3):
        reader.read_row_group(path, rg)
    return (dict(injector.injected),
            {k: round(v, 9) for k, v in injector.injected_s.items()},
            reader.take_events())


@pytest.mark.parametrize('seed', [0, 11])
@pytest.mark.parametrize('in_flight', [1, 8])
def test_trace_replay_ranged_pass_as_jax(parquet_path, seed, in_flight):
    """One seed gives JAX's injected read count and replayed latency (to
    the ns), whatever order the fetch threads finish in."""
    got = _trace_run('torch', parquet_path, seed, in_flight)
    assert got == _trace_run('jax', parquet_path, seed, in_flight)
    assert got == _trace_run('torch', parquet_path, seed, in_flight)
    assert got[0]['trace_reads'] > 0 and got[1]['trace_latency_s'] > 0
    assert got[2]['io_range_requests'] > 3


def test_same_range_redraws_as_jax():
    def tally(mod, n):
        injector = mod.FaultInjector('trace-replay', seed=2,
                                     trace='s3-us-east-1',
                                     latency_scale=1e-6, bandwidth_scale=1e9)
        for _ in range(n):
            injector.trace_delay('/d/p.parquet', 4096, 1024)
        return injector.injected_s['trace_latency_s']
    for n in (1, 2, 3):
        assert tally(tfaultfs, n) == tally(jfaultfs, n)
    assert tally(tfaultfs, 2) != pytest.approx(2 * tally(tfaultfs, 1))


class _Handle:
    def __init__(self, path):
        self.path = path
        self.closed = False

    def close(self):
        self.closed = True


@pytest.mark.parametrize('cls', [FileHandleCache, JFileHandleCache])
def test_handle_cache_keys_on_the_filesystem(cls):
    identity = {'fs': 'clean'}
    cache = cls(_Handle, fs_key=lambda: identity['fs'])
    first = cache.get('/d/p.parquet')
    assert cache.get('/d/p.parquet') is first
    identity['fs'] = 'chaos'
    second = cache.get('/d/p.parquet')
    assert second is not first and not first.closed
    assert '/d/p.parquet' in cache and len(cache) == 2
    cache.invalidate('/d/p.parquet')
    assert first.closed and second.closed
    assert '/d/p.parquet' not in cache and len(cache) == 0


def test_fetch_threads_are_joined(parquet_path):
    before = {t.name for t in threading.enumerate()}
    reader = tobjectstore.ParallelRangeReader(_Clean.make('torch'),
                                              max_range_bytes=512)
    reader.read_row_group(parquet_path, 0)
    left = {t.name for t in threading.enumerate()} - before
    assert not [n for n in left if 'rangeio' in n]
