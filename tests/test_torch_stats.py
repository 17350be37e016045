"""The port's stats plane against the JAX package's.

Units: the key tuples, ``ReaderStats`` fed one call sequence, the derived
fractions, ``bottleneck_signals``, ``infeed_diagnosis`` and
``explain_step`` over the same seeded snapshots, all exact.

The slice as a whole: one store read through both packages on the dummy
pool (the token store's NGram windows through the loader, the 48-row png
store with 3 garbage cells under ``'quarantine'``, a second pass over a
local-disk cache, a shared cache): every deterministic counter, the
latency observation count of every stage and the span count of every
name are equal. On the thread and process pools the snapshot's key set
and the counters that do not depend on scheduling are equal. Tests that
start worker processes carry a ``timeout`` mark.
"""

import collections
import functools
import shutil
import uuid

import numpy as np
import pytest
import torch

import petastorm_tpu
from petastorm_tpu import goodput as jgoodput
from petastorm_tpu import health as jhealth
from petastorm_tpu import latency as jlat
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.jax_utils import infeed_diagnosis as jdiagnosis
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.predicates import in_lambda as jin_lambda
from petastorm_tpu.sharedcache import SharedRowGroupCache as JSharedCache
from petastorm_tpu.transform import TransformSpec as JTransformSpec
from petastorm_tpu.workers import stats as jstats

import petastorm_tpu_torch
from petastorm_tpu_torch import TorchDataLoader, materialize_dataset
from petastorm_tpu_torch import goodput as tgoodput
from petastorm_tpu_torch import health as thealth
from petastorm_tpu_torch import latency as tlat
from petastorm_tpu_torch import torch_utils
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops import decode as tdecode
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers import stats as tstats

from test_torch_lineage import POISON, _open, _write, corrupt_cells

#: counters whose value depends on the data alone, not on scheduling
DETERMINISTIC = ('items_out', 'rows_quarantined', 'items_quarantined',
                 'rows_decoded_batched', 'rows_decoded_percell',
                 'rows_decoded_device', 'bytes_shipped_raw', 'shared_hits',
                 'shared_misses', 'payload_frames', 'payload_copies')

TOKEN_ROWS = 40
TOKEN_LEN = 16


@pytest.fixture(scope='module')
def png_store(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp('stats') / 'png'))


@pytest.fixture(scope='module')
def corrupt_store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('stats') / 'corrupt')
    url = _write(path)
    corrupt_cells(path, 'image', POISON)
    return url


@pytest.fixture(scope='module')
def token_store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('stats') / 'tokens')
    schema = Unischema('Tokens', [
        UnischemaField('step', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (TOKEN_LEN,), NdarrayCodec(),
                       False)])
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 500, (TOKEN_ROWS, TOKEN_LEN), dtype=np.int32)
    with materialize_dataset('file://' + path, schema,
                             row_group_size_mb=0.001,
                             rows_per_file=TOKEN_ROWS // 2) as w:
        w.write_rows({'step': np.int64(i), 'tokens': tokens[i]}
                     for i in range(TOKEN_ROWS))
    return 'file://' + path


# -- units --------------------------------------------------------------------

def test_key_tuples_match_jax():
    for name in ('TIME_STAGES', 'COUNTERS', 'GAUGES', 'DERIVED',
                 'GOODPUT_DERIVED', 'LATENCY_HISTOGRAMS_KEY'):
        assert getattr(tstats, name) == getattr(jstats, name), name
    assert tstats.stage_keys() == jstats.stage_keys()


def _feed(module, seed):
    rng = np.random.default_rng(seed)
    stats = module.ReaderStats()
    for stage in module.TIME_STAGES:
        stats.add_time(stage, float(rng.uniform(0, 2)))
    stats.merge_times({'worker_io_s': 0.5, 'readahead_io_s': 1.0})
    for name in module.COUNTERS:
        stats.add(name, int(rng.integers(0, 50)))
    stats.merge_counts({'items_out': 3, 'payload_copies': 1})
    stats.merge_counts(None)
    for name in module.GAUGES:
        for value in rng.integers(0, 9, 3):
            stats.gauge(name, int(value))
    stats.merge_gauges({'queue_depth': 11, 'readahead_depth': 1})
    for v in rng.lognormal(-5, 1, 40):
        stats.record_latency('queue_wait', float(v))
        stats.record_latency('e2e_batch', float(v) * 3)
    with stats.timed('deserialize_s'):
        pass
    return stats


def _without_window(snapshot):
    """A snapshot without its wall-clock keys (the window and its rates,
    and ``deserialize_s``, which :meth:`ReaderStats.timed` measured)."""
    return {k: v for k, v in snapshot.items()
            if k not in ('window_s', 'items_per_s', 'mb_per_s',
                         'deserialize_s')}


@pytest.mark.parametrize('seed', [0, 1])
def test_reader_stats_snapshot_matches_jax(seed):
    """One call sequence into both: equal snapshots apart from the window's
    wall-clock keys (exact)."""
    ref, got = _feed(jstats, seed), _feed(tstats, seed)
    want, have = ref.snapshot(), got.snapshot()
    assert tuple(k for k in have if not k.startswith(
        ('_', 'goodput_fraction', 'data_stall'))) == tstats.stage_keys()
    assert _without_window(have) == _without_window(want)
    assert have['goodput_fraction'] == want['goodput_fraction']
    for stats in (ref, got):
        stats.reset()
    assert (_without_window(got.snapshot())
            == _without_window(ref.snapshot()))
    assert 'goodput_fraction' not in got.snapshot()


def _snapshots():
    """Seeded snapshots over the bottleneck regimes (io, decode, consumer,
    balanced, tail stall, slow object store, slow peer cache, empty)."""
    rng = np.random.default_rng(5)
    out = [{}]
    for io_s, decode_s, publish, p50, p99, rng_p99, peer_p99 in (
            (5.0, 1.0, 0.0, 0.001, 0.002, 0.0, 0.0),
            (1.0, 5.0, 0.0, 0.001, 0.002, 0.0, 0.0),
            (1.0, 1.0, 9.0, 0.001, 0.002, 0.0, 0.0),
            (1.0, 1.2, 0.0, 0.001, 0.002, 0.0, 0.0),
            (1.0, 1.0, 0.0, 0.0001, 0.2, 0.0, 0.0),
            (5.0, 1.0, 0.0, 0.001, 0.002, 2.0, 0.0),
            (1.0, 1.0, 0.0, 0.001, 0.002, 0.0, 0.5)):
        snapshot = {'worker_io_s': io_s, 'worker_decode_s': decode_s,
                    'readahead_io_s': float(rng.uniform(0, 1)),
                    'readahead_wait_s': float(rng.uniform(0, 0.2)),
                    'worker_publish_wait_s': publish,
                    'queue_wait_p50_s': p50, 'queue_wait_p99_s': p99,
                    'io_range_p99_s': rng_p99, 'peer_fetch_p99_s': peer_p99,
                    'readahead_hits': int(rng.integers(0, 9)),
                    'readahead_misses': int(rng.integers(0, 9)),
                    'rows_decoded_batched': int(rng.integers(0, 9)),
                    'rows_decoded_percell': int(rng.integers(0, 9)),
                    'rows_decoded_device': int(rng.integers(0, 9)),
                    'goodput_total_s': float(rng.uniform(0, 2)),
                    'goodput_device_s': 0.5, 'goodput_stall_s': 0.1,
                    'goodput_h2d_s': 0.05, 'prefetch_occupancy': 1,
                    'items_out': 7, 'bytes_moved': 9}
        out.append(snapshot)
    return out


@pytest.mark.parametrize('index', range(8))
def test_derived_fractions_and_signals_match_jax(index):
    snapshot = _snapshots()[index]
    for name in ('effective_io_s', 'progress_marker', 'readahead_hit_rate',
                 'batched_decode_fraction', 'device_decode_fraction',
                 'goodput_fraction', 'data_stall_fraction',
                 'recommend_io_readahead'):
        assert (getattr(tstats, name)(snapshot)
                == getattr(jstats, name)(snapshot)), name
    assert (thealth.bottleneck_signals(snapshot)
            == jhealth.bottleneck_signals(snapshot))
    for name in ('SLOW_RANGE_FETCH_P99_S', 'SLOW_PEER_FETCH_P99_S'):
        assert getattr(thealth, name) == getattr(jhealth, name)


def test_finalize_item_times_matches_jax():
    for times, elapsed, transport in (({}, 1.0, 0.0),
                                      ({'worker_io_s': 0.4}, 1.0, 0.2),
                                      ({'worker_io_s': 2.0,
                                        'worker_decode_s': 0.1}, 1.0, 0.5)):
        assert (tstats.finalize_item_times(dict(times), elapsed, transport)
                == jstats.finalize_item_times(dict(times), elapsed,
                                              transport))


@pytest.mark.parametrize('index', range(8))
def test_infeed_diagnosis_matches_jax(index):
    """Equal dicts on the same snapshot, with a latency plane and an SLO
    verdict embedded (exact)."""
    snapshot = _snapshots()[index]
    planes = []
    for m in (jlat, tlat):
        plane = m.PipelineLatency(clock=lambda: 0.0)
        for v in np.random.default_rng(index).lognormal(-5, 1, 30):
            plane.record('queue_wait', float(v))
        planes.append(plane)
    verdict = {'breached': False}
    assert (torch_utils.infeed_diagnosis(snapshot, latency=planes[1],
                                         slo=verdict)
            == jdiagnosis(snapshot, latency=planes[0], slo=verdict))
    assert torch_utils.infeed_diagnosis(snapshot) == jdiagnosis(snapshot)


def test_infeed_diagnosis_refuses_later_slices():
    # heartbeats came with the health slice: an empty pipeline is healthy,
    # as in JAX; the roofline came with the profiler slice: a section that
    # is no profile passes through as it is, as in JAX
    assert (torch_utils.infeed_diagnosis({}, heartbeats={})
            == jdiagnosis({}, heartbeats={}))
    got = torch_utils.infeed_diagnosis({}, roofline={'kind': 'x'})
    assert got == jdiagnosis({}, roofline={'kind': 'x'})
    assert got['roofline'] == {'kind': 'x'}


@pytest.mark.parametrize('index', range(8))
def test_explain_step_walks_a_snapshot_as_jax(index):
    snapshot = _snapshots()[index]
    monitors = (jgoodput.GoodputMonitor(), tgoodput.GoodputMonitor())
    for m in monitors:
        m.note_fetch(0.4)
        m.note_stage(0.1)
        m.finish_step(0.05)
    want, got = (m.explain_step(snapshot=snapshot) for m in monitors)
    assert got == want and got['verdict'] == 'data-stall'


# -- the slice as a whole -----------------------------------------------------

def _summary(reader):
    """``(deterministic counters, latency counts by stage, span counts by
    name)`` of a reader after its pass."""
    snapshot = reader.stats.snapshot()
    counters = {k: snapshot[k] for k in DETERMINISTIC}
    latency = {stage: state['count'] for stage, state in snapshot.get(
        tstats.LATENCY_HISTOGRAMS_KEY, {}).items()}
    spans = collections.Counter(s[0] for s in reader.tracer.spans())
    return counters, latency, spans


def _loader(package, reader):
    return (JaxDataLoader(reader, batch_size=4) if package == 'jax'
            else TorchDataLoader(reader, batch_size=4, device='cpu'))


def _pass(package, kind, url, loader=False, **kw):
    with _open(package, kind, url, reader_pool_type='dummy', num_epochs=1,
               seed=0, trace=True, **kw) as reader:
        if loader:
            batches = sum(1 for _ in _loader(package, reader))
        else:
            batches = sum(1 for _ in reader)
    return batches, _summary(reader)


def _ngram(package):
    return (JNGram if package == 'jax' else NGram)(
        {0: ['step', 'tokens'], 1: ['tokens']}, delta_threshold=1,
        timestamp_field='step')


@pytest.mark.parametrize('kind,extra', [
    (kind, extra) for kind in ('row', 'columnar', 'batch')
    for extra in ('plain', 'row_drop', 'local_disk')
    # make_batch_reader takes no row-drop partitions
    if (kind, extra) != ('batch', 'row_drop')])
def test_png_quarantine_pass_matches_jax(corrupt_store, kind, extra,
                                         tmp_path):
    """The 48-row png store with 3 garbage cells under 'quarantine' on the
    dummy pool: counters, latency counts and span counts equal (exact)."""
    got = {}
    for package in ('jax', 'torch'):
        kw = {'on_decode_error': 'quarantine'}
        if extra == 'row_drop':
            kw['shuffle_row_drop_partitions'] = 2
        if extra == 'local_disk':
            kw.update(cache_type='local-disk', cache_size_limit=1 << 30,
                      cache_location=str(tmp_path / package))
        got[package] = [_pass(package, kind, corrupt_store, **kw)
                        for _ in range(2 if extra == 'local_disk' else 1)]
    assert got['torch'] == got['jax']
    counters = got['torch'][0][1][0]
    if kind != 'batch':
        assert counters['rows_quarantined'] == (6 if extra == 'row_drop'
                                                else 3)
        assert counters['rows_decoded_percell'] > 0
    if extra == 'local_disk':       # the second pass decodes nothing
        assert got['torch'][1][1][0]['rows_decoded_batched'] == 0


def test_token_ngram_through_the_loader_matches_jax(token_store):
    got = {p: _pass(p, 'row', token_store, loader=True,
                    schema_fields=_ngram(p)) for p in ('jax', 'torch')}
    assert got['torch'] == got['jax']
    batches, (counters, latency, spans) = got['torch']
    assert latency['train_step'] == latency['infeed_wait'] == batches
    assert spans['step'] == spans['train_step'] == batches
    assert counters['rows_decoded_batched'] == TOKEN_ROWS


@pytest.mark.parametrize('case', ['row_predicate', 'ngram_predicate',
                                  'columnar_predicate', 'row_transform',
                                  'columnar_transform', 'batch_transform',
                                  'device_decode', 'row_loader'])
def test_reader_paths_match_jax(png_store, case, monkeypatch):
    """Each path draws the decode path line where JAX does: the row
    reader's predicate and NGram loads (decoded row by row in JAX) count no
    path and span ``decode_rows`` (exact)."""
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR,
                       'on' if case == 'device_decode' else 'off')
    kind = case.split('_')[0]
    if kind == 'ngram':
        kind = 'row'
    got = {}
    for package in ('jax', 'torch'):
        kw, loader = {}, case in ('device_decode', 'row_loader')
        if 'predicate' in case:
            kw['predicate'] = (jin_lambda if package == 'jax' else in_lambda)(
                ['idx'], lambda v: v['idx'] % 3 == 0)
        if case == 'ngram_predicate':
            kw['schema_fields'] = (JNGram if package == 'jax' else NGram)(
                {0: ['idx', 'matrix'], 1: ['idx']}, 1, 'idx')
        if 'transform' in case:
            kw['transform_spec'] = (JTransformSpec if package == 'jax'
                                    else TransformSpec)(lambda x: x)
        if case == 'device_decode':
            kind = 'columnar'
        got[package] = _pass(package, kind, png_store, loader=loader, **kw)
    assert got['torch'] == got['jax']
    counters, _, spans = got['torch'][1]
    if case in ('row_predicate', 'ngram_predicate'):
        assert counters['rows_decoded_batched'] == 0
        assert counters['rows_decoded_percell'] == 0
        assert spans['decode_rows'] > 0 and 'decode_columns' not in spans
    if case == 'device_decode':
        assert counters['rows_decoded_device'] == 48
        assert counters['bytes_shipped_raw'] > 0


def test_shared_cache_hits_and_misses_match_jax(png_store, tmp_path,
                                                request):
    """Each cache's tier 0 lives under ``/dev/shm`` at a name hashed from
    its root, and outlives the root: a root under a ``uuid4`` segment
    cannot meet one an earlier run filled, and a finalizer removes the
    tier-0 directories this test made."""
    run = uuid.uuid4().hex
    got = {}
    for package in ('jax', 'torch'):
        root = str(tmp_path / run / package)
        cache = JSharedCache if package == 'jax' else SharedRowGroupCache
        request.addfinalizer(functools.partial(
            shutil.rmtree, cache._default_mem_dir(root), ignore_errors=True))
        kw = dict(cache_type='shared', cache_size_limit=1 << 30,
                  cache_location=root)
        got[package] = [_pass(package, 'columnar', png_store, **kw)[1][0]
                        for _ in range(2)]
    assert got['torch'] == got['jax']
    assert got['torch'][0]['shared_misses'] == 8
    assert got['torch'][1]['shared_hits'] == 8


def _keys_and_counters(package, kind, url, pool, **kw):
    with _open(package, kind, url, reader_pool_type=pool, workers_count=2,
               num_epochs=1, seed=0, on_decode_error='quarantine',
               **kw) as reader:
        rows = sum(1 for _ in reader)
        diagnostics = reader.diagnostics
    return (rows, sorted(diagnostics),
            {k: diagnostics[k] for k in DETERMINISTIC})


@pytest.mark.parametrize('kind', ['row', 'columnar', 'batch'])
def test_thread_pool_keys_and_counters_match_jax(corrupt_store, kind):
    got = [_keys_and_counters(p, kind, corrupt_store, 'thread')
           for p in ('jax', 'torch')]
    assert got[1] == got[0]


@pytest.mark.timeout(120)
@pytest.mark.parametrize('kind', ['row', 'columnar', 'batch'])
def test_process_pool_keys_and_counters_match_jax(corrupt_store, kind):
    got = [_keys_and_counters(p, kind, corrupt_store, 'process')
           for p in ('jax', 'torch')]
    assert got[1] == got[0]
    assert got[1][2]['payload_frames'] >= got[1][2]['items_out'] > 0


@pytest.mark.timeout(120)
def test_process_pool_zero_copy_counts(token_store, monkeypatch):
    """Device decode on the process pool: the raw grids cross as
    out-of-band frames with no copy, and the loader's staging counts the
    planned cells."""
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'on')
    with petastorm_tpu_torch.make_columnar_reader(
            token_store, reader_pool_type='process', workers_count=2,
            num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=4, device='cpu')
        batches = list(loader.iter_prefetched())
        snapshot = reader.diagnostics
    rows = sum(len(b['tokens']) for b in batches)
    assert rows == TOKEN_ROWS
    assert snapshot['payload_copies'] == 0 and snapshot['bytes_moved'] > 0
    assert snapshot['rows_decoded_device'] == rows * 1
    assert snapshot['bytes_shipped_raw'] > rows * TOKEN_LEN * 4


def test_staging_records_device_stage_and_occupancy(png_store):
    with petastorm_tpu_torch.make_columnar_reader(
            png_store, reader_pool_type='dummy', num_epochs=1,
            trace=True) as reader:
        loader = TorchDataLoader(reader, batch_size=4, device='cpu')
        staged = list(loader.iter_prefetched())
        snapshot = reader.diagnostics
        spans = collections.Counter(s[0] for s in reader.tracer.spans())
    assert spans['device_stage'] == len(staged) == spans['train_step']
    assert snapshot['device_stage_s'] > 0
    assert reader.latency.histograms['device_stage'].count == len(staged)
    assert snapshot['prefetch_occupancy_max'] >= 1
    assert snapshot['goodput_total_s'] > 0 and 'goodput_fraction' in snapshot
    # the monitor took the reader's planes
    assert loader.goodput.stats is reader.stats
    assert loader.goodput.tracer is reader.tracer


def test_prefetch_to_device_alone_records_into_given_planes():
    stats = tstats.ReaderStats()
    tracer = petastorm_tpu_torch.tracing.Tracer()
    batches = [{'x': np.arange(4)} for _ in range(5)]
    out = list(torch_utils.prefetch_to_device(iter(batches), 2, device='cpu',
                                              stats=stats, tracer=tracer))
    assert [torch.equal(b['x'], torch.arange(4)) for b in out] == [True] * 5
    assert stats.latency.histograms['device_stage'].count == 5
    assert len([s for s in tracer.spans() if s[0] == 'device_stage']) == 5


def test_reader_properties(png_store):
    with petastorm_tpu_torch.make_columnar_reader(
            png_store, reader_pool_type='dummy', num_epochs=1,
            slo={'p99_e2e_ms': 1e6, 'min_samples_per_s': 0,
                 'eval_interval_s': 0}) as reader:
        list(reader)
        assert reader.stats is reader._pool.stats
        assert reader.latency is reader.stats.latency
        assert reader.tracer is None
        verdict = reader.slo.evaluate()
        assert verdict['checks']['p99_e2e_ms']['ok'] is True
        assert not verdict['breached']
        assert set(tstats.stage_keys()) <= set(reader.diagnostics)
    with pytest.raises(ValueError, match='unknown slo target'):
        petastorm_tpu_torch.make_reader(png_store, slo={'p99': 1})


def test_readahead_stats_reach_the_reader(png_store):
    with petastorm_tpu_torch.make_columnar_reader(
            png_store, reader_pool_type='thread', workers_count=1,
            io_readahead=2, num_epochs=1, trace=True) as reader:
        list(reader)
        snapshot = reader.diagnostics
        spans = collections.Counter(s[0] for s in reader.tracer.spans())
    assert snapshot['readahead_hits'] + snapshot['readahead_misses'] == 8
    assert snapshot['readahead_hits'] > 0
    assert snapshot['readahead_io_s'] > 0
    assert spans['readahead_read'] + spans['parquet_read'] == 8
