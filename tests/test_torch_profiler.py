"""The port's roofline profiler against the JAX package's, on the CPU.

The pure functions (``interval_union``, ``attribute``,
``predict_throughput``, ``measured_worker_efficiency``, ``build_profile``,
``explain``, ``roofline_gauges``, ``roofline_summary``, ``advise``,
``replay_against_artifacts``) get the same inputs, made from a seed with
numpy, in both packages and must give equal outputs: the same float
arithmetic in the same order, so equality is exact. ``dataset_digest``
is compared on one store and view. ``calibrate(device='cpu')`` runs the
probes on that store: JAX's artifact keys (the port adds ``device``),
every ceiling positive but the two JAX measures only on an accelerator
with device decode (``device_decode``, ``ingest``), a cache round trip,
and a JAX artifact, or one of another device, read as a miss. Readers of
both packages give profiles with equal keys, the profiler's kill switch
acts alike, and on the card (``cuda``) the staging probe names the card.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import petastorm_tpu
from petastorm_tpu import profiler as jprof

import petastorm_tpu_torch
from petastorm_tpu_torch import materialize_dataset
from petastorm_tpu_torch import profiler as tprof
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS = 64          # 8 files of one 8-row group each

SPAN_NAMES = ('parquet_read', 'readahead_read', 'decode_columns',
              'decode_rows', 'transform', 'serialize', 'deserialize',
              'device_stage', 'train_step', 'queue_wait', 'infeed_wait',
              'process_item', 'ventilate', 'custom_span')


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('profiler') / 'ds')
    schema = Unischema('Prof', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (16, 16, 3),
                       CompressedImageCodec('png'), False)])
    rng = np.random.default_rng(3)
    with materialize_dataset(url, schema, rows_per_file=8) as w:
        w.write_rows({'idx': np.int64(i),
                      'image': rng.integers(0, 255, (16, 16, 3),
                                            dtype=np.uint8)}
                     for i in range(ROWS))
    return url


@pytest.fixture()
def calibration_dir(tmp_path, monkeypatch):
    """Calibration artifacts go to a temporary directory, never to the
    user's cache."""
    target = tmp_path / 'calibration'
    monkeypatch.setenv(tprof.CALIBRATION_DIR_ENV_VAR, str(target))
    return str(target)


# -- seeded inputs ------------------------------------------------------------

def _spans(rng, n=None):
    n = int(rng.integers(0, 40)) if n is None else n
    out = []
    for _ in range(n):
        name = str(rng.choice(SPAN_NAMES))
        start = float(rng.random() * 10.0)
        dur = float(rng.random() * 2.0) * (1 if rng.random() < 0.9 else -1)
        out.append((name, 'cat' if rng.random() < 0.5 else '', start, dur,
                    int(rng.integers(1, 4)), int(rng.integers(1, 9)), None))
    return out


def _snapshot(rng):
    keys = ('worker_io_s', 'readahead_io_s', 'readahead_wait_s',
            'worker_decode_s', 'serialize_s', 'deserialize_s',
            'device_stage_s', 'queue_wait_s', 'worker_publish_wait_s')
    snap = {k: float(rng.random() * 5.0) for k in keys
            if rng.random() < 0.8}
    snap['items_per_s'] = float(rng.random() * 200.0)
    snap['window_s'] = float(1.0 + rng.random() * 10.0) \
        if rng.random() < 0.8 else None
    snap['io_overlap_fraction'] = float(rng.random())
    snap['shared_hits'] = int(rng.integers(0, 50))
    snap['shared_misses'] = int(rng.integers(0, 50))
    return snap


def _ceilings(rng):
    out = {}
    for stage in ('io', 'decode', 'serialize', 'device_stage'):
        if rng.random() < 0.8:
            out[stage] = float(10.0 ** rng.uniform(1, 5))
    return out


def _calibration(rng):
    if rng.random() < 0.15:
        return None
    return {'ceilings': _ceilings(rng),
            'cpu_count': int(rng.integers(1, 17)),
            'rows_per_group': float(rng.integers(0, 3) * rng.random() * 64),
            'host': 'h', 'dataset_digest': 'd'}


def _profile_kwargs(rng):
    return dict(
        spans=_spans(rng) if rng.random() < 0.6 else None,
        samples_per_sec=(float(rng.random() * 5e4)
                         if rng.random() < 0.5 else None),
        workers_count=(int(rng.integers(0, 12))
                       if rng.random() < 0.8 else None),
        io_readahead=[0, 2, 'auto'][int(rng.integers(0, 3))],
        pool_type=['thread', 'process', 'dummy'][int(rng.integers(0, 3))],
        cache_type=['null', 'local-disk', 'shared'][int(rng.integers(0, 3))])


# -- the pure functions -------------------------------------------------------

@pytest.mark.parametrize('seed', range(8))
def test_interval_union_as_jax(seed):
    rng = np.random.default_rng(seed)
    intervals = [tuple(rng.random(2) * 10.0)
                 for _ in range(int(rng.integers(0, 30)))]
    assert tprof.interval_union(intervals) == jprof.interval_union(intervals)


@pytest.mark.parametrize('seed', range(8))
def test_attribute_as_jax(seed):
    rng = np.random.default_rng(100 + seed)
    spans = _spans(rng)
    snapshot = _snapshot(rng)
    wall = float(rng.random() * 20.0) if rng.random() < 0.3 else None
    assert (tprof.attribute(spans, wall_s=wall, snapshot=snapshot)
            == jprof.attribute(spans, wall_s=wall, snapshot=snapshot))
    # the snapshot fallback (tracing off)
    assert (tprof.attribute(None, wall_s=wall, snapshot=snapshot)
            == jprof.attribute(None, wall_s=wall, snapshot=snapshot))


@pytest.mark.parametrize('seed', range(6))
def test_predict_throughput_and_efficiency_as_jax(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(40):
        ceilings = _ceilings(rng)
        kwargs = dict(workers=int(rng.integers(1, 12)),
                      cpu_count=(int(rng.integers(1, 16))
                                 if rng.random() < 0.8 else None),
                      io_overlap=bool(rng.random() < 0.5),
                      in_process=bool(rng.random() < 0.5),
                      cached=bool(rng.random() < 0.3),
                      worker_efficiency=float(rng.uniform(-1, 1)))
        assert (tprof.predict_throughput(ceilings, **kwargs)
                == jprof.predict_throughput(ceilings, **kwargs))
        args = (float(rng.random() * 1e4) if rng.random() < 0.9 else None,
                ceilings.get('decode'), int(rng.integers(0, 8)))
        assert (tprof.measured_worker_efficiency(*args)
                == jprof.measured_worker_efficiency(*args))


@pytest.mark.parametrize('seed', range(16))
def test_build_profile_explain_gauges_summary_advise_as_jax(seed):
    rng = np.random.default_rng(300 + seed)
    snapshot = _snapshot(rng)
    calibration = _calibration(rng)
    kwargs = _profile_kwargs(rng)
    got = tprof.build_profile(dict(snapshot), calibration, **kwargs)
    want = jprof.build_profile(dict(snapshot), calibration, **kwargs)
    assert got == want
    assert tprof.explain(got) == jprof.explain(want)
    assert tprof.roofline_gauges(got) == jprof.roofline_gauges(want)
    assert tprof.roofline_summary(got) == jprof.roofline_summary(want)
    for max_workers in (None, int(rng.integers(1, 32))):
        assert (tprof.advise(got, max_workers=max_workers)
                == jprof.advise(want, max_workers=max_workers))


def test_constants_as_jax():
    for name in ('PROFILER_ENV_VAR', 'CALIBRATION_DIR_ENV_VAR',
                 'PROBE_SCHEMA_VERSION', 'CEILING_STAGES', 'SPAN_STAGE',
                 'IDLE_ATTRIBUTION_STAGES', 'SANE_FRACTION_LIMIT',
                 'PROBE_REPS'):
        assert getattr(tprof, name) == getattr(jprof, name), name
    assert tprof.CALIBRATION_KIND != 'petastorm_tpu_roofline_calibration'


@pytest.mark.parametrize('where', ['repo', 'empty'])
def test_replay_against_artifacts_as_jax(where, tmp_path):
    root = None if where == 'repo' else str(tmp_path)
    got = tprof.replay_against_artifacts(root)
    assert got == jprof.replay_against_artifacts(root)
    assert (len(got) > 0) == (where == 'repo')
    assert all(check['ok'] for check in got)


@pytest.mark.parametrize('value', ['', '1', '0', 'false', 'off', 'on'])
def test_profiler_enabled_as_jax(value, monkeypatch):
    monkeypatch.setenv(tprof.PROFILER_ENV_VAR, value)
    assert tprof.profiler_enabled() == jprof.profiler_enabled()


# -- the store: digest, calibration and its cache ------------------------------

def _jax_view(url):
    with petastorm_tpu.make_reader(url, workers_count=1) as reader:
        return (reader._filesystem_factory(), reader._dataset_path,
                reader._pieces, reader._worker_args['schema'])


def _torch_view(url, **kwargs):
    with petastorm_tpu_torch.make_reader(url, workers_count=1,
                                         **kwargs) as reader:
        return reader.dataset_path, reader.pieces, reader._view


@pytest.mark.parametrize('fields', [None, ['idx']])
def test_dataset_digest_as_jax(store, fields):
    with petastorm_tpu.make_reader(store, workers_count=1,
                                   schema_fields=fields) as reader:
        want = jprof.dataset_digest(reader._pieces,
                                    reader._worker_args['schema'])
        want_pieces = jprof.dataset_digest(reader._pieces)
    _, pieces, view = _torch_view(store, schema_fields=fields)
    assert tprof.dataset_digest(pieces, view) == want
    assert tprof.dataset_digest(pieces) == want_pieces


def test_calibrate_on_cpu_has_jax_keys(store, calibration_dir):
    path, pieces, view = _torch_view(store)
    got = tprof.calibrate(path, pieces, view, save=False, device='cpu')
    fs, jpath, jpieces, jview = _jax_view(store)
    want = jprof.calibrate(fs, jpath, jpieces, jview, save=False)
    assert set(got) == set(want) | {'device'}
    assert got['kind'] == tprof.CALIBRATION_KIND
    assert got['device'] == 'cpu'
    assert got['probe_version'] == want['probe_version'] == 4
    assert got['dataset_digest'] == want['dataset_digest']
    assert set(got['ceilings']) == set(want['ceilings'])
    assert set(got['probes']) == set(want['probes'])
    for probe in ('storage', 'decode', 'serialize'):
        assert set(got['probes'][probe]) == set(want['probes'][probe]), probe
    assert (set(got['probes']['device_stage'])
            == set(want['probes']['device_stage']) | {'device'})
    assert got['probes']['device_stage']['device'] == 'cpu'
    assert set(got['probes']['decode']['per_codec']) \
        == set(want['probes']['decode']['per_codec'])
    for stage in tprof.CEILING_STAGES:
        assert got['ceilings'][stage] > 0, stage
    # not ported: the ranged read (a range reader) and the device-decode
    # gate's two ceilings
    assert got['probes']['storage']['parquet_ranged_rows_per_s'] is None
    assert got['ceilings']['device_decode'] is None
    assert got['ceilings']['ingest'] is None
    assert got['rows_per_group'] == want['rows_per_group'] == 8
    assert not os.path.exists(calibration_dir)        # save=False


def test_calibration_cache_round_trip_and_misses(store, calibration_dir):
    path, pieces, view = _torch_view(store)
    assert tprof.get_calibration(path, pieces, view, mode='cached',
                                 device='cpu') is None
    made = tprof.get_calibration(path, pieces, view, mode='auto',
                                 device='cpu')
    loaded = tprof.get_calibration(path, pieces, view, mode='cached',
                                   device='cpu')
    assert loaded == json.loads(json.dumps(made))
    digest = made['dataset_digest']
    # another device's artifact is a miss: a CPU ceiling never judges a card
    assert tprof.load_calibration(digest, 'NVIDIA H100 80GB HBM3') is None
    # a JAX artifact of the same store is a miss, under another name
    fs, jpath, jpieces, jview = _jax_view(store)
    jcal = jprof.calibrate(fs, jpath, jpieces, jview, save=False)
    jax_file = jprof.save_calibration(jcal)
    ours = tprof.calibration_path(digest, 'cpu')
    assert os.path.basename(jax_file) != os.path.basename(ours)
    assert os.path.dirname(jax_file) == os.path.dirname(ours)
    assert jprof.load_calibration(digest) is not None
    assert tprof.load_calibration(digest, 'cpu') == loaded
    # a JAX artifact written under the port's name is still a miss
    with open(ours, 'w') as f:
        json.dump(dict(jcal, device='cpu'), f)
    assert tprof.load_calibration(digest, 'cpu') is None
    assert jprof.load_calibration(digest) is not None
    # 'force' probes again and overwrites
    again = tprof.get_calibration(path, pieces, view, mode='force',
                                  device='cpu')
    assert tprof.load_calibration(digest, 'cpu')['written_at'] \
        == again['written_at']
    with pytest.raises(ValueError, match='calibration mode'):
        tprof.get_calibration(path, pieces, view, mode='sometimes',
                              device='cpu')


def test_calibrate_without_cuda_raises(store, calibration_dir):
    if torch.cuda.is_available():
        pytest.skip('needs a host without CUDA: the default device is CUDA')
    path, pieces, view = _torch_view(store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprof.calibrate(path, pieces, view, save=False)
    assert not os.path.exists(calibration_dir)


# -- readers --------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_reader_profile_as_jax(store, calibration_dir):
    profiles = {}
    for name, package in (('jax', petastorm_tpu),
                          ('torch', petastorm_tpu_torch)):
        with package.make_reader(store, workers_count=2, num_epochs=2,
                                 trace=True) as reader:
            rows = sum(1 for _ in reader)
            kwargs = {'device': 'cpu'} if name == 'torch' else {}
            profiles[name] = reader.profile(samples_per_sec=1000.0,
                                            **kwargs)
            sentence = reader.explain_throughput(calibrate='cached')
            assert sentence.startswith('measured ')
            snapshot = reader._stats_snapshot()
        assert rows == 2 * ROWS
        assert 'binding_stage' in snapshot and 'roofline_fraction' in snapshot
    got, want = profiles['torch'], profiles['jax']
    assert set(got) == set(want)
    assert set(got['config']) == set(want['config'])
    assert got['config'] == want['config']
    assert got['calibrated'] and want['calibrated']
    assert got['measured_samples_per_s'] == want['measured_samples_per_s']
    assert got['binding_stage'] in tprof.CEILING_STAGES
    assert set(got['attribution']) == set(want['attribution'])


@pytest.mark.timeout(60)
def test_profiler_kill_switch_as_jax(store, calibration_dir, monkeypatch):
    monkeypatch.setenv(tprof.PROFILER_ENV_VAR, '0')
    answers = {}
    for name, package in (('jax', petastorm_tpu),
                          ('torch', petastorm_tpu_torch)):
        with package.make_reader(store, workers_count=1,
                                 debug_port=0) as reader:
            with pytest.raises(RuntimeError) as err:
                reader.profile()
            url = 'http://127.0.0.1:{}/profile'.format(reader.debug_port)
            with pytest.raises(urllib.error.HTTPError) as http:
                urllib.request.urlopen(url, timeout=10)
            answers[name] = (str(err.value), http.value.code,
                             http.value.read().decode())
            for _ in reader:
                pass
    assert answers['torch'] == answers['jax']
    assert answers['torch'][1] == 404
    assert answers['torch'][0] == \
        'the roofline profiler is disabled via PETASTORM_TPU_PROFILER=0'


@pytest.mark.timeout(60)
def test_profile_route_serves_the_last_profile(store, calibration_dir):
    with petastorm_tpu_torch.make_reader(store, workers_count=1,
                                         num_epochs=1,
                                         debug_port=0) as reader:
        for _ in reader:
            pass
        made = reader.profile(device='cpu', samples_per_sec=500.0)
        url = 'http://127.0.0.1:{}/profile'.format(reader.debug_port)
        served = json.loads(urllib.request.urlopen(url, timeout=10).read())
        assert served['from_cache'] is True
        assert served['roofline_fraction'] == made['roofline_fraction']
        assert reader.calibration['device'] == 'cpu'
        record = json.load(open(reader.dump_flight_record(
            path=os.path.join(calibration_dir, 'flight.json'))))
        assert record['roofline'] == tprof.roofline_summary(made)
        # a new pass drops the old pass's profile and gauges
        reader.reset()
        for _ in reader:
            pass
        assert 'roofline_fraction' not in reader._stats_snapshot()


@pytest.mark.cuda
def test_profile_staging_probe_names_the_card(store, calibration_dir):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the staging probe stages to it')
    with petastorm_tpu_torch.make_reader(store, workers_count=2,
                                         num_epochs=1) as reader:
        rows = sum(1 for _ in reader)
        profile = reader.profile(device='cuda', samples_per_sec=rows / 1.0)
    assert profile['calibrated']
    probe = reader.calibration['probes']['device_stage']
    assert probe['device'] == torch.cuda.get_device_name(0)
    assert probe['rows_per_s'] > 0
    assert reader.calibration['device'] == probe['device']
    assert profile['binding_stage'] in tprof.CEILING_STAGES
