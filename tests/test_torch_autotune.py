"""The port's autotune controller and live actuators against the JAX
package's, on the CPU.

The controller runs in lockstep with JAX's: both get the same fake
actuators, snapshots, calibration and injected clock (``tick()`` is
driven directly, never by sleeping through real ticks) and must give
equal action records, reverts, quarantines, ``report()``, ``gauges()`` and
``flight_summary()`` in JAX's cases (decode-bound raises workers, io-bound
raises readahead, revert on regression, hysteresis, the SLO block, a tail
stall raising the queue bound, a data stall raising readahead, grading).
Options resolve alike (typos, the kill switch; ``device`` is the one extra
key), and the host arbiter splits cores alike, also between a JAX and a
port controller on one scratch directory.

Readers of both packages on one store: thread- and process-pool resizes
up and down mid-epoch (and across a pass's end and ``reset()``) with every
audit complete and the same rows; the live readahead depth on a dormant
controlled readahead, inherited by a grown worker, and broadcast to
worker interpreters; the ventilation window's pause, resume and bound; a
live enlargement of the results queue's bound; the kill switch (no
thread, no files); an autotuned reader's routes, gauges and flight-record
sections; ``/autotune`` answering 404 when off; ``infeed_diagnosis(
roofline=)`` equal on one profile.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu import autotune as jat
from petastorm_tpu import profiler as jprof
from petastorm_tpu.jax_utils import infeed_diagnosis as jinfeed
from petastorm_tpu.readers.readahead import RowGroupReadahead as JReadahead

import petastorm_tpu_torch
from petastorm_tpu_torch import autotune as tat
from petastorm_tpu_torch import materialize_dataset
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.readers.readahead import \
    RowGroupReadahead as TReadahead
from petastorm_tpu_torch.torch_utils import infeed_diagnosis as tinfeed
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers.thread_pool import (ThreadPool,
                                                     VentilationJob)

ROWS = 96          # 12 files of one 8-row group each

PACKAGES = {'jax': petastorm_tpu, 'torch': petastorm_tpu_torch}
AUTOTUNE = {'jax': jat, 'torch': tat}


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('autotune') / 'ds')
    schema = Unischema('Tune', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (6,), NdarrayCodec(), False)])
    rng = np.random.default_rng(11)
    with materialize_dataset(url, schema, rows_per_file=8) as w:
        w.write_rows({'idx': np.int64(i),
                      'vec': rng.random(6).astype(np.float32)}
                     for i in range(ROWS))
    return url


@pytest.fixture()
def scratch(tmp_path, monkeypatch):
    """The arbitration scratch directory and the calibration directory,
    both temporary."""
    target = tmp_path / 'autotune_scratch'
    monkeypatch.setenv(tat.AUTOTUNE_DIR_ENV_VAR, str(target))
    monkeypatch.setenv('PETASTORM_TPU_CALIBRATION_DIR',
                       str(tmp_path / 'calibration'))
    return target


# -- the controller in lockstep -----------------------------------------------

class FakeActuators:
    """In-memory actuators; every set_* call is recorded."""

    pool_type = 'thread'

    def __init__(self, workers=1, readahead=0, vent=4, qbound=50):
        self.workers = workers
        self.readahead = readahead
        self.vent = vent
        self.qbound = qbound
        self.calls = []

    def get_workers(self):
        return self.workers

    def set_workers(self, n):
        self.calls.append(('workers', n))
        self.workers = n
        return n

    def get_readahead(self):
        return self.readahead

    def set_readahead(self, k):
        self.calls.append(('readahead', k))
        self.readahead = k
        return k

    def get_vent_window(self):
        return self.vent

    def set_vent_window(self, n):
        self.calls.append(('vent', n))
        self.vent = n
        return n

    def get_queue_bound(self):
        return self.qbound

    def set_queue_bound(self, n):
        self.calls.append(('qbound', n))
        self.qbound = n
        return n

    def reap(self):
        pass


class FakeLatency:
    def __init__(self, p99s, p50):
        self._p99s = p99s
        self._p50 = p50

    def window_p99s(self):
        return dict(self._p99s)

    def quantile(self, stage, q, window=False):
        return self._p50


#: name -> (actuators kwargs, start snapshot, ceilings (None: no
#: calibration), cpu_count, ticks, rate(actuators), controller kwargs)
SCENARIOS = {
    'decode_bound_raises_workers': (
        dict(workers=1, readahead=1), {'worker_decode_s': 5.0,
                                       'worker_io_s': 0.1},
        {'io': 10000.0, 'decode': 100.0}, 4, 10, lambda a: 50, {}),
    'io_bound_raises_readahead': (
        dict(workers=1, readahead=0), {'worker_io_s': 5.0,
                                       'worker_decode_s': 1.0},
        {'io': 100.0, 'decode': 400.0}, 2, 6, lambda a: 50, {}),
    'revert_on_regression': (
        dict(workers=1, readahead=1), {'worker_decode_s': 5.0},
        {'io': 10000.0, 'decode': 100.0}, 4, 8,
        lambda a: 50 if a.workers == 1 else 10, {}),
    'hysteresis_blocks': (
        dict(workers=1, readahead=0), {'worker_io_s': 5.0,
                                       'worker_decode_s': 1.0},
        {'io': 100.0, 'decode': 1000.0}, 2, 5, lambda a: 50,
        {'options': {'hysteresis_pct': 15.0}}),
    'slo_blocks_breach': (
        dict(workers=1, readahead=0), {'worker_io_s': 5.0,
                                       'worker_decode_s': 1.0},
        {'io': 100.0, 'decode': 400.0}, 1, 5, lambda a: 50,
        {'latency': (({'e2e_batch': 0.100, 'queue_wait': 0.001}, 0.0005)),
         'slo_targets': {'p99_e2e_ms': 100.0}}),
    'tail_stall_raises_queue_bound': (
        dict(workers=1, readahead=1, qbound=50), {'worker_decode_s': 1.0,
                                                  'worker_io_s': 1.0},
        None, 4, 6, lambda a: 50,
        {'latency': ({'queue_wait': 0.2}, 0.0001)}),
    'data_stall_raises_readahead': (
        dict(workers=2, readahead=0), {'worker_decode_s': 1.0,
                                       'worker_io_s': 1.0},
        None, 4, 6, lambda a: 50,
        {'stall': True}),
    'grading_perfect_model': (
        dict(workers=1, readahead=1), {'worker_decode_s': 5.0,
                                       'worker_io_s': 0.1},
        {'io': 10000.0, 'decode': 100.0}, 2, 8, lambda a: 50 * a.workers,
        {'options': {'cooldown_ticks': 1}}),
}


def _run_scenario(module, name):
    act_kwargs, start, ceilings, cpu_count, ticks, rate, extra = \
        SCENARIOS[name]
    actuators = FakeActuators(**act_kwargs)
    state = dict(start, items_out=0)
    clock = [0.0]
    stall = extra.get('stall')

    def snapshot():
        out = {'worker_io_s': 0.0, 'worker_decode_s': 0.0,
               'readahead_io_s': 0.0, 'readahead_wait_s': 0.0,
               'worker_publish_wait_s': 0.0, 'queue_wait_s': 0.0,
               'bytes_moved': 0}
        out.update(state)
        return out

    calibration = None if ceilings is None else {
        'ceilings': ceilings, 'cpu_count': cpu_count, 'rows_per_group': 10.0}
    latency = extra.get('latency')
    controller = module.PipelineController(
        actuators, snapshot, calibration_fn=lambda: calibration,
        latency=FakeLatency(*latency) if latency else None,
        slo_targets=extra.get('slo_targets'), options=extra.get('options'),
        clock=lambda: clock[0])
    for _ in range(ticks):
        clock[0] += 5.0
        state['items_out'] += rate(actuators)
        if stall:
            # the consumer waited on data for 80% of every window
            state['goodput_total_s'] = state.get('goodput_total_s', 0) + 5.0
            state['goodput_stall_s'] = state.get('goodput_stall_s', 0) + 4.0
        controller.tick()
    return controller, actuators


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_controller_in_lockstep_with_jax(name):
    tctl, tact = _run_scenario(tat, name)
    jctl, jact = _run_scenario(jat, name)
    assert tact.calls == jact.calls
    assert tctl.actions() == jctl.actions()
    assert tctl.report() == jctl.report()
    assert tctl.gauges() == jctl.gauges()
    assert tctl.flight_summary() == jctl.flight_summary()
    report = tctl.report()
    knobs = [(a['knob'], a['direction']) for a in tctl.actions()]
    if name == 'decode_bound_raises_workers':
        assert tact.workers == 4
        assert knobs == [('workers_count', 'up')] * 3
        assert tact.vent == 4 * (1 + tact.readahead) + 2
    elif name == 'io_bound_raises_readahead':
        assert ('io_readahead', 'up') in knobs
    elif name == 'revert_on_regression':
        assert tact.workers == 1 and report['reverts_total'] == 1
        assert report['quarantined'][0]['knob'] == 'workers_count'
    elif name in ('hysteresis_blocks', 'slo_blocks_breach'):
        assert knobs == [] and tact.calls == []
    elif name == 'tail_stall_raises_queue_bound':
        assert tact.qbound > 50
        assert tctl.actions()[0]['policy'] == 'sensor'
    elif name == 'data_stall_raises_readahead':
        assert tact.readahead >= 2
        first = tctl.actions()[0]
        assert (first['knob'], first['policy']) == ('io_readahead', 'sensor')
        assert tctl.gauges()['autotune_data_stall_fraction'] == 0.8
    elif name == 'grading_perfect_model':
        assert report['prediction']['graded'] >= 1
        assert report['prediction']['direction_accuracy'] == 1.0


def test_controller_survives_a_failing_calibration_as_jax(caplog):
    """A calibration that raises is logged and disables the model moves;
    the sensor moves stay (JAX :453-469)."""
    def boom():
        raise RuntimeError('no card')

    out = {}
    for name, module in AUTOTUNE.items():
        ctl = module.PipelineController(
            FakeActuators(), lambda: {'items_out': 0},
            calibration_fn=boom, clock=lambda: 0.0)
        assert ctl._get_calibration() is None
        out[name] = ctl.report()
    assert out['torch'] == out['jax']
    assert 'autotune calibration failed' in caplog.text


# -- options and arbitration ---------------------------------------------------

OPTION_CASES = [True, False, None, 0, '', {}, {'tick_interval_s': 0.5},
                {'tick_intervall_s': 5}, {'tick_interval_s': 0},
                {'hysteresis_pct': -1}, {'cooldown_ticks': 0},
                {'calibrate': 'sometimes'}, {'calibrate': 'cached',
                                             'max_workers': 3}]


def _resolve(module, value):
    try:
        return ('ok', module.resolve_autotune(value))
    except ValueError as e:
        return ('error', str(e))


@pytest.mark.parametrize('env', ['', '1', '0', 'off', 'on'])
def test_resolve_autotune_as_jax(env, monkeypatch):
    monkeypatch.setenv(tat.AUTOTUNE_ENV_VAR, env)
    for value in OPTION_CASES:
        got, want = _resolve(tat, value), _resolve(jat, value)
        assert got[0] == want[0], value
        if got[0] == 'error':
            # the port's list of valid keys ends with its one extra key
            assert got[1].split('; valid keys')[0] == \
                want[1].split('; valid keys')[0]
        elif want[1] is None:
            assert got[1] is None
        else:
            assert got[1] == dict(want[1], device=None)


def test_device_is_the_one_extra_option():
    assert set(tat.AUTOTUNE_OPTION_KEYS) - set(jat.AUTOTUNE_OPTION_KEYS) \
        == {'device'}
    assert tat.AUTOTUNE_OPTION_KEYS[:-1] == jat.AUTOTUNE_OPTION_KEYS
    assert tat.resolve_autotune({'device': 'cpu'})['device'] == 'cpu'
    with pytest.raises(ValueError, match='unknown autotune option'):
        jat.resolve_autotune({'device': 'cpu'})
    for name in ('AUTOTUNE_ENV_VAR', 'AUTOTUNE_DIR_ENV_VAR', 'KNOBS',
                 'VENT_EXTRA', 'DATA_STALL_SENSOR_THRESHOLD'):
        assert getattr(tat, name) == getattr(jat, name), name
    assert tat._DEFAULT_OPTIONS == dict(jat._DEFAULT_OPTIONS, device=None)


def _arbiter_script(module, directory):
    a = module.HostArbiter(directory, cpu_count=8, tick_interval_s=5.0,
                           controller_id='a')
    b = module.HostArbiter(directory, cpu_count=8, tick_interval_s=5.0,
                           controller_id='b')
    caps = []
    a.publish(deficit=0.9, workers=1)
    caps.append(a.worker_cap(0.9))
    b.publish(deficit=0.1, workers=4)
    caps += [a.worker_cap(0.9), b.worker_cap(0.1)]
    a.publish(deficit=0.0, workers=1)
    b.publish(deficit=0.0, workers=1)
    caps += [a.worker_cap(0.0), b.worker_cap(0.0)]
    stale = os.path.join(directory, 'controller-b.json')
    blob = json.load(open(stale))
    blob['ts'] -= 3600.0
    with open(stale, 'w') as f:
        json.dump(blob, f)
    caps.append(a.worker_cap(0.5))
    a.cleanup()
    b.cleanup()
    return caps, os.listdir(directory)


def test_host_arbiter_splits_as_jax(tmp_path):
    got = _arbiter_script(tat, str(tmp_path / 'torch'))
    assert got == _arbiter_script(jat, str(tmp_path / 'jax'))
    assert got == ([8, 7, 1, 4, 4, 8], [])


def test_jax_and_port_controllers_split_one_host(tmp_path):
    """One scratch directory, one record format: a JAX reader's controller
    and a port reader's split the host's cores between them."""
    directory = str(tmp_path / 'shared')
    jarb = jat.HostArbiter(directory, cpu_count=8, tick_interval_s=5.0,
                           controller_id='jax')
    tarb = tat.HostArbiter(directory, cpu_count=8, tick_interval_s=5.0,
                           controller_id='torch')
    jarb.publish(deficit=0.75, workers=2)
    tarb.publish(deficit=0.25, workers=2)
    assert sorted(p['id'] for p in tarb.peers()) == ['jax', 'torch']
    assert tarb.worker_cap(0.25) == 2 and jarb.worker_cap(0.75) == 6
    jarb.cleanup()
    tarb.cleanup()


def test_scratch_dir_resolution_as_jax(monkeypatch, tmp_path):
    monkeypatch.setenv(tat.AUTOTUNE_DIR_ENV_VAR, str(tmp_path / 'x'))
    for options in (None, {}, {'scratch_dir': '/y'}):
        assert tat.scratch_dir(options) == jat.scratch_dir(options)
    monkeypatch.delenv(tat.AUTOTUNE_DIR_ENV_VAR)
    assert tat.scratch_dir() == jat.scratch_dir()


# -- live actuators on both packages' readers ----------------------------------

def _rows(reader):
    return [int(row.idx) for row in reader]


@pytest.mark.timeout(120)
@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_thread_pool_resize_mid_epoch_keeps_exactly_once(store, package):
    with PACKAGES[package].make_reader(
            store, reader_pool_type='thread', workers_count=2, num_epochs=4,
            shuffle_row_groups=False, io_readahead=1) as reader:
        pool = reader._pool
        seen = []
        for row in reader:
            seen.append(int(row.idx))
            if len(seen) == 30:
                assert pool.resize(4) == 4
            if len(seen) == 200:
                assert pool.resize(1) == 1
        assert sorted(seen) == sorted(list(range(ROWS)) * 4)
        assert pool.workers_count == 1
        assert pool.reap_retired() == 0
        reader.audit().assert_complete()


@pytest.mark.timeout(120)
def test_thread_pool_resize_across_pass_end_and_reset(store):
    with petastorm_tpu_torch.make_reader(
            store, reader_pool_type='thread', workers_count=2, num_epochs=1,
            shuffle_row_groups=False, io_readahead=2) as reader:
        pool = reader._pool
        seen = []
        for row in reader:
            seen.append(int(row.idx))
            if len(seen) == ROWS - 4:
                # the end markers are out: both wait for the next pass
                assert pool.resize(3) == 3
                assert pool.resize(1) == 1
        assert sorted(seen) == list(range(ROWS))
        reader.audit().assert_complete()
        reader.reset()
        assert len(pool.workers) == 1
        second = []
        for row in reader:
            second.append(int(row.idx))
            if len(second) == 10:
                assert pool.resize(3) == 3
        assert sorted(second) == list(range(ROWS))
        reader.audit().assert_complete()
        reader.reset()
        assert len(pool.workers) == 3
        assert sorted(_rows(reader)) == list(range(ROWS))
        reader.audit().assert_complete()


@pytest.mark.timeout(180)
@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_process_pool_resize_mid_epoch_keeps_exactly_once(store, package):
    with PACKAGES[package].make_reader(
            store, reader_pool_type='process', workers_count=2, num_epochs=6,
            shuffle_row_groups=False) as reader:
        pool = reader._pool
        results = {}

        def resizer():
            results['up'] = pool.resize(3, timeout_s=30)
            results['down'] = pool.resize(1, timeout_s=30)

        # the shrink's quiesce needs the consumer draining meanwhile: the
        # controller thread / consumer thread split of a real run
        thread = threading.Thread(target=resizer)
        seen = []
        for row in reader:
            seen.append(int(row.idx))
            if len(seen) == 50:
                thread.start()
        thread.join(timeout=60)
        assert not thread.is_alive()
        assert results == {'up': 3, 'down': 1}
        assert sorted(seen) == sorted(list(range(ROWS)) * 6)
        assert pool.workers_count == 1
        reader.audit().assert_complete()
        if package == 'torch':
            # a second pass on the one worker left
            reader.reset()
            assert sorted(_rows(reader)) == sorted(list(range(ROWS)) * 6)
            reader.audit().assert_complete()


@pytest.mark.timeout(120)
def test_process_pool_live_readahead_depth_reaches_workers(store, scratch):
    with petastorm_tpu_torch.make_reader(
            store, reader_pool_type='process', workers_count=1,
            num_epochs=4, shuffle_row_groups=False,
            autotune=dict(tick_interval_s=3600.0, calibrate='cached',
                          device='cpu')) as reader:
        pool = reader._pool
        seen = []
        for row in reader:
            seen.append(int(row.idx))
            if len(seen) == 16:
                assert reader.stats.snapshot()['readahead_hits'] == 0
                pool.set_readahead_depth(3)
        assert sorted(seen) == sorted(list(range(ROWS)) * 4)
        assert reader.stats.snapshot()['readahead_hits'] > 0
        reader.audit().assert_complete()


@pytest.mark.timeout(60)
@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_dormant_readahead_wakes_on_a_live_depth(store, scratch, package):
    options = dict(tick_interval_s=3600.0, calibrate='cached')
    if package == 'torch':
        options['device'] = 'cpu'
    with PACKAGES[package].make_reader(
            store, reader_pool_type='thread', workers_count=1, num_epochs=3,
            shuffle_row_groups=False, autotune=options) as reader:
        pool = reader._pool
        n = 0
        for _ in reader:
            n += 1
            if n == 16:
                assert reader.stats.snapshot()['readahead_hits'] == 0
                pool.set_readahead_depth(4)
        assert reader.stats.snapshot()['readahead_hits'] > 0
        reader.audit().assert_complete()


@pytest.mark.timeout(60)
def test_grown_worker_inherits_live_readahead_depth(store, scratch):
    with petastorm_tpu_torch.make_reader(
            store, reader_pool_type='thread', workers_count=1, num_epochs=3,
            shuffle_row_groups=False,
            autotune=dict(tick_interval_s=3600.0, calibrate='cached',
                          device='cpu')) as reader:
        pool = reader._pool
        assert pool.workers[0].readahead.depth == 0      # dormant
        pool.set_readahead_depth(3)
        pool.resize(2)
        assert [w.readahead.depth for w in pool.workers] == [3, 3]
        assert sorted(_rows(reader)) == sorted(list(range(ROWS)) * 3)
        reader.audit().assert_complete()


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_readahead_set_depth_pins_and_dormant_as_jax(package):
    cls = {'jax': JReadahead, 'torch': TReadahead}[package]
    ra = cls(lambda piece, columns: piece, 0, controlled=True)
    assert ra.depth == 0
    assert ra.sync([('k1', 'p1', None), ('k2', 'p2', None)]) == 0
    assert ra.take('k1') is None          # dormant: an inline read, no miss
    ra.set_depth(2)
    ra.sync([('k1', 'p1', None), ('k2', 'p2', None)])
    assert ra.take('k1') == 'p1'
    assert ra.take('k2') == 'p2'
    with pytest.raises(ValueError):
        ra.set_depth(-1)
    ra.set_depth(100)
    assert ra.depth == 8                  # capped at AUTO_MAX_DEPTH
    ra.stop()
    # 'auto' under a controller does not retune itself
    auto = cls(lambda piece, columns: piece, 'auto', controlled=True)
    assert auto.depth == 2 and not auto._auto
    auto.stop()


@pytest.mark.timeout(30)
def test_ventilation_window_pause_resume_and_bound():
    job = VentilationJob(list(range(6)), shuffle=False, seed=0,
                         max_in_flight=2)
    stop = threading.Event()
    admitted = []

    def ventilate():
        for item in job.order(1):
            if not job.acquire_slot(stop):
                return
            admitted.append(item)

    assert job.max_in_flight == 2
    job.pause()
    thread = threading.Thread(target=ventilate)
    thread.start()
    time.sleep(0.15)
    assert admitted == [] and job.in_flight == 0     # paused
    job.resume()
    deadline = time.monotonic() + 5
    while len(admitted) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    assert len(admitted) == 2 and job.in_flight == 2  # the bound holds
    job.set_max_in_flight(6)                          # growing admits more
    while len(admitted) < 6 and time.monotonic() < deadline:
        time.sleep(0.01)
    thread.join(5)
    assert admitted == list(range(6)) and job.in_flight == 6
    job.set_max_in_flight(1)                          # shrinking recalls none
    for _ in range(6):
        job.processed_item()
    assert job.in_flight == 0 and job.max_in_flight == 1
    with pytest.raises(ValueError):
        job.set_max_in_flight(0)
    stop.set()


@pytest.mark.timeout(30)
def test_thread_pool_queue_bound_live_enlarge():
    pool = ThreadPool(1, results_queue_size=1)
    assert pool.results_queue_bound == 1
    pool._results.put('a')                 # full at bound 1
    unblocked = threading.Event()

    def putter():
        pool._results.put('b')             # blocks until the bound grows
        unblocked.set()

    thread = threading.Thread(target=putter)
    thread.start()
    time.sleep(0.1)
    assert not unblocked.is_set()
    pool.set_results_queue_bound(4)
    assert unblocked.wait(5)
    thread.join(5)
    assert pool.results_queue_bound == 4
    with pytest.raises(ValueError):
        pool.set_results_queue_bound(0)


# -- kill switch and observability ---------------------------------------------

@pytest.mark.timeout(60)
@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_kill_switch_no_thread_no_files(store, scratch, package,
                                        monkeypatch):
    monkeypatch.setenv(tat.AUTOTUNE_ENV_VAR, '0')
    with PACKAGES[package].make_reader(
            store, reader_pool_type='thread', workers_count=1,
            autotune=True) as reader:
        assert reader.autotune is None
        assert not any(t.name.endswith('-autotune')
                       for t in threading.enumerate())
        assert len(_rows(reader)) == ROWS
    assert not scratch.exists()


@pytest.mark.timeout(60)
def test_dummy_pool_warns_and_runs_no_controller(store, scratch, caplog):
    with petastorm_tpu_torch.make_reader(
            store, reader_pool_type='dummy',
            autotune=dict(device='cpu')) as reader:
        assert reader.autotune is None
        assert len(_rows(reader)) == ROWS
    assert ('autotune disabled: the dummy pool has no live actuators'
            in caplog.text)
    assert not scratch.exists()


def _get(port, route):
    try:
        with urllib.request.urlopen('http://127.0.0.1:{}{}'.format(
                port, route), timeout=10) as response:
            return response.status, response.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.timeout(120)
def test_autotuned_reader_routes_gauges_and_flight_record(store, scratch,
                                                          tmp_path):
    seen = {}
    for package in sorted(PACKAGES):
        options = dict(tick_interval_s=0.1, calibrate='cached')
        if package == 'torch':
            options['device'] = 'cpu'
        with PACKAGES[package].make_reader(
                store, reader_pool_type='thread', workers_count=2,
                num_epochs=10, shuffle_row_groups=False, autotune=options,
                debug_port=0) as reader:
            rows = len(_rows(reader))
            deadline = time.monotonic() + 10
            while reader.autotune.report()['ticks'] < 2 \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            status, body = _get(reader.debug_port, '/autotune')
            report = json.loads(body)
            _, metrics = _get(reader.debug_port, '/metrics')
            snap = reader._stats_snapshot()
            record = json.load(open(reader.dump_flight_record(
                path=str(tmp_path / '{}.json'.format(package)))))
            assert list(scratch.glob('controller-*.json'))
        seen[package] = (rows, status, sorted(report),
                         sorted(report['config']), sorted(report['prediction']),
                         sorted(k for k in snap if k.startswith('autotune_')),
                         sorted(record['autotune']),
                         'petastorm_tpu_autotune_ticks' in metrics)
        assert report['ticks'] >= 2 and report['config']['pool_type'] == \
            'thread'
        assert snap['autotune_workers'] == reader._pool.workers_count
    assert seen['torch'] == seen['jax']
    assert seen['torch'][0] == 10 * ROWS and seen['torch'][1] == 200
    assert seen['torch'][-1] is True
    assert not list(scratch.glob('controller-*.json'))     # cleaned on stop


@pytest.mark.timeout(60)
def test_autotune_route_404_when_off_as_jax(store):
    answers = {}
    for package in sorted(PACKAGES):
        with PACKAGES[package].make_reader(store, workers_count=1,
                                           debug_port=0) as reader:
            answers[package] = _get(reader.debug_port, '/autotune')
            assert len(_rows(reader)) == ROWS
    assert answers['torch'] == answers['jax']
    assert answers['torch'][0] == 404


@pytest.mark.timeout(60)
def test_infeed_diagnosis_roofline_as_jax(store, scratch):
    with petastorm_tpu_torch.make_reader(store, workers_count=2,
                                         num_epochs=2) as reader:
        rows = len(_rows(reader))
        profile = reader.profile(device='cpu', samples_per_sec=rows / 0.5)
        snapshot = reader.diagnostics
    got = tinfeed(snapshot, roofline=profile)
    want = jinfeed(snapshot, roofline=profile)
    assert got == want
    assert got['roofline'] == jprof.roofline_summary(profile)
    # a summary passes through as it is
    summary = jprof.roofline_summary(profile)
    assert tinfeed(snapshot, roofline=summary)['roofline'] == summary


def test_public_names():
    assert petastorm_tpu_torch.PipelineController is tat.PipelineController
    assert petastorm_tpu.PipelineController is jat.PipelineController
    assert 'PipelineController' in petastorm_tpu_torch.__all__
