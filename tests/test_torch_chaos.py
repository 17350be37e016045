"""The port's chaos-hardened read path against the JAX package's.

Both packages read ``create_test_dataset``'s store (32 rows, 2 files) under
one seeded ``PETASTORM_TPU_CHAOS`` scenario. Each filesystem scenario runs
the 2-shard x 2-epoch pass of JAX's ``tests/test_chaos.py`` on the port's
thread and process pools; the delivered ids and the audit verdicts equal
JAX's (its thread pool; its process pool too under ``transient-errors``,
which its own suite runs there). Also: a killed process worker recovers
(respawn, redispatch, ``degraded`` naming ``worker-respawns``) and stays
loud under ``worker_recovery=False``; a poison item is quarantined at
``io_readahead`` 0 and 2 with records equal to JAX's apart from
timestamps; a permanent error and a spent respawn budget stay loud;
``cache-enospc`` degrades both pools to direct decode; a kill during
``resize(4)`` ends at the right size with a complete audit; and a thread
worker killed by a ``BaseException`` reaches the consumer (the hang this
file pins). Every test has a ``timeout`` mark.
"""

import threading
import time

import pytest

import petastorm_tpu
from petastorm_tpu import faultfs as jfaultfs
from petastorm_tpu.test_util.dataset_gen import create_test_dataset
from petastorm_tpu.transform import TransformSpec as JTransformSpec

import petastorm_tpu_torch
from petastorm_tpu_torch import faultfs as tfaultfs
from petastorm_tpu_torch.faultfs import SimulatedWorkerCrash
from petastorm_tpu_torch.health import classify_pipeline
from petastorm_tpu_torch.transform import TransformSpec

pytest.importorskip('zmq')

ROWS = 32
SHARDS = 2
EPOCHS = 2
PACKAGES = {'jax': petastorm_tpu, 'torch': petastorm_tpu_torch}

#: JAX's matrix (``tests/test_chaos.py``): env spec -> extra reader kwargs.
FS_SCENARIOS = {
    'transient-errors': ('transient-errors:101', {}),
    'truncated-reads': ('truncated-reads:202', {}),
    'tail-latency': (
        'tail-latency:303:tail_rate=0.08,tail_latency_s=0.05,'
        'base_latency_s=0.001',
        {'hedge': 0.02}),
    'read-hangs': ('read-hangs:404:hang_rate=0.1,hang_s=0.3',
                   {'hedge': 0.05}),
    'worker-kill': ('worker-kill:505:kill_after_reads=6,max_kills=2', {}),
}


@pytest.fixture(scope='module')
def chaos_dataset(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('chaos') / 'dataset')
    create_test_dataset(url, range(ROWS), num_files=2)
    return url


@pytest.fixture
def chaos_env(monkeypatch):
    """Arm ``PETASTORM_TPU_CHAOS`` for one test, both packages' injector
    caches fresh, so each run replays its scenario from occurrence 0."""
    def arm(value):
        jfaultfs.reset_chaos_cache()
        tfaultfs.reset_chaos_cache()
        monkeypatch.setenv(tfaultfs.CHAOS_ENV_VAR, value)
    yield arm
    jfaultfs.reset_chaos_cache()
    tfaultfs.reset_chaos_cache()


def _verdict(report):
    """What must equal across packages of one audit report."""
    return {epoch: (v['complete'], v['rows_delivered'], v['rows_quarantined'],
                    len(v['dup_items']), len(v['dropped_items']),
                    len(v['quarantined_items']))
            for epoch, v in report['epochs'].items()}


def _sharded_pass(pkg, url, pool_type, reader_kwargs=None, kill=False,
                  fields=('id',)):
    """One 2-shard x 2-epoch pass; ``(sorted ids, verdicts, snapshots)``
    after asserting each shard's audit is complete and each epoch delivered
    the store exactly once across the shards."""
    ids, verdicts, snapshots, reports = [], [], [], []
    for shard in range(SHARDS):
        reader = PACKAGES[pkg].make_reader(
            url, schema_fields=list(fields), reader_pool_type=pool_type,
            workers_count=2, num_epochs=EPOCHS, cur_shard=shard,
            shard_count=SHARDS, seed=17, **(reader_kwargs or {}))
        try:
            iterator = iter(reader)
            got = [int(next(iterator).id)]
            if kill:
                reader._pool._processes[0].kill()
            got += [int(row.id) for row in iterator]
            report = reader.audit().assert_complete()
            ids.extend(got)
            reports.append(report)
            verdicts.append(_verdict(report))
            snapshots.append(reader.stats.snapshot())
        finally:
            reader.stop()
            reader.join()
    for epoch in reports[0]['epochs']:
        rows = sum(r['epochs'][epoch]['rows_delivered'] for r in reports)
        quarantined = sum(r['epochs'][epoch]['rows_quarantined']
                          for r in reports)
        assert rows + quarantined == ROWS
    return sorted(ids), verdicts, snapshots


def _total(snapshots, key):
    return sum(s.get(key, 0) for s in snapshots)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('scenario', sorted(FS_SCENARIOS))
def test_thread_pool_scenario_matches_jax(chaos_dataset, chaos_env,
                                          scenario):
    spec, extra = FS_SCENARIOS[scenario]
    out = {}
    for pkg, fault in (('jax', jfaultfs), ('torch', tfaultfs)):
        chaos_env(spec)
        out[pkg] = _sharded_pass(pkg, chaos_dataset, 'thread', extra)
        injector = fault.chaos_from_env()
        assert injector.injected, (pkg, scenario, 'injected nothing')
        if pkg == 'torch':
            tallies = dict(injector.injected)
    ids, verdicts, snapshots = out['torch']
    assert ids == out['jax'][0] == sorted(list(range(ROWS)) * EPOCHS)
    assert verdicts == out['jax'][1]
    assert sum(tallies.values()) > 0
    if scenario in ('transient-errors', 'truncated-reads'):
        assert _total(snapshots, 'io_retries') > 0
    if scenario == 'worker-kill':
        assert _total(snapshots, 'worker_respawns') >= 1
        assert _total(snapshots, 'items_redispatched') >= 1
    if scenario == 'read-hangs':
        assert _total(snapshots, 'io_hedges') >= 1
        assert _total(snapshots, 'io_hedge_wins') >= 1
    assert _total(snapshots, 'io_permanent_failures') == 0


@pytest.mark.timeout(120)
@pytest.mark.parametrize('scenario', sorted(FS_SCENARIOS))
def test_process_pool_scenario_matches_jax(chaos_dataset, chaos_env,
                                           scenario):
    """The worker interpreters inherit the armed scenario: the port's
    process pool completes exactly once, its ids and verdicts equal to
    JAX's (its process pool under ``transient-errors``, its thread pool
    otherwise). The injector lives in the workers, so the gates are the
    counters they ship."""
    spec, extra = FS_SCENARIOS[scenario]
    chaos_env(spec)
    reference = _sharded_pass(
        'jax', chaos_dataset,
        'process' if scenario == 'transient-errors' else 'thread', extra)
    chaos_env(spec)
    ids, verdicts, snapshots = _sharded_pass('torch', chaos_dataset,
                                             'process', extra)
    assert ids == reference[0]
    assert verdicts == reference[1]
    if scenario in ('transient-errors', 'truncated-reads'):
        assert _total(snapshots, 'io_retries') > 0
    if scenario == 'worker-kill':
        assert _total(snapshots, 'worker_respawns') >= 1
        assert _total(snapshots, 'items_redispatched') >= 1
    assert _total(snapshots, 'io_permanent_failures') == 0


@pytest.mark.timeout(120)
def test_deterministic_by_seed(chaos_dataset, chaos_env):
    """One scenario, seed and access sequence (1 worker, no shuffle): the
    same faults in two runs of the port and in JAX."""
    tallies = []
    for pkg, fault in (('torch', tfaultfs), ('torch', tfaultfs),
                       ('jax', jfaultfs)):
        chaos_env('transient-errors:909')
        with PACKAGES[pkg].make_reader(chaos_dataset, workers_count=1,
                                       shuffle_row_groups=False) as reader:
            for _ in reader:
                pass
            reader.audit().assert_complete()
        tallies.append(dict(fault.chaos_from_env().injected))
    assert tallies[0] == tallies[1] == tallies[2]
    assert tallies[0].get('transient_error', 0) > 0


@pytest.mark.timeout(120)
def test_killed_process_worker_recovers(chaos_dataset):
    ids, _verdicts, snapshots = _sharded_pass('torch', chaos_dataset,
                                              'process', kill=True)
    assert ids == sorted(list(range(ROWS)) * EPOCHS)
    assert _total(snapshots, 'worker_respawns') >= SHARDS
    assert _total(snapshots, 'items_redispatched') >= 1
    verdict = classify_pipeline({}, snapshots[0])
    assert verdict['state'] == 'degraded'
    assert any('worker-respawns' in c for c in verdict['degraded_causes'])


@pytest.mark.timeout(120)
def test_killed_process_worker_stays_loud_without_recovery(chaos_dataset):
    with pytest.raises(RuntimeError, match='died with exit codes'):
        _sharded_pass('torch', chaos_dataset, 'process', kill=True,
                      reader_kwargs=dict(worker_recovery=False))


def _poison_row_transform(row):
    if int(row['id']) == 7:
        raise SimulatedWorkerCrash('poison row')
    return row


def _jax_poison_row_transform(row):
    from petastorm_tpu.faultfs import SimulatedWorkerCrash as JCrash
    if int(row['id']) == 7:
        raise JCrash('poison row')
    return row


def _poison_run(pkg, url, io_readahead):
    spec = (TransformSpec(func=_poison_row_transform) if pkg == 'torch'
            else JTransformSpec(func=_jax_poison_row_transform))
    reader = PACKAGES[pkg].make_reader(
        url, reader_pool_type='thread', workers_count=1, num_epochs=1,
        shuffle_row_groups=False, io_readahead=io_readahead,
        transform_spec=spec,
        worker_recovery=dict(poison_threshold=2, max_respawns=5))
    try:
        ids = sorted(int(row.id) for row in reader)
        report = reader.audit().assert_complete()
        snapshot = reader.stats.snapshot()
        records = [{k: v for k, v in r.items() if k != 'ts'}
                   for r in reader.lineage.quarantines()]
    finally:
        reader.stop()
        reader.join()
    return ids, _verdict(report), snapshot, records


@pytest.mark.timeout(120)
@pytest.mark.parametrize('io_readahead', [0, 2])
def test_poison_item_quarantined_as_jax(tmp_path, io_readahead):
    url = 'file://' + str(tmp_path / 'poison')
    create_test_dataset(url, range(ROWS), num_files=2)
    out = {pkg: _poison_run(pkg, url, io_readahead) for pkg in PACKAGES}
    ids, verdict, snapshot, records = out['torch']
    assert ids == out['jax'][0] and 7 not in ids and len(ids) < ROWS
    assert verdict == out['jax'][1]
    assert records == out['jax'][3]
    assert [r['stage'] for r in records] == ['worker-crash']
    assert snapshot['poison_items_quarantined'] == 1
    assert snapshot['worker_respawns'] == 2
    state = classify_pipeline({}, snapshot)
    assert state['state'] == 'degraded'
    assert any('poison-items' in c for c in state['degraded_causes'])


def _missing_file(row):
    raise FileNotFoundError('/data/part-0007.parquet')


def _always_crash(row):
    raise SimulatedWorkerCrash('every item crashes')


@pytest.mark.timeout(120)
def test_permanent_error_and_spent_budget_stay_loud(tmp_path):
    url = 'file://' + str(tmp_path / 'loud')
    create_test_dataset(url, range(ROWS), num_files=2)
    reader = petastorm_tpu_torch.make_reader(
        url, reader_pool_type='thread', workers_count=1,
        shuffle_row_groups=False, transform_spec=TransformSpec(
            func=_missing_file))
    try:
        with pytest.raises(FileNotFoundError):
            list(reader)
        assert reader.stats.snapshot()['worker_respawns'] == 0
    finally:
        reader.stop()
        reader.join()
    for pool_type in ('thread', 'process'):
        reader = petastorm_tpu_torch.make_reader(
            url, reader_pool_type=pool_type, workers_count=1,
            shuffle_row_groups=False,
            transform_spec=TransformSpec(func=_always_crash),
            worker_recovery=dict(max_respawns=2, poison_threshold=99))
        start = time.monotonic()
        try:
            with pytest.raises((SimulatedWorkerCrash, RuntimeError)):
                for _ in reader:
                    assert time.monotonic() - start < 60
            assert reader.stats.snapshot()['worker_respawns'] == 2
        finally:
            reader.stop()
            reader.join()


@pytest.mark.timeout(120)
@pytest.mark.parametrize('pool_type', ['thread', 'process'])
def test_cache_enospc_degrades_to_direct_decode(chaos_dataset, chaos_env,
                                                tmp_path, pool_type):
    chaos_env('cache-enospc:606')
    kwargs = dict(cache_type='shared',
                  cache_location=str(tmp_path / 'cache'),
                  cache_size_limit=64 * 1024 * 1024,
                  cache_extra_settings={'mem_dir': str(tmp_path / 'mem')})
    ids, _verdicts, snapshots = _sharded_pass('torch', chaos_dataset,
                                              pool_type, kwargs)
    assert ids == sorted(list(range(ROWS)) * EPOCHS)
    assert _total(snapshots, 'shared_put_failures') > 0
    verdict = classify_pipeline({}, snapshots[0])
    assert verdict['state'] == 'degraded'
    assert any('cache-degraded' in c for c in verdict['degraded_causes'])


@pytest.mark.timeout(120)
def test_kill_during_resize_ends_sized_and_complete(chaos_dataset):
    """A worker killed while ``resize(4)`` grows the process pool: the
    replacement joins the grown pool, which ends at 4, and the audit of
    both epochs is complete."""
    reader = petastorm_tpu_torch.make_reader(
        chaos_dataset, schema_fields=['id'], reader_pool_type='process',
        workers_count=2, num_epochs=EPOCHS, seed=17)
    try:
        iterator = iter(reader)
        ids = [int(next(iterator).id)]
        pool = reader._pool
        grow = threading.Thread(target=pool.resize, args=(4,))
        grow.start()
        pool._processes[0].kill()
        ids += [int(row.id) for row in iterator]
        grow.join(30)
        assert not grow.is_alive()
        assert pool.workers_count == 4
        assert len(pool._processes) == 4
        reader.audit().assert_complete()
        assert sorted(ids) == sorted(list(range(ROWS)) * EPOCHS)
        assert reader.stats.snapshot()['worker_respawns'] == 1
    finally:
        reader.stop()
        reader.join()


def _exit_transform(row):
    raise SystemExit('worker killed')


def _jax_exit_transform(row):
    raise SystemExit('worker killed')


@pytest.mark.timeout(30)
@pytest.mark.parametrize('pool_type', ['dummy', 'thread'])
def test_thread_worker_base_exception_reaches_consumer(chaos_dataset,
                                                       pool_type):
    """A worker that dies of a ``BaseException`` reaches the consumer as
    that exception, as in JAX, with recovery off: no pass is left without
    its end marker."""
    for pkg, spec in (('jax', JTransformSpec(func=_jax_exit_transform)),
                      ('torch', TransformSpec(func=_exit_transform))):
        reader = PACKAGES[pkg].make_reader(
            chaos_dataset, schema_fields=['id'], workers_count=1,
            reader_pool_type=pool_type, transform_spec=spec,
            worker_recovery=False)
        try:
            with pytest.raises(SystemExit, match='worker killed'):
                for _ in reader:
                    pass
        finally:
            reader.stop()
            reader.join()


def _result_frames(pool, control, payload=None):
    """One worker message as the pool's results socket takes it."""
    import pickle
    frames = (pool._serializer.serialize_multipart(payload)
              if payload is not None else [b''])
    return [frames[0], pickle.dumps(control)] + list(frames[1:])


@pytest.mark.timeout(60)
def test_recovery_reads_queued_frames_before_it_ends():
    """A consumer back from a long step (the settle window long past) finds
    a survivor's payload and ITEM_DONE queued, its last beat an idle stage
    (``backpressured`` on the high-water mark): the episode must not end
    before the queue is read, or the survivor's item goes out again (a
    duplicate) and its second ITEM_DONE ends the epoch an item early (a
    drop). A duplicated ITEM_DONE counts once."""
    import zmq
    from petastorm_tpu_torch.resilience import DEFAULT_RECOVERY
    from petastorm_tpu_torch.workers import process_pool as pp
    from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                         VentilationJob)
    pool = pp.ProcessPool(2, recovery=dict(DEFAULT_RECOVERY))
    context = zmq.Context()
    pool._results_receiver = context.socket(zmq.PULL)
    pool._results_receiver.bind('inproc://results')
    pool._poller = zmq.Poller()
    pool._poller.register(pool._results_receiver, zmq.POLLIN)
    sender = context.socket(zmq.PUSH)
    sender.connect('inproc://results')
    try:
        pool._job = VentilationJob([], False, 0, max_in_flight=2)
        pool._job.pause()
        long_ago = time.monotonic() - 60.0
        # worker 0 died holding seq 0; survivor worker 1 holds seq 1
        pool._ventilated, pool._ventilation_done = 2, True
        pool._outstanding = {0: 'lost-item', 1: 'survivor-item'}
        pool._recovering = {'awaiting_start': set(),
                            'last_progress': long_ago}
        pool.recoveries = [{'dead': [0], 'codes': [-9], 'began': long_ago,
                            'finalized': None, 'redispatched': 0,
                            'first_redelivery': None}]
        pool._heartbeats = {'worker-1': {'stage': 'backpressured',
                                         'ts': time.perf_counter(),
                                         'pid': -1}}
        pool._last_alive_check = long_ago
        sent = []

        def send_work(message):
            # the replacement takes the item and delivers it
            sent.append(message)
            seq, item = message
            sender.send_multipart(_result_frames(pool, pp._DATA,
                                                 {'item': item}))
            sender.send_multipart(_result_frames(
                pool, (pp._ITEM_DONE, {'seq': seq})))
            return True

        pool._send_work = send_work
        sender.send_multipart(_result_frames(pool, pp._DATA,
                                             {'item': 'survivor-item'}))
        for _ in range(2):
            sender.send_multipart(_result_frames(
                pool, (pp._ITEM_DONE, {'seq': 1})))
        time.sleep(0.05)

        assert pool.get_results() == {'item': 'survivor-item'}
        assert sent == []
        assert pool.recoveries[-1]['finalized'] is None
        # the queue read, the settle window passes on an empty poll
        assert pool.get_results() == {'item': 'lost-item'}
        assert sent == [(0, 'lost-item')]
        with pytest.raises(EmptyResultError):
            pool.get_results()
        assert pool._processed == 2 and not pool._outstanding
        episode = pool.recoveries[-1]
        assert episode['redispatched'] == 1
        assert episode['first_redelivery'] is not None
    finally:
        sender.close(linger=0)
        pool._results_receiver.close(linger=0)
        context.term()
