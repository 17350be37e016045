"""The port's elastic pod membership against the JAX package's.

On the 240-row store of JAX's ``tests/test_podelastic.py``: the constants;
``rendezvous_assign`` over a grid of lease counts and host sets, a death
and a join included; ``LeasePlan`` (bounds, batch rows over seed, epoch,
lease and batch, JAX's errors); scripted ``PodMembership`` and
``LeaseLedger`` sequences with equal records; ``ElasticPodSim`` over each
package's own ``IndexedDatasetReader`` clean and under ``host-death`` and
``host-join`` for three seeds each (equal reports, equal coordination
records, equal delivered batches, one seed's replay); each package's
auditor certifying the other's ledger and naming the same drop;
``resolve_elastic_shard`` and the three factories' ``elastic=`` on the
same member files (equal shards and errors); the kill switch; the pod
merge of the hosts' elastic sections; the flight record's ``elastic``
section; and phase 23 (a) of ``chip_smoke.py`` on the CPU at a small
width. Everything is compared exactly. One test needs the card and skips
here.
"""

import argparse
import json
import os
import threading

import numpy as np
import pytest
import torch

import petastorm_tpu
from petastorm_tpu import faultfs as jfaultfs
from petastorm_tpu import health as jhealth
from petastorm_tpu import podelastic as jelastic
from petastorm_tpu import podobs as jpodobs
from petastorm_tpu.indexed import IndexedDatasetReader as JIndexed

import petastorm_tpu_torch
from petastorm_tpu_torch import faultfs as tfaultfs
from petastorm_tpu_torch import health as thealth
from petastorm_tpu_torch import materialize_dataset
from petastorm_tpu_torch import podelastic as telastic
from petastorm_tpu_torch import podobs as tpodobs
from petastorm_tpu_torch.codecs import ArrowListCodec, ScalarCodec
from petastorm_tpu_torch.indexed import IndexedDatasetReader as TIndexed
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ELASTIC = {'jax': jelastic, 'torch': telastic}
INDEXED = {'jax': JIndexed, 'torch': TIndexed}
FACTORY = {'jax': petastorm_tpu, 'torch': petastorm_tpu_torch}
ROWS = 240
BATCH = 8
DEATHS = ('host-death:42', 'host-death:2', 'host-death:101')
JOINS = ('host-join:7', 'host-join:13', 'host-join:3')


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    path = tmp_path_factory.mktemp('podelastic') / 'ds'
    schema = Unischema('ElasticSchema', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (4,), ArrowListCodec(), False)])
    rng = np.random.default_rng(3)
    with materialize_dataset('file://' + str(path), schema,
                             row_group_size_mb=0.001) as w:
        w.write_rows({'idx': np.int64(i),
                      'vec': rng.standard_normal(4).astype(np.float32)}
                     for i in range(ROWS))
    return 'file://' + str(path)


@pytest.fixture
def no_chaos(monkeypatch):
    monkeypatch.delenv('PETASTORM_TPU_CHAOS', raising=False)
    monkeypatch.delenv('PETASTORM_TPU_ELASTIC', raising=False)
    _reset()
    yield
    _reset()


def _reset():
    jfaultfs.reset_chaos_cache()
    tfaultfs.reset_chaos_cache()


def _records(root):
    """Every coordination record under ``root``: ``{relative path: JSON}``."""
    out = {}
    for sub in ('members', 'leases', 'delivered'):
        d = os.path.join(root, sub)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            with open(os.path.join(d, name)) as f:
                out[sub + '/' + name] = json.load(f)
    return out


# -- units --------------------------------------------------------------------

def test_constants_as_jax():
    for name in ('ELASTIC_ENV_VAR', 'MEMBERS_DIR', 'LEASES_DIR',
                 'DELIVERED_DIR', 'RECORD_VERSION', 'DEFAULT_TTL_BEATS',
                 'ELASTIC_COUNTERS'):
        assert getattr(telastic, name) == getattr(jelastic, name), name
    assert issubclass(telastic.ElasticConfigError, ValueError)
    assert issubclass(telastic.SimulatedHostDeath, SystemExit)


@pytest.mark.parametrize('num_leases', [1, 4, 6, 9, 16])
def test_rendezvous_as_jax(num_leases):
    pods = [(), ('a',), ('a', 'b'), ('host-0', 'host-1', 'host-2'),
            ('host-2', 'host-0', 'host-1', 'host-0'),
            ('host-0', 'host-2'),                        # host-1 died
            ('host-0', 'host-1', 'host-2', 'host-3')]    # host-3 joined
    for hosts in pods:
        assert (telastic.rendezvous_assign(num_leases, hosts)
                == jelastic.rendezvous_assign(num_leases, hosts)), hosts
    # bounded: a death moves the dead host's leases only
    full = telastic.rendezvous_assign(num_leases, pods[3])
    died = telastic.rendezvous_assign(num_leases, pods[5])
    assert all(died[i] == full[i] for i in full if full[i] != 'host-1')


@pytest.mark.parametrize('shuffle', [True, False])
def test_lease_plan_as_jax(store, shuffle):
    dataset = TIndexed(store)
    try:
        offsets = dataset.row_offsets
        for leases in (1, 3, 6, len(dataset.pieces)):
            plans = {name: module.LeasePlan(offsets, BATCH, leases, seed=5,
                                            shuffle=shuffle)
                     for name, module in ELASTIC.items()}
            t, j = plans['torch'], plans['jax']
            assert t.piece_bounds == j.piece_bounds
            assert t.describe() == j.describe()
            for lease in range(leases):
                assert list(t.lease_pieces(lease)) == list(
                    j.lease_pieces(lease))
                assert t.lease_rows(lease) == j.lease_rows(lease)
                for epoch in (0, 1):
                    for b in range(t.batches_per_lease(lease)):
                        np.testing.assert_array_equal(
                            t.batch_rows(lease, epoch, b),
                            j.batch_rows(lease, epoch, b))
        for args in ((BATCH, 0), (BATCH, len(offsets)), (0, 2)):
            errors = {}
            for name, module in ELASTIC.items():
                with pytest.raises(module.ElasticConfigError) as info:
                    module.LeasePlan(offsets, *args)
                errors[name] = str(info.value)
            assert errors['torch'] == errors['jax']
    finally:
        dataset.close()


def _membership_script(module, root):
    out = []
    a = module.PodMembership(root, host_id='a', ttl_beats=2)
    b = module.PodMembership(root, host_id='b', ttl_beats=2)
    out.append(a.observe())
    for _ in range(4):                   # b goes silent
        a.beat()
        out.append(a.observe())
    b.beat()                             # and comes back
    out.append(a.observe())
    c = module.PodMembership(root, host_id='c')
    out.append(c.observe())
    b.leave()
    out.append(a.observe())
    out.append((dict(a.counters), dict(c.counters), a.live_hosts, a.beats))
    with pytest.raises(module.ElasticConfigError) as info:
        module.PodMembership('')
    out.append(str(info.value))
    with pytest.raises(module.ElasticConfigError) as info:
        module.PodMembership(root, ttl_beats=0)
    out.append(str(info.value))
    return out


def test_membership_as_jax(tmp_path):
    got = {name: _membership_script(module, str(tmp_path / name))
           for name, module in ELASTIC.items()}
    assert got['torch'] == got['jax']
    assert got['torch'][-3][0] == {'hosts_joined': 4, 'hosts_died': 2}
    assert (_records(str(tmp_path / 'torch'))
            == _records(str(tmp_path / 'jax')))


def _ledger_script(module, root):
    ledger = module.LeaseLedger(root)
    groups = [{'path': '/x/part_0.parquet', 'row_group': 1}]
    out = [ledger.resume_batch(0, 0)]
    out.append([ledger.claim_delivery(0, 0, b, 'h', 8, groups)
                for b in (0, 1, 1, 2)])
    out.append(ledger.resume_batch(0, 0))          # claims beyond the cursor
    ledger.checkpoint_lease(0, 'h', 0, 1)
    out.append(ledger.resume_batch(0, 0))
    ledger.checkpoint_lease(0, 'h', 0, 7)
    out.append(ledger.resume_batch(0, 0))
    out.append(ledger.resume_batch(0, 1))          # another epoch
    out.append(ledger.delivered_batches(0, 0))
    out.append(ledger.read_delivery(0, 0, 2))
    out.append(ledger.read_lease(0))
    out.append(ledger.read_lease(5))
    return out


def test_ledger_as_jax(tmp_path):
    got = {name: _ledger_script(module, str(tmp_path / name))
           for name, module in ELASTIC.items()}
    assert got['torch'] == got['jax']
    assert got['torch'][1] == [True, True, False, True]
    assert (_records(str(tmp_path / 'torch'))
            == _records(str(tmp_path / 'jax')))
    # no temporary file outlives a claim
    assert all('.tmp.' not in n for n in os.listdir(
        str(tmp_path / 'torch' / 'delivered')))


# -- the elastic pod across the two packages ----------------------------------

def _run_pod(name, store, root, spec, monkeypatch, k_hosts=3, seed=1):
    if spec is None:
        monkeypatch.delenv('PETASTORM_TPU_CHAOS', raising=False)
    else:
        monkeypatch.setenv('PETASTORM_TPU_CHAOS', spec)
    _reset()
    module = ELASTIC[name]
    dataset = INDEXED[name](store)
    got = {}
    try:
        sim = module.ElasticPodSim(dataset, root, k_hosts=k_hosts,
                                   batch_size=BATCH, seed=seed)

        def on_batch(columns, lease, b):
            assert (lease, b) not in got
            got[(lease, b)] = (np.asarray(columns['idx']),
                               np.asarray(columns['vec']))
        report = sim.run_epoch(0, on_batch=on_batch)
        certificate = sim.certificate(0)
        faults = getattr((tfaultfs if name == 'torch' else jfaultfs)
                         .chaos_from_env(), 'injected', {})
        records = _records(root)
        sim.close()
    finally:
        dataset.close()
        _reset()
    return report, certificate, records, got, dict(faults)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('spec', (None,) + DEATHS + JOINS)
def test_elastic_pod_as_jax(store, tmp_path, monkeypatch, no_chaos, spec):
    out = {name: _run_pod(name, store, str(tmp_path / name), spec,
                          monkeypatch) for name in ELASTIC}
    report, certificate, records, got, faults = out['torch']
    want = out['jax']
    assert report == want[0]
    assert certificate == want[1] and certificate['ok']
    assert records == want[2]
    assert faults == want[4]
    assert sorted(got) == sorted(want[3])
    for key, (idx, vec) in got.items():
        np.testing.assert_array_equal(idx, want[3][key][0])
        np.testing.assert_array_equal(vec, want[3][key][1])
    rows = np.concatenate([idx for idx, _ in got.values()])
    assert len(rows) == len(np.unique(rows))
    assert report['counters']['batches_delivered'] == len(got) == \
        report['plan']['total_batches']
    if spec in DEATHS:
        assert len(report['deaths']) == 1 and faults == {'host_death': 1}
        assert report['counters']['leases_rebalanced'] >= 1
        causes = thealth.degradation_causes(dict(
            report['counters'], dead_hosts=report['deaths']))
        assert causes == jhealth.degradation_causes(dict(
            report['counters'], dead_hosts=report['deaths']))
        assert any('host-death' in c and report['deaths'][0] in c
                   for c in causes)
    elif spec in JOINS:
        assert len(report['joins']) == 1
        assert report['audit']['by_host'].get(report['joins'][0], 0) > 0
    else:
        assert not report['deaths'] and not report['joins']


@pytest.mark.timeout(120)
def test_same_seed_replays(store, tmp_path, monkeypatch, no_chaos):
    runs = [_run_pod('torch', store, str(tmp_path / str(i)), DEATHS[0],
                     monkeypatch) for i in range(2)]
    assert runs[0][0]['deaths'] == runs[1][0]['deaths']
    assert runs[0][0]['counters'] == runs[1][0]['counters']
    assert runs[0][4] == runs[1][4] == {'host_death': 1}


@pytest.mark.timeout(120)
def test_ledgers_cross_readable(store, tmp_path, monkeypatch, no_chaos):
    """Each package's auditor certifies the other's ledger, and names a
    dropped batch in the same words."""
    for writer, reader in (('jax', 'torch'), ('torch', 'jax')):
        root = str(tmp_path / writer)
        _run_pod(writer, store, root, DEATHS[0], monkeypatch)
        audits = {}
        for name in (writer, reader):
            module = ELASTIC[name]
            dataset = INDEXED[name](store)
            try:
                plan = module.LeasePlan(dataset.row_offsets, BATCH,
                                        min(len(dataset.pieces), 6), seed=1)
                auditor = module.ElasticCoverageAuditor(
                    plan, module.LeaseLedger(root), pieces=dataset.pieces)
                audits[name] = [auditor.assert_complete(0)]
                dropped = os.path.join(root, 'delivered', 'l1_e0_b2.json')
                kept = dropped + '.kept'
                os.rename(dropped, kept)
                try:
                    audits[name].append(auditor.audit_epoch(
                        0, require_hosts=['host-0', 'nobody']))
                    with pytest.raises(AssertionError) as info:
                        auditor.assert_complete(0)
                    audits[name].append(str(info.value))
                finally:
                    os.rename(kept, dropped)
            finally:
                dataset.close()
        assert audits[reader] == audits[writer]
        assert audits[reader][0]['ok'] and not audits[reader][1]['ok']
        assert 'batch 2 of lease 1' in audits[reader][2]


# -- shard resolution and the factories ---------------------------------------

def _register(root, hosts):
    for host in hosts:
        jelastic.PodMembership(root, host_id=host)


@pytest.mark.parametrize('hosts,me', [((), 'a'), (('a',), 'b'),
                                      (('b', 'c'), 'a'), (('a', 'c'), 'b')])
def test_resolve_elastic_shard_as_jax(tmp_path, no_chaos, hosts, me):
    got = {}
    for name, module in ELASTIC.items():
        root = str(tmp_path / name)
        _register(root, hosts)
        cur, count, membership = module.resolve_elastic_shard(
            {'coord_root': root, 'host_id': me, 'ttl_beats': 2}, None, None,
            False)
        got[name] = (cur, count, membership.host_id, membership.ttl_beats,
                     _records(root))
    assert got['torch'] == got['jax']


def test_resolve_errors_as_jax(tmp_path, no_chaos):
    root = str(tmp_path)
    cases = [({'coord_root': root}, 0, 2, False),
             ({'coord_root': root}, None, 1, False),
             ({'coord_root': root}, None, None, True),
             ({'coord_root': root, 'nope': 1}, None, None, False),
             ({}, None, None, False),
             ({'coord_root': root, 'ttl_beats': 0}, None, None, False)]
    for case in cases:
        errors = {}
        for name, module in ELASTIC.items():
            with pytest.raises(module.ElasticConfigError) as info:
                module.resolve_elastic_shard(*case)
            errors[name] = str(info.value)
        assert errors['torch'] == errors['jax'], case
    # a config that is not a dict: JAX's words (JAX itself raises KeyError
    # there, its message's braces unescaped)
    with pytest.raises(telastic.ElasticConfigError,
                       match=r"must be a dict like \{'coord_root': \.\.\.\}, "
                             r"got \['coord_root'\]"):
        telastic.resolve_elastic_shard(['coord_root'], None, None, False)
    with pytest.raises(KeyError):
        jelastic.resolve_elastic_shard(['coord_root'], None, None, False)
    assert (telastic.resolve_elastic_shard(None, 1, 3, False)
            == jelastic.resolve_elastic_shard(None, 1, 3, False)
            == (1, 3, None))


def _rows(reader, batched):
    if batched:
        return sorted(int(x) for b in reader for x in b.idx)
    return sorted(int(r.idx) for r in reader)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('factory', ['make_reader', 'make_batch_reader',
                                     'make_columnar_reader'])
def test_factories_elastic_as_jax(store, tmp_path, no_chaos, factory):
    got = {}
    for name, module in FACTORY.items():
        root = str(tmp_path / name)
        _register(root, ('a', 'b'))
        shards = []
        for host in ('a', 'b'):
            with getattr(module, factory)(
                    store, schema_fields=['idx'], workers_count=2,
                    shuffle_row_groups=False,
                    elastic={'coord_root': root, 'host_id': host}) as reader:
                shards.append(_rows(reader, factory != 'make_reader'))
        with pytest.raises(ELASTIC[name].ElasticConfigError) as info:
            getattr(module, factory)(store, elastic={'coord_root': root},
                                     cur_shard=0, shard_count=2)
        got[name] = (shards, str(info.value), _records(root))
    assert got['torch'] == got['jax']
    a, b = got['torch'][0]
    assert a and b and not set(a) & set(b)
    assert sorted(a + b) == list(range(ROWS))


@pytest.mark.timeout(120)
def test_kill_switch(store, tmp_path, monkeypatch, caplog):
    """``PETASTORM_TPU_ELASTIC=0``: the simulator refuses with JAX's words,
    ``elastic=`` warns and reads the whole store, and no thread, no file
    and no directory is made."""
    monkeypatch.setenv('PETASTORM_TPU_ELASTIC', '0')
    dataset = TIndexed(store)
    try:
        errors = {}
        for name, module in ELASTIC.items():
            with pytest.raises(module.ElasticConfigError) as info:
                module.ElasticPodSim(dataset, str(tmp_path / 'sim'),
                                     k_hosts=2, batch_size=BATCH)
            errors[name] = str(info.value)
        assert errors['torch'] == errors['jax'] and 'kill switch' in \
            errors['torch']
    finally:
        dataset.close()
    threads = threading.active_count()
    root = str(tmp_path / 'off')
    assert telastic.resolve_elastic_shard({'coord_root': root}, None, None,
                                          False) == (None, None, None)
    with petastorm_tpu_torch.make_reader(
            store, reader_pool_type='dummy',
            elastic={'coord_root': root}) as reader:
        assert _rows(reader, False) == list(range(ROWS))
    assert not os.path.exists(root) and not os.path.exists(
        str(tmp_path / 'sim'))
    assert threading.active_count() == threads
    assert 'the kill switch wins' in caplog.text


# -- the pod merge, the flight record -----------------------------------------

@pytest.mark.timeout(120)
def test_pod_merge_of_elastic_sections(store, tmp_path, monkeypatch,
                                       no_chaos):
    reports = {}
    for name, module in ELASTIC.items():
        monkeypatch.setenv('PETASTORM_TPU_CHAOS', DEATHS[0])
        _reset()
        dataset = INDEXED[name](store)
        try:
            sim = module.ElasticPodSim(dataset, str(tmp_path / name),
                                       k_hosts=3, batch_size=BATCH, seed=1)
            sim.run_epoch(0)
            podobs = tpodobs if name == 'torch' else jpodobs
            snapshots = [podobs.make_observe_fn(
                elastic_fn=host.elastic_snapshot, host=host.host_id)()
                for host in sim.hosts]
            for snap in snapshots:
                snap.pop('clock_s')
            observer = podobs.PodObserver(
                ['x:1'], expected_batches=sim.plan.total_batches(),
                trace_id='0' * 32)
            report = observer.merge(snapshots)
            observer.assert_certificate(report)
            reports[name] = (report, sim.plan.total_batches())
            sim.close()
        finally:
            dataset.close()
            _reset()
    assert reports['torch'] == reports['jax']
    report, total = reports['torch']
    assert report['elastic']['totals']['batches_delivered'] == total
    # K hosts' constant is not summed into the denominator
    assert report['certificate']['elastic']['expected_batches'] == total
    assert report['certificate']['elastic']['checked']


def test_flight_record_elastic_as_jax():
    records = {}
    for name, module in (('jax', jhealth), ('torch', thealth)):
        record = module.build_flight_record(
            {'state': 'healthy'}, {}, {'items_out': 1},
            elastic={'hosts_died': 1, 'held_leases': 2})
        for key in ('written_at', 'stacks', 'pid'):
            record.pop(key)
        records[name] = record
        assert 'elastic' not in module.build_flight_record(
            {'state': 'healthy'}, {})
    assert records['torch'] == records['jax']
    assert records['torch']['elastic'] == {'hosts_died': 1, 'held_leases': 2}


def test_public_names():
    for name in ('ElasticPodSim', 'PodMembership', 'LeasePlan'):
        assert getattr(petastorm_tpu_torch, name) is getattr(telastic, name)
        assert name in petastorm_tpu_torch.__all__


# -- phase 23 (a) of chip_smoke.py --------------------------------------------

@pytest.mark.timeout(300)
def test_chip_smoke_elastic_line_on_cpu(tmp_path, monkeypatch, no_chaos):
    import chip_smoke
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ops import kernels
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    cfg = tlm.TransformerConfig(vocab_size=512, d_model=64, n_heads=2,
                                n_layers=1, d_ff=128, max_seq_len=64,
                                attention='flash')
    # 192 rows in 15 row groups: the dead host still holds work
    launches = chip_smoke.elastic_line(
        torch, np, tlm, kernels, argparse.Namespace(seed=0), device='cpu',
        cfg=cfg, rows=192, group_mb=0.005)
    assert launches['flash_fwd'] == 0       # the CPU runs K1's twin
    assert os.listdir(str(tmp_path)) == []   # the stores and coord dirs go


@pytest.mark.cuda
def test_elastic_batches_stage_to_the_card(store, tmp_path, no_chaos):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the batches stage to the card')
    from petastorm_tpu_torch.torch_utils import stage_to_device
    device = torch.device('cuda', torch.cuda.current_device())
    dataset = TIndexed(store)
    try:
        sim = telastic.ElasticPodSim(dataset, str(tmp_path), k_hosts=3,
                                     batch_size=BATCH, seed=1)
        seen = []

        def on_batch(columns, lease, b):
            staged, _ = stage_to_device(dict(columns), device)
            want = torch.from_numpy(dataset.gather(
                sim.plan.batch_rows(lease, 0, b))['vec'])
            assert staged['vec'].is_cuda
            assert torch.equal(staged['vec'].cpu(), want)
            seen.append((lease, b))
        sim.run_epoch(0, on_batch=on_batch)
        sim.certificate(0)
        assert len(seen) == sim.plan.total_batches()
        sim.close()
    finally:
        dataset.close()
