"""The port's sharded streaming loader, ``Reader.drain`` and
``shard_by_jax_process`` against the JAX package's, on the CPU.

A store of 9 row groups (written by the JAX package) is read on 2 gloo
ranks (``launch_ranks`` over a ``FileStore`` under the test's temp
directory): ``make_reader(shard_by_jax_process=True)`` on one thread, row
groups in order, into ``make_torch_loader(mesh={'data': 2})``. Each rank's
rows equal JAX's ``make_reader(cur_shard=r, shard_count=2)`` row for row
up to the lockstep stop, both ranks yield the same number of steps (the
surplus rank drains), and a second pass after the reset equals the first;
an NGram reader keeps the nested layout, window batches equal JAX's
loader's over the same shard. ``drain`` then ``reset`` and the coverage
audit after ``drain`` equal JAX's; ``require_single_bucket_pad_spec``,
the ``shard_by_jax_process`` exclusions and the device-decode decline use
JAX's words; without a process group ``shard_by_jax_process`` reads what
JAX's does in one process. Tolerance: exact.
"""

import logging
import types

import jax
import numpy as np
import pytest
import torch

import petastorm_tpu
from petastorm_tpu.codecs import NdarrayCodec as JNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JScalarCodec
from petastorm_tpu.etl.dataset_metadata import \
    materialize_dataset as jmaterialize
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.jax_utils import make_jax_loader
from petastorm_tpu.jax_utils import \
    require_single_bucket_pad_spec as jrequire_single_bucket
from petastorm_tpu.jax_utils import validate_pad_spec as jvalidate_pad_spec
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.parallel import make_mesh as jmake_mesh
from petastorm_tpu.unischema import Unischema as JUnischema
from petastorm_tpu.unischema import UnischemaField as JField

import petastorm_tpu_torch
from petastorm_tpu_torch import make_reader, torch_utils
from petastorm_tpu_torch.padding import require_single_bucket_pad_spec
from petastorm_tpu_torch.parallel import launch_ranks

GROUPS = 9
ROWS_PER_GROUP = 10
LOCAL_BATCH = 4
NGRAM_FIELDS = {0: ['ts', 'vec'], 1: ['ts']}

Schema = JUnischema('ShardedSchema', [
    JField('idx', np.int64, (), JScalarCodec(), False),
    JField('ts', np.int64, (), JScalarCodec(), False),
    JField('vec', np.float32, (4,), JNdarrayCodec(), False),
    JField('name', np.str_, (), JScalarCodec(), False),
])


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """9 files of 10 rows: 9 row groups, read in file order."""
    url = 'file://' + str(tmp_path_factory.mktemp('sharded') / 'ds')
    rng = np.random.default_rng(0)
    rows = [{'idx': np.int64(i), 'ts': np.int64(i),
             'vec': rng.standard_normal(4).astype(np.float32),
             'name': 'row_%03d' % i}
            for i in range(GROUPS * ROWS_PER_GROUP)]
    with jmaterialize(url, Schema, row_group_size_mb=100,
                      rows_per_file=ROWS_PER_GROUP) as w:
        w.write_rows(rows)
    return url


def _jax_rows(url, shard, fields=('idx', 'vec', 'name')):
    with petastorm_tpu.make_reader(url, schema_fields=list(fields),
                                   cur_shard=shard, shard_count=2,
                                   shuffle_row_groups=False,
                                   workers_count=1) as reader:
        return [r._asdict() for r in reader]


@pytest.fixture(scope='module')
def row_ranks(store, tmp_path_factory):
    return launch_ranks('torch_mesh_ranks:streaming', 2,
                        str(tmp_path_factory.mktemp('rows')),
                        args=(store, LOCAL_BATCH),
                        kwargs={'fields': ['idx', 'vec', 'name']},
                        timeout_s=240)


@pytest.mark.timeout(300)
def test_lockstep_stop_and_second_pass(row_ranks):
    steps = [[len(p) for p in r['passes']] for r in row_ranks]
    # shards of 5 and 4 row groups: 50 and 40 rows, 12 and 10 batches of 4;
    # both ranks stop together after the shorter shard's 10
    assert steps == [[10, 10], [10, 10]]
    for r in row_ranks:
        assert r['drains'] == 2            # one lockstep stop a pass
        assert r['consumed']
        assert r['spec'] == ('data',)
    assert [r['host_shard'] for r in row_ranks] == [(0, 2), (1, 2)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize('rank', [0, 1])
def test_rank_rows_equal_jax_shard(store, row_ranks, rank):
    want = _jax_rows(store, rank)
    for batches in row_ranks[rank]['passes']:
        idx = np.concatenate([b['idx'] for b in batches])
        n = len(idx)
        assert n == 10 * LOCAL_BATCH
        np.testing.assert_array_equal(idx, [w['idx'] for w in want[:n]])
        np.testing.assert_array_equal(
            np.concatenate([b['vec'] for b in batches]),
            np.stack([w['vec'] for w in want[:n]]))
        # strings cannot live on a device: they ride under '_host'
        assert all(set(b) == {'idx', 'vec', '_host'} for b in batches)
        names = np.concatenate([b['_host']['name'] for b in batches])
        assert list(names) == [w['name'] for w in want[:n]]


@pytest.mark.timeout(300)
def test_ngram_windows_keep_the_nested_layout(store, tmp_path):
    ranks = launch_ranks('torch_mesh_ranks:streaming', 2, str(tmp_path),
                         args=(store, LOCAL_BATCH),
                         kwargs={'ngram': NGRAM_FIELDS, 'passes': 1},
                         timeout_s=240)
    counts = [len(r['passes'][0]) for r in ranks]
    assert counts[0] == counts[1] > 0
    for rank, r in enumerate(ranks):
        ngram = JNGram(dict(NGRAM_FIELDS), delta_threshold=1,
                       timestamp_field='ts')
        with petastorm_tpu.make_reader(store, schema_fields=ngram,
                                       cur_shard=rank, shard_count=2,
                                       shuffle_row_groups=False,
                                       workers_count=1) as reader:
            loader = JaxDataLoader(reader, batch_size=LOCAL_BATCH,
                                   drop_last=True)
            want = [{off: {k: np.asarray(v) for k, v in cols.items()}
                     for off, cols in b.items()} for b in loader]
        assert len(want) >= counts[rank]
        for got, w in zip(r['passes'][0], want):
            assert sorted(got) == sorted(w) == [0, 1]
            for off in w:
                assert sorted(got[off]) == sorted(w[off])
                for k in w[off]:
                    np.testing.assert_array_equal(got[off][k], w[off][k])


def _reader_pair(url, module, **kw):
    return module.make_reader(url, schema_fields=['idx'], cur_shard=0,
                              shard_count=2, shuffle_row_groups=False,
                              workers_count=1, **kw)


def test_drain_then_reset_and_audit_as_jax(store):
    out = []
    for module in (petastorm_tpu, petastorm_tpu_torch):
        with _reader_pair(store, module) as reader:
            first = [int(next(reader).idx) for _ in range(7)]
            reader.drain()
            assert reader.last_row_consumed
            report = reader.audit().report()
            reader.reset()
            second = [int(r.idx) for r in reader]
            out.append((first, report, second))
    (jfirst, jreport, jsecond), (tfirst, treport, tsecond) = out
    assert tfirst == jfirst and tsecond == jsecond
    assert len(tsecond) == 5 * ROWS_PER_GROUP
    # the drained items count as delivered: the first pass audits complete
    assert treport['complete'] is True
    for key in ('complete', 'passes', 'records_registered', 'epochs'):
        assert treport[key] == jreport[key], key


def test_drain_discards_a_partly_read_item(store):
    with _reader_pair(store, petastorm_tpu_torch) as reader:
        next(reader)
        assert reader._rows            # the item's other rows are buffered
        reader.drain()
        assert reader._rows == []
        reader.reset()
        assert len(list(reader)) == 5 * ROWS_PER_GROUP


def test_require_single_bucket_pad_spec_words_are_jax():
    spec = {'vec': {'buckets': [2, 4]}, 'ts': {'max_len': 8}}
    norm = jvalidate_pad_spec(spec)
    with pytest.raises(ValueError) as jerr:
        jrequire_single_bucket(norm, 'ShardedJaxLoader')
    with pytest.raises(ValueError) as terr:
        require_single_bucket_pad_spec(
            torch_utils.validate_pad_spec(spec), 'ShardedJaxLoader')
    assert str(terr.value) == str(jerr.value)
    require_single_bucket_pad_spec(None, 'x')
    require_single_bucket_pad_spec(
        torch_utils.validate_pad_spec({'ts': {'max_len': 8}}), 'x')


@pytest.mark.parametrize('factory', ['make_reader', 'make_columnar_reader',
                                     'make_batch_reader'])
def test_shard_by_jax_process_exclusions_are_jax(store, tmp_path, factory):
    jfac = getattr(petastorm_tpu, factory)
    tfac = getattr(petastorm_tpu_torch, factory)
    for kw in (dict(cur_shard=0, shard_count=2),
               dict(elastic={'coord_root': str(tmp_path)})):
        with pytest.raises(ValueError) as jerr:
            jfac(store, shard_by_jax_process=True, **kw)
        with pytest.raises(ValueError) as terr:
            tfac(store, shard_by_jax_process=True, **kw)
        assert str(terr.value) == str(jerr.value)


def test_shard_by_jax_process_without_a_process_group(store):
    got = []
    for module in (petastorm_tpu, petastorm_tpu_torch):
        with module.make_reader(store, schema_fields=['idx'],
                                shard_by_jax_process=True,
                                workers_count=1) as reader:
            got.append(sorted(int(r.idx) for r in reader))
    assert got[0] == got[1] == list(range(GROUPS * ROWS_PER_GROUP))
    assert jax.process_count() == 1


def _one_device_mesh():
    """The attributes a sharded loader reads of a one-rank CPU mesh."""
    return types.SimpleNamespace(mesh_dim_names=('data',), shape=(1,),
                                 device_type='cpu',
                                 get_local_rank=lambda axis: 0)


def test_one_rank_loader_stages_the_plain_loader_batches(store):
    with make_reader(store, schema_fields=['idx', 'vec', 'name'],
                     shuffle_row_groups=False, workers_count=1) as reader:
        loader = petastorm_tpu_torch.make_torch_loader(
            reader, batch_size=8, mesh=_one_device_mesh())
        assert isinstance(loader, petastorm_tpu_torch.ShardedTorchLoader)
        got = list(loader)
    with make_reader(store, schema_fields=['idx', 'vec', 'name'],
                     shuffle_row_groups=False, workers_count=1) as reader:
        want = list(torch_utils.TorchDataLoader(reader, batch_size=8,
                                                drop_last=True,
                                                device='cpu'))
    assert len(got) == len(want) == GROUPS * ROWS_PER_GROUP // 8
    for g, w in zip(got, want):
        assert torch.equal(g['idx'], w['idx'])
        assert torch.equal(g['vec'], w['vec'])
        assert list(g['_host']['name']) == list(w['name'])


def test_device_decode_decline_words_are_jax(store, caplog):
    jmesh = jmake_mesh({'data': 1}, devices=jax.devices()[:1])
    words = []
    for make in (
            lambda r: make_jax_loader(r, batch_size=4, mesh=jmesh,
                                      transform_fn=lambda b: b),
            lambda r: petastorm_tpu_torch.make_torch_loader(
                r, batch_size=4, mesh=_one_device_mesh(),
                transform_fn=lambda b: b)):
        module = petastorm_tpu if len(words) == 0 else petastorm_tpu_torch
        with module.make_columnar_reader(store, schema_fields=['vec'],
                                         workers_count=1) as reader:
            assert reader.device_decode_plans
            caplog.clear()
            with caplog.at_level(logging.INFO):
                make(reader)
            words.append([r.getMessage() for r in caplog.records
                          if 'declining' in r.getMessage()])
    assert len(words[0]) == 1
    assert words[1] == [w.replace('ShardedJaxLoader', 'ShardedTorchLoader')
                        for w in words[0]]


def test_public_names():
    assert petastorm_tpu_torch.ShardedTorchLoader is \
        torch_utils.ShardedTorchLoader
    assert 'ShardedTorchLoader' in petastorm_tpu_torch.__all__
    assert torch_utils.require_single_bucket_pad_spec is \
        require_single_bucket_pad_spec
