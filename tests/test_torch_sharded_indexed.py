"""The port's sharded indexed loaders against the JAX package's, on the
CPU.

``make_indexed_loader(mesh=)`` and ``make_indexed_ngram_loader(mesh=)`` on
2 and 4 gloo ranks (``launch_ranks`` over a ``FileStore`` under the test's
temp directory): the ranks' batches, concatenated in the order of their
``data`` coordinate, equal the global batches of JAX's
``ShardedIndexedLoader`` / ``ShardedIndexedNGramLoader`` on
``make_mesh({'data': n})`` of virtual CPU devices, over two epochs; on
``{'data': 2, 'seq': 2}`` the seq ranks of a data group get equal batches;
a cursor saved on 2 ranks resumes the same global stream on 4. The setup
errors use JAX's words. Tolerance: exact (bit for bit).
"""

import types

import jax
import numpy as np
import pytest

from petastorm_tpu import indexed as jindexed
from petastorm_tpu import make_indexed_loader as jmake_indexed_loader
from petastorm_tpu.codecs import NdarrayCodec as JNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JScalarCodec
from petastorm_tpu.etl.dataset_metadata import \
    materialize_dataset as jmaterialize
from petastorm_tpu.indexed_ngram import \
    make_indexed_ngram_loader as jmake_ngram_loader
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.parallel import make_mesh as jmake_mesh
from petastorm_tpu.unischema import Unischema as JUnischema
from petastorm_tpu.unischema import UnischemaField as JField

from petastorm_tpu_torch import indexed as tindexed
from petastorm_tpu_torch.indexed_ngram import ShardedIndexedNGramLoader
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.parallel import launch_ranks

BATCH = 8
EPOCHS = 2
STOP = 3                 # batches before the cursor is saved on 2 ranks
NGRAM_FIELDS = {0: ['ts', 'vec'], 1: ['ts']}

Schema = JUnischema('ShardedIndexed', [
    JField('idx', np.int64, (), JScalarCodec(), False),
    JField('ts', np.int64, (), JScalarCodec(), False),
    JField('vec', np.float32, (4,), JNdarrayCodec(), False),
    JField('name', np.str_, (), JScalarCodec(), False),
])


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """120 rows in 6 row groups (one a file)."""
    url = 'file://' + str(tmp_path_factory.mktemp('shidx') / 'ds')
    rng = np.random.default_rng(1)
    with jmaterialize(url, Schema, row_group_size_mb=100,
                      rows_per_file=20) as w:
        w.write_rows({'idx': np.int64(i), 'ts': np.int64(i),
                      'vec': rng.standard_normal(4).astype(np.float32),
                      'name': 'r%03d' % i} for i in range(120))
    return url


def _jobs(url, axes, state=None, stop=None):
    base = dict(url=url, batch=BATCH, axes=axes, num_epochs=EPOCHS)
    return [base,
            dict(base, ngram=NGRAM_FIELDS),
            dict(base, state=state, stop=stop)]


@pytest.fixture(scope='module')
def ranks(store, tmp_path_factory):
    """``{name: [per rank: result]}``: rows and windows on 2 and 4 ranks,
    rows on {'data': 2, 'seq': 2}, and the resume (saved on 2, restored
    on 4)."""
    two = launch_ranks('torch_mesh_ranks:indexed_jobs', 2,
                       str(tmp_path_factory.mktemp('two')),
                       args=(_jobs(store, {'data': 2}, stop=STOP),),
                       timeout_s=240)
    state = two[0][2]['state']
    jobs = _jobs(store, {'data': 4}, state=state)
    jobs.append(dict(url=store, batch=BATCH, axes={'data': 2, 'seq': 2},
                     num_epochs=EPOCHS))
    four = launch_ranks('torch_mesh_ranks:indexed_jobs', 4,
                        str(tmp_path_factory.mktemp('four')),
                        args=(jobs,), timeout_s=240)
    pick = lambda res, i: [r[i] for r in res]
    return {'rows2': pick(two, 0), 'ngram2': pick(two, 1),
            'saved2': pick(two, 2), 'rows4': pick(four, 0),
            'ngram4': pick(four, 1), 'resumed4': pick(four, 2),
            'rows2x2': pick(four, 3), 'state': state}


def _global(per_rank, data_axis_size):
    """The ranks' batches joined in data-coordinate order (one rank per
    coordinate): a list of global batches."""
    by_coord = {}
    for r in per_rank:
        by_coord.setdefault(r['coords']['data'], r['batches'])
    parts = [by_coord[c] for c in range(data_axis_size)]
    return [_join([p[i] for p in parts]) for i in range(len(parts[0]))]


def _join(parts):
    if isinstance(parts[0], dict):
        return {k: _join([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def _jax_global(store, n, ngram=False, mesh=True):
    kw = dict(batch_size=BATCH, num_epochs=EPOCHS, seed=3, workers_count=2)
    if mesh:
        kw['mesh'] = jmake_mesh({'data': n}, devices=jax.devices()[:n])
    if ngram:
        loader = jmake_ngram_loader(store, JNGram(
            dict(NGRAM_FIELDS), delta_threshold=1, timestamp_field='ts'),
            **kw)
        return [{off: {k: np.asarray(v) for k, v in cols.items()}
                 for off, cols in b.items()} for b in loader]
    return [{k: (np.asarray(v) if k != '_host' else
                 {hk: np.asarray(hv) for hk, hv in v.items()})
             for k, v in b.items()} for b in jmake_indexed_loader(store,
                                                                   **kw)]


def _flat(batch):
    """A batch with the columns under ``'_host'`` moved to the top (an
    unsharded loader keeps them there)."""
    out = {k: v for k, v in batch.items() if k != '_host'}
    out.update(batch.get('_host', {}))
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if '_host' in g or '_host' in w:
            g, w = _flat(g), _flat(w)
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], dict):
                _assert_batches_equal([g[k]], [w[k]])
            else:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.timeout(300)
@pytest.mark.parametrize('n', [2, 4])
def test_row_batches_equal_jax_global_batches(store, ranks, n):
    got = _global(ranks['rows%d' % n], n)
    _assert_batches_equal(got, _jax_global(store, n))
    assert all(r['spec'] == ('data',) for r in ranks['rows%d' % n])


@pytest.mark.timeout(300)
@pytest.mark.parametrize('n', [2, 4])
def test_ngram_batches_equal_jax_global_batches(store, ranks, n):
    got = _global(ranks['ngram%d' % n], n)
    _assert_batches_equal(got, _jax_global(store, n, ngram=True))


@pytest.mark.timeout(300)
def test_seq_ranks_of_a_data_group_get_equal_batches(store, ranks):
    per_rank = ranks['rows2x2']
    for a in per_rank:
        for b in per_rank:
            if a['coords']['data'] == b['coords']['data']:
                _assert_batches_equal(a['batches'], b['batches'])
    _assert_batches_equal(_global(per_rank, 2), _jax_global(store, 2))


@pytest.mark.timeout(300)
def test_cursor_saved_on_2_ranks_resumes_on_4(store, ranks):
    assert ranks['state'] == {'epoch': 0, 'batch': STOP, 'version': 1}
    assert all(r['state'] == ranks['state'] for r in ranks['saved2'])
    want = _jax_global(store, 1, mesh=False)
    _assert_batches_equal(_global(ranks['saved2'], 2), want[:STOP])
    _assert_batches_equal(_global(ranks['resumed4'], 4), want[STOP:])


def _fake_mesh(**axes):
    return types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 shape=tuple(axes.values()),
                                 device_type='cpu',
                                 get_local_rank=lambda axis: 0)


def test_setup_errors_are_jax(store):
    jmesh = jmake_mesh({'data': 3}, devices=jax.devices()[:3])
    with pytest.raises(ValueError) as jerr:
        jindexed.sharded_batch_setup(jmesh, 'data', BATCH)
    with pytest.raises(ValueError) as terr:
        tindexed.sharded_batch_setup(_fake_mesh(data=3), 'data', BATCH)
    assert str(terr.value) == str(jerr.value)
    pad = {'vec': {'buckets': [2, 4]}}
    jmesh = jmake_mesh({'data': 1}, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as jerr:
        jmake_indexed_loader(store, BATCH, mesh=jmesh, pad_spec=pad)
    with pytest.raises(ValueError) as terr:
        tindexed.make_indexed_loader(store, BATCH, mesh=_fake_mesh(data=1),
                                     pad_spec=pad)
    assert str(terr.value) == str(jerr.value)


def test_positions_follow_the_data_coordinate():
    mesh = types.SimpleNamespace(mesh_dim_names=('data', 'seq'), shape=(4, 2),
                                 device_type='cpu',
                                 get_local_rank={'data': 2, 'seq': 1}.get)
    sharding, positions = tindexed.sharded_batch_setup(mesh, 'data', 16)
    assert sharding.spec == ('data',)
    np.testing.assert_array_equal(positions, [8, 9, 10, 11])


def test_one_rank_ngram_loader_equals_the_host_loader(store):
    ngram = NGram(dict(NGRAM_FIELDS), delta_threshold=1, timestamp_field='ts')
    dataset = tindexed.IndexedDatasetReader(store)
    loader = ShardedIndexedNGramLoader(dataset, ngram, BATCH,
                                       mesh=_fake_mesh(data=1), seed=3)
    got = [{off: {k: v.numpy() for k, v in cols.items()}
            for off, cols in b.items()} for b in loader]
    loader.close()
    _assert_batches_equal(got, _jax_global(store, 1, ngram=True,
                                           mesh=False)[:len(got)])
