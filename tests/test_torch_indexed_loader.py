"""The port's indexed row loader against the JAX package's, on the CPU.

The same stores (written by the JAX package from seeded numpy values) go
through ``petastorm_tpu.indexed`` and ``petastorm_tpu_torch.indexed``:
``epoch_permutation`` for several seeds and window sizes; ``read_piece`` /
``gather`` on codec columns (``NdarrayCodec``, png), hive partitions and a
nullable column that is int64 in one row group and NaN-holed float in the
next; predicates, ``transform_spec`` and ``pad_spec``; the cursor (mid-epoch,
an epoch boundary, a folded batch, bad states in JAX's words); any worker
count giving JAX's stream; the lazily ventilated schedule; ``close()``
leaving no handle open; and ``mesh=`` raising. The port's counterparts of
JAX's ``tests/test_indexed_loader.py`` cases that apply without a mesh.
Tolerance everywhere: exact (batches, cursors and permutations equal, NaN
where JAX has NaN).
"""

import json
import threading
import tracemalloc

import numpy as np
import pytest

from petastorm_tpu import make_indexed_loader as jmake_indexed_loader
from petastorm_tpu import indexed as jindexed
from petastorm_tpu.codecs import (ArrowListCodec as JArrowListCodec,
                                  CompressedImageCodec as JImageCodec,
                                  NdarrayCodec as JNdarrayCodec,
                                  ScalarCodec as JScalarCodec)
from petastorm_tpu.errors import NoDataAvailableError as JNoData
from petastorm_tpu.etl.dataset_metadata import \
    materialize_dataset as jmaterialize
from petastorm_tpu.predicates import in_lambda as jin_lambda
from petastorm_tpu.transform import TransformSpec as JTransformSpec
from petastorm_tpu.unischema import Unischema as JUnischema
from petastorm_tpu.unischema import UnischemaField as JField

import petastorm_tpu_torch
from petastorm_tpu_torch import indexed as tindexed
from petastorm_tpu_torch import make_indexed_loader
from petastorm_tpu_torch.codecs import BATCHED_DECODE_ENV_VAR
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.faultfs import FaultInjector, FaultyFilesystem
from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.transform import TransformSpec

ROWS = 230

IndexedSchema = JUnischema('IndexedSchema', [
    JField('idx', np.int64, (), JScalarCodec(), False),
    JField('vec', np.float32, (5,), JArrowListCodec(), False),
])


@pytest.fixture(scope='module')
def indexed_dataset(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('indexed') / 'ds')
    rng = np.random.default_rng(0)
    rows = [{'idx': np.int64(i),
             'vec': rng.standard_normal(5).astype(np.float32)}
            for i in range(ROWS)]
    with jmaterialize(url, IndexedSchema, row_group_size_mb=0.001) as w:
        w.write_rows(rows)
    return url, rows


def _stream(loader, limit=None):
    out = []
    for i, batch in enumerate(loader):
        out.append(batch)
        if limit is not None and i + 1 >= limit:
            break
    return out


def _same_columns(got, want):
    """Two column dicts hold the same keys, dtypes and values (NaN at the
    same places)."""
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if g.dtype == object:
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _same_streams(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_columns(g, w)


def _both(url, **kw):
    """One loader of each package on ``url`` with the same arguments,
    predicates and transforms given as ``(jax, port)`` pairs."""
    jkw = {k: (v[0] if k in ('predicate', 'transform_spec') else v)
           for k, v in kw.items()}
    tkw = {k: (v[1] if k in ('predicate', 'transform_spec') else v)
           for k, v in kw.items()}
    return jmake_indexed_loader(url, **jkw), make_indexed_loader(url, **tkw)


def _stream_both(url, **kw):
    jl, tl = _both(url, **kw)
    with jl, tl:
        return _stream(jl), _stream(tl)


# ---------------------------------------------------------------------------
# the dataset reader and the permutation
# ---------------------------------------------------------------------------

def test_random_access_gather_as_jax(indexed_dataset):
    url, rows = indexed_dataset
    jds, tds = jindexed.IndexedDatasetReader(url), \
        tindexed.IndexedDatasetReader(url)
    assert tds.total_rows == jds.total_rows == ROWS
    assert len(tds.pieces) >= 4
    np.testing.assert_array_equal(tds.row_offsets, jds.row_offsets)
    want = np.asarray([7, 199, 0, 64, 7], np.int64)
    got = tds.gather(want)
    _same_columns(got, jds.gather(want))
    np.testing.assert_array_equal(got['idx'], want)
    for j, i in enumerate(want):
        np.testing.assert_array_equal(got['vec'][j], rows[i]['vec'])
    for p in range(len(tds.pieces)):
        _same_columns(tds.read_piece(p), jds.read_piece(p))
        _same_columns(tds.read_piece(p, ('vec',)),
                      jds.read_piece(p, ('vec',)))
    jds.close()
    tds.close()


@pytest.mark.parametrize('seed', [0, 5, 123, (7, 3)])
@pytest.mark.parametrize('window', [1, 4, 1000])
@pytest.mark.parametrize('shuffle', [True, False])
def test_epoch_permutation_as_jax(indexed_dataset, seed, window, shuffle):
    url, _ = indexed_dataset
    ds = tindexed.IndexedDatasetReader(url)
    for epoch in (0, 1, 9):
        got = tindexed.epoch_permutation(ds.total_rows, ds.row_offsets, seed,
                                         epoch, shuffle, window)
        want = jindexed.epoch_permutation(ds.total_rows, ds.row_offsets,
                                          seed, epoch, shuffle, window)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.sort(got), np.arange(ROWS))


def test_permutation_properties(indexed_dataset):
    url, _ = indexed_dataset
    ds = tindexed.IndexedDatasetReader(url)
    p1 = tindexed.epoch_permutation(ds.total_rows, ds.row_offsets, seed=5,
                                    epoch=0)
    p2 = tindexed.epoch_permutation(ds.total_rows, ds.row_offsets, seed=5,
                                    epoch=0)
    p3 = tindexed.epoch_permutation(ds.total_rows, ds.row_offsets, seed=5,
                                    epoch=1)
    np.testing.assert_array_equal(p1, p2)
    assert not np.array_equal(p1, p3)
    np.testing.assert_array_equal(np.sort(p1), np.arange(ROWS))


@pytest.fixture(scope='module')
def codec_store(tmp_path_factory):
    """An ``NdarrayCodec`` and a png column in several row groups."""
    schema = JUnischema('Codecs', [
        JField('idx', np.int64, (), JScalarCodec(), False),
        JField('matrix', np.float32, (3, 4), JNdarrayCodec(), False),
        JField('image', np.uint8, (8, 6, 3), JImageCodec('png'), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('codecs') / 'ds')
    rng = np.random.default_rng(3)
    rows = [{'idx': np.int64(i),
             'matrix': rng.standard_normal((3, 4)).astype(np.float32),
             'image': rng.integers(0, 255, (8, 6, 3), dtype=np.uint8)}
            for i in range(48)]
    with jmaterialize(url, schema, row_group_size_mb=0.001) as w:
        w.write_rows(rows)
    return url, rows


@pytest.mark.parametrize('switch', ['on', 'off'])
def test_read_piece_of_codecs_as_jax(codec_store, switch, monkeypatch):
    """png and ``NdarrayCodec`` cells through ``read_piece`` and ``gather``
    bit for bit, with the batched decode on and off."""
    monkeypatch.setenv(BATCHED_DECODE_ENV_VAR, switch)
    url, rows = codec_store
    jds, tds = jindexed.IndexedDatasetReader(url), \
        tindexed.IndexedDatasetReader(url)
    assert len(tds.pieces) == len(jds.pieces) >= 4
    for p in range(len(tds.pieces)):
        got = tds.read_piece(p)
        _same_columns(got, jds.read_piece(p))
        for i, idx in enumerate(got['idx']):
            np.testing.assert_array_equal(got['image'][i],
                                          rows[int(idx)]['image'])
            np.testing.assert_array_equal(got['matrix'][i],
                                          rows[int(idx)]['matrix'])
        _same_columns(tds.read_piece(p, ('image',)),
                      jds.read_piece(p, ('image',)))
    _same_columns(tds.gather(np.arange(47, -1, -3)),
                  jds.gather(np.arange(47, -1, -3)))


@pytest.mark.timeout(60)
def test_hive_partitions_as_jax(tmp_path):
    """The partition key of a hive-partitioned plain store, made from the
    directory names, in ``read_piece``, a narrowed read, a predicate on it
    and the loader's stream."""
    from petastorm_tpu.test_util.dataset_gen import create_partitioned_dataset
    url = 'file://' + str(tmp_path / 'hive')
    create_partitioned_dataset(url, 90)
    jds, tds = jindexed.IndexedDatasetReader(url), \
        tindexed.IndexedDatasetReader(url)
    for p in range(len(tds.pieces)):
        _same_columns(tds.read_piece(p), jds.read_piece(p))
        _same_columns(tds.read_piece(p, ('part', 'id')),
                      jds.read_piece(p, ('part', 'id')))
    assert set(tds.read_piece(0)['part']) <= {'p_0', 'p_1', 'p_2'}
    want, got = _stream_both(
        url, batch_size=7, num_epochs=2, seed=3,
        predicate=_pred(['part'], lambda v: v['part'] != 'p_1'))
    _same_streams(got, want)
    assert 'p_1' not in {x for b in got for x in b['part']}


@pytest.mark.timeout(60)
def test_gather_promotes_dtype_across_mixed_null_pieces(tmp_path):
    """A nullable int column: int64 in the null-free group, NaN-holed float
    in the other; gather promotes as JAX's does."""
    schema = JUnischema('N', [
        JField('id', np.int64, (), JScalarCodec(), False),
        JField('m', np.int64, (), JScalarCodec(), True)])
    url = 'file://' + str(tmp_path / 'mixed_nulls')
    vals = list(range(10)) + [None if i % 2 else i for i in range(10, 20)]
    with jmaterialize(url, schema, rows_per_file=10) as w:
        w.write_rows({'id': np.int64(i), 'm': vals[i]} for i in range(20))
    want, got = _stream_both(url, batch_size=20, num_epochs=1, shuffle=False)
    _same_streams(got, want)
    m = got[0]['m']
    assert m.dtype.kind == 'f'
    assert float(m[0]) == 0.0 and float(m[10]) == 10.0
    assert np.isnan(m[11]) and np.isnan(m[19])
    # both orders of the pieces in one batch
    want, got = _stream_both(url, batch_size=20, num_epochs=2, seed=1,
                             shuffle_window_groups=2)
    _same_streams(got, want)


# ---------------------------------------------------------------------------
# the loader's stream and cursor
# ---------------------------------------------------------------------------

@pytest.mark.timeout(60)
def test_epoch_covers_all_batched_rows_exactly_once(indexed_dataset):
    url, _ = indexed_dataset
    want, got = _stream_both(url, batch_size=32, num_epochs=1, seed=1)
    _same_streams(got, want)
    assert len(got) == ROWS // 32
    ids = np.concatenate([b['idx'] for b in got])
    assert len(np.unique(ids)) == len(ids)


@pytest.mark.timeout(60)
@pytest.mark.parametrize('workers', [1, 3, 8])
def test_any_worker_count_gives_jax_stream(indexed_dataset, workers):
    url, _ = indexed_dataset
    want = _stream(jmake_indexed_loader(url, batch_size=16, num_epochs=2,
                                        seed=3, workers_count=4))
    got = _stream(make_indexed_loader(url, batch_size=16, num_epochs=2,
                                      seed=3, workers_count=workers,
                                      prefetch_batches=2))
    _same_streams(got, want)


@pytest.mark.timeout(60)
def test_stress_many_workers_short_switch_interval(indexed_dataset):
    """16 workers on a tiny switch interval share the dataset's row-group
    cache and the permutation cache: the stream stays JAX's."""
    import sys
    url, _ = indexed_dataset
    want = _stream(jmake_indexed_loader(url, batch_size=8, num_epochs=3,
                                        seed=6, cache_groups=2))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _stream(make_indexed_loader(url, batch_size=8, num_epochs=3,
                                          seed=6, workers_count=16,
                                          prefetch_batches=4, cache_groups=2))
    finally:
        sys.setswitchinterval(interval)
    _same_streams(got, want)


@pytest.mark.timeout(60)
def test_kill_midepoch_restore_byte_identical(indexed_dataset):
    url, _ = indexed_dataset

    def make():
        return make_indexed_loader(url, batch_size=16, num_epochs=3, seed=9,
                                   workers_count=4)

    reference = _stream(make())
    _same_streams(reference, _stream(jmake_indexed_loader(
        url, batch_size=16, num_epochs=3, seed=9)))
    victim = make()
    it = iter(victim)
    for _ in range(10):
        next(it)
    state = victim.state_dict()
    it.close()
    assert state == {'epoch': 0, 'batch': 10, 'version': 1}
    restored = make()
    restored.load_state_dict(state)
    rest = _stream(restored)
    assert len(rest) == len(reference) - 10
    _same_streams(rest, reference[10:])


@pytest.mark.timeout(60)
def test_resume_across_epoch_boundary(indexed_dataset):
    url, _ = indexed_dataset

    def make(package):
        factory = (make_indexed_loader if package == 'torch'
                   else jmake_indexed_loader)
        return factory(url, batch_size=16, num_epochs=2, seed=4,
                       workers_count=2)

    reference = _stream(make('torch'))
    per_epoch = ROWS // 16
    states = {}
    for package in ('jax', 'torch'):
        victim = make(package)
        it = iter(victim)
        for _ in range(per_epoch):
            next(it)
        states[package] = victim.state_dict()
        it.close()
    assert states['torch'] == states['jax'] == {'epoch': 1, 'batch': 0,
                                                'version': 1}
    restored = make('torch')
    restored.load_state_dict(states['torch'])
    rest = _stream(restored)
    assert len(rest) == per_epoch
    _same_streams(rest, reference[per_epoch:])


@pytest.mark.timeout(60)
def test_folded_batch_restores_as_jax(indexed_dataset):
    """A ``batch`` past the epoch folds into epochs (JAX :506-509)."""
    url, _ = indexed_dataset
    per_epoch = ROWS // 16
    state = {'epoch': 0, 'batch': per_epoch + 3, 'version': 1}
    jl, tl = _both(url, batch_size=16, num_epochs=3, seed=2)
    jl.load_state_dict(dict(state))
    tl.load_state_dict(dict(state))
    assert tl.state_dict() == jl.state_dict() == {'epoch': 1, 'batch': 3,
                                                  'version': 1}
    _same_streams(_stream(tl), _stream(jl))


@pytest.mark.parametrize('state', [
    [1, 2], {'epoch': 0, 'batch': 0}, {'epoch': 0, 'batch': 0, 'version': 2},
    {'batch': 0, 'version': 1}, {'version': 1}])
def test_bad_states_raise_jax_words(indexed_dataset, state):
    url, _ = indexed_dataset
    jl, tl = _both(url, batch_size=16, num_epochs=1)
    with pytest.raises(ValueError) as jerr:
        jl.load_state_dict(state)
    with pytest.raises(ValueError) as terr:
        tl.load_state_dict(state)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.timeout(60)
def test_state_dict_points_at_the_next_batch(indexed_dataset):
    url, _ = indexed_dataset
    loader = make_indexed_loader(url, batch_size=16, num_epochs=1, seed=0)
    it = iter(loader)
    next(it)
    next(it)
    assert loader.state_dict() == {'epoch': 0, 'batch': 2, 'version': 1}
    it.close()
    loader.close()


@pytest.mark.timeout(60)
def test_no_shuffle_is_sequential(indexed_dataset):
    url, _ = indexed_dataset
    want, got = _stream_both(url, batch_size=32, num_epochs=1, shuffle=False)
    _same_streams(got, want)
    ids = np.concatenate([b['idx'] for b in got])
    np.testing.assert_array_equal(ids, np.arange(len(ids)))


def test_state_roundtrips_through_json(indexed_dataset):
    url, _ = indexed_dataset
    loader = make_indexed_loader(url, batch_size=32, num_epochs=1)
    state = json.loads(json.dumps(loader.state_dict()))
    loader.load_state_dict(state)
    assert loader.state_dict() == state


# ---------------------------------------------------------------------------
# plain parquet stores
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def foreign_url(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = tmp_path_factory.mktemp('foreign') / 'plain'
    path.mkdir()
    n = 120
    table = pa.table({'id': np.arange(n, dtype=np.int64),
                      'value': np.arange(n, dtype=np.float64) * 0.5})
    pq.write_table(table, str(path / 'part0.parquet'), row_group_size=16)
    return 'file://' + str(path), n


@pytest.mark.timeout(60)
def test_schema_inferred_and_values_exact(foreign_url):
    url, n = foreign_url
    want, got = _stream_both(url, batch_size=10, num_epochs=1, seed=1)
    _same_streams(got, want)
    loader = make_indexed_loader(url, batch_size=10, num_epochs=1, seed=1)
    assert set(loader.schema.fields) == {'id', 'value'}
    seen = np.sort(np.concatenate([b['id'] for b in got]))
    np.testing.assert_array_equal(seen, np.arange(n, dtype=np.int64))
    loader.close()


@pytest.mark.timeout(60)
def test_resume_on_foreign_store(foreign_url):
    url, _ = foreign_url
    full = _stream(make_indexed_loader(url, batch_size=10, num_epochs=2,
                                       seed=3))
    probe = make_indexed_loader(url, batch_size=10, num_epochs=2, seed=3)
    _stream(probe, limit=7)
    state = probe.state_dict()
    probe.close()
    restored = make_indexed_loader(url, batch_size=10, num_epochs=2, seed=3)
    restored.load_state_dict(state)
    rest = _stream(restored)
    assert len(rest) == len(full) - 7
    _same_streams(rest, full[7:])


# ---------------------------------------------------------------------------
# predicates, transforms, padding
# ---------------------------------------------------------------------------

def _pred(fields, fn):
    return (jin_lambda(fields, fn), in_lambda(fields, fn))


@pytest.mark.timeout(60)
def test_predicate_fixes_surviving_rows(indexed_dataset):
    url, _ = indexed_dataset
    pred = _pred(['idx'], lambda v: v['idx'] % 3 == 0)
    jl, tl = _both(url, batch_size=8, num_epochs=1, seed=0, predicate=pred)
    expected = np.arange(0, ROWS, 3, dtype=np.int64)
    assert tl.total_rows == jl.total_rows == len(expected)
    np.testing.assert_array_equal(tl._selection, jl._selection)
    got = _stream(tl)
    _same_streams(got, _stream(jl))
    seen = np.concatenate([b['idx'] for b in got])
    assert np.all(seen % 3 == 0)
    assert len(np.unique(seen)) == len(seen)
    tl.close()
    jl.close()


@pytest.mark.timeout(60)
def test_predicate_stream_deterministic_and_resumable(indexed_dataset):
    url, _ = indexed_dataset
    kwargs = dict(batch_size=8, num_epochs=2, seed=11)
    pred = in_lambda(['idx'], lambda v: v['idx'] % 2 == 0)
    full = _stream(make_indexed_loader(url, predicate=pred, **kwargs))
    _same_streams(full, _stream(jmake_indexed_loader(
        url, predicate=jin_lambda(['idx'], lambda v: v['idx'] % 2 == 0),
        **kwargs)))
    probe = make_indexed_loader(url, predicate=pred, **kwargs)
    _stream(probe, limit=5)
    state = probe.state_dict()
    probe.close()
    restored = make_indexed_loader(url, workers_count=1, predicate=pred,
                                   **kwargs)
    restored.load_state_dict(state)
    rest = _stream(restored)
    assert len(rest) == len(full) - 5
    _same_streams(rest, full[5:])


def test_unknown_predicate_field_fails_fast(indexed_dataset):
    url, _ = indexed_dataset
    with pytest.raises(ValueError, match='unknown fields') as terr:
        make_indexed_loader(url, batch_size=8,
                            predicate=in_lambda(['nope'], lambda v: True))
    with pytest.raises(ValueError) as jerr:
        jmake_indexed_loader(url, batch_size=8,
                             predicate=jin_lambda(['nope'], lambda v: True))
    assert str(terr.value) == str(jerr.value)


def test_predicate_rejecting_everything_raises(indexed_dataset):
    url, _ = indexed_dataset
    with pytest.raises(NoDataAvailableError, match='after predicate') as terr:
        make_indexed_loader(url, batch_size=8,
                            predicate=in_lambda(['idx'], lambda v: False))
    with pytest.raises(JNoData) as jerr:
        jmake_indexed_loader(url, batch_size=8,
                             predicate=jin_lambda(['idx'], lambda v: False))
    assert str(terr.value) == str(jerr.value)


def _shrink(columns):
    columns['vec'] = (columns['vec'][:, :3] * 2.0).astype(np.float32)
    return columns


def _resize_spec():
    """A deterministic worker transform: vec (5,) -> its first three
    components doubled (standing in for a decode and resize)."""
    return (JTransformSpec(_shrink,
                           edit_fields=[('vec', np.float32, (3,), False)],
                           selected_fields=['idx', 'vec']),
            TransformSpec(_shrink,
                          edit_fields=[('vec', np.float32, (3,), False)],
                          selected_fields=['idx', 'vec']))


@pytest.mark.timeout(60)
def test_transform_applied_and_schema_updated(indexed_dataset):
    url, rows = indexed_dataset
    jl, tl = _both(url, batch_size=8, num_epochs=1, seed=0, shuffle=False,
                   transform_spec=_resize_spec())
    assert tl.schema.fields['vec'].shape == (3,)
    got = _stream(tl)
    _same_streams(got, _stream(jl))
    batch = got[0]
    assert batch['vec'].shape == (8, 3)
    for i, idx in enumerate(batch['idx']):
        np.testing.assert_array_equal(
            batch['vec'][i], (rows[int(idx)]['vec'][:3] * 2.0)
            .astype(np.float32))
    tl.close()
    jl.close()


@pytest.mark.timeout(60)
def test_transform_resume_value_exact(indexed_dataset):
    url, _ = indexed_dataset
    kwargs = dict(batch_size=8, num_epochs=2, seed=9)
    spec = _resize_spec()[1]
    full = _stream(make_indexed_loader(url, transform_spec=spec, **kwargs))
    probe = make_indexed_loader(url, transform_spec=spec, **kwargs)
    _stream(probe, limit=11)
    state = probe.state_dict()
    probe.close()
    restored = make_indexed_loader(url, workers_count=2, transform_spec=spec,
                                   **kwargs)
    restored.load_state_dict(state)
    rest = _stream(restored)
    assert len(rest) == len(full) - 11
    _same_streams(rest, full[11:])


@pytest.mark.timeout(60)
def test_predicate_and_transform_compose(indexed_dataset):
    url, rows = indexed_dataset
    want, got = _stream_both(
        url, batch_size=8, num_epochs=1, seed=4,
        predicate=_pred(['idx'], lambda v: v['idx'] < 100),
        transform_spec=_resize_spec())
    _same_streams(got, want)
    for batch in got:
        assert np.all(batch['idx'] < 100)
        assert batch['vec'].shape == (8, 3)


@pytest.mark.timeout(60)
def test_predicate_may_use_fields_outside_view(indexed_dataset):
    url, _ = indexed_dataset
    want, got = _stream_both(
        url, batch_size=4, num_epochs=1, seed=0, schema_fields=['vec'],
        predicate=_pred(['idx'], lambda v: v['idx'] % 5 == 0))
    _same_streams(got, want)
    assert set(got[0].keys()) == {'vec'}


@pytest.fixture(scope='module')
def ragged_url(tmp_path_factory):
    schema = JUnischema('Ragged', [
        JField('idx', np.int64, (), JScalarCodec(), False),
        JField('seq', np.int32, (None,), JNdarrayCodec(), False),
    ])
    url = 'file://' + str(tmp_path_factory.mktemp('ragged_idx') / 'ds')
    rng = np.random.default_rng(1)
    rows = [{'idx': np.int64(i),
             'seq': rng.integers(0, 100, rng.integers(1, 9),
                                 dtype='int64').astype(np.int32)}
            for i in range(96)]
    with jmaterialize(url, schema, row_group_size_mb=0.001) as w:
        w.write_rows(rows)
    return url, rows


def _ragged(url, pad_spec, factory=make_indexed_loader):
    return factory(url, batch_size=16, num_epochs=2, seed=5, workers_count=2,
                   pad_spec=pad_spec)


@pytest.mark.timeout(60)
def test_padded_batches_dense_and_resumable(ragged_url):
    url, rows = ragged_url
    pad_spec = {'seq': {'max_len': 8, 'pad_value': -1}}
    full = _stream(_ragged(url, pad_spec))
    _same_streams(full, _stream(_ragged(url, pad_spec,
                                        jmake_indexed_loader)))
    for batch in full:
        assert batch['seq'].dtype == np.int32
        assert batch['seq'].shape == (16, 8)
        for r in range(16):
            n = int(batch['seq_len'][r])
            src = rows[int(batch['idx'][r])]
            np.testing.assert_array_equal(batch['seq'][r, :n], src['seq'])
            assert (batch['seq'][r, n:] == -1).all()
    first = _ragged(url, pad_spec)
    it = iter(first)
    for _ in range(3):
        next(it)
    state = first.state_dict()
    it.close()
    first.close()
    resumed = _ragged(url, pad_spec)
    resumed.load_state_dict(state)
    _same_streams(_stream(resumed), full[3:])


@pytest.mark.parametrize('pad_spec', [{'nope': {'max_len': 8}},
                                      {'seq': {'max_len': 8,
                                               'length_field': 'idx'}}])
def test_bad_pad_specs_raise_jax_words(ragged_url, pad_spec):
    url, _ = ragged_url
    with pytest.raises(ValueError) as terr:
        _ragged(url, pad_spec)
    with pytest.raises(ValueError) as jerr:
        _ragged(url, pad_spec, jmake_indexed_loader)
    assert str(terr.value) == str(jerr.value)
    assert 'unknown fields' in str(terr.value) or 'collides' in str(
        terr.value)


# ---------------------------------------------------------------------------
# the schedule, the pool and the handles
# ---------------------------------------------------------------------------

@pytest.mark.timeout(60)
def test_schedule_is_never_materialized(indexed_dataset):
    """10**6 epochs: the first batch arrives at once and the traced
    allocations stay small (the grid's tuples would take gigabytes)."""
    url, _ = indexed_dataset
    loader = make_indexed_loader(url, batch_size=16, num_epochs=10 ** 6,
                                 seed=0, workers_count=2, prefetch_batches=2)
    tracemalloc.start()
    try:
        it = iter(loader)
        first = next(it)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert first['idx'].shape == (16,)
    assert peak < 16 << 20, peak
    for _ in range(30):        # across epoch boundaries, still lazily
        next(it)
    assert loader.state_dict()['epoch'] == 31 // (ROWS // 16)
    it.close()
    loader.close()


@pytest.mark.timeout(60)
def test_ventilator_beats_and_window_bounds_in_flight(indexed_dataset,
                                                      monkeypatch):
    """The schedule's ventilator beats as ``ventilator`` and never holds
    more than ``workers_count + prefetch_batches`` items in flight."""
    from petastorm_tpu_torch.workers import thread_pool
    url, _ = indexed_dataset
    beats, peaks = [], []
    processed = thread_pool.VentilationJob.processed_item

    def counting(job):
        peaks.append(job.in_flight)
        processed(job)

    monkeypatch.setattr(thread_pool.VentilationJob, 'processed_item',
                        counting)
    loader = make_indexed_loader(url, batch_size=8, num_epochs=1, seed=0,
                                 workers_count=2, prefetch_batches=3)
    loader.heartbeat = lambda entity, stage: beats.append((entity, stage))
    got = _stream(loader)
    assert len(got) == ROWS // 8
    assert {e for e, _ in beats} == {'ventilator'}
    assert beats[0] == ('ventilator', 'ventilate')
    assert beats[-1] == ('ventilator', 'done')
    assert peaks and max(peaks) <= 2 + 3


@pytest.mark.timeout(30)
@pytest.mark.parametrize('extra', [{'items': [1]}, {'num_epochs': 2},
                                   {'shuffle': False}, {'seed': 3}])
def test_scheduled_pool_refuses_items_and_reset(extra):
    """A schedule is ventilated once, in place of the items' epochs: the
    pool refuses items, epochs, shuffle or seed beside it, and a reset."""
    from petastorm_tpu_torch.workers.thread_pool import ThreadPool
    args = dict({'items': []}, **extra)
    pool = ThreadPool(1)
    with pytest.raises(ValueError, match='in place of items'):
        pool.start(lambda item: item, schedule=iter(range(3)), **args)
    pool = ThreadPool(1)
    pool.start(lambda item: item, [], schedule=iter(range(3)))
    try:
        assert sorted(pool.get_results() for _ in range(3)) == [0, 1, 2]
        with pytest.raises(RuntimeError, match='ventilates its schedule'):
            pool.reset()
    finally:
        pool.stop()
        pool.join()


@pytest.mark.timeout(30)
def test_worker_exception_reaches_the_consumer(indexed_dataset):
    url, _ = indexed_dataset
    loader = make_indexed_loader(url, batch_size=8, num_epochs=1, seed=0,
                                 workers_count=3)
    assemble = loader._assemble

    def failing(epoch, batch):
        if batch == 4:
            raise KeyError('corrupt batch 4')
        return assemble(epoch, batch)

    loader._assemble = failing
    got = []
    with pytest.raises(KeyError, match='corrupt batch 4'):
        for batch in loader:
            got.append(batch)
    # the error is raised when its result is taken, which may be before
    # the batches ahead of it arrive
    assert len(got) <= 4
    assert not [t for t in threading.enumerate()
                if t.name.startswith('petastorm-torch-') and t.is_alive()]


class _CountingFilesystem:
    """``LOCAL_FILESYSTEM`` that keeps every file it opened."""

    protocol = 'file'

    def __init__(self):
        self.opened = []

    def open(self, path, mode='rb', **kwargs):
        f = LOCAL_FILESYSTEM.open(path, mode, **kwargs)
        self.opened.append(f)
        return f

    def __getattr__(self, name):
        return getattr(LOCAL_FILESYSTEM, name)


@pytest.mark.timeout(60)
def test_close_leaves_no_handle_open(indexed_dataset, monkeypatch):
    """Through a ``FaultyFilesystem`` over ``LOCAL_FILESYSTEM``: every
    handle the pool's threads, the predicate scan and the reads opened is
    closed after ``close()``."""
    url, _ = indexed_dataset
    counting = _CountingFilesystem()
    wrapped = FaultyFilesystem(counting, FaultInjector('none'))
    real = tindexed.get_filesystem_and_path_or_paths

    def resolve(url_, storage_options=None):
        _, path, factory = real(url_, storage_options)
        return wrapped, path, factory

    monkeypatch.setattr(tindexed, 'get_filesystem_and_path_or_paths',
                        resolve)
    loader = make_indexed_loader(
        url, batch_size=8, num_epochs=1, seed=0, workers_count=4,
        predicate=in_lambda(['idx'], lambda v: v['idx'] % 2 == 0))
    it = iter(loader)
    for _ in range(3):
        next(it)
    it.close()
    for batch in _stream(loader, limit=2):
        pass
    loader.close()
    assert counting.opened and wrapped.read_calls > 0
    assert all(f.closed for f in counting.opened)


def test_mesh_raises_not_implemented(indexed_dataset):
    """``mesh=`` is ported (the sharded loader): what still raises is a
    global batch that the mesh's ``data`` axis does not divide, in JAX's
    words (``tests/test_torch_sharded_indexed.py`` holds the sharded
    batches against JAX's)."""
    import types
    url, _ = indexed_dataset
    mesh = types.SimpleNamespace(mesh_dim_names=('data',), shape=(3,),
                                 device_type='cpu',
                                 get_local_rank=lambda axis: 0)
    with pytest.raises(ValueError) as terr:
        make_indexed_loader(url, batch_size=8, mesh=mesh)
    assert str(terr.value) == ("global batch_size 8 must divide evenly over "
                               "the 3 devices of mesh axis 'data'")
    mesh.shape = (1,)
    loader = make_indexed_loader(url, batch_size=8, mesh=mesh)
    assert isinstance(loader, tindexed.ShardedIndexedLoader)
    loader.close()


def test_finite_epochs_required(indexed_dataset):
    url, _ = indexed_dataset
    with pytest.raises(ValueError, match='finite num_epochs'):
        make_indexed_loader(url, batch_size=8, num_epochs=None)


def test_public_names():
    from petastorm_tpu_torch import indexed_mixture, indexed_ngram
    assert petastorm_tpu_torch.make_indexed_loader is \
        tindexed.make_indexed_loader
    assert petastorm_tpu_torch.make_indexed_ngram_loader is \
        indexed_ngram.make_indexed_ngram_loader
    assert petastorm_tpu_torch.WeightedIndexedMixture is \
        indexed_mixture.WeightedIndexedMixture
    assert {'make_indexed_loader', 'make_indexed_ngram_loader',
            'WeightedIndexedMixture'} <= set(petastorm_tpu_torch.__all__)
