"""The port's batch reader against the JAX package's on the same stores.

Stores come from the JAX package's own generators (a plain Parquet store,
a hive-partitioned one) or from numpy with a seed, at most 2,000 rows.
``make_batch_reader`` must infer the same Unischema and deliver the same
columns, by key, with the same dtypes and values (NaN where NaN); an
explicit list of files is read in the caller's order; an ``ArrowListCodec``
store written by either package reads in both through
``make_batch_reader`` and ``make_columnar_reader``; the pandas transform
gives the same fixed-shape columns and the same shape error. A
null-bearing numeric scalar column decodes as the JAX readers decode it:
NaN-holed floats on the columnar and batch paths, ``None`` on the row
path. Also the hello-world twin on the CPU.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import petastorm_tpu
from petastorm_tpu.codecs import (ArrowListCodec as JArrowListCodec,
                                  ScalarCodec as JScalarCodec)
from petastorm_tpu.etl.dataset_metadata import \
    infer_or_load_unischema as jinfer
from petastorm_tpu.test_util.dataset_gen import (create_non_petastorm_dataset,
                                                 create_partitioned_dataset)
from petastorm_tpu.unischema import (Unischema as JUnischema,
                                     UnischemaField as JField)

import petastorm_tpu_torch
from petastorm_tpu_torch import (TorchDataLoader, make_batch_reader,
                                 make_columnar_reader, make_reader)
from petastorm_tpu_torch.codecs import ArrowListCodec, ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import infer_or_load_unischema
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS = 600


def _numpy_store(url, seed=0, rows=ROWS):
    """A plain store from numpy: scalars (a nullable int64 and float32),
    a string, a fixed-length (6,) float32 list and a variable-length int32
    list, in 3 files of 2 row groups."""
    rng = np.random.default_rng(seed)
    path = url[len('file://'):]
    os.makedirs(path)
    ids = np.arange(rows, dtype=np.int64)
    maybe = rng.integers(0, 1000, rows).astype(object)
    maybe[rng.random(rows) < 0.2] = None
    scores = rng.standard_normal(rows).astype(np.float32).astype(object)
    scores[rng.random(rows) < 0.2] = None
    fixed = rng.standard_normal((rows, 6)).astype(np.float32)
    lengths = rng.integers(0, 5, rows)
    table = pa.table({
        'id': ids,
        'maybe': pa.array(list(maybe), pa.int64()),
        'score': pa.array(list(scores), pa.float32()),
        'word': ['w%d' % rng.integers(0, 50) for _ in range(rows)],
        'fixed': pa.array(list(fixed), pa.list_(pa.float32())),
        'ragged': pa.array([rng.integers(0, 9, n).astype(np.int32)
                            for n in lengths], pa.list_(pa.int32())),
    })
    per_file = -(-rows // 3)
    for k in range(3):
        pq.write_table(table.slice(k * per_file, per_file),
                       '%s/part_%05d.parquet' % (path, k),
                       row_group_size=per_file // 2 + 1)


STORES = {
    'plain': lambda url: create_non_petastorm_dataset(url, ROWS, num_files=3),
    'partitioned': lambda url: create_partitioned_dataset(url, ROWS),
    'numpy': _numpy_store,
}


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp('stores')
    urls = {}
    for name, make in STORES.items():
        urls[name] = 'file://' + str(root / name)
        make(urls[name])
    return urls


def _columns(batches):
    """Every delivered column, concatenated and sorted by ``id``."""
    fields = batches[0]._fields
    cols = {}
    for f in fields:
        parts = [getattr(b, f) for b in batches]
        if all(p.dtype != object for p in parts):
            cols[f] = np.concatenate(parts)
        else:
            cols[f] = np.empty(sum(len(p) for p in parts), dtype=object)
            cols[f][:] = [v for p in parts for v in p]
    order = np.argsort(cols['id'], kind='stable')
    return {f: v[order] for f, v in cols.items()}


def _assert_same_columns(got, ref):
    assert sorted(got) == sorted(ref)
    for name in ref:
        g, r = got[name], ref[name]
        assert g.dtype == r.dtype and g.shape == r.shape, (
            name, g.dtype, r.dtype, g.shape, r.shape)
        if r.dtype != object:
            np.testing.assert_array_equal(g, r, err_msg=name)   # NaN == NaN
            continue
        for a, b in zip(g, r):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
            else:
                assert type(a) is type(b) and a == b, (name, a, b)


def _read_both(url, factory='make_batch_reader', **kw):
    port = getattr(petastorm_tpu_torch, factory)
    jax = getattr(petastorm_tpu, factory)
    with port(url, workers_count=3, **kw) as reader:
        got = list(reader)
    with jax(url, workers_count=3, **kw) as reader:
        ref = list(reader)
    return got, ref


@pytest.mark.parametrize('store', sorted(STORES))
def test_inferred_unischema_matches_jax(stores, store):
    import fsspec
    path = stores[store][len('file://'):]
    got, got_stored = infer_or_load_unischema(path)
    ref, ref_stored = jinfer(fsspec.filesystem('file'), path)
    assert not got_stored and not ref_stored
    assert got.to_json() == ref.to_json()
    if store == 'partitioned':
        assert got.fields['part'].numpy_dtype is str


@pytest.mark.parametrize('store,kw', [
    ('plain', {}),
    ('plain', {'schema_fields': ['id', 'na.*']}),
    ('partitioned', {}),
    ('partitioned', {'filters': [('part', 'in', ['p_0', 'p_2'])]}),
    ('numpy', {}),
    ('numpy', {'filters': [('id', '>=', 250)], 'cur_shard': 1,
               'shard_count': 2}),
])
def test_batch_reader_matches_jax(stores, store, kw):
    got, ref = _read_both(stores[store], **kw)
    assert len(got) == len(ref)
    assert {type(b).__name__ for b in got} == {type(r).__name__ for r in ref}
    _assert_same_columns(_columns(got), _columns(ref))


def test_file_list_keeps_the_callers_order(stores):
    """Three files listed last first: one worker, no shuffle, so the
    delivered row order is the piece order, in both packages."""
    path = stores['plain'][len('file://'):]
    urls = ['file://%s/part_%05d.parquet' % (path, k) for k in (2, 0, 1)]
    kw = dict(workers_count=1, shuffle_row_groups=False)
    with make_batch_reader(urls, **kw) as reader:
        pieces = [(p.path, p.row_group) for p in reader.pieces]
        got = list(reader)
    with petastorm_tpu.make_batch_reader(urls, **kw) as reader:
        ref_pieces = [(p.path, p.row_group) for p in reader._pieces]
        ref = list(reader)
    assert pieces == ref_pieces
    assert [p for p, _ in pieces[::2]] == [u[len('file://'):] for u in urls]
    ids = np.concatenate([b.id for b in got])
    np.testing.assert_array_equal(ids, np.concatenate([b.id for b in ref]))
    assert ids[0] == 2 * (ROWS // 3)


def _list_schema(package):
    cls, field, scalar, lst = (
        (JUnischema, JField, JScalarCodec, JArrowListCodec) if package == 'jax'
        else (Unischema, UnischemaField, ScalarCodec, ArrowListCodec))
    return cls('ListSchema', [
        field('id', np.int64, (), scalar(), False),
        field('grid', np.uint8, (4, 7), lst(), False),
        field('seq', np.float32, (None,), lst(), False)])


@pytest.mark.parametrize('writer', ['jax', 'torch'])
@pytest.mark.parametrize('factory', ['make_batch_reader',
                                     'make_columnar_reader'])
def test_arrow_list_store_reads_in_both(tmp_path, writer, factory):
    url = 'file://' + str(tmp_path / 'lists')
    rng = np.random.default_rng(5)
    rows = [{'id': np.int64(i),
             'grid': rng.integers(0, 256, (4, 7), dtype=np.uint8),
             'seq': rng.standard_normal(int(rng.integers(1, 6))).astype(
                 np.float32)}
            for i in range(300)]
    materialize = (petastorm_tpu.materialize_dataset if writer == 'jax'
                   else petastorm_tpu_torch.materialize_dataset)
    with materialize(url, _list_schema(writer), row_group_size_mb=0.004,
                     rows_per_file=150) as w:
        w.write_rows(rows)
    got, ref = _read_both(url, factory)
    got_cols, ref_cols = _columns(got), _columns(ref)
    _assert_same_columns(got_cols, ref_cols)
    assert got_cols['grid'].shape == (300, 4, 7)
    np.testing.assert_array_equal(got_cols['grid'],
                                  np.stack([r['grid'] for r in rows]))


def _to_shape(df):
    df['fixed'] = df['fixed'].map(lambda a: np.asarray(a).reshape(2, 3) * 2)
    return df


def _wrong_shape(df):
    df['fixed'] = df['fixed'].map(lambda a: np.asarray(a).reshape(3, 2))
    return df


@pytest.mark.parametrize('func', [_to_shape, _wrong_shape])
def test_pandas_transform_matches_jax(stores, func):
    def spec(package):
        mod = petastorm_tpu if package == 'jax' else petastorm_tpu_torch
        return mod.TransformSpec(func, edit_fields=[('fixed', np.float32,
                                                     (2, 3), False)],
                                 removed_fields=['ragged'])
    url = stores['numpy']
    outcomes = []
    for package in ('torch', 'jax'):
        factory = (make_batch_reader if package == 'torch'
                   else petastorm_tpu.make_batch_reader)
        try:
            with factory(url, workers_count=2,
                         transform_spec=spec(package)) as reader:
                outcomes.append(_columns(list(reader)))
        except ValueError as e:
            outcomes.append(e)
    got, ref = outcomes
    if func is _wrong_shape:
        assert isinstance(got, ValueError) and isinstance(ref, ValueError)
        assert 'does not match schema shape' in str(got)
        return
    _assert_same_columns(got, ref)
    assert got['fixed'].shape == (ROWS, 2, 3) and 'ragged' not in got


def _nullable_store(tmp_path):
    """The smallest input of the null-column fault, written by the JAX
    package's ``materialize_dataset``."""
    url = 'file://' + str(tmp_path / 'nulls')
    schema = JUnischema('Nulls', [
        JField('id', np.int64, (), JScalarCodec(), False),
        JField('count', np.int64, (), JScalarCodec(), True),
        JField('weight', np.float32, (), JScalarCodec(), True)])
    with petastorm_tpu.materialize_dataset(url, schema) as w:
        w.write_rows([{'id': np.int64(0), 'count': None, 'weight': None},
                      {'id': np.int64(1), 'count': np.int64(1),
                       'weight': np.float32(1.0)},
                      {'id': np.int64(2), 'count': np.int64(2),
                       'weight': np.float32(2.5)}])
    return url


@pytest.mark.parametrize('factory', ['make_columnar_reader',
                                     'make_batch_reader', 'make_reader'])
def test_null_numeric_columns_decode_as_jax(tmp_path, factory):
    url = _nullable_store(tmp_path)
    got, ref = _read_both(url, factory)
    if factory == 'make_reader':
        by_id = {int(r.id): r for r in got}
        ref_by_id = {int(r.id): r for r in ref}
        assert by_id[0].count is None and by_id[0].weight is None
        for i in (1, 2):
            for name in ('count', 'weight'):
                g, r = getattr(by_id[i], name), getattr(ref_by_id[i], name)
                assert type(g) is type(r) and g == r
        return
    got_cols, ref_cols = _columns(got), _columns(ref)
    _assert_same_columns(got_cols, ref_cols)
    assert got_cols['count'].dtype == np.float64
    assert got_cols['weight'].dtype == np.float32
    assert np.isnan(got_cols['count'][0]) and got_cols['count'][2] == 2
    with getattr(petastorm_tpu_torch, factory)(url, workers_count=1) as r:
        batch = next(iter(TorchDataLoader(r, batch_size=3, device='cpu')))
    assert batch['count'].dtype == torch.float64
    assert int(torch.isnan(batch['count']).sum()) == 1


def test_fixed_list_columns_become_tensors(tmp_path):
    """A fixed-shape ``ArrowListCodec`` field reaches ``TorchDataLoader``
    as ``(n, *shape)`` and becomes a tensor of its dtype."""
    url = 'file://' + str(tmp_path / 'grid')
    with petastorm_tpu_torch.materialize_dataset(
            url, _list_schema('torch'), row_group_size_mb=0.004) as w:
        w.write_rows({'id': np.int64(i),
                      'grid': np.full((4, 7), i % 256, np.uint8),
                      'seq': np.zeros(2, np.float32)} for i in range(200))
    with make_batch_reader(url, workers_count=2,
                           schema_fields=['id', 'grid']) as reader:
        batch = next(iter(TorchDataLoader(reader, batch_size=64,
                                          device='cpu')))
    assert batch['grid'].dtype == torch.uint8
    assert tuple(batch['grid'].shape) == (64, 4, 7)
    assert torch.equal(batch['grid'][:, 0, 0],
                       (batch['id'] % 256).to(torch.uint8))


def test_metadata_less_store_needs_batch_reader(stores):
    with pytest.raises(RuntimeError, match='make_batch_reader'):
        make_reader(stores['plain'])
    with pytest.raises(RuntimeError, match='make_batch_reader'):
        make_columnar_reader(stores['plain'])
    with pytest.raises(ValueError, match='regex strings'):
        make_batch_reader(stores['plain'], schema_fields=[object()])


class TestHelloWorld:
    """The twin of ``tests/test_examples.py::TestHelloWorld``, on the CPU."""

    def test_generate_and_read(self, tmp_path, capsys):
        from petastorm_tpu_torch.examples.hello_world.main import (
            generate_petastorm_tpu_dataset, python_hello_world,
            torch_hello_world)
        url = 'file://' + str(tmp_path / 'hw')
        generate_petastorm_tpu_dataset(url, rows_count=4)
        python_hello_world(url)
        torch_hello_world(url, device='cpu')
        out = capsys.readouterr().out
        assert '(128, 256, 3)' in out
        assert 'batch of 4 images (4, 128, 256, 3)' in out

    def test_external_dataset(self, stores, capsys):
        from petastorm_tpu_torch.examples.hello_world.main import \
            external_dataset_hello_world
        external_dataset_hello_world(stores['plain'])
        out = capsys.readouterr().out
        assert "columns: ('id', 'name', 'value')" in out


def test_import_pulls_in_no_pandas():
    """pandas is reached only inside the batch transform: importing every
    module of the port loads none of it."""
    import subprocess
    import sys
    code = ('import importlib, pkgutil, sys\n'
            'import petastorm_tpu_torch as p\n'
            'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
            '    importlib.import_module(m.name)\n'
            'assert "pandas" not in sys.modules\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
