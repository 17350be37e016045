"""The port's selection surface against the JAX package's on the same stores.

Over a grid of ``filters`` (partition values, statistics, mixed, ``in`` /
``not in``, strings, DNF), ``cur_shard``/``shard_count`` and a
``SingleIndexSelector``, the port keeps the same row-group pieces as JAX,
as (path, row group), and raises ``NoDataAvailableError`` where JAX does.
Under a predicate, residual filters, a shard and row-drop partitions, the
row, columnar and batch readers deliver JAX's rows. ``in_pseudorandom_split``
buckets int, str and bytes keys as JAX does; ``in_set.column_mask`` agrees
with ``do_include``; a row-group index built by either package reads in
the other; the row ``transform_spec`` gives JAX's rows.
"""

import fsspec
import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu import predicates as jpred
from petastorm_tpu import selectors as jsel
from petastorm_tpu.errors import NoDataAvailableError as JNoData
from petastorm_tpu.etl import rowgroup_indexing as jindexing
from petastorm_tpu.etl.rowgroup_indexers import \
    SingleFieldIndexer as JSingleFieldIndexer
from petastorm_tpu.test_util.dataset_gen import create_partitioned_dataset

import petastorm_tpu_torch
from petastorm_tpu_torch import NoDataAvailableError
from petastorm_tpu_torch import predicates as tpred
from petastorm_tpu_torch import selectors as tsel
from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.etl import rowgroup_indexing as tindexing
from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS = 1000

RowsSchema = Unischema('RowsSchema', [
    UnischemaField('id', np.int64, (), ScalarCodec(), False),
    UnischemaField('bucket', np.int64, (), ScalarCodec(), False),
    UnischemaField('name', str, (), ScalarCodec(), False),
    UnischemaField('weight', np.float32, (), ScalarCodec(), True),
])


def _write_rows_store(url):
    """1,000 rows in 2 files of about 50-row row groups; ``bucket`` is
    ``id // 100``, ``name`` sorts as ``id`` does."""
    rng = np.random.default_rng(11)
    weights = rng.standard_normal(ROWS).astype(np.float32)
    with petastorm_tpu_torch.materialize_dataset(
            url, RowsSchema, row_group_size_mb=0.0015,
            rows_per_file=ROWS // 2) as w:
        w.write_rows({'id': np.int64(i), 'bucket': np.int64(i // 100),
                      'name': 'row_%04d' % i,
                      'weight': None if i % 9 == 0 else weights[i]}
                     for i in range(ROWS))


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp('filters')
    rows_url = 'file://' + str(root / 'rows')
    _write_rows_store(rows_url)
    tindexing.build_rowgroup_index(
        rows_url, [SingleFieldIndexer('bucket_ix', 'bucket')])
    part_url = 'file://' + str(root / 'part')
    create_partitioned_dataset(part_url, 600)
    return {'rows': rows_url, 'part': part_url}


def test_rows_store_has_many_row_groups(stores):
    with petastorm_tpu_torch.make_reader(stores['rows'],
                                         workers_count=1) as reader:
        assert len(reader.pieces) >= 16


FILTERS = {
    'partition': ('part', [('part', '=', 'p_1')]),
    'partition_in': ('part', [('part', 'in', ['p_0', 'p_2'])]),
    'mixed': ('part', [('part', '!=', 'p_0'), ('id', '>=', 300)]),
    'stats': ('rows', [('id', '<', 300)]),
    'in': ('rows', [('id', 'in', [5, 250, 900])]),
    'not_in': ('rows', [('bucket', 'not in', [0, 1, 2])]),
    'string': ('rows', [('name', '>', 'row_0600')]),
    'dnf': ('rows', [[('id', '<', 100)], [('id', '>=', 900)]]),
    'none_left': ('rows', [('id', '>', 10 ** 6)]),
}
SHARDS = [None, (0, 2), (1, 3)]


def _grid():
    for name, (store, _) in FILTERS.items():
        for shard in SHARDS:
            for selector in ([False, True] if store == 'rows' else [False]):
                yield pytest.param(name, shard, selector,
                                   id='%s-%s-%s' % (name, shard, selector))


def _pieces_or_error(factory, url, kw, attr):
    try:
        with factory(url, workers_count=1, **kw) as reader:
            return [(p.path, p.row_group) for p in getattr(reader, attr)]
    except (NoDataAvailableError, JNoData) as e:
        return type(e).__name__


@pytest.mark.parametrize('name,shard,selector', list(_grid()))
def test_filtered_pieces_match_jax(stores, name, shard, selector):
    store, filters = FILTERS[name]
    kw = {'filters': filters}
    if shard is not None:
        kw.update(cur_shard=shard[0], shard_count=shard[1])
    factory = 'make_reader' if store == 'rows' else 'make_batch_reader'
    port_kw, jax_kw = dict(kw), dict(kw)
    if selector:
        port_kw['rowgroup_selector'] = tsel.SingleIndexSelector(
            'bucket_ix', [1, 4, 7])
        jax_kw['rowgroup_selector'] = jsel.SingleIndexSelector(
            'bucket_ix', [1, 4, 7])
    got = _pieces_or_error(getattr(petastorm_tpu_torch, factory),
                           stores[store], port_kw, 'pieces')
    ref = _pieces_or_error(getattr(petastorm_tpu, factory), stores[store],
                           jax_kw, '_pieces')
    assert got == ref
    if name == 'none_left' or (name == 'partition' and shard == (1, 3)):
        assert got == 'NoDataAvailableError'


def test_partition_predicate_prunes_as_jax(stores):
    got = _pieces_or_error(petastorm_tpu_torch.make_batch_reader,
                           stores['part'],
                           {'predicate': tpred.in_set({'p_2'}, 'part')},
                           'pieces')
    ref = _pieces_or_error(petastorm_tpu.make_batch_reader, stores['part'],
                           {'predicate': jpred.in_set({'p_2'}, 'part')},
                           '_pieces')
    assert got == ref and len(got) == 2


def _rows_by_id(rows):
    out = {}
    for r in rows:
        d = r._asdict()
        key = int(d['id'])
        assert key not in out, 'row %d delivered twice' % key
        out[key] = d
    return out


def _columns_by_id(batches):
    out = {}
    for b in batches:
        d = b._asdict()
        for i, key in enumerate(d['id']):
            assert int(key) not in out, 'row %d delivered twice' % key
            out[int(key)] = {k: v[i] for k, v in d.items()}
    return out


def _same_value(a, b):
    if a is None or b is None:
        return a is b
    if isinstance(b, float) or isinstance(b, np.floating):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize('factory', ['make_reader', 'make_columnar_reader',
                                     'make_batch_reader'])
def test_selected_rows_match_jax(stores, factory):
    """Predicate + residual filters + shard (+ row-drop partitions where
    JAX's factory takes them): the same rows, the same values."""
    kw = dict(filters=[('id', '<', 800), ('bucket', '!=', 3)], cur_shard=0,
              shard_count=2, workers_count=3, seed=1)
    if factory != 'make_batch_reader':
        kw['shuffle_row_drop_partitions'] = 2
    with getattr(petastorm_tpu_torch, factory)(
            stores['rows'], predicate=tpred.in_pseudorandom_split(
                [0.7, 0.3], 0, 'id'), **kw) as reader:
        got = list(reader)
    with getattr(petastorm_tpu, factory)(
            stores['rows'], predicate=jpred.in_pseudorandom_split(
                [0.7, 0.3], 0, 'id'), **kw) as reader:
        ref = list(reader)
    by_id = _rows_by_id if factory == 'make_reader' else _columns_by_id
    got, ref = by_id(got), by_id(ref)
    assert sorted(got) == sorted(ref) and 100 < len(got) < 400
    assert all(k < 800 and k // 100 != 3 for k in got)
    for key, row in ref.items():
        assert set(got[key]) == set(row)
        for name, value in row.items():
            assert _same_value(got[key][name], value), (key, name)


@pytest.mark.parametrize('kind', ['int', 'numpy_int', 'str', 'bytes'])
def test_pseudorandom_split_buckets_match_jax(kind):
    rng = np.random.default_rng(3)
    raw = rng.integers(-10 ** 12, 10 ** 12, 10000)
    keys = {'int': [int(k) for k in raw], 'numpy_int': list(raw),
            'str': ['key-%d' % k for k in raw],
            'bytes': [b'\x00\xff%d' % k for k in raw]}[kind]
    fractions = [0.3, 0.5, 0.2]
    counts = []
    for subset in range(3):
        port = tpred.in_pseudorandom_split(fractions, subset, 'k')
        jax = jpred.in_pseudorandom_split(fractions, subset, 'k')
        got = [port.do_include({'k': k}) for k in keys]
        assert got == [jax.do_include({'k': k}) for k in keys]
        counts.append(sum(got))
    assert sum(counts) == 10000 and all(c > 1000 for c in counts)


@pytest.mark.parametrize('column,values', [
    (np.arange(50, dtype=np.int64), {3, 7, 49, 1000}),
    (np.arange(50, dtype=np.int32), {3.0, 7.5}),
    (np.linspace(0, 1, 50), {0.0, 1.0, float('nan')}),
    (np.linspace(0, 1, 50).astype(np.float32), {0.0, 1}),
    (np.array(['a', 'b', 'c'] * 10), {'a', 'c'}),
    (np.array([b'x', b'y'] * 10), {b'y'}),
    (np.array(['a', None, 'c'] * 10, dtype=object), {'a'}),
    (np.arange(20, dtype=np.uint64), {-1, 5}),
])
def test_in_set_column_mask_agrees_with_do_include(column, values):
    port = tpred.in_set(values, 'f')
    want = [port.do_include({'f': v}) for v in column]
    assert want == [jpred.in_set(values, 'f').do_include({'f': v})
                    for v in column]
    mask = port.column_mask({'f': column})
    ref_mask = jpred.in_set(values, 'f').column_mask({'f': column})
    assert (mask is None) == (ref_mask is None)
    if mask is not None:
        assert mask.tolist() == want


@pytest.mark.parametrize('builder', ['torch', 'jax'])
def test_rowgroup_index_reads_across_packages(tmp_path, builder):
    url = 'file://' + str(tmp_path / 'rows')
    _write_rows_store(url)
    if builder == 'torch':
        tindexing.build_rowgroup_index(
            url, [SingleFieldIndexer('bucket_ix', 'bucket'),
                  SingleFieldIndexer('name_ix', 'name')])
    else:
        jindexing.build_rowgroup_index(
            url, [JSingleFieldIndexer('bucket_ix', 'bucket'),
                  JSingleFieldIndexer('name_ix', 'name')])
    path = url[len('file://'):]
    got = tindexing.get_row_group_indexes(path)
    ref = jindexing.get_row_group_indexes(fsspec.filesystem('file'), path)
    assert sorted(got) == sorted(ref) == ['bucket_ix', 'name_ix']
    for name in ref:
        assert got[name].to_json_dict() == ref[name].to_json_dict()
    assert got['bucket_ix'].get_row_group_indexes(4) == \
        ref['bucket_ix'].get_row_group_indexes(4) != set()


def _double_and_square(row):
    row = dict(row)
    row['bucket'] = row['bucket'] * 2
    row['square'] = row['id'] * row['id']
    return row


def test_row_transform_matches_jax(stores):
    def spec(mod):
        return mod.TransformSpec(_double_and_square,
                                 edit_fields=[('square', np.int64, (),
                                               False)],
                                 removed_fields=['name'])
    rows = []
    for mod in (petastorm_tpu_torch, petastorm_tpu):
        with mod.make_reader(stores['rows'], workers_count=2,
                             transform_spec=spec(mod),
                             filters=[('id', '<', 200)]) as reader:
            rows.append(_rows_by_id(list(reader)))
            fields = sorted(reader.schema.fields)
    got, ref = rows
    assert fields == ['bucket', 'id', 'square', 'weight']
    assert sorted(got) == sorted(ref) == list(range(200))
    for key, row in ref.items():
        for name, value in row.items():
            assert _same_value(got[key][name], value), (key, name)
    assert got[150]['square'] == 22500 and got[150]['bucket'] == 2


def test_shards_outnumbering_pieces_raise_as_jax(stores):
    kw = {'filters': [('id', '<', 60)], 'cur_shard': 0, 'shard_count': 5}
    got = _pieces_or_error(petastorm_tpu_torch.make_reader, stores['rows'],
                           kw, 'pieces')
    ref = _pieces_or_error(petastorm_tpu.make_reader, stores['rows'], kw,
                           '_pieces')
    assert got == 'NoDataAvailableError' == ref
    with pytest.raises(ValueError, match='cur_shard'):
        petastorm_tpu_torch.make_reader(stores['rows'], cur_shard=2,
                                        shard_count=2)
