"""The port's tools and metadata surface against the JAX package's, on the
CPU: ``tools/copy_dataset.py``, ``etl/generate_metadata.py``,
``etl/metadata_util.py``, ``etl.get_schema_from_dataset_url`` and the
``etl`` re-exports, ``unischema.decode_row``,
``pyarrow_helpers.BatchingTableQueue`` and the codec extension surface
(``DataframeColumnCodec``, ``register_codec``, ``codec_from_json_dict``).

The copy and metadata cases of ``tests/test_tools.py`` run on both
packages over the same source: the two copies hold the same cells, and
the port's copy read back equals the source's rows; the console tools
print what JAX's print. A user codec defined once for each package under
one name writes a store in one package that the other reads, value for
value.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import codecs as jcodecs
from petastorm_tpu.etl import dataset_metadata as jdm
from petastorm_tpu.reader import make_reader as jmake_reader
from petastorm_tpu.unischema import Unischema as JUnischema
from petastorm_tpu.unischema import UnischemaField as JField

from petastorm_tpu_torch import codecs
from petastorm_tpu_torch.etl import dataset_metadata as dm
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


def read_rows(factory, url, **kw):
    """``{id: row dict}`` of a store, read on the dummy pool."""
    with factory(url, reader_pool_type='dummy', num_epochs=1, **kw) as r:
        return {int(row.id): row._asdict() for row in r}


def assert_rows_equal(got, want):
    """Equal values and dtypes; a string array's width may differ (a row
    group's string cells decode to its widest)."""
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key])
        for name, value in want[key].items():
            if value is None:
                assert got[key][name] is None, name
                continue
            np.testing.assert_array_equal(got[key][name], value)
            g, w = np.asarray(got[key][name]).dtype, np.asarray(value).dtype
            assert g.kind == w.kind if w.kind == 'U' else g == w, name


def both_copies(tmp_path, source, **kw):
    """The source copied by each package's ``copy_dataset``: ``(port
    count, JAX count, port url, JAX url)``."""
    from petastorm_tpu.tools.copy_dataset import copy_dataset as jcopy

    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    port_url = 'file://' + str(tmp_path / 'port_copy')
    jax_url = 'file://' + str(tmp_path / 'jax_copy')
    return (copy_dataset(source, port_url, **kw), jcopy(source, jax_url, **kw),
            port_url, jax_url)


# -- copy_dataset ---------------------------------------------------------------

@pytest.mark.parametrize('kw', [
    {},
    {'field_regex': ['^id.*']},
    {'field_regex': ['id', 'matrix_nullable'],
     'not_null_fields': ['matrix_nullable']},
    {'field_regex': ['^id$', 'matrix', 'image_png'], 'rows_per_file': 17,
     'row_group_size_mb': 0.01},
], ids=['full', 'field-subset', 'not-null', 'layout'])
def test_copy_as_jax(synthetic_dataset, tmp_path, kw):
    n, jn, port_url, jax_url = both_copies(tmp_path, synthetic_dataset.url,
                                           **kw)
    assert n == jn
    # both copies hold the same cells; read back by the port, they are the
    # source's rows as JAX reads them (its reader truncates strings of
    # wider rows in a row group of several, so it reads the one-row groups
    # of the source)
    tables = [pq.read_table(u[len('file://'):], columns=sorted(
        dm.get_schema_from_dataset_url(u).fields)).sort_by('id')
        for u in (port_url, jax_url)]
    assert tables[0].equals(tables[1])
    got = read_rows(make_reader, port_url)
    fields = list(dm.get_schema_from_dataset_url(port_url).fields)
    want = {i: {k: v for k, v in row.items() if k in fields}
            for i, row in read_rows(jmake_reader,
                                    synthetic_dataset.url).items()
            if i in got}
    assert_rows_equal(got, want)
    assert dm.get_schema_from_dataset_url(port_url).to_json() == \
        jdm.get_schema_from_dataset_url(jax_url).to_json()
    if 'not_null_fields' in kw:
        assert n == len([r for r in synthetic_dataset.data
                         if r['matrix_nullable'] is not None])
    else:
        assert n == len(synthetic_dataset.data)
    if 'rows_per_file' in kw:
        groups = [(p.path.rsplit('/', 1)[-1], p.num_rows)
                  for p in dm.load_row_groups(port_url[len('file://'):])]
        jgroups = [(p.path.rsplit('/', 1)[-1], p.num_rows)
                   for p in jdm.load_row_groups(
                       *jdm.get_filesystem_and_path_or_paths(jax_url)[:2])]
        assert groups == jgroups
        assert len({f for f, _ in groups}) == -(-n // kw['rows_per_file'])


def test_copy_refuses_an_existing_target_unless_overwritten(
        synthetic_dataset, tmp_path):
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    target = 'file://' + str(tmp_path / 'copy')
    copy_dataset(synthetic_dataset.url, target, field_regex=['^id$'])
    with pytest.raises(ValueError, match='overwrite'):
        copy_dataset(synthetic_dataset.url, target, field_regex=['^id$'])
    assert copy_dataset(synthetic_dataset.url, target, field_regex=['^id2$'],
                        overwrite_output=True) == len(synthetic_dataset.data)
    assert set(dm.get_schema_from_dataset_url(target).fields) == {'id2'}


@pytest.mark.parametrize('kw,exc', [
    ({'field_regex': ['^nothing$']}, 'matched no fields'),
    ({'not_null_fields': ['no_such_field']}, 'not in schema'),
])
def test_copy_errors_in_jax_words(synthetic_dataset, tmp_path, kw, exc):
    from petastorm_tpu.tools.copy_dataset import copy_dataset as jcopy

    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    with pytest.raises(ValueError, match=exc) as got:
        copy_dataset(synthetic_dataset.url,
                     'file://' + str(tmp_path / 'a'), **kw)
    with pytest.raises(ValueError) as want:
        jcopy(synthetic_dataset.url, 'file://' + str(tmp_path / 'b'), **kw)
    assert str(got.value) == str(want.value)


def test_copy_with_storage_options(synthetic_dataset, tmp_path):
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    target = 'file://' + str(tmp_path / 'copy')
    assert copy_dataset(synthetic_dataset.url, target, field_regex=['^id$'],
                        storage_options={}) == len(synthetic_dataset.data)


def test_copy_cli_main_as_jax(synthetic_dataset, tmp_path):
    from petastorm_tpu.tools import copy_dataset as jtool

    from petastorm_tpu_torch.tools import copy_dataset as tool
    target = 'file://' + str(tmp_path / 'cli_copy')
    assert tool.main([synthetic_dataset.url, target, '--field-regex', '^id$',
                      '--rows-per-file', '30']) == 0
    assert sorted(read_rows(make_reader, target)) == sorted(
        r['id'] for r in synthetic_dataset.data)
    actions = [(a.dest, a.nargs, a.type, a.default)
               for a in tool.build_parser()._actions]
    assert actions == [(a.dest, a.nargs, a.type, a.default)
                       for a in jtool.build_parser()._actions]


# -- metadata_util --------------------------------------------------------------

def _printed(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_metadata_util_prints_as_jax(synthetic_dataset, capsys):
    from petastorm_tpu.etl.metadata_util import main as jmain

    from petastorm_tpu_torch.etl.metadata_util import main
    argv = [synthetic_dataset.url, '--schema', '--row-groups']
    out = _printed(main, argv, capsys)
    assert 'Schema (stored)' in out and 'row groups' in out
    assert 'matrix' in out
    assert out == _printed(jmain, argv, capsys)


def test_metadata_util_inferred_schema_as_jax(non_petastorm_dataset, capsys):
    from petastorm_tpu.etl.metadata_util import main as jmain

    from petastorm_tpu_torch.etl.metadata_util import main
    argv = [non_petastorm_dataset.url, '--schema', '--row-groups']
    out = _printed(main, argv, capsys)
    assert 'Schema (inferred)' in out
    assert out == _printed(jmain, argv, capsys)


def test_metadata_util_prints_index_as_jax(tmp_path, capsys):
    from petastorm_tpu.etl.metadata_util import main as jmain
    from petastorm_tpu.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu.test_util.dataset_gen import create_test_dataset

    from petastorm_tpu_torch.etl.metadata_util import main
    url = 'file://' + str(tmp_path / 'indexed_meta')
    create_test_dataset(url, range(20))
    build_rowgroup_index(url, [SingleFieldIndexer('by_pk', 'partition_key'),
                               SingleFieldIndexer('by_id2', 'id2')])
    out = _printed(main, [url, '--index'], capsys)
    assert 'by_pk' in out and 'by_id2' in out
    assert out == _printed(jmain, [url, '--index'], capsys)
    skipped = _printed(main, [url, '--index', '--skip-index', 'by_pk'],
                       capsys)
    assert 'by_pk' not in skipped and 'by_id2' in skipped
    assert skipped == _printed(
        jmain, [url, '--index', '--skip-index', 'by_pk'], capsys)


# -- generate_metadata ------------------------------------------------------

def _plain_store(path, n=40):
    path.mkdir(parents=True)
    table = pa.table({'id': np.arange(n, dtype=np.int64),
                      'x': np.arange(n, dtype=np.float32) * 0.5,
                      'name': ['r%d' % i for i in range(n)]})
    pq.write_table(table.slice(0, n // 2), str(path / 'part_0.parquet'),
                   row_group_size=7)
    pq.write_table(table.slice(n // 2), str(path / 'part_1.parquet'),
                   row_group_size=7)
    return 'file://' + str(path)


def test_generate_metadata_on_a_plain_store_as_jax(tmp_path):
    from petastorm_tpu.etl.generate_metadata import \
        generate_metadata as jgenerate

    from petastorm_tpu_torch.etl.generate_metadata import generate_metadata
    port_url = _plain_store(tmp_path / 'port')
    jax_url = _plain_store(tmp_path / 'jax')
    generate_metadata(port_url)
    jgenerate(jax_url)
    schema = dm.get_schema_from_dataset_url(port_url)
    assert schema.to_json() == jdm.get_schema_from_dataset_url(
        jax_url).to_json()
    port_meta = dm.read_common_metadata(port_url[len('file://'):])
    jax_meta = dm.read_common_metadata(jax_url[len('file://'):])
    assert port_meta == jax_meta
    got = read_rows(make_reader, port_url)
    assert got == read_rows(jmake_reader, jax_url)
    assert sorted(got) == list(range(40))
    assert [p.num_rows for p in dm.load_row_groups(port_url[7:])] == \
        [7, 7, 6, 7, 7, 6]


def test_generate_metadata_keeps_the_index_and_takes_a_schema_class(
        tmp_path, monkeypatch):
    import sys
    import types

    from petastorm_tpu_torch.etl.generate_metadata import (
        _import_unischema, generate_metadata, main)
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import (
        build_rowgroup_index, get_row_group_indexes)
    url = _plain_store(tmp_path / 'store')
    generate_metadata(url)
    build_rowgroup_index(url, [SingleFieldIndexer('by_name', 'name')])
    declared = Unischema('Declared', [
        UnischemaField('id', np.int64, (), None, False),
        UnischemaField('x', np.float32, (), None, False),
        UnischemaField('name', str, (), None, False)])
    module = types.ModuleType('declared_schemas')
    module.Declared = declared
    module.NotASchema = 3
    monkeypatch.setitem(sys.modules, 'declared_schemas', module)
    assert _import_unischema('declared_schemas.Declared') is declared
    with pytest.raises(ValueError, match='not a Unischema'):
        _import_unischema('declared_schemas.NotASchema')
    with pytest.raises(ValueError, match='full module path'):
        _import_unischema('Declared')
    main([url, '--unischema-class', 'declared_schemas.Declared'])
    assert dm.get_schema_from_dataset_url(url).to_json() == declared.to_json()
    assert set(get_row_group_indexes(url[len('file://'):])) == {'by_name'}


def test_generate_metadata_without_files_raises(tmp_path):
    from petastorm_tpu_torch.errors import PetastormMetadataError
    from petastorm_tpu_torch.etl.generate_metadata import generate_metadata
    (tmp_path / 'empty').mkdir()
    (tmp_path / 'empty' / 'part_0.parquet').write_bytes(b'')
    (tmp_path / 'empty' / 'part_0.parquet').unlink()
    with pytest.raises(PetastormMetadataError):
        generate_metadata('file://' + str(tmp_path / 'empty'))


# -- get_schema_from_dataset_url, the etl names, decode_row --------------------

def test_get_schema_from_dataset_url_as_jax(synthetic_dataset):
    got = dm.get_schema_from_dataset_url(synthetic_dataset.url + '/',
                                         storage_options={})
    assert got.to_json() == jdm.get_schema_from_dataset_url(
        synthetic_dataset.url).to_json()


def test_etl_names_as_jax():
    import petastorm_tpu.etl as jetl

    import petastorm_tpu_torch.etl as etl
    names = ['materialize_dataset', 'load_row_groups', 'get_schema',
             'get_schema_from_dataset_url', 'infer_or_load_unischema',
             'RowGroupPiece']
    assert sorted(etl.__all__) == sorted(names)
    for name in names:
        assert hasattr(jetl, name)
        assert getattr(etl, name) is getattr(dm, name)


def test_decode_row_as_jax(synthetic_dataset):
    """Stored rows of the synthetic store (every codec, nulls, strings, a
    partition value) decoded by both packages' ``decode_row``, with an
    override on one field."""
    from petastorm_tpu.unischema import decode_row as jdecode

    from petastorm_tpu_torch.unischema import decode_row
    path = synthetic_dataset.path
    schema = dm.get_schema(path)
    jschema = jdm.get_schema(*jdm.get_filesystem_and_path_or_paths(
        synthetic_dataset.url)[:2])
    piece = dm.load_row_groups(path)[0]
    rows = pq.ParquetFile(piece.path).read_row_group(
        piece.row_group).to_pylist()
    overrides = {'id2': lambda v: -v}
    for row in rows:
        row = dict(row, not_in_schema=1)
        got = decode_row(dict(row), schema, overrides)
        want = jdecode(dict(row), jschema, overrides)
        assert set(got) == set(want)
        assert 'not_in_schema' not in got
        for name in want:
            if want[name] is None:
                assert got[name] is None
                continue
            assert type(got[name]) is type(want[name]), name
            np.testing.assert_array_equal(got[name], want[name])


# -- BatchingTableQueue ---------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_batching_table_queue_as_jax(seed):
    from petastorm_tpu.pyarrow_helpers import \
        BatchingTableQueue as JQueue

    from petastorm_tpu_torch.pyarrow_helpers import BatchingTableQueue
    rng = np.random.default_rng(seed)
    batch = int(rng.integers(1, 20))
    ours, theirs = BatchingTableQueue(batch), JQueue(batch)
    start = 0
    for _ in range(40):
        n = int(rng.integers(0, 30))
        table = pa.table({'a': np.arange(start, start + n),
                          'b': [str(i) for i in range(start, start + n)]})
        start += n
        item = table.to_batches()[0] if n and rng.random() < 0.3 else table
        ours.put(item)
        theirs.put(item)
        assert ours.empty() == theirs.empty()
        while not theirs.empty():
            got, want = ours.get(), theirs.get()
            assert got.num_rows == batch
            assert got.equals(want)
    assert ours.empty()
    with pytest.raises(IndexError, match='empty'):
        ours.get()
    with pytest.raises(ValueError, match='positive'):
        BatchingTableQueue(0)


# -- the codec extension surface -------------------------------------------------

class _ReversedCodecBase:
    """Cells are the array's C-order bytes, reversed: a codec neither
    package ships, defined once for each."""

    codec_name = 'test_reversed_bytes'

    def encode(self, unischema_field, value):
        return np.ascontiguousarray(value).tobytes()[::-1]

    def decode(self, unischema_field, value):
        return np.frombuffer(bytes(value)[::-1],
                             dtype=unischema_field.numpy_dtype).reshape(
                                 unischema_field.shape).copy()

    def arrow_type(self, unischema_field):
        return pa.binary()


class PortReversedCodec(_ReversedCodecBase, codecs.DataframeColumnCodec):
    pass


class JaxReversedCodec(_ReversedCodecBase, jcodecs.DataframeColumnCodec):
    pass


@pytest.fixture
def user_codec():
    codecs.register_codec(PortReversedCodec)
    jcodecs.register_codec(JaxReversedCodec)
    yield
    codecs._CODEC_REGISTRY.pop('test_reversed_bytes')
    jcodecs._CODEC_REGISTRY.pop('test_reversed_bytes')


def _write_user_store(url, pkg, rows):
    if pkg == 'port':
        schema = Unischema('User', [
            UnischemaField('id', np.int64, (), codecs.ScalarCodec(), False),
            UnischemaField('v', np.int16, (3, 2), PortReversedCodec(),
                           False)])
        with dm.materialize_dataset(url, schema, rows_per_file=5) as w:
            w.write_rows(rows)
    else:
        schema = JUnischema('User', [
            JField('id', np.int64, (), jcodecs.ScalarCodec(), False),
            JField('v', np.int16, (3, 2), JaxReversedCodec(), False)])
        with jdm.materialize_dataset(url, schema, rows_per_file=5) as w:
            w.write_rows(rows)


def test_user_codec_stores_read_across_packages(tmp_path, user_codec):
    from petastorm_tpu.reader import make_batch_reader as jmake_batch_reader

    from petastorm_tpu_torch.reader import (make_batch_reader,
                                            make_columnar_reader)
    rng = np.random.default_rng(3)
    rows = [{'id': np.int64(i),
             'v': rng.integers(-999, 999, (3, 2)).astype(np.int16)}
            for i in range(12)]
    for writer in ('port', 'jax'):
        url = 'file://' + str(tmp_path / writer)
        _write_user_store(url, writer, rows)
        assert isinstance(dm.get_schema_from_dataset_url(url).v.codec,
                          PortReversedCodec)
        for factory in (make_reader, jmake_reader):
            got = read_rows(factory, url)
            assert sorted(got) == list(range(12))
            for i, row in got.items():
                assert row['v'].dtype == np.int16
                np.testing.assert_array_equal(row['v'], rows[i]['v'])
        with make_columnar_reader(url, reader_pool_type='dummy',
                                  num_epochs=1) as r:
            batches = list(r)
        ids = np.concatenate([b.id for b in batches])
        np.testing.assert_array_equal(
            np.concatenate([b.v for b in batches]),
            np.stack([rows[i]['v'] for i in ids]))
        # make_batch_reader gives the stored cells, as JAX's does
        cells = []
        for factory in (make_batch_reader, jmake_batch_reader):
            with factory(url, reader_pool_type='dummy', num_epochs=1,
                         shuffle_row_groups=False) as r:
                cells.append([bytes(c) for b in r for c in b.v])
        assert cells[0] == cells[1] and len(cells[0]) == 12


def test_user_codec_through_the_port_loader(tmp_path, user_codec):
    from petastorm_tpu_torch.pytorch import DataLoader
    rows = [{'id': np.int64(i), 'v': np.full((3, 2), i, np.int16)}
            for i in range(10)]
    url = 'file://' + str(tmp_path / 'port')
    _write_user_store(url, 'port', rows)
    with make_reader(url, reader_pool_type='dummy', num_epochs=1,
                     shuffle_row_groups=False) as r:
        batches = list(DataLoader(r, batch_size=4, device='cpu'))
    for b in batches:
        for i, v in zip(b['id'].tolist(), b['v']):
            np.testing.assert_array_equal(v.numpy(), rows[i]['v'])


def test_codec_registry_as_jax():
    assert sorted(codecs._CODEC_REGISTRY) == sorted(jcodecs._CODEC_REGISTRY)
    for name, cls in codecs._CODEC_REGISTRY.items():
        assert issubclass(cls, codecs.DataframeColumnCodec)
        codec = codecs.codec_from_json_dict({'codec': name})
        assert codec == codecs.codec_from_json_dict(codec.to_json_dict())
    with pytest.raises(ValueError) as got:
        codecs.codec_from_json_dict({'codec': 'no_such_codec'})
    with pytest.raises(ValueError) as want:
        jcodecs.codec_from_json_dict({'codec': 'no_such_codec'})
    assert str(got.value) == str(want.value)
    assert 'Unknown codec name' in str(got.value)


def test_codec_base_is_abstract_and_needs_a_name():
    with pytest.raises(TypeError):
        codecs.DataframeColumnCodec()

    class Nameless(_ReversedCodecBase, codecs.DataframeColumnCodec):
        codec_name = None

    with pytest.raises(AssertionError, match='codec_name'):
        codecs.register_codec(Nameless)
    codec = PortReversedCodec()
    assert codec == PortReversedCodec()
    assert repr(codec) == 'PortReversedCodec()'
    assert codec.make_column_decoder(None) is None
    assert 'no device-decode path' in \
        codec.device_decode_unsupported_reason(None)
    field = UnischemaField('v', np.int16, (2,), codec, False)
    cell = codec.make_cell_decoder(field)(
        np.frombuffer(codec.encode(field, np.array([1, -2], np.int16)),
                      np.uint8))
    np.testing.assert_array_equal(cell, [1, -2])


def test_bytes_cells_of_a_user_codec_decode_as_an_object_column(tmp_path):
    """A fixed-shape field whose codec gives non-array values: an object
    column, as JAX's cell loop gives."""
    class Raw(codecs.DataframeColumnCodec):
        codec_name = 'test_raw'

        def encode(self, field, value):
            return bytes(value)

        def decode(self, field, value):
            return bytes(value)

        def arrow_type(self, field):
            return pa.binary()

    field = UnischemaField('b', bytes, (1,), Raw(), False)
    out = Raw().decode_column(field, pa.array([b'ab', b'c'], pa.binary()))
    assert out.dtype == object and list(out) == [b'ab', b'c']


def test_ndarray_cells_as_jax_decode():
    """The built-in codecs still decode through the base's cell path."""
    field = UnischemaField('m', np.float32, (2, 2), codecs.NdarrayCodec(),
                           False)
    value = np.arange(4, dtype=np.float32).reshape(2, 2)
    buf = io.BytesIO()
    np.save(buf, value)
    cell = np.frombuffer(buf.getvalue(), np.uint8)
    np.testing.assert_array_equal(
        codecs.NdarrayCodec().make_cell_decoder(field)(cell), value)
