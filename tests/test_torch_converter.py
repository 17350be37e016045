"""The port's dataset converter (``petastorm_tpu_torch/converter.py``)
against the JAX package's (``petastorm_tpu/converter.py``), on the CPU.

Every case of ``tests/test_converter.py`` runs on both packages: the same
input materialised by each converter under its own parent directory, the
port's ``make_torch_loader`` read beside JAX's ``make_jax_loader`` and the
port's ``make_torch_dataloader`` beside JAX's, with the batches equal
element for element (dummy pool, unshuffled, so both orders are the
store's). Beside them: the fingerprint digest equal to JAX's, each
package's registry apart from the other's, list columns dropped by
``make_torch_dataloader`` and kept by ``make_torch_loader`` as JAX does,
the device rule, a handle unpickled in a fresh interpreter with no
``jax`` in ``sys.modules``, and ``_get_rank_and_size`` in a 2-rank gloo
group.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from petastorm_tpu import converter as jconv

from petastorm_tpu_torch import converter as conv
from petastorm_tpu_torch.converter import (make_dataset_converter,
                                           set_parent_cache_dir_url)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cache_dir(tmp_path):
    url = 'file://' + str(tmp_path / 'conv_cache')
    set_parent_cache_dir_url(url)
    jconv.set_parent_cache_dir_url('file://' + str(tmp_path / 'jax_cache'))
    conv._materialized.clear()
    jconv._materialized.clear()
    yield url
    set_parent_cache_dir_url(None)
    jconv.set_parent_cache_dir_url(None)
    conv._materialized.clear()
    jconv._materialized.clear()


def _table(n=100):
    return pa.table({'id': np.arange(n, dtype=np.int64),
                     'value': np.arange(n, dtype=np.float64) * 0.5})


def _numpy(value):
    return value.numpy() if isinstance(value, torch.Tensor) else value


def jax_batches(data, loader_kw=None, **convert_kw):
    saved = jconv.make_dataset_converter(data, **convert_kw)
    kw = dict(batch_size=50, num_epochs=1, reader_pool_type='dummy')
    kw.update(loader_kw or {})
    with saved.make_jax_loader(**kw) as loader:
        return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def port_batches(saved, loader_kw=None, method='make_torch_loader'):
    kw = dict(batch_size=50, num_epochs=1, reader_pool_type='dummy',
              device='cpu')
    kw.update(loader_kw or {})
    with getattr(saved, method)(**kw) as loader:
        return [{k: _numpy(v) for k, v in b.items()} for b in loader]


def assert_same(got, want):
    """Equal batches; a batch's lineage record (``_provenance``, each
    package's own class) only where JAX's has one."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == '_provenance':
                continue
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def roundtrip(data, loader_kw=None, **convert_kw):
    saved = make_dataset_converter(data, **convert_kw)
    got = port_batches(saved, loader_kw)
    assert_same(got, jax_batches(data, loader_kw, **convert_kw))
    return saved, got


def ids(batches):
    return sorted(int(i) for b in batches for i in b['id'])


# -- TestMaterialization -------------------------------------------------------

def test_roundtrip_torch_loader_as_jax():
    saved, got = roundtrip(_table())
    assert len(saved) == 100
    assert ids(got) == list(range(100))


def test_pandas_input_as_jax():
    df = pd.DataFrame({'id': np.arange(10), 'x': np.ones(10)})
    saved, _ = roundtrip(df)
    assert len(saved) == 10


def test_cache_hit_same_content():
    s1 = make_dataset_converter(_table())
    s2 = make_dataset_converter(_table())
    assert s1.cache_dir_url == s2.cache_dir_url


@pytest.mark.parametrize('first,second', [
    (dict(n=100), dict(n=101)),
    (dict(n=100), dict(n=100, compression='snappy')),
])
def test_cache_miss_on_content_or_params(first, second):
    s1 = make_dataset_converter(_table(first.pop('n')), **first)
    s2 = make_dataset_converter(_table(second.pop('n')), **second)
    assert s1.cache_dir_url != s2.cache_dir_url


def test_cache_miss_on_suffix_only_difference():
    n = 50_000
    base = np.arange(n, dtype=np.int64)
    tail_changed = base.copy()
    tail_changed[-1] = -1
    s1 = make_dataset_converter(pa.table({'id': base}))
    s2 = make_dataset_converter(pa.table({'id': tail_changed}))
    assert s1.cache_dir_url != s2.cache_dir_url


def test_schemeless_cache_dir(tmp_path):
    saved = make_dataset_converter(
        _table(), parent_cache_dir_url=str(tmp_path / 'bare_cache'))
    assert all('://' not in u for u in saved.file_urls)
    got = port_batches(saved, dict(batch_size=10,
                                   reader_pool_type='thread'))
    assert sum(len(b['id']) for b in got) == 100


@pytest.mark.parametrize('precision,src,want', [
    ('float32', np.float64, np.float32), ('float64', np.float32, np.float64)])
def test_precision_as_jax(precision, src, want):
    table = pa.table({'id': np.arange(10, dtype=np.int64),
                      'x': np.arange(10, dtype=src) * 0.1})
    _, got = roundtrip(table, dict(batch_size=10), precision=precision)
    assert got[0]['x'].dtype == want


def test_pickle_handle():
    saved = make_dataset_converter(_table())
    clone = pickle.loads(pickle.dumps(saved))
    assert type(clone) is conv.SavedDataset
    assert ids(port_batches(clone)) == list(range(100))


def test_delete():
    saved = make_dataset_converter(_table())
    path = saved.cache_dir_url[len('file://'):]
    assert os.path.exists(path)
    saved.delete()
    assert not os.path.exists(path)
    s2 = make_dataset_converter(_table())
    assert os.path.exists(s2.cache_dir_url[len('file://'):])


# -- TestTorchAndTf ------------------------------------------------------------

def test_torch_dataloader_as_jax():
    saved = make_dataset_converter(_table())
    got = port_batches(saved, dict(batch_size=25),
                       method='make_torch_dataloader')
    jsaved = jconv.make_dataset_converter(_table())
    with jsaved.make_torch_dataloader(batch_size=25, num_epochs=1,
                                      reader_pool_type='dummy') as loader:
        want = [{k: v.numpy() for k, v in b.items()} for b in loader]
    assert_same(got, want)
    assert sum(len(b['id']) for b in got) == 100


def test_torch_dataloader_yields_tensors_on_its_device():
    saved = make_dataset_converter(_table())
    with saved.make_torch_dataloader(batch_size=25, num_epochs=1,
                                     reader_pool_type='dummy',
                                     device='cpu') as loader:
        batch = next(iter(loader))
    assert isinstance(batch['id'], torch.Tensor)
    assert batch['id'].device.type == 'cpu'


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    saved = make_dataset_converter(_table())
    for method in ('make_torch_dataloader', 'make_torch_loader'):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(saved, method)(num_epochs=1, reader_pool_type='dummy')


def test_tf_dataset_as_jax():
    pytest.importorskip('tensorflow')
    saved = make_dataset_converter(_table())
    with saved.make_tf_dataset(batch_size=10, num_epochs=1,
                               reader_pool_type='dummy') as dataset:
        got = [int(i) for b in dataset for i in b.id.numpy()]
    jsaved = jconv.make_dataset_converter(_table())
    with jsaved.make_tf_dataset(batch_size=10, num_epochs=1,
                                reader_pool_type='dummy') as dataset:
        want = [int(i) for b in dataset for i in b.id.numpy()]
    assert got == want
    assert sorted(got) == list(range(100))


def test_list_columns_as_jax():
    """``make_torch_dataloader`` drops a list column and
    ``make_torch_loader`` keeps it as an object array, as JAX's
    ``make_torch_dataloader`` and ``make_jax_loader`` do."""
    table = pa.table({'idx': np.arange(8, dtype=np.int64),
                      'tokens': pa.array([list(range(i, i + 5))
                                          for i in range(8)],
                                         pa.list_(pa.int32()))})
    saved = make_dataset_converter(table)
    got = port_batches(saved, dict(batch_size=8),
                       method='make_torch_dataloader')
    jsaved = jconv.make_dataset_converter(table)
    with jsaved.make_torch_dataloader(batch_size=8, num_epochs=1,
                                      reader_pool_type='dummy') as loader:
        want = [{k: v.numpy() for k, v in b.items()} for b in loader]
    assert_same(got, want)
    assert set(got[0]) == {'idx'}
    got = port_batches(saved, dict(batch_size=8))
    want = jax_batches(table, dict(batch_size=8))
    assert got[0]['tokens'].dtype == want[0]['tokens'].dtype == object
    assert got[0]['tokens'].shape == want[0]['tokens'].shape == (8,)
    for g, w in zip(got[0]['tokens'], want[0]['tokens']):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- TestRankDetection ---------------------------------------------------------

def test_env_var_mismatch_warns_as_jax(monkeypatch):
    monkeypatch.setenv('HOROVOD_RANK', '1')
    monkeypatch.setenv('HOROVOD_SIZE', '4')
    saved = make_dataset_converter(_table(2000), row_group_size_mb=0.001)
    with pytest.warns(UserWarning, match='rank 1 of 4') as got:
        port_batches(saved, dict(batch_size=10, cur_shard=0, shard_count=2))
    jsaved = jconv.make_dataset_converter(_table(2000),
                                          row_group_size_mb=0.001)
    with pytest.warns(UserWarning, match='rank 1 of 4') as want:
        with jsaved.make_jax_loader(batch_size=10, num_epochs=1,
                                    reader_pool_type='dummy', cur_shard=0,
                                    shard_count=2) as loader:
            list(loader)
    assert ([str(w.message) for w in got if 'cur_shard' in str(w.message)]
            == [str(w.message) for w in want
                if 'cur_shard' in str(w.message)])


def test_env_var_match_does_not_warn(monkeypatch, recwarn):
    monkeypatch.setenv('HOROVOD_RANK', '0')
    monkeypatch.setenv('HOROVOD_SIZE', '2')
    saved, _ = roundtrip(_table(2000), dict(batch_size=10, cur_shard=0,
                                            shard_count=2,
                                            shuffle_row_groups=False),
                         row_group_size_mb=0.001)
    assert not [w for w in recwarn.list if 'cur_shard' in str(w.message)]


@pytest.mark.parametrize('envs', [
    ('HOROVOD_RANK', 'HOROVOD_SIZE'),
    ('OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_SIZE'),
    ('PMI_RANK', 'PMI_SIZE'),
])
def test_mpi_and_pmi_env_vars_as_jax(monkeypatch, envs):
    rank_env, size_env = envs
    monkeypatch.setenv(rank_env, '3')
    monkeypatch.setenv(size_env, '8')
    assert conv._get_rank_and_size() == jconv._get_rank_and_size() == (3, 8)


def test_no_rank_without_a_group_or_variables(monkeypatch):
    for name in ('HOROVOD_RANK', 'OMPI_COMM_WORLD_RANK', 'PMI_RANK'):
        monkeypatch.delenv(name, raising=False)
    assert conv._get_rank_and_size() == (None, None)


@pytest.mark.timeout(240)
def test_rank_and_size_from_a_two_rank_gloo_group(tmp_path):
    """In a 2-rank gloo group the group answers, before the Horovod
    variables (set to another rank and size); reading the rank's shard
    does not warn, and the two shards together are the table."""
    from petastorm_tpu_torch.parallel import launch_ranks
    saved = make_dataset_converter(_table(2000), row_group_size_mb=0.001,
                                   delete_at_exit=False)
    out = launch_ranks('torch_mesh_ranks:converter_rank', 2,
                       str(tmp_path / 'store'),
                       args=(saved, {'HOROVOD_RANK': '5',
                                     'HOROVOD_SIZE': '9'}),
                       timeout_s=200)
    assert [(r, s) for r, s, _, _ in out] == [(0, 2), (1, 2)]
    assert all(not warned for _, _, warned, _ in out)
    assert sorted(out[0][3] + out[1][3]) == list(range(2000))
    assert not set(out[0][3]) & set(out[1][3])


# -- TestPrimitiveRoundtrip ----------------------------------------------------

def test_scalar_dtype_matrix_as_jax():
    n = 64
    table = pa.table({
        'f_bool': np.arange(n) % 2 == 0,
        'f_i8': np.arange(n, dtype=np.int8),
        'f_i16': np.arange(n, dtype=np.int16),
        'f_i32': np.arange(n, dtype=np.int32),
        'f_i64': np.arange(n, dtype=np.int64),
        'f_f32': np.arange(n, dtype=np.float32) * 0.5,
        'f_f64': np.arange(n, dtype=np.float64) * 0.25,
        'f_str': pa.array(['s%d' % i for i in range(n)]),
    })
    _, got = roundtrip(table, dict(batch_size=n))
    batch = got[0]
    for name, dtype in (('f_i8', np.int8), ('f_i16', np.int16),
                        ('f_i32', np.int32), ('f_i64', np.int64),
                        ('f_f32', np.float32), ('f_f64', np.float64)):
        assert batch[name].dtype == dtype
    np.testing.assert_array_equal(batch['f_i64'], np.arange(n))


def test_scalar_dtype_matrix_through_torch_dataloader_as_jax():
    n = 32
    table = pa.table({'f_bool': np.arange(n) % 2 == 0,
                      'f_i8': np.arange(n, dtype=np.int8),
                      'f_f32': np.arange(n, dtype=np.float32) * 0.5,
                      'f_str': pa.array(['s%d' % i for i in range(n)])})
    saved = make_dataset_converter(table)
    got = port_batches(saved, dict(batch_size=n),
                       method='make_torch_dataloader')
    jsaved = jconv.make_dataset_converter(table)
    with jsaved.make_torch_dataloader(batch_size=n, num_epochs=1,
                                      reader_pool_type='dummy') as loader:
        want = [{k: v.numpy() for k, v in b.items()} for b in loader]
    assert_same(got, want)
    assert got[0]['f_bool'].dtype == np.uint8


def test_list_column_roundtrip_as_jax():
    n = 30
    values = [list(range(i % 5 + 1)) for i in range(n)]
    table = pa.table({'id': np.arange(n, dtype=np.int64),
                      'seq': pa.array(values, pa.list_(pa.int64()))})
    saved = make_dataset_converter(table)
    got = port_batches(saved, dict(batch_size=n))[0]
    want = jax_batches(table, dict(batch_size=n))[0]
    assert {int(i): list(s) for i, s in zip(got['id'], got['seq'])} == \
        {int(i): list(s) for i, s in zip(want['id'], want['seq'])} == \
        {i: values[i] for i in range(n)}


@pytest.mark.parametrize('call,words', [
    (lambda m: m(_table(), precision='float16'), 'precision'),
    (lambda m: m([1, 2, 3]), 'Unsupported input type'),
])
def test_bad_inputs_rejected_in_jax_words(call, words):
    with pytest.raises((ValueError, TypeError), match=words) as got:
        call(make_dataset_converter)
    with pytest.raises((ValueError, TypeError)) as want:
        call(jconv.make_dataset_converter)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# -- TestCompression -----------------------------------------------------------

@pytest.mark.parametrize('compression', [None, 'snappy', 'gzip'])
def test_compression_as_jax(compression):
    import pyarrow.parquet as pq
    saved, got = roundtrip(_table(), compression=compression)
    meta = pq.ParquetFile(saved.file_urls[0][len('file://'):]).metadata
    codec = meta.row_group(0).column(0).compression
    assert codec.upper() == (compression or 'UNCOMPRESSED').upper()
    assert ids(got) == list(range(100))


# -- TestCachingSemantics ------------------------------------------------------

def test_fingerprint_digest_equals_jax():
    table = _table(300)
    for params in ({'compression': 'none', 'row_group_size_mb': 32.0,
                    'precision': 'none'},
                   {'compression': 'gzip', 'row_group_size_mb': 0.5,
                    'precision': 'float32'}):
        assert conv._fingerprint(table, params) == \
            jconv._fingerprint(table, params)
    sliced = table.slice(17, 100)
    params = {'compression': 'none'}
    assert conv._fingerprint(sliced, params) == \
        jconv._fingerprint(sliced, params)
    assert conv._params_repr(params) == jconv._params_repr(params)


def test_converted_table_and_digest_as_jax():
    df = pd.DataFrame({'idx': np.arange(50),
                       'x': np.linspace(0, 1, 50),
                       'y': np.linspace(0, 1, 50).astype(np.float32)})
    for precision in (None, 'float32', 'float64'):
        got = conv._normalize_precision(conv._to_arrow_table(df), precision)
        want = jconv._normalize_precision(jconv._to_arrow_table(df),
                                          precision)
        assert got.equals(want)
        assert got.schema == want.schema


def test_fingerprint_memoized_by_table_identity(monkeypatch):
    calls = []
    real = conv._fingerprint

    def counting(table, params):
        calls.append(1)
        return real(table, params)

    monkeypatch.setattr(conv, '_fingerprint', counting)
    table = _table()
    s1 = make_dataset_converter(table)
    s2 = make_dataset_converter(table)
    assert s1 is s2
    assert len(calls) == 1


def test_pandas_input_always_rehashed():
    df = pd.DataFrame({'id': np.arange(10, dtype=np.int64)})
    s1 = make_dataset_converter(df)
    df.loc[5, 'id'] = 99
    s2 = make_dataset_converter(df)
    assert s1.cache_dir_url != s2.cache_dir_url


def test_deleted_cache_rematerializes_from_memo():
    table = _table()
    s1 = make_dataset_converter(table)
    s1.delete()
    s2 = make_dataset_converter(table)
    assert s1.cache_dir_url != s2.cache_dir_url
    assert sum(len(b['id']) for b in port_batches(s2)) == 100


def test_sliced_tables_do_not_collide():
    base = _table(100)
    s1 = make_dataset_converter(base.slice(0, 50))
    s2 = make_dataset_converter(base.slice(50, 50))
    assert s1.cache_dir_url != s2.cache_dir_url


def test_each_package_keeps_its_own_registry(tmp_path):
    """The same table under one parent directory: each converter
    materialises once and hands out only its own handle."""
    parent = 'file://' + str(tmp_path / 'shared')
    table = _table()
    t1 = make_dataset_converter(table, parent_cache_dir_url=parent)
    j1 = jconv.make_dataset_converter(table, parent_cache_dir_url=parent)
    assert type(t1) is conv.SavedDataset
    assert type(j1) is jconv.SavedDataset
    assert t1.cache_dir_url != j1.cache_dir_url
    assert make_dataset_converter(table, parent_cache_dir_url=parent) is t1
    assert jconv.make_dataset_converter(table,
                                        parent_cache_dir_url=parent) is j1
    assert list(conv._materialized.values()) == [t1]
    j1.delete()
    assert make_dataset_converter(table, parent_cache_dir_url=parent) is t1


# -- TestPicklingRemotely -------------------------------------------------------

@pytest.mark.timeout(240)
def test_handle_read_in_fresh_interpreter_without_jax(tmp_path):
    saved = make_dataset_converter(_table())
    blob = tmp_path / 'handle.pkl'
    blob.write_bytes(pickle.dumps(saved))
    script = (
        "import pickle, sys\n"
        "saved = pickle.load(open(sys.argv[1], 'rb'))\n"
        "with saved.make_torch_dataloader(batch_size=50, num_epochs=1,\n"
        "        reader_pool_type='dummy', device='cpu') as loader:\n"
        "    total = sum(len(b['id']) for b in loader)\n"
        "with saved.make_torch_loader(batch_size=50, num_epochs=1,\n"
        "        reader_pool_type='dummy', device='cpu') as loader:\n"
        "    total += sum(len(b['id']) for b in loader)\n"
        "assert total == 200, total\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'petastorm_tpu')]\n"
        "assert not bad, bad\n"
        "print('REMOTE_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', script, str(blob)],
                         capture_output=True, timeout=200, env=env,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr.decode()
    assert 'REMOTE_OK' in out.stdout.decode()


# -- TestArgPlumbing -----------------------------------------------------------

def test_reader_kwargs_reach_make_batch_reader(monkeypatch):
    import petastorm_tpu_torch.reader as reader_mod
    saved = make_dataset_converter(_table(2000), row_group_size_mb=0.001)
    real = reader_mod.make_batch_reader
    seen = {}

    def spy(urls, **kwargs):
        seen.update(kwargs)
        return real(urls, **kwargs)

    monkeypatch.setattr('petastorm_tpu_torch.reader.make_batch_reader', spy)
    port_batches(saved, dict(batch_size=10, cur_shard=1, shard_count=2,
                             shuffle_row_groups=False))
    assert seen['cur_shard'] == 1
    assert seen['shard_count'] == 2
    assert seen['num_epochs'] == 1
    assert seen['shuffle_row_groups'] is False


def test_transform_spec_through_torch_dataloader_as_jax():
    from petastorm_tpu.transform import TransformSpec as JTransformSpec

    from petastorm_tpu_torch.transform import TransformSpec

    def double(df):
        df['value'] = df['value'] * 2
        return df

    saved = make_dataset_converter(_table())
    got = port_batches(saved, dict(batch_size=100,
                                   transform_spec=TransformSpec(double)),
                       method='make_torch_dataloader')
    jsaved = jconv.make_dataset_converter(_table())
    with jsaved.make_torch_dataloader(
            batch_size=100, num_epochs=1, reader_pool_type='dummy',
            transform_spec=JTransformSpec(double)) as loader:
        want = [{k: v.numpy() for k, v in b.items()} for b in loader]
    assert_same(got, want)
    np.testing.assert_allclose(np.sort(got[0]['value']),
                               np.arange(100, dtype=np.float64))


def test_unexpected_param_raises():
    saved = make_dataset_converter(_table())
    for method in ('make_torch_loader', 'make_torch_dataloader'):
        with pytest.raises(TypeError):
            with getattr(saved, method)(no_such_argument=True,
                                        device='cpu') as loader:
                list(loader)


# -- TestLifecycle -------------------------------------------------------------

@pytest.mark.timeout(240)
def test_atexit_delete_in_subprocess(tmp_path):
    cache = tmp_path / 'atexit_cache'
    script = (
        "import numpy as np, pyarrow as pa\n"
        "from petastorm_tpu_torch.converter import make_dataset_converter\n"
        "saved = make_dataset_converter(\n"
        "    pa.table({'id': np.arange(10, dtype=np.int64)}),\n"
        "    parent_cache_dir_url=%r, delete_at_exit=True)\n"
        "print(saved.cache_dir_url)\n" % str(cache))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', script],
                         capture_output=True, timeout=200, env=env)
    assert out.returncode == 0, out.stderr.decode()
    path = out.stdout.decode().strip().splitlines()[-1]
    assert path.startswith(str(cache))
    assert not os.path.exists(path), 'atexit did not delete %s' % path


def test_no_cache_dir_configured_raises_jax_words(monkeypatch):
    set_parent_cache_dir_url(None)
    jconv.set_parent_cache_dir_url(None)
    monkeypatch.delenv('PETASTORM_TPU_CACHE_DIR', raising=False)
    with pytest.raises(ValueError, match='No cache directory') as got:
        make_dataset_converter(_table())
    with pytest.raises(ValueError) as want:
        jconv.make_dataset_converter(_table())
    assert str(got.value) == str(want.value)


def test_env_var_cache_dir(tmp_path, monkeypatch):
    set_parent_cache_dir_url(None)
    monkeypatch.setenv('PETASTORM_TPU_CACHE_DIR',
                       'file://' + str(tmp_path / 'env_cache'))
    saved = make_dataset_converter(_table())
    assert str(tmp_path / 'env_cache') in saved.cache_dir_url


def test_wait_file_available_success_and_timeout(tmp_path):
    from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM
    present = tmp_path / 'present.bin'
    present.write_bytes(b'x')
    conv._wait_file_available(LOCAL_FILESYSTEM, [str(present)], timeout_s=1.0)
    with pytest.raises(RuntimeError, match='Timed out'):
        conv._wait_file_available(LOCAL_FILESYSTEM,
                                  [str(tmp_path / 'never.bin')],
                                  timeout_s=0.3)


def test_public_names():
    import petastorm_tpu_torch
    assert 'make_dataset_converter' in petastorm_tpu_torch.__all__
    assert petastorm_tpu_torch.make_dataset_converter is \
        make_dataset_converter
