"""The port's PyTorch adapter (``petastorm_tpu_torch/pytorch.py``) against
the JAX package's (``petastorm_tpu/pytorch.py``), on the CPU.

Every case of ``tests/test_pytorch_loader.py`` runs both packages'
``DataLoader`` / ``BatchedDataLoader`` over the same store, read by each
package's own reader on the dummy pool with the same seeds, and holds the
batches equal element for element (tensors bit-equal, NaN where JAX's
NaN is, with equal dtypes, string and ragged fields equal lists). Beside them: the dtype
casts on the edge-type store (bool, uint16, uint32, Decimal), the device
rule (the default raises without CUDA, ``device='cpu'`` works), the
read-only copy, the loader protocol (second pass, guards, the context
manager), NGram refusal in JAX's words, the mixture through the row
loader (the counterpart of ``tests/test_weighted_sampling.py:157``), and
the slice as a whole: a small LM trained from each package's
``DataLoader`` with the same parameters, losses within 1e-4.
"""

import warnings
from decimal import Decimal

import numpy as np
import pytest
import torch

from petastorm_tpu import pytorch as jpt
from petastorm_tpu.reader import make_batch_reader as jmake_batch_reader
from petastorm_tpu.reader import make_reader as jmake_reader

from petastorm_tpu_torch import pytorch as tpt
from petastorm_tpu_torch.reader import make_batch_reader, make_reader

ROW_FIELDS = ['id', 'id2', 'id_odd', 'matrix', 'matrix_uint16',
              'python_primitive_uint8', 'partition_key', 'sensor_name',
              'image_png']


def assert_batches_equal(got, want):
    """Port batches == JAX batches: same keys, tensors equal with equal
    dtypes (the port's on the CPU here), other values equal lists."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if isinstance(w[key], torch.Tensor):
                assert isinstance(g[key], torch.Tensor), key
                assert g[key].dtype == w[key].dtype, key
                assert g[key].device.type == 'cpu'
                torch.testing.assert_close(g[key], w[key], rtol=0, atol=0,
                                           equal_nan=True, msg=key)
            else:
                assert isinstance(g[key], list) and len(g[key]) == len(w[key])
                for a, b in zip(g[key], w[key]):
                    assert type(a) is type(b), key
                    np.testing.assert_array_equal(a, b)


def ids_of(batches, key='id'):
    return [int(i) for b in batches for i in np.asarray(b[key]).ravel()]


def both_row_batches(url, loader_kw, **reader_kw):
    kw = dict(reader_pool_type='dummy', num_epochs=1, seed=0, **reader_kw)
    with jmake_reader(url, **kw) as r:
        want = list(jpt.DataLoader(r, **loader_kw))
    with make_reader(url, **kw) as r:
        got = list(tpt.DataLoader(r, device='cpu', **loader_kw))
    return got, want


def both_batched(url, loader_cls, loader_kw, **reader_kw):
    kw = dict(reader_pool_type='dummy', num_epochs=1, seed=0, **reader_kw)
    with jmake_batch_reader(url, **kw) as r:
        want = list(getattr(jpt, loader_cls)(r, **loader_kw))
    with make_batch_reader(url, **kw) as r:
        got = list(getattr(tpt, loader_cls)(r, device='cpu', **loader_kw))
    return got, want


# -- TestSanitize / TestCollate ---------------------------------------------

def test_sanitize_promotions_as_jax():
    def row():
        return {'b': np.array([True, False]),
                'u16': np.array([1, 2], np.uint16),
                'u32': np.array([1, 2], np.uint32),
                'd': Decimal('2.5'),
                'dec_col': np.array([Decimal('1.5'), Decimal('2')], object),
                'f': np.float32(3.0), 's': 'abc'}
    got = tpt._sanitize_pytorch_types(row())
    want = jpt._sanitize_pytorch_types(row())
    assert got['b'].dtype == np.uint8
    assert got['u16'].dtype == np.int32
    assert got['u32'].dtype == np.int64
    assert got['d'] == 2.5
    assert got['dec_col'].dtype == np.float64
    for key in want:
        assert type(got[key]) is type(want[key]), key
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_sanitize_none_rejected_in_jax_words():
    with pytest.raises(TypeError) as want:
        jpt._sanitize_pytorch_types({'x': None})
    with pytest.raises(TypeError) as got:
        tpt._sanitize_pytorch_types({'x': None})
    assert str(got.value) == str(want.value)


def test_collate_mixed_fields_as_jax():
    def rows():
        return [{'x': np.float32(1.0), 's': 'a', 'r': np.arange(2)},
                {'x': np.float32(2.0), 's': 'bb', 'r': np.arange(3)}]
    got, want = tpt.decimal_friendly_collate(rows()), \
        jpt.decimal_friendly_collate(rows())
    assert_batches_equal([got], [want])
    assert isinstance(got['x'], torch.Tensor)
    assert got['s'] == ['a', 'bb']


# -- TestDataLoader -------------------------------------------------------------

def test_row_reader_as_jax(synthetic_dataset):
    got, want = both_row_batches(synthetic_dataset.url,
                                 dict(batch_size=10),
                                 schema_fields=['id', 'matrix'])
    assert_batches_equal(got, want)
    assert sorted(ids_of(got)) == sorted(
        r['id'] for r in synthetic_dataset.data)
    assert got[0]['matrix'].shape == (10, 8, 4, 3)


def test_row_reader_types_as_jax(synthetic_dataset):
    """bool, uint16 and uint8 fields, strings and string arrays, an image:
    the dtypes and values of JAX's batches."""
    got, want = both_row_batches(synthetic_dataset.url,
                                 dict(batch_size=7),
                                 schema_fields=ROW_FIELDS,
                                 shuffle_row_groups=False)
    assert_batches_equal(got, want)
    assert got[0]['id_odd'].dtype == torch.uint8
    assert got[0]['matrix_uint16'].dtype == torch.int32
    assert isinstance(got[0]['partition_key'], list)


def test_batched_reader_transposed_as_jax(scalar_dataset):
    kw = dict(reader_pool_type='dummy', num_epochs=1, seed=0,
              schema_fields=['^id$', 'float64', 'string'])
    with jmake_batch_reader(scalar_dataset.url, **kw) as r:
        want = list(jpt.DataLoader(r, batch_size=16))
    with make_batch_reader(scalar_dataset.url, **kw) as r:
        got = list(tpt.DataLoader(r, batch_size=16, device='cpu'))
    assert_batches_equal(got, want)
    assert sorted(ids_of(got)) == sorted(r['id'] for r in scalar_dataset.data)


@pytest.mark.parametrize('capacity', [0, 7, 50])
def test_shuffling_as_jax(synthetic_dataset, capacity):
    got, want = both_row_batches(
        synthetic_dataset.url,
        dict(batch_size=10, shuffling_queue_capacity=capacity, seed=3),
        schema_fields=['id'], shuffle_row_groups=False)
    assert_batches_equal(got, want)
    plain = sorted(r['id'] for r in synthetic_dataset.data)
    assert sorted(ids_of(got)) == plain
    if capacity > 7:
        assert ids_of(got) != plain


def test_same_seed_same_order(synthetic_dataset):
    def order(seed):
        with make_reader(synthetic_dataset.url, reader_pool_type='dummy',
                         num_epochs=1, schema_fields=['id'], seed=0) as r:
            return ids_of(tpt.DataLoader(r, batch_size=8,
                                         shuffling_queue_capacity=32,
                                         seed=seed, device='cpu'))
    assert order(5) == order(5)
    assert order(5) != order(6)


def test_ngram_reader_refused_in_jax_words(tmp_path):
    from petastorm_tpu.ngram import NGram as JNGram
    from petastorm_tpu.test_util.dataset_gen import create_test_dataset

    from petastorm_tpu_torch.ngram import NGram
    url = 'file://' + str(tmp_path / 'ngram')
    create_test_dataset(url, range(10), num_files=1, row_group_size_mb=100)
    fields = {0: ['id'], 1: ['id']}
    for cls, kind in (('DataLoader', 'DataLoader'),
                      ('BatchedDataLoader', 'BatchedDataLoader')):
        with jmake_reader(url, reader_pool_type='dummy', schema_fields=JNGram(
                dict(fields), 5, 'id')) as r, \
                pytest.raises(NotImplementedError) as want:
            getattr(jpt, cls)(r)
        with make_reader(url, reader_pool_type='dummy', schema_fields=NGram(
                dict(fields), 5, 'id')) as r, \
                pytest.raises(NotImplementedError) as got:
            getattr(tpt, cls)(r, device='cpu')
        assert str(got.value) == str(want.value), kind


# -- TestBatchedDataLoader ------------------------------------------------------

def test_vectorized_batches_as_jax(scalar_dataset):
    got, want = both_batched(scalar_dataset.url, 'BatchedDataLoader',
                             dict(batch_size=16))
    assert_batches_equal(got, want)
    assert sorted(ids_of(got)) == sorted(r['id'] for r in scalar_dataset.data)
    assert isinstance(got[0]['id'], torch.Tensor)
    # object columns (strings) are dropped, as JAX drops them
    assert 'string' not in got[0]


def test_requires_batched_reader_in_jax_words(synthetic_dataset):
    with jmake_reader(synthetic_dataset.url, reader_pool_type='dummy') as r:
        with pytest.raises(ValueError) as want:
            jpt.BatchedDataLoader(r)
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy') as r:
        with pytest.raises(ValueError, match='batched reader') as got:
            tpt.BatchedDataLoader(r, device='cpu')
    assert str(got.value) == str(want.value)


def test_inmemory_cache_replays_without_a_reader_pass(scalar_dataset):
    with make_batch_reader(scalar_dataset.url, reader_pool_type='dummy',
                           num_epochs=1, seed=0) as r:
        loader = tpt.BatchedDataLoader(r, batch_size=16, device='cpu',
                                       shuffling_queue_capacity=40, seed=1,
                                       inmemory_cache_all=True)
        first = list(loader)
        resets = []
        r.reset = lambda: resets.append(1)
        second = list(loader)
    assert not resets
    assert_batches_equal(second, first)
    with jmake_batch_reader(scalar_dataset.url, reader_pool_type='dummy',
                            num_epochs=1, seed=0) as r:
        jloader = jpt.BatchedDataLoader(r, batch_size=16,
                                        shuffling_queue_capacity=40, seed=1,
                                        inmemory_cache_all=True)
        want = list(jloader)
        want_second = list(jloader)
    assert_batches_equal(first, want)
    assert_batches_equal(second, want_second)


@pytest.mark.parametrize('capacity,batch', [(40, 10), (8, 16), (100, 7)])
def test_shuffled_batches_as_jax(scalar_dataset, capacity, batch):
    got, want = both_batched(
        scalar_dataset.url, 'BatchedDataLoader',
        dict(batch_size=batch, shuffling_queue_capacity=capacity, seed=0),
        shuffle_row_groups=False)
    assert_batches_equal(got, want)
    ids = ids_of(got)
    assert sorted(ids) == sorted(r['id'] for r in scalar_dataset.data)
    assert ids != sorted(ids)


def test_transform_fn_as_jax(scalar_dataset):
    got, want = both_batched(
        scalar_dataset.url, 'BatchedDataLoader',
        dict(batch_size=8, transform_fn=lambda b: {'double': b['id'] * 2}))
    assert_batches_equal(got, want)
    assert set(got[0]) == {'double'}


def test_list_columns_through_both_loaders_as_jax(tmp_path):
    """An ``ArrowListCodec`` (28, 28) uint8 column comes through
    ``BatchedDataLoader(make_batch_reader)`` as (16, 28, 28) uint8, and an
    ``NdarrayCodec`` int32 row through ``DataLoader(make_reader)`` as
    (8, n) int32, in both packages."""
    from petastorm_tpu.codecs import ArrowListCodec, NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import materialize_dataset
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('L', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (28, 28), ArrowListCodec(), False),
        UnischemaField('tokens', np.int32, (33,), NdarrayCodec(), False)])
    rng = np.random.default_rng(7)
    url = 'file://' + str(tmp_path / 'lists')
    with materialize_dataset(url, schema, rows_per_file=24) as w:
        w.write_rows({'idx': np.int64(i),
                      'image': rng.integers(0, 256, (28, 28), np.uint8),
                      'tokens': rng.integers(0, 100, 33, dtype=np.int32)}
                     for i in range(48))
    got, want = both_batched(url, 'BatchedDataLoader',
                             dict(batch_size=16, shuffling_queue_capacity=20,
                                  seed=2),
                             schema_fields=['idx', 'image'])
    assert_batches_equal(got, want)
    assert got[0]['image'].shape == (16, 28, 28)
    assert got[0]['image'].dtype == torch.uint8
    got, want = both_row_batches(url, dict(batch_size=8),
                                 schema_fields=['idx', 'tokens'])
    assert_batches_equal(got, want)
    assert got[0]['tokens'].shape == (8, 33)
    assert got[0]['tokens'].dtype == torch.int32


# -- dtypes of the edge-type store ----------------------------------------------

@pytest.fixture(scope='module')
def edge_store(tmp_path_factory):
    """bool, uint16 and uint32 scalars and a Decimal, written by JAX."""
    from petastorm_tpu.codecs import ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import materialize_dataset
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('Edge', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('flag', np.bool_, (), ScalarCodec(), False),
        UnischemaField('u16', np.uint16, (), ScalarCodec(), False),
        UnischemaField('u32', np.uint32, (), ScalarCodec(), False),
        UnischemaField('price', Decimal, (), ScalarCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('edge') / 'ds')
    with materialize_dataset(url, schema, rows_per_file=10) as w:
        w.write_rows({'id': np.int64(i), 'flag': bool(i % 2),
                      'u16': np.uint16(60000 + i), 'u32': np.uint32(4e9 + i),
                      'price': Decimal('19.99') + Decimal(i)}
                     for i in range(20))
    return url


def test_edge_types_through_row_loader_as_jax(edge_store):
    got, want = both_row_batches(edge_store, dict(batch_size=6),
                                 shuffle_row_groups=False)
    assert_batches_equal(got, want)
    assert got[0]['flag'].dtype == torch.uint8
    assert got[0]['u16'].dtype == torch.int32
    assert got[0]['u32'].dtype == torch.int64


def test_edge_types_through_batched_loader_as_jax(edge_store):
    got, want = both_batched(edge_store, 'BatchedDataLoader',
                             dict(batch_size=6), shuffle_row_groups=False)
    assert_batches_equal(got, want)
    assert got[0]['u32'].dtype == torch.int64


# -- the device rule, read-only arrays, the protocol ------------------------

def test_default_device_raises_without_cuda(scalar_dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with make_batch_reader(scalar_dataset.url, reader_pool_type='dummy') as r:
        for cls in (tpt.DataLoader, tpt.BatchedDataLoader):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls(r)
            assert cls(r, device='cpu').device == torch.device('cpu')


class _ArrayReader:
    """A batched reader of one read-only column batch."""

    batched_output = True
    ngram = None

    def __init__(self, n=12):
        col = np.arange(n, dtype=np.float32)
        col.flags.writeable = False
        self.column = col
        self.stopped = self.joined = False
        self.resets = 0

    def __iter__(self):
        yield {'x': self.column}

    def reset(self):
        self.resets += 1

    def stop(self):
        self.stopped = True

    def join(self):
        self.joined = True


def test_read_only_arrays_are_copied_at_the_edge():
    reader = _ArrayReader()
    with warnings.catch_warnings():
        warnings.simplefilter('error')      # torch warns on a read-only view
        batch = next(iter(tpt.BatchedDataLoader(reader, batch_size=12,
                                                device='cpu')))
    batch['x'][0] = 99.0
    assert reader.column[0] == 0.0


@pytest.mark.timeout(240)
@pytest.mark.parametrize('kind', ['row', 'batch'])
def test_process_pool_batches_as_the_dummy_pools(synthetic_dataset,
                                                    scalar_dataset, kind):
    """Over worker processes (arrays received as frames) torch warns of
    no non-writable array, and the rows are the dummy pool's."""
    if kind == 'row':
        url, factory, cls = synthetic_dataset.url, make_reader, tpt.DataLoader
        kw = dict(schema_fields=['id', 'matrix'])
    else:
        url, factory, cls = (scalar_dataset.url, make_batch_reader,
                             tpt.BatchedDataLoader)
        kw = {}

    def rows(pool):
        with factory(url, reader_pool_type=pool, workers_count=2,
                     num_epochs=1, **kw) as r:
            with warnings.catch_warnings():
                warnings.filterwarnings('error', message='.*not writable')
                batches = list(cls(r, batch_size=10, device='cpu'))
        out = {}
        for b in batches:
            for i, key in enumerate(b['id'].tolist()):
                out[key] = {k: v[i] for k, v in b.items()
                            if isinstance(v, torch.Tensor)}
        return out

    got, want = rows('process'), rows('dummy')
    assert sorted(got) == sorted(want)
    for key in want:
        for name in want[key]:
            torch.testing.assert_close(got[key][name], want[key][name],
                                       rtol=0, atol=0, equal_nan=True)


def test_second_pass_resets_with_the_warning_and_guards(caplog):
    reader = _ArrayReader()
    loader = tpt.BatchedDataLoader(reader, batch_size=4, device='cpu')
    first = list(loader)
    with caplog.at_level('WARNING', logger='petastorm_tpu_torch.pytorch'):
        second = list(loader)
    assert reader.resets == 1
    assert 'inmemory_cache_all=True' in caplog.text
    assert_batches_equal(second, first)
    it = iter(loader)
    next(it)
    with pytest.raises(RuntimeError, match='already being iterated'):
        next(iter(loader))
    it.close()


def test_no_iteration_after_a_failed_one():
    class Failing(_ArrayReader):
        def __iter__(self):
            raise IOError('disk gone')
    for pkg in (jpt, tpt):
        kw = {'device': 'cpu'} if pkg is tpt else {}
        loader = pkg.BatchedDataLoader(Failing(), batch_size=4, **kw)
        with pytest.raises(IOError):
            list(loader)
        with pytest.raises(RuntimeError, match='after a failed one'):
            list(loader)


def test_context_manager_stops_and_joins_the_reader():
    reader = _ArrayReader()
    with tpt.DataLoader(reader, batch_size=5, device='cpu') as loader:
        batches = list(loader)
    assert reader.stopped and reader.joined
    assert [len(b['x']) for b in batches] == [5, 5, 2]


# -- the mixture through the row loader (test_weighted_sampling.py:157) ----

def test_mixture_through_the_row_loader_as_jax():
    from petastorm_tpu.test_util.reader_mock import ReaderMock
    from petastorm_tpu.unischema import Unischema, UnischemaField
    from petastorm_tpu.weighted_sampling_reader import \
        WeightedSamplingReader as JMixed

    from petastorm_tpu_torch.weighted_sampling_reader import \
        WeightedSamplingReader
    schema = Unischema('mock', [UnischemaField('id', np.int64, (), None,
                                               False)])

    def batches(mixed_cls, pkg, **kw):
        readers = [ReaderMock(schema, num_rows=40, seed=0),
                   ReaderMock(schema, num_rows=40, seed=100)]
        mixed = mixed_cls(readers, [0.5, 0.5], seed=0)
        with pkg.DataLoader(mixed, batch_size=10, **kw) as loader:
            return list(loader)

    want = batches(JMixed, jpt)
    got = batches(WeightedSamplingReader, tpt, device='cpu')
    assert got, 'mixed reader produced no batches'
    assert_batches_equal(got, want)
    assert all(len(b['id']) == 10 for b in got[:-1])


def test_mixture_of_port_readers_through_the_row_loader(synthetic_dataset):
    from petastorm_tpu.weighted_sampling_reader import \
        WeightedSamplingReader as JMixed

    from petastorm_tpu_torch.weighted_sampling_reader import \
        WeightedSamplingReader
    kw = dict(reader_pool_type='dummy', schema_fields=['^id$', 'matrix'],
              num_epochs=1, shuffle_row_groups=False)
    with JMixed([jmake_reader(synthetic_dataset.url, **kw),
                 jmake_reader(synthetic_dataset.url, **kw)], [0.3, 0.7],
                seed=4) as mixed:
        want = list(jpt.DataLoader(mixed, batch_size=9))
    with WeightedSamplingReader([make_reader(synthetic_dataset.url, **kw),
                                 make_reader(synthetic_dataset.url, **kw)],
                                [0.3, 0.7], seed=4) as mixed:
        got = list(tpt.DataLoader(mixed, batch_size=9, device='cpu'))
    assert_batches_equal(got, want)


# -- the slice as a whole ------------------------------------------------------

def test_small_lm_from_both_data_loaders(tmp_path):
    """A 2-layer LM (d_model 64, float32, params from JAX's init) takes 2
    AdamW steps on each package's ``DataLoader`` batches of an
    ``NdarrayCodec`` token store (shuffled, seed 3): batches equal, losses
    within 1e-4 (JAX's flash attention as its own tests run it here)."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import materialize_dataset
    from petastorm_tpu.models import transformer_lm as jtlm
    from petastorm_tpu.unischema import Unischema, UnischemaField

    from petastorm_tpu_torch.models import transformer_lm as ttlm
    from petastorm_tpu_torch.weights import params_from_jax
    seq, vocab = 32, 128
    schema = Unischema('Tok', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (seq + 1,), NdarrayCodec(),
                       False)])
    url = 'file://' + str(tmp_path / 'tok')
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (24, seq + 1), dtype=np.int32)
    with materialize_dataset(url, schema, rows_per_file=8) as w:
        w.write_rows({'idx': np.int64(i), 'tokens': tokens[i]}
                     for i in range(24))
    base = dict(vocab_size=vocab, d_model=64, n_heads=4, n_layers=2,
                d_ff=128, max_seq_len=seq, attention='flash')
    jcfg = jtlm.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = ttlm.TransformerConfig(dtype=torch.float32, **base)
    jparams = jtlm.init(jax.random.PRNGKey(0), jcfg)
    loader_kw = dict(batch_size=4, shuffling_queue_capacity=8, seed=3)
    got, want = both_row_batches(url, loader_kw)
    assert_batches_equal(got, want)
    for b in got:
        for i, row in zip(b['idx'].tolist(), b['tokens']):
            np.testing.assert_array_equal(row.numpy(), tokens[i])

    optimizer, jstep = jtlm.make_train_step(jcfg)
    opt_state = optimizer.init(jparams)
    params, jax_losses = jparams, []
    for b in want[:2]:
        t = jnp.asarray(b['tokens'].numpy())
        params, opt_state, loss = jstep(params, opt_state, t[:, :-1],
                                        t[:, 1:])
        jax_losses.append(float(loss))
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device='cpu')
    _, step = ttlm.make_train_step(tcfg, tparams)
    losses = []
    for b in got[:2]:
        t = b['tokens'].long()
        losses.append(float(step(t[:, :-1], t[:, 1:])))
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=1e-4)


def test_ngram_reader_next_gives_jax_windows(tmp_path):
    """``next()`` on a chunked NGram reader gives its windows one by one,
    each chunk's last first, equal to JAX's (what the TF adapter and any
    per-window consumer iterate); the port once raised ``TypeError``."""
    from petastorm_tpu.ngram import NGram as JNGram
    from petastorm_tpu.test_util.dataset_gen import create_test_dataset

    from petastorm_tpu_torch.ngram import NGram
    url = 'file://' + str(tmp_path / 'ngram')
    create_test_dataset(url, range(30), num_files=2, row_group_size_mb=100)
    fields = {0: ['id', 'matrix'], 1: ['id'], 3: ['id2']}
    kw = dict(reader_pool_type='dummy', num_epochs=1,
              shuffle_row_groups=False)
    with jmake_reader(url, schema_fields=JNGram(dict(fields), 10, 'id'),
                      **kw) as r:
        want = list(r)
    with make_reader(url, schema_fields=NGram(dict(fields), 10, 'id'),
                     **kw) as r:
        assert r.ngram_chunked
        got = list(r)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {0, 1, 3}
        for off in w:
            assert g[off]._fields == w[off]._fields
            for name in w[off]._fields:
                np.testing.assert_array_equal(getattr(g[off], name),
                                              getattr(w[off], name))


# -- phase 26 of chip_smoke.py on the CPU ---------------------------------------

@pytest.mark.timeout(300)
def test_chip_smoke_adapter_line_on_cpu(tmp_path, monkeypatch):
    """Phase 26 (a)-(e) at small sizes on the CPU: every gate holds (the
    twins run: no launches) and nothing is left behind."""
    import argparse
    import os

    import chip_smoke
    from petastorm_tpu_torch.models import transformer_lm as ttlm
    from petastorm_tpu_torch.ops import kernels
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    cfg = ttlm.TransformerConfig(vocab_size=512, d_model=64, n_heads=4,
                                 n_layers=2, d_ff=128, max_seq_len=64,
                                 attention='flash', dtype=torch.float32)
    launches = chip_smoke.adapter_line(
        torch, np, ttlm, kernels, argparse.Namespace(seed=0), device='cpu',
        cfg=cfg, rows=64, image_rows=32, image_batch=8, image_size=32,
        mnist_rows=2000, mnist_batch=128, table_rows=1000)
    assert launches == {'flash_fwd': 0, 'flash_bwd_dq': 0,
                        'flash_bwd_dkdv': 0, 'normalize': 0}
    assert os.listdir(str(tmp_path)) == []
