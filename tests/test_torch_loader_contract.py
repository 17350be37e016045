"""The port's loader contract against ``JaxDataLoader``'s.

A loader iterated a second time reads a second pass of the reader (13 and
13 batches of 16 from a 200-row store, as JAX; it read 0 the second time
before ``Reader.reset`` existed), one iteration runs at a time, none after
a failed one, and ``reset()`` before the pass drained raises JAX's error.
``pad_spec`` validation gives JAX's messages word for word, and padding
gives JAX's arrays on row and batch readers (buckets, dense arrival, an
empty batch). ``transform_fn``, ``inmemory_cache_all`` (a cached pass
leaves the reader alone; an abandoned one leaves no partial cache),
``epoch_cache_on_device``, ``make_torch_loader`` and
``resolve_prefetch_depth`` behave as JAX's.
"""

import os
from collections import namedtuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import petastorm_tpu
from examples.mnist.main import generate_synthetic_mnist as jgenerate
from petastorm_tpu import jax_utils
from petastorm_tpu.jax_utils import JaxDataLoader

import petastorm_tpu_torch
from petastorm_tpu_torch import torch_utils
from petastorm_tpu_torch.torch_utils import TorchDataLoader

ROWS = 200


@pytest.fixture(scope='module')
def mnist_url(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('mnist') / 'mnist')
    jgenerate(url, n=ROWS, seed=3)
    return url


@pytest.fixture(scope='module')
def ragged_url(tmp_path_factory):
    """40 rows of ``tokens`` int32 ``(None,)`` of 3 to 22 tokens, as the
    JAX package's padding tests write them."""
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Ragged', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (None,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('ragged') / 'ds')
    rng = np.random.default_rng(0)
    with materialize_dataset(url, schema) as w:
        w.write_rows({'id': np.int64(i), 'tokens': rng.integers(
            1, 100, 3 + i % 20).astype(np.int32)} for i in range(40))
    return url


@pytest.fixture(scope='module')
def plain_ragged_url(tmp_path_factory):
    """A plain Parquet store with a ragged ``list<int64>`` column."""
    path = tmp_path_factory.mktemp('plain') / 'ds'
    os.makedirs(str(path))
    table = pa.table({'id': np.arange(40),
                      'tokens': [list(range(3 + i % 20)) for i in range(40)]})
    pq.write_table(table, str(path / 'part.parquet'), row_group_size=10)
    return 'file://' + str(path)


def _numpy(batch):
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in batch.items() if not k.startswith('_')}


def _passes(package, url, n=2, **kw):
    """``n`` passes of a loader over one reader: the idx of each batch."""
    if package == 'jax':
        reader = petastorm_tpu.make_reader(url, workers_count=2, seed=1)
        loader = JaxDataLoader(reader, batch_size=16, **kw)
    else:
        reader = petastorm_tpu_torch.make_reader(url, workers_count=2, seed=1)
        loader = TorchDataLoader(reader, batch_size=16, device='cpu', **kw)
    with loader:
        return [[np.asarray(b['idx']).tolist() for b in loader]
                for _ in range(n)]


def test_second_pass_reads_the_reader_again_as_jax(mnist_url, caplog):
    ref = _passes('jax', mnist_url)
    with caplog.at_level('WARNING', logger=torch_utils.__name__):
        got = _passes('torch', mnist_url)
    assert [len(p) for p in got] == [len(p) for p in ref] == [13, 13]
    for g, r in zip(got, ref):
        assert [len(b) for b in g] == [len(b) for b in r]
        assert sorted(sum(g, [])) == sorted(sum(r, [])) == list(range(ROWS))
    assert 'Start a new pass of the Reader' in caplog.text


def test_iteration_guard(mnist_url):
    with petastorm_tpu_torch.make_reader(mnist_url, workers_count=1) as r:
        loader = TorchDataLoader(r, batch_size=16, device='cpu')
        it = iter(loader)
        next(it)
        with pytest.raises(RuntimeError, match='already being iterated'):
            next(iter(loader))
    calls = []

    def fail_once(batch):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError('bad batch')
        return batch

    with petastorm_tpu_torch.make_reader(mnist_url, workers_count=1) as r:
        loader = TorchDataLoader(r, batch_size=16, device='cpu',
                                 transform_fn=fail_once)
        with pytest.raises(ValueError, match='bad batch'):
            list(loader)
        with pytest.raises(RuntimeError, match='Cannot start a new '
                           'iteration after a failed one') as e:
            next(iter(loader))
        assert isinstance(e.value.__cause__, ValueError)


def test_reset_before_draining_raises_as_jax(mnist_url):
    messages = []
    for package in (petastorm_tpu, petastorm_tpu_torch):
        with package.make_reader(mnist_url, workers_count=1) as reader:
            next(reader)
            with pytest.raises(RuntimeError) as e:
                reader.reset()
            messages.append(str(e.value))
            rest = sum(1 for _ in reader)
            reader.reset()                  # drained: a second pass
            assert sum(1 for _ in reader) == ROWS == rest + 1
    assert messages[0] == messages[1]


PAD_SPECS = {
    'neither': {'t': {}},
    'both': {'t': {'max_len': 4, 'buckets': [4]}},
    'unknown key': {'t': {'max_len': 4, 'bukets': [2]}},
    'zero bucket': {'t': {'buckets': [0, 4]}},
}


@pytest.mark.parametrize('case', sorted(PAD_SPECS))
def test_pad_spec_validation_matches_jax(case):
    with pytest.raises(ValueError) as ref:
        jax_utils.validate_pad_spec(PAD_SPECS[case])
    with pytest.raises(ValueError) as got:
        torch_utils.validate_pad_spec(PAD_SPECS[case])
    assert str(got.value) == str(ref.value)


def test_pad_spec_fields_and_ngram_refusal_match_jax(ragged_url):
    for spec in ({'token': {'max_len': 8}},
                 {'tokens': {'max_len': 8, 'length_field': 'id'}}):
        errors = []
        for package, loader_cls, kw in (
                (petastorm_tpu, JaxDataLoader, {}),
                (petastorm_tpu_torch, TorchDataLoader, {'device': 'cpu'})):
            with package.make_reader(ragged_url, workers_count=1) as r:
                with pytest.raises(ValueError) as e:
                    loader_cls(r, batch_size=4, pad_spec=spec, **kw)
            errors.append(str(e.value).replace('TorchDataLoader',
                                               'JaxDataLoader'))
        assert errors[0] == errors[1]
    from petastorm_tpu.ngram import NGram as JNGram
    from petastorm_tpu_torch.ngram import NGram as TNGram
    errors = []
    for package, ngram, loader_cls, kw in (
            (petastorm_tpu, JNGram, JaxDataLoader, {}),
            (petastorm_tpu_torch, TNGram, TorchDataLoader, {'device': 'cpu'})):
        window = ngram({0: ['id'], 1: ['id']}, delta_threshold=1,
                       timestamp_field='id')
        with package.make_reader(ragged_url, schema_fields=window,
                                 workers_count=1) as r:
            with pytest.raises(ValueError) as e:
                loader_cls(r, batch_size=4, pad_spec={'id': {'max_len': 2}},
                           **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _object_column(*rows):
    col = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        col[i] = np.asarray(r, np.int32)
    return col


PAD_BATCHES = {
    'ragged': ({'tokens': _object_column([1, 2], [3], [4, 5, 6])},
               {'tokens': {'buckets': [2, 4, 8], 'pad_value': -1}}),
    'dense arrival': ({'tokens': np.arange(6, dtype=np.int32).reshape(2, 3)},
                      {'tokens': {'buckets': [4, 8]}}),
    'empty, declared': ({'tokens': _object_column()},
                        {'tokens': {'max_len': 4, 'dtype': np.int16,
                                    'trailing_shape': (3,)}}),
    'empty, undeclared': ({'tokens': _object_column()},
                          {'tokens': {'buckets': [2, 4]}}),
    'absent field': ({'other': np.zeros(2)}, {'tokens': {'max_len': 4}}),
}


@pytest.mark.parametrize('case', sorted(PAD_BATCHES))
def test_pad_ragged_batch_matches_jax(case):
    batch, spec = PAD_BATCHES[case]
    ref = jax_utils.pad_ragged_batch(batch, jax_utils.validate_pad_spec(spec))
    got = torch_utils.pad_ragged_batch(batch,
                                       torch_utils.validate_pad_spec(spec))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize('case', ['overflow', 'scalar rows'])
def test_pad_ragged_batch_errors_match_jax(case):
    if case == 'overflow':
        batch, spec = {'t': _object_column(np.arange(10))}, {'t': {
            'max_len': 4}}
    else:
        batch, spec = {'t': np.zeros(3, np.int32)}, {'t': {'max_len': 4}}
    with pytest.raises(ValueError) as ref:
        jax_utils.pad_ragged_batch(batch, jax_utils.validate_pad_spec(spec))
    with pytest.raises(ValueError) as got:
        torch_utils.pad_ragged_batch(batch,
                                     torch_utils.validate_pad_spec(spec))
    assert str(got.value) == str(ref.value)


def _padded_batches(package, url, factory, batch_size, spec):
    if package == 'jax':
        make = getattr(petastorm_tpu, factory)
        with make(url, workers_count=1, shuffle_row_groups=False) as r:
            return [_numpy(b) for b in JaxDataLoader(
                r, batch_size=batch_size, pad_spec=spec)]
    make = getattr(petastorm_tpu_torch, factory)
    with make(url, workers_count=1, shuffle_row_groups=False) as r:
        out = []
        for b in TorchDataLoader(r, batch_size=batch_size, pad_spec=spec,
                                 device='cpu'):
            assert torch.is_tensor(b['tokens']) and torch.is_tensor(
                b['tokens_len'])
            out.append(_numpy(b))
        return out


@pytest.mark.parametrize('factory,url_fixture,batch_size', [
    ('make_reader', 'ragged_url', 8),
    ('make_reader', 'ragged_url', 1),
    ('make_batch_reader', 'plain_ragged_url', 8),
])
def test_loader_pads_as_jax(request, factory, url_fixture, batch_size):
    url = request.getfixturevalue(url_fixture)
    spec = {'tokens': {'buckets': [8, 16, 32], 'pad_value': -1}}
    ref = _padded_batches('jax', url, factory, batch_size, spec)
    got = _padded_batches('torch', url, factory, batch_size, spec)
    assert len(got) == len(ref) == 40 // batch_size

    def by_id(batches):
        return {int(i): (b['tokens'].shape[1], b['tokens'][j].tolist(),
                         int(b['tokens_len'][j]))
                for b in batches for j, i in enumerate(b['id'])}

    assert by_id(got) == by_id(ref)
    assert all(b['tokens'].dtype == r['tokens'].dtype
               and b['tokens_len'].dtype == np.int32
               for b, r in zip(got, ref))


def test_transform_fn_matches_jax(mnist_url):
    def transform(batch):
        return {'twice': batch['idx'] * 2, 'n': len(batch['digit'])}

    with petastorm_tpu.make_reader(mnist_url, workers_count=1,
                                   shuffle_row_groups=False) as r:
        ref = [_numpy(b) for b in JaxDataLoader(r, batch_size=32,
                                                transform_fn=transform)]
    with petastorm_tpu_torch.make_reader(mnist_url, workers_count=1,
                                         shuffle_row_groups=False) as r:
        got = [_numpy(b) for b in TorchDataLoader(
            r, batch_size=32, transform_fn=transform, device='cpu')]
    assert [set(b) for b in got] == [set(b) for b in ref]
    assert [b['n'] for b in got] == [b['n'] for b in ref]
    assert sorted(np.concatenate([b['twice'] for b in got]).tolist()) == \
        sorted(np.concatenate([b['twice'] for b in ref]).tolist())


def test_inmemory_cache_replays_without_the_reader(mnist_url):
    with petastorm_tpu_torch.make_reader(mnist_url, workers_count=2) as r:
        resets = []
        real_reset = r.reset
        r.reset = lambda: resets.append(1) or real_reset()
        loader = TorchDataLoader(r, batch_size=16, device='cpu',
                                 inmemory_cache_all=True)
        first = list(loader)
        second = list(loader)
        third = list(loader)
        assert not resets
        assert all(a is b for a, b in zip(first, second))
        assert len(first) == len(second) == len(third) == 13
        with pytest.raises(StopIteration):
            next(r)                         # nothing more came from it


class _StubReader:
    """A batched reader of 4 items of 4 ids, resettable at any time."""
    ngram = None
    batched_output = True
    Item = namedtuple('Item', ['id'])

    def __init__(self):
        self.resets = 0

    def __iter__(self):
        return (self.Item(np.arange(4 * i, 4 * i + 4)) for i in range(4))

    def reset(self):
        self.resets += 1

    def stop(self):
        pass

    def join(self):
        pass


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_abandoned_pass_leaves_no_partial_cache(package):
    stub = _StubReader()
    loader = (JaxDataLoader(stub, batch_size=4, inmemory_cache_all=True)
              if package == 'jax' else
              TorchDataLoader(stub, batch_size=4, inmemory_cache_all=True,
                              device='cpu'))
    for _ in loader:
        break                               # abandoned after one batch
    assert not loader._cache_complete
    full = [np.asarray(b['id']).tolist() for b in loader]
    replay = [np.asarray(b['id']).tolist() for b in loader]
    assert full == replay == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11],
                              [12, 13, 14, 15]]
    assert stub.resets == 1                 # the replay read no reader


def test_epoch_cache_on_device_replays_the_same_tensors():
    batches = [{'x': np.full(3, i, np.int64), 'name': np.array(['a', 'b'])}
               for i in range(3)]
    gen = torch_utils.epoch_cache_on_device(iter(batches), device='cpu')
    first = [next(gen) for _ in range(3)]
    again = [next(gen) for _ in range(3)]
    assert all(a is b for a, b in zip(first, again))
    assert all(torch.is_tensor(b['x']) and b['name'].dtype.kind == 'U'
               for b in first)
    assert [int(b['x'][0]) for b in again] == [0, 1, 2]
    assert list(torch_utils.epoch_cache_on_device(iter([]),
                                                  device='cpu')) == []


def test_make_torch_loader(mnist_url):
    assert petastorm_tpu_torch.make_torch_loader is \
        torch_utils.make_torch_loader
    with petastorm_tpu_torch.make_reader(mnist_url, workers_count=1) as r:
        # with a mesh: the sharded loader (tests/test_torch_sharded_loader.py)
        import types
        mesh = types.SimpleNamespace(mesh_dim_names=('data',), shape=(1,),
                                     device_type='cpu',
                                     get_local_rank=lambda axis: 0)
        sharded = torch_utils.make_torch_loader(r, batch_size=4, mesh=mesh)
        assert isinstance(sharded, torch_utils.ShardedTorchLoader)
        assert sharded.sharding.spec == ('data',)
        loader = torch_utils.make_torch_loader(r, batch_size=64,
                                               drop_last=True,
                                               prefetch_depth=3, device='cpu')
        assert isinstance(loader, TorchDataLoader)
        assert loader.prefetch_depth == 3
        got = list(loader.iter_prefetched())
        assert [len(b['idx']) for b in got] == [64] * 3
        host = list(loader.iter_prefetched(to_device=False))
        assert len(host) == 3


@pytest.mark.parametrize('value', [None, 3, '4', 0, -1, 2.5, 'x', ' '])
@pytest.mark.parametrize('env', [None, '5', '0'])
def test_resolve_prefetch_depth_matches_jax(monkeypatch, value, env):
    assert torch_utils.PREFETCH_DEPTH_ENV_VAR == \
        jax_utils.PREFETCH_DEPTH_ENV_VAR
    if env is None:
        monkeypatch.delenv(jax_utils.PREFETCH_DEPTH_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(jax_utils.PREFETCH_DEPTH_ENV_VAR, env)
    results = []
    for fn in (jax_utils.resolve_prefetch_depth,
               torch_utils.resolve_prefetch_depth):
        try:
            results.append(fn(value))
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]
