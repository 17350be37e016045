"""The port's ``WeightedSamplingReader`` against the JAX package's, on the
CPU.

The port's counterparts of JAX's ``tests/test_weighted_sampling.py`` (all
but its ``pytorch.DataLoader`` case, which waits for the port of that
adapter): every case runs the JAX mixture beside the port's over the same
readers or stubs and seed, and holds the draws, the rows, the errors'
words and the loader's batches equal (exact). Mixed NGram readers give
JAX's windows, and ``TorchDataLoader`` over the port's mixture gives the
batches ``JaxDataLoader`` gives over JAX's.
"""

import collections

import numpy as np
import pytest

from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.reader import make_reader as jmake_reader
from petastorm_tpu.test_util.reader_mock import ReaderMock
from petastorm_tpu.unischema import Unischema, UnischemaField
from petastorm_tpu.weighted_sampling_reader import \
    WeightedSamplingReader as JMixed

from petastorm_tpu_torch import TorchDataLoader, make_reader
from petastorm_tpu_torch.weighted_sampling_reader import (
    WeightedSamplingReader, draw_index, normalize_cumulative)

_SCHEMA = Unischema('mock', [
    UnischemaField('id', np.int64, (), None, False),
])

MIXTURES = {'jax': JMixed, 'torch': WeightedSamplingReader}


class _StubReader:
    """An endless reader of one tag: counts which reader served a row."""

    def __init__(self, tag, schema=_SCHEMA, batched_output=False, ngram=None):
        self.tag = tag
        self.schema = schema
        self.batched_output = batched_output
        self.ngram = ngram
        self.last_row_consumed = False
        self.stopped = False
        self.joined = False

    def __iter__(self):
        return self

    def __next__(self):
        return self.tag

    def stop(self):
        self.stopped = True

    def join(self):
        self.joined = True


def _draws(tags, p, seed, n):
    """``n`` draws of each package's mixture over stubs."""
    return {name: _take(mixed([_StubReader(t) for t in tags], p, seed=seed),
                        n)
            for name, mixed in MIXTURES.items()}


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize('p', [[0.0, 1.0], [2, 6], [0.5, 0.3, 0.2],
                               [1, 1, 0, 5]])
@pytest.mark.parametrize('seed', [0, 7, 11])
def test_draws_as_jax(p, seed):
    tags = 'abcd'[:len(p)]
    got = _draws(tags, p, seed, 500)
    assert got['torch'] == got['jax']
    if p == [0.0, 1.0]:
        assert got['torch'] == ['b'] * 500


def test_select_only_one_of_readers():
    mixed = WeightedSamplingReader([_StubReader('a'), _StubReader('b')],
                                   [0.0, 1.0], seed=0)
    assert [next(mixed) for _ in range(100)] == ['b'] * 100


def test_not_normalized_probabilities():
    counts = collections.Counter(_take(WeightedSamplingReader(
        [_StubReader('a'), _StubReader('b')], [2, 6], seed=7), 4000))
    assert abs(counts['b'] / 4000 - 0.75) < 0.05


def test_mixing_ratios():
    counts = collections.Counter(_take(WeightedSamplingReader(
        [_StubReader(t) for t in 'abc'], [0.5, 0.3, 0.2], seed=3), 6000))
    for tag, p in zip('abc', (0.5, 0.3, 0.2)):
        assert abs(counts[tag] / 6000 - p) < 0.05


def test_seed_reproducible():
    def stream(seed):
        return _take(WeightedSamplingReader(
            [_StubReader('a'), _StubReader('b')], [0.5, 0.5], seed=seed), 200)
    assert stream(11) == stream(11)
    assert stream(11) != stream(12)


def test_draw_functions_as_jax():
    from petastorm_tpu import weighted_sampling_reader as jws
    rng = np.random.default_rng(0)
    for p in ([1], [0.2, 0.8], [3, 0, 4, 1]):
        np.testing.assert_array_equal(normalize_cumulative(p),
                                      jws.normalize_cumulative(p))
        cumulative = normalize_cumulative(p)
        for u in list(rng.random(50)) + [0.0, 0.999999999, 1.0]:
            assert draw_index(cumulative, u) == jws.draw_index(cumulative, u)


def test_stops_when_any_reader_exhausted():
    got = {}
    for name, mixed_cls in MIXTURES.items():
        finite = ReaderMock(_SCHEMA, num_rows=5)
        mixed = mixed_cls([finite, _StubReader('b')], [1.0, 0.0], seed=0)
        got[name] = [row.id for row in mixed]
        assert mixed.last_row_consumed
    assert got['torch'] == got['jax']
    assert len(got['torch']) == 5


@pytest.mark.parametrize('case', ['length', 'empty', 'zero', 'negative',
                                  'schema', 'batched', 'ngram'])
def test_bad_arguments_raise_jax_words(case):
    other = Unischema('other', [
        UnischemaField('other_field', np.int64, (), None, False)])

    def args():
        return {
            'length': ([_StubReader('a')], [0.5, 0.5]),
            'empty': ([], []),
            'zero': ([_StubReader('a')], [0.0]),
            'negative': ([_StubReader('a'), _StubReader('b')], [-1.0, 1.0]),
            'schema': ([_StubReader('a'), _StubReader('b', schema=other)],
                       [0.5, 0.5]),
            'batched': ([_StubReader('a'),
                         _StubReader('b', batched_output=True)], [0.5, 0.5]),
            'ngram': ([_StubReader('a', ngram=object()), _StubReader('b')],
                      [0.5, 0.5])}[case]
    with pytest.raises(ValueError) as terr:
        WeightedSamplingReader(*args())
    with pytest.raises(ValueError) as jerr:
        JMixed(*args())
    assert str(terr.value) == str(jerr.value)


def test_ngram_pair_allowed():
    mixed = WeightedSamplingReader(
        [_StubReader('a', ngram=object()), _StubReader('b', ngram=object())],
        [0.5, 0.5], seed=0)
    assert mixed.ngram is not None
    assert mixed.ngram_chunked is False


def test_context_manager_stops_all():
    readers = [_StubReader('a'), _StubReader('b')]
    with WeightedSamplingReader(readers, [0.5, 0.5], seed=0) as mixed:
        next(mixed)
    assert all(r.stopped and r.joined for r in readers)


@pytest.mark.timeout(60)
def test_mix_two_real_readers_as_jax(synthetic_dataset):
    """Two live readers of one store (dummy pool, endless): the same 50
    rows as JAX's mixture of JAX's readers."""
    got = {}
    for name, factory in (('jax', jmake_reader), ('torch', make_reader)):
        readers = [factory(synthetic_dataset.url, reader_pool_type='dummy',
                           schema_fields=['^id$'], num_epochs=None,
                           shuffle_row_groups=False) for _ in range(2)]
        with MIXTURES[name](readers, [0.5, 0.5], seed=0) as mixed:
            got[name] = [int(mixed.next().id) for _ in range(50)]
    assert got['torch'] == got['jax']
    assert set(got['torch']) <= {d['id'] for d in synthetic_dataset.data}


@pytest.mark.timeout(60)
def test_torch_loader_over_the_mixture_as_jax_loader(synthetic_dataset):
    """``TorchDataLoader`` over the port's mixture of two readers gives the
    batches ``JaxDataLoader`` gives over JAX's mixture (same seeds)."""
    batches = {}
    for name, factory in (('jax', jmake_reader), ('torch', make_reader)):
        readers = [factory(synthetic_dataset.url, reader_pool_type='dummy',
                           schema_fields=['id', 'id2'], num_epochs=1,
                           seed=s) for s in (1, 2)]
        mixed = MIXTURES[name](readers, [0.3, 0.7], seed=5)
        if name == 'jax':
            loader = JaxDataLoader(mixed, batch_size=10)
        else:
            loader = TorchDataLoader(mixed, batch_size=10, device='cpu')
        with loader:
            batches[name] = [{k: np.asarray(v).tolist()
                              for k, v in b.items()} for b in loader]
    assert batches['torch'] == batches['jax']
    assert len(batches['torch']) >= 2


@pytest.mark.timeout(60)
def test_mock_readers_through_torch_loader():
    readers = [ReaderMock(_SCHEMA, num_rows=30), ReaderMock(_SCHEMA,
                                                            num_rows=30)]
    mixed = WeightedSamplingReader(readers, [0.5, 0.5], seed=0)
    with TorchDataLoader(mixed, batch_size=10, device='cpu') as loader:
        batches = list(loader)
    assert batches
    assert all(b['id'].shape[0] == 10 for b in batches[:-1])


@pytest.mark.timeout(60)
def test_mixed_ngram_readers_as_jax(tmp_path):
    """Two NGram readers (the port's yield window chunks): the mixture
    yields JAX's windows one by one, and the loaders batch them alike."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import materialize_dataset
    from petastorm_tpu.ngram import NGram as JNGram
    from petastorm_tpu_torch.ngram import NGram
    schema = Unischema('Tok', [
        UnischemaField('step', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (4,), NdarrayCodec(), False)])
    urls = []
    for k in range(2):
        url = 'file://' + str(tmp_path / str(k))
        rng = np.random.default_rng(k)
        with materialize_dataset(url, schema, rows_per_file=12) as w:
            w.write_rows({'step': np.int64(i),
                          'tokens': rng.integers(0, 99, 4, dtype=np.int32)}
                         for i in range(36))
        urls.append(url)
    fields = {0: ['step', 'tokens'], 1: ['tokens']}

    def mixture(name):
        factory, ngram = ((jmake_reader, JNGram) if name == 'jax'
                          else (make_reader, NGram))
        readers = [factory(u, schema_fields=ngram(dict(fields), 1, 'step'),
                           reader_pool_type='dummy', seed=4) for u in urls]
        return MIXTURES[name](readers, [0.6, 0.4], seed=2)

    windows = {}
    for name in MIXTURES:
        with mixture(name) as mixed:
            windows[name] = [
                {off: {f: np.asarray(v).tolist()
                       for f, v in nt._asdict().items()}
                 for off, nt in w.items()} for w in mixed]
    assert windows['torch'] == windows['jax']
    assert len(windows['torch']) > 10
    batches = {}
    for name in MIXTURES:
        mixed = mixture(name)
        loader = (JaxDataLoader(mixed, batch_size=4, drop_last=True)
                  if name == 'jax' else
                  TorchDataLoader(mixed, batch_size=4, drop_last=True,
                                  device='cpu'))
        with loader:
            batches[name] = [{off: {f: np.asarray(v).tolist()
                                    for f, v in cols.items()}
                              for off, cols in b.items()} for b in loader]
    assert batches['torch'] == batches['jax']
