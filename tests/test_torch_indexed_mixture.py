"""The port's ``WeightedIndexedMixture`` against the JAX package's, on the
CPU.

The port's counterparts of JAX's ``tests/test_indexed_mixture.py``: each
mixes the port's indexed loaders over two stores written by the JAX
package and is held against JAX's mixture over JAX's loaders on the same
stores and seeds (the mixed stream, its choice sequence, its cursor and
its resume). Also NGram sources, the choice sequence against
``draw_index(normalize_cumulative(p), default_rng((seed, k)).random())``,
and a source whose close raises. Tolerance: exact.
"""

import json

import numpy as np
import pytest

from petastorm_tpu import WeightedIndexedMixture as JMixture
from petastorm_tpu.codecs import ScalarCodec as JScalarCodec
from petastorm_tpu.etl.dataset_metadata import \
    materialize_dataset as jmaterialize
from petastorm_tpu.indexed import make_indexed_loader as jmake_loader
from petastorm_tpu.unischema import Unischema as JUnischema
from petastorm_tpu.unischema import UnischemaField as JField

from petastorm_tpu_torch import WeightedIndexedMixture, make_indexed_loader
from petastorm_tpu_torch.weighted_sampling_reader import (draw_index,
                                                          normalize_cumulative)

Schema = JUnischema('Src', [
    JField('id', np.int64, (), JScalarCodec(), False),
    JField('src', np.int64, (), JScalarCodec(), False)])


def _write(path, source_id, rows):
    url = 'file://' + str(path)
    with jmaterialize(url, Schema, rows_per_file=16) as w:
        w.write_rows({'id': np.int64(i), 'src': np.int64(source_id)}
                     for i in range(rows))
    return url


@pytest.fixture()
def two_sources(tmp_path):
    return (_write(tmp_path / 'a', 0, 96), _write(tmp_path / 'b', 1, 96))


def _mixture(urls, seed=7, workers=2, num_epochs=4, batch=8, package='torch'):
    factory, mixture = ((make_indexed_loader, WeightedIndexedMixture)
                        if package == 'torch' else (jmake_loader, JMixture))
    loaders = [factory(u, batch_size=batch, num_epochs=num_epochs,
                       seed=10 + i, workers_count=workers)
               for i, u in enumerate(urls)]
    return mixture(loaders, [0.75, 0.25], seed=seed)


def _digest(batch):
    return (int(batch['src'][0]), tuple(int(i) for i in batch['id']))


def _jax_stream(urls, **kw):
    mix = _mixture(urls, package='jax', **kw)
    out = [_digest(b) for b in mix]
    mix.close()
    return out


@pytest.mark.timeout(60)
def test_mix_ratio_and_source_purity(two_sources):
    mix = _mixture(two_sources)
    got = []
    for batch in mix:
        src = set(int(s) for s in batch['src'])
        assert len(src) == 1
        got.append(_digest(batch))
    mix.close()
    assert got == _jax_stream(two_sources)
    picks = [src for src, _ in got]
    assert len(picks) > 30
    assert 0.55 < picks.count(0) / len(picks) < 0.95


@pytest.mark.timeout(60)
@pytest.mark.parametrize('workers', [1, 4])
def test_stream_deterministic_across_worker_counts(two_sources, workers):
    mix = _mixture(two_sources, workers=workers)
    got = [_digest(b) for b in mix]
    mix.close()
    assert got == _jax_stream(two_sources, workers=2)


@pytest.mark.timeout(60)
def test_resume_is_byte_exact_mid_stream(two_sources):
    full = _jax_stream(two_sources)
    states = {}
    for package in ('jax', 'torch'):
        first = _mixture(two_sources, package=package)
        it = iter(first)
        got = [_digest(next(it)) for _ in range(11)]
        states[package] = first.state_dict()
        it.close()
        first.close()
        assert got == full[:11]
    assert states['torch'] == states['jax']
    resumed = _mixture(two_sources, workers=3)
    resumed.load_state_dict(json.loads(json.dumps(states['torch'])))
    rest = [_digest(b) for b in resumed]
    resumed.close()
    assert rest == full[11:]
    assert rest


@pytest.mark.timeout(60)
def test_state_dict_is_o1(two_sources):
    mix = _mixture(two_sources)
    it = iter(mix)
    next(it)
    state = mix.state_dict()
    assert set(state) == {'step', 'sources', 'version'}
    assert state['step'] == 1
    assert all(set(s) >= {'epoch', 'batch'} for s in state['sources'])
    it.close()
    mix.close()


class _Stub:
    def __init__(self):
        self.closed = 0

    def state_dict(self):
        return {}

    def load_state_dict(self, s):
        pass

    def __iter__(self):
        return iter(())

    def close(self):
        self.closed += 1


@pytest.mark.parametrize('seed', [0, 3, 17, 2 ** 40])
@pytest.mark.parametrize('p', [(0.5, 0.5), (0.75, 0.25), (2, 6, 1)])
def test_choice_sequence_as_jax_and_pure(seed, p):
    mix = WeightedIndexedMixture([_Stub() for _ in p], list(p), seed=seed)
    jmix = JMixture([_Stub() for _ in p], list(p), seed=seed)
    deep = WeightedIndexedMixture([_Stub() for _ in p], list(p), seed=seed)
    deep.step = 40                    # a mixture resumed deep in its stream
    cumulative = normalize_cumulative(p)
    for k in range(0, 60):
        want = draw_index(cumulative,
                          np.random.default_rng((seed, k)).random())
        assert mix._choice(k) == jmix._choice(k) == want
        assert deep._choice(k) == want


def test_rejects_streaming_readers(two_sources):
    from petastorm_tpu_torch import make_reader
    with make_reader(two_sources[0], reader_pool_type='dummy') as r:
        with pytest.raises(ValueError, match='indexed-family'):
            WeightedIndexedMixture([r], [1.0])


def test_rejects_replay_checkpointable_loaders():
    from petastorm_tpu.checkpoint import CheckpointableLoader as JCkpt
    from petastorm_tpu_torch.checkpoint import CheckpointableLoader
    with pytest.raises(ValueError, match='indexed-family') as terr:
        WeightedIndexedMixture([CheckpointableLoader(lambda: iter(()))],
                               [1.0])
    with pytest.raises(ValueError) as jerr:
        JMixture([JCkpt(lambda: iter(()))], [1.0])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize('args', [([1.5, -0.5], 2), ([1.0], 2), ([], 0),
                                  ([0.0, 0.0], 2)])
def test_bad_arguments_raise_jax_words(args):
    p, n = args
    with pytest.raises(ValueError) as terr:
        WeightedIndexedMixture([_Stub() for _ in range(n)], p)
    with pytest.raises(ValueError) as jerr:
        JMixture([_Stub() for _ in range(n)], p)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.timeout(60)
def test_stops_on_first_exhausted_pick(tmp_path):
    urls = (_write(tmp_path / 'long', 0, 96), _write(tmp_path / 'short', 1,
                                                     16))
    streams = {}
    for package, factory, mixture in (
            ('jax', jmake_loader, JMixture),
            ('torch', make_indexed_loader, WeightedIndexedMixture)):
        loaders = [factory(urls[0], batch_size=8, num_epochs=8, seed=1),
                   factory(urls[1], batch_size=8, num_epochs=1, seed=2)]
        mix = mixture(loaders, [0.5, 0.5], seed=0)
        streams[package] = [_digest(b) for b in mix]
        mix.close()
    assert streams['torch'] == streams['jax']
    assert 0 < len(streams['torch']) < 8 * 12


@pytest.mark.timeout(60)
def test_ngram_sources_as_jax(tmp_path):
    """Two indexed NGram loaders mixed: the same windows as JAX's mixture
    over JAX's NGram loaders, and a resume mid-stream."""
    from petastorm_tpu.indexed_ngram import \
        make_indexed_ngram_loader as jmake_ngram
    from petastorm_tpu.ngram import NGram as JNGram
    from petastorm_tpu_torch import make_indexed_ngram_loader
    from petastorm_tpu_torch.ngram import NGram
    urls = (_write(tmp_path / 'a', 0, 64), _write(tmp_path / 'b', 1, 64))
    fields = {0: ['id', 'src'], 1: ['id']}

    def mix(package, workers=2):
        factory, ngram_cls, mixture = (
            (make_indexed_ngram_loader, NGram, WeightedIndexedMixture)
            if package == 'torch' else (jmake_ngram, JNGram, JMixture))
        loaders = [factory(u, ngram_cls(dict(fields), delta_threshold=1,
                                        timestamp_field='id'),
                           batch_size=4, num_epochs=1, seed=5,
                           workers_count=workers) for u in urls]
        return mixture(loaders, [0.75, 0.25], seed=9)

    def digest(batch):
        return (int(batch[0]['src'][0]), tuple(int(i) for i in batch[0]['id']),
                tuple(int(i) for i in batch[1]['id']))

    want = [digest(b) for b in mix('jax')]
    got = [digest(b) for b in mix('torch')]
    assert got == want and len(got) > 5
    first = mix('torch')
    it = iter(first)
    for _ in range(5):
        next(it)
    state = first.state_dict()
    it.close()
    resumed = mix('torch', workers=1)
    resumed.load_state_dict(state)
    assert [digest(b) for b in resumed] == want[5:]


def test_every_source_closed_when_one_close_raises():
    class Failing(_Stub):
        def __iter__(self):
            return _Closing(self, fail=True)

    class Fine(_Stub):
        def __iter__(self):
            return _Closing(self, fail=False)

    sources = [Failing(), Fine()]
    mix = WeightedIndexedMixture(sources, [0.5, 0.5], seed=0)
    it = iter(mix)
    for _ in range(6):
        next(it)
    with pytest.raises(RuntimeError, match='close failed'):
        it.close()
    assert all(s.closed == 1 for s in sources)


class _Closing:
    """An endless iterator whose close counts on its source (and raises
    when ``fail``)."""

    def __init__(self, source, fail):
        self._source, self._fail = source, fail

    def __iter__(self):
        return self

    def __next__(self):
        return {'x': 1}

    def close(self):
        self._source.closed += 1
        if self._fail:
            raise RuntimeError('close failed')
