"""The port's replay checkpoint (``CheckpointableLoader``) against the JAX
package's, on the CPU.

The port's counterparts of JAX's ``tests/test_checkpoint.py``: the port's
``make_reader`` + ``TorchDataLoader`` under the port's
``CheckpointableLoader`` give the batches JAX's ``make_reader`` +
``JaxDataLoader`` give under JAX's, on one store with one seed, for a full
run, a mid-epoch resume, an epoch-boundary resume and a JSON round trip;
a restored but unstarted loader reports its pending skip; thread-pool
readers are released each epoch; bad states raise JAX's words; and an NGram
reader resumes window for window. Tolerance: exact.
"""

import json
import threading

import numpy as np
import pytest

from petastorm_tpu.checkpoint import CheckpointableLoader as JCkpt
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.reader import make_reader as jmake_reader

from petastorm_tpu_torch import TorchDataLoader, make_reader
from petastorm_tpu_torch.checkpoint import CheckpointableLoader


def _factory(url, package='torch'):
    def factory():
        if package == 'jax':
            reader = jmake_reader(url, reader_pool_type='dummy', num_epochs=1,
                                  seed=7, shuffle_row_groups=True,
                                  schema_fields=['id'])
            return JaxDataLoader(reader, batch_size=8, seed=7)
        reader = make_reader(url, reader_pool_type='dummy', num_epochs=1,
                             seed=7, shuffle_row_groups=True,
                             schema_fields=['id'])
        return TorchDataLoader(reader, batch_size=8, seed=7, device='cpu')
    return factory


def _stream(loader, num_epochs):
    return [(loader.epoch, np.asarray(batch['id']).tolist())
            for batch in loader.epochs(num_epochs)]


def _jax_reference(url, num_epochs=2):
    return _stream(JCkpt(_factory(url, 'jax')), num_epochs)


def _consume(loader, n, num_epochs=2):
    consumed = []
    for batch in loader.epochs(num_epochs):
        consumed.append((loader.epoch, np.asarray(batch['id']).tolist()))
        if len(consumed) == n:
            return consumed, loader.state_dict()
    raise AssertionError('the stream ended after %d batches' % len(consumed))


@pytest.mark.timeout(60)
def test_full_run_covers_epochs(synthetic_dataset):
    stream = _stream(CheckpointableLoader(_factory(synthetic_dataset.url)), 2)
    assert stream == _jax_reference(synthetic_dataset.url)
    assert {e for e, _ in stream} == {0, 1}
    ids_epoch0 = [i for e, b in stream if e == 0 for i in b]
    assert sorted(ids_epoch0) == sorted(r['id'] for r in
                                        synthetic_dataset.data)


@pytest.mark.timeout(60)
def test_mid_epoch_resume_exact(synthetic_dataset):
    url = synthetic_dataset.url
    reference = _jax_reference(url)
    consumed, state = _consume(CheckpointableLoader(_factory(url)), 7)
    _, jstate = _consume(JCkpt(_factory(url, 'jax')), 7)
    assert state == jstate == {'epoch': 0, 'step': 7, 'version': 1}
    second = CheckpointableLoader(_factory(url))
    second.load_state_dict(state)
    assert consumed + _stream(second, 2) == reference


@pytest.mark.timeout(60)
def test_epoch_boundary_resume(synthetic_dataset):
    url = synthetic_dataset.url
    reference = _jax_reference(url)
    n_epoch0 = sum(1 for e, _ in reference if e == 0)
    consumed, state = _consume(CheckpointableLoader(_factory(url)), n_epoch0)
    assert state == {'epoch': 0, 'step': n_epoch0, 'version': 1}
    second = CheckpointableLoader(_factory(url))
    second.load_state_dict(state)
    assert consumed + _stream(second, 2) == reference


@pytest.mark.timeout(60)
def test_state_is_jsonable(synthetic_dataset):
    loader = CheckpointableLoader(_factory(synthetic_dataset.url))
    next(iter(loader.epochs(1)))
    state = json.loads(json.dumps(loader.state_dict()))
    assert state == {'epoch': 0, 'step': 1, 'version': 1}
    restored = CheckpointableLoader(_factory(synthetic_dataset.url))
    restored.load_state_dict(state)
    assert restored.epoch == 0


def test_save_before_resume_keeps_cursor(synthetic_dataset):
    for cls in (CheckpointableLoader, JCkpt):
        loader = cls(_factory(synthetic_dataset.url))
        loader.load_state_dict({'epoch': 3, 'step': 500, 'version': 1})
        assert loader.state_dict() == {'epoch': 3, 'step': 500, 'version': 1}


@pytest.mark.parametrize('state', [
    [1], {'epoch': 0, 'step': 1}, {'epoch': 0, 'step': 1, 'version': 3},
    {'step': 1, 'version': 1}])
def test_bad_states_raise_jax_words(state):
    with pytest.raises(ValueError) as terr:
        CheckpointableLoader(lambda: iter(())).load_state_dict(state)
    with pytest.raises(ValueError) as jerr:
        JCkpt(lambda: iter(())).load_state_dict(state)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.timeout(60)
def test_thread_pool_readers_are_released(synthetic_dataset):
    def factory():
        reader = make_reader(synthetic_dataset.url, reader_pool_type='thread',
                             workers_count=2, num_epochs=1, seed=0,
                             schema_fields=['id'])
        return TorchDataLoader(reader, batch_size=8, device='cpu')
    before = threading.active_count()
    loader = CheckpointableLoader(factory)
    for _ in loader.epochs(3):
        pass
    assert threading.active_count() <= before + 2


@pytest.mark.timeout(60)
def test_ngram_reader_resumes_window_for_window(tmp_path):
    """The LM line's replay: NGram windows of a token store through
    ``make_reader`` (dummy pool, seeded) and the loader with ``drop_last``;
    the port's stream equals JAX's, and a restore after 5 batches gives the
    rest of it."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import materialize_dataset
    from petastorm_tpu.ngram import NGram as JNGram
    from petastorm_tpu.unischema import Unischema, UnischemaField
    from petastorm_tpu_torch.ngram import NGram
    schema = Unischema('Tok', [
        UnischemaField('step', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (16,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path / 'tok')
    rng = np.random.default_rng(2)
    with materialize_dataset(url, schema, rows_per_file=40) as w:
        w.write_rows({'step': np.int64(i),
                      'tokens': rng.integers(0, 99, 16, dtype=np.int32)}
                     for i in range(80))
    fields = {0: ['step', 'tokens'], 1: ['tokens']}

    def factory(package):
        def make():
            if package == 'jax':
                reader = jmake_reader(
                    url, schema_fields=JNGram(dict(fields), 1, 'step'),
                    reader_pool_type='dummy', seed=3)
                return JaxDataLoader(reader, batch_size=8, drop_last=True)
            reader = make_reader(url, schema_fields=NGram(dict(fields), 1,
                                                          'step'),
                                 reader_pool_type='dummy', seed=3)
            return TorchDataLoader(reader, batch_size=8, drop_last=True,
                                   device='cpu')
        return make

    def digest(loader, n=None):
        out = []
        for batch in loader.epochs(1):
            out.append((np.asarray(batch[0]['step']).tolist(),
                        np.asarray(batch[1]['tokens']).tolist()))
            if len(out) == n:
                break
        return out

    full = digest(CheckpointableLoader(factory('torch')))
    assert full == digest(JCkpt(factory('jax')))
    assert len(full) == 2 * 39 // 8
    first = CheckpointableLoader(factory('torch'))
    head = digest(first, 5)
    state = first.state_dict()
    assert state == {'epoch': 0, 'step': 5, 'version': 1}
    second = CheckpointableLoader(factory('torch'))
    second.load_state_dict(state)
    assert head + digest(second) == full
