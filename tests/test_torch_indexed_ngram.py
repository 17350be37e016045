"""The port's indexed NGram loader against the JAX package's, on the CPU.

The same stores (written by the JAX package) go through
``petastorm_tpu.indexed_ngram.make_indexed_ngram_loader`` and the port's:
the window universe of contiguous, gapped, non-overlapping, gapped-offset
and unsorted stores (also held against the port's streaming NGram reader,
JAX's ground truth); ``total_windows``; a predicate dropping rows before
windows form; a transform; ``delta_threshold`` gaps; the fields read and
the fields copied out of the fused gather; the ``pad_spec`` refusal in
JAX's words; determinism across worker counts; and resume. The port's
counterparts of JAX's ``tests/test_indexed_ngram.py`` cases that apply
without a mesh. Tolerance: exact.
"""

import numpy as np
import pytest

from petastorm_tpu.codecs import NdarrayCodec as JNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JScalarCodec
from petastorm_tpu.etl.dataset_metadata import \
    materialize_dataset as jmaterialize
from petastorm_tpu.indexed_ngram import \
    make_indexed_ngram_loader as jmake_loader
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.predicates import in_lambda as jin_lambda
from petastorm_tpu.transform import TransformSpec as JTransformSpec
from petastorm_tpu.unischema import Unischema as JUnischema
from petastorm_tpu.unischema import UnischemaField as JField

from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.indexed_ngram import make_indexed_ngram_loader
from petastorm_tpu_torch.ngram import NGram, valid_window_starts
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.transform import TransformSpec

SeqSchema = JUnischema('SeqSchema', [
    JField('ts', np.int64, (), JScalarCodec(), False),
    JField('value', np.float32, (3,), JNdarrayCodec(), False),
    JField('label', np.int32, (), JScalarCodec(), False),
])


def _write(path, timestamps, rows_per_file=10, shuffle_rows=False):
    url = 'file://' + str(path)
    rows = [{'ts': np.int64(t),
             'value': np.full(3, t, dtype=np.float32),
             'label': np.int32(t % 7)} for t in timestamps]
    if shuffle_rows:
        # shuffled within each file's rows: groups hold the same ts sets,
        # not in ts order
        rng = np.random.default_rng(0)
        shuffled = []
        for start in range(0, len(rows), rows_per_file):
            chunk = rows[start:start + rows_per_file]
            rng.shuffle(chunk)
            shuffled.extend(chunk)
        rows = shuffled
    with jmaterialize(url, SeqSchema, row_group_size_mb=100,
                      rows_per_file=rows_per_file) as w:
        w.write_rows(rows)
    return url


def _ngrams(length=3, delta_threshold=1, timestamp_overlap=True, fields=None):
    """The same NGram in both packages: ``(jax, port)``."""
    fields = fields or {i: ['ts', 'value', 'label'] for i in range(length)}
    return tuple(cls(dict(fields), delta_threshold=delta_threshold,
                     timestamp_field='ts',
                     timestamp_overlap=timestamp_overlap)
                 for cls in (JNGram, NGram))


def _both(url, ngrams, **kw):
    """One loader of each package, predicates and transforms given as
    ``(jax, port)`` pairs."""
    jkw = {k: (v[0] if k in ('predicate', 'transform_spec') else v)
           for k, v in kw.items()}
    tkw = {k: (v[1] if k in ('predicate', 'transform_spec') else v)
           for k, v in kw.items()}
    return jmake_loader(url, ngrams[0], **jkw), \
        make_indexed_ngram_loader(url, ngrams[1], **tkw)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for off in w:
            assert sorted(g[off]) == sorted(w[off])
            for f in w[off]:
                assert g[off][f].dtype == w[off][f].dtype
                np.testing.assert_array_equal(g[off][f], w[off][f],
                                              err_msg='{}/{}'.format(off, f))


def _stream_both(url, ngrams, **kw):
    jl, tl = _both(url, ngrams, **kw)
    with jl, tl:
        want, got = list(jl), list(tl)
    _same_batches(got, want)
    assert tl.total_windows == jl.total_windows
    return got, tl


def _streaming_windows(url, ngram, **reader_kwargs):
    """Every window of the port's streaming NGram reader as {offset:
    {field: value}}."""
    with make_reader(url, schema_fields=ngram, reader_pool_type='dummy',
                     shuffle_row_groups=False, num_epochs=1,
                     **reader_kwargs) as reader:
        windows = []
        if reader.ngram_chunked:
            offsets, base, fields_at = ngram.timestep_layout(
                reader.schema.fields)
            for chunk in reader.iter_ngram_chunks():
                for s in chunk.starts:
                    windows.append({off: {f: chunk.columns[f][s + off - base]
                                          for f in fields_at[off]}
                                    for off in offsets})
            return windows
        return [{off: nt._asdict() for off, nt in w.items()} for w in reader]


def _unbatched(batches, loader):
    out = []
    for batch in batches:
        n = len(next(iter(batch[loader._offsets[0]].values())))
        for i in range(n):
            out.append({off: {f: cols[f][i] for f in cols}
                        for off, cols in batch.items()})
    return out


def _assert_windows_match(got, expected, batch_size):
    """Indexed windows (trimmed by drop_last) equal the streaming universe,
    keyed by each window's first-offset ts."""
    assert len(got) == (len(expected) // batch_size) * batch_size
    exp_by_key = {int(w[sorted(w)[0]]['ts']): w for w in expected}
    assert len(exp_by_key) == len(expected)
    for w in got:
        exp = exp_by_key[int(w[sorted(w)[0]]['ts'])]
        assert sorted(w) == sorted(exp)
        for off in w:
            assert set(w[off]) == set(exp[off])
            for f in w[off]:
                np.testing.assert_array_equal(w[off][f], exp[off][f])


# ---------------------------------------------------------------------------
# window starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', [
    (np.arange(10), 3, 1, True), (np.asarray([0, 1, 2, 10, 11, 12]), 3, 1,
                                  True),
    (np.arange(10), 3, 1, False), (np.asarray([5, 9]), 1, 1, True),
    (np.asarray([0, 2, 4, 5, 6, 20]), 2, 2, False)])
def test_valid_starts_as_jax(case):
    from petastorm_tpu.ngram import valid_window_starts as jstarts
    np.testing.assert_array_equal(valid_window_starts(*case), jstarts(*case))


# ---------------------------------------------------------------------------
# the window universe
# ---------------------------------------------------------------------------

@pytest.mark.timeout(60)
@pytest.mark.parametrize('case', ['contiguous', 'gapped', 'no_overlap',
                                  'gapped_offsets', 'unsorted_storage'])
def test_window_universe_as_jax_and_streaming(tmp_path, case):
    ts, args = list(range(40)), dict(length=3)
    if case == 'gapped':
        ts = list(range(15)) + list(range(20, 40))
    elif case == 'no_overlap':
        args['timestamp_overlap'] = False
    elif case == 'gapped_offsets':
        args['fields'] = {0: ['ts', 'value'], 2: ['ts', 'label']}
    elif case == 'unsorted_storage':
        args['length'] = 2
    url = _write(tmp_path / case, ts,
                 shuffle_rows=(case == 'unsorted_storage'))
    got, loader = _stream_both(url, _ngrams(**args), batch_size=4,
                               num_epochs=1, shuffle=False, workers_count=2)
    expected = _streaming_windows(url, _ngrams(**args)[1])
    assert loader.total_windows == len(expected)
    _assert_windows_match(_unbatched(got, loader), expected, 4)


# ---------------------------------------------------------------------------
# determinism and resume
# ---------------------------------------------------------------------------

def _digest_stream(loader):
    return [(tuple(int(t) for t in batch[0]['ts']),
             (loader.epoch, loader.batch)) for batch in loader]


@pytest.mark.timeout(60)
def test_stream_deterministic_across_worker_counts(tmp_path):
    url = _write(tmp_path / 'det', list(range(50)))
    jngram, ngram = _ngrams(3)
    want = _digest_stream(jmake_loader(url, jngram, batch_size=8,
                                       num_epochs=2, seed=11))
    for workers in (1, 4, 7):
        loader = make_indexed_ngram_loader(url, ngram, batch_size=8,
                                           num_epochs=2, seed=11,
                                           workers_count=workers)
        assert _digest_stream(loader) == want
    assert len(want) == 2 * loader.batches_per_epoch


@pytest.mark.timeout(60)
def test_shuffle_changes_order_keeps_universe(tmp_path):
    url = _write(tmp_path / 'shuf', list(range(50)))
    ngrams = _ngrams(2)
    plain, pl = _stream_both(url, ngrams, batch_size=4, num_epochs=1,
                             shuffle=False)
    shuffled, _ = _stream_both(url, ngrams, batch_size=4, num_epochs=1,
                               seed=3, shuffle=True)
    a = [int(t) for b in plain for t in b[0]['ts']]
    b = [int(t) for x in shuffled for t in x[0]['ts']]
    assert a != b
    assert len(set(a) ^ set(b)) <= 2 * (pl.total_windows % 4)


@pytest.mark.timeout(60)
def test_mid_epoch_resume_byte_exact(tmp_path):
    url = _write(tmp_path / 'resume', list(range(60)))
    jngram, ngram = _ngrams(3)
    kwargs = dict(batch_size=8, num_epochs=2, seed=7, workers_count=2)
    full = _digest_stream(make_indexed_ngram_loader(url, ngram, **kwargs))
    assert full == _digest_stream(jmake_loader(url, jngram, **kwargs))
    assert len(full) >= 6
    states = {}
    for package, factory, ng in (('torch', make_indexed_ngram_loader, ngram),
                                 ('jax', jmake_loader, jngram)):
        first = factory(url, ng, **kwargs)
        it = iter(first)
        for _ in range(3):
            next(it)
        states[package] = first.state_dict()
        it.close()
        first.close()
    assert states['torch'] == states['jax']
    resumed = make_indexed_ngram_loader(url, ngram, batch_size=8,
                                        num_epochs=2, seed=7, workers_count=5)
    resumed.load_state_dict(states['torch'])
    assert _digest_stream(resumed) == full[3:]


@pytest.mark.timeout(60)
def test_resume_across_the_epoch_boundary(tmp_path):
    url = _write(tmp_path / 'boundary', list(range(60)))
    _, ngram = _ngrams(2)
    kwargs = dict(batch_size=8, num_epochs=3, seed=1, workers_count=3)
    full = _digest_stream(make_indexed_ngram_loader(url, ngram, **kwargs))
    loader = make_indexed_ngram_loader(url, ngram, **kwargs)
    per_epoch = loader.batches_per_epoch
    it = iter(loader)
    for _ in range(per_epoch + 2):
        next(it)
    state = loader.state_dict()
    it.close()
    assert state == {'epoch': 1, 'batch': 2, 'version': 1}
    restored = make_indexed_ngram_loader(url, ngram, **kwargs)
    restored.load_state_dict(state)
    assert _digest_stream(restored) == full[per_epoch + 2:]


@pytest.mark.timeout(60)
def test_epoch_shuffles_differ(tmp_path):
    url = _write(tmp_path / 'epochs', list(range(50)))
    got, loader = _stream_both(url, _ngrams(2), batch_size=4, num_epochs=2,
                               seed=5)
    per_epoch = len(got) // 2
    e0 = [tuple(int(t) for t in b[0]['ts']) for b in got[:per_epoch]]
    e1 = [tuple(int(t) for t in b[0]['ts']) for b in got[per_epoch:]]
    assert e0 != e1


# ---------------------------------------------------------------------------
# predicate, transform, fields
# ---------------------------------------------------------------------------

@pytest.mark.timeout(60)
def test_predicate_as_jax_and_streaming(tmp_path):
    """label == ts % 7: rejecting label 3 drills holes into the ts sequence
    that delta_threshold 1 then rejects."""
    url = _write(tmp_path / 'pred', list(range(40)))
    ngrams = _ngrams(2)
    fn = lambda v: v['label'] != 3  # noqa: E731
    got, loader = _stream_both(url, ngrams, batch_size=4, num_epochs=1,
                               shuffle=False,
                               predicate=(jin_lambda(['label'], fn),
                                          in_lambda(['label'], fn)))
    expected = _streaming_windows(url, _ngrams(2)[1],
                                  predicate=in_lambda(['label'], fn))
    assert 0 < len(expected) < 39
    assert loader.total_windows == len(expected)
    _assert_windows_match(_unbatched(got, loader), expected, 4)


@pytest.mark.timeout(60)
def test_predicate_survivor_windows_span_dropped_rows(tmp_path):
    """With a loose delta_threshold windows form across dropped rows."""
    url = _write(tmp_path / 'pred2', list(range(30)))
    ngrams = _ngrams(2, delta_threshold=10)
    fn = lambda v: v['label'] % 2 == 0  # noqa: E731
    got, loader = _stream_both(url, ngrams, batch_size=2, num_epochs=1,
                               shuffle=False,
                               predicate=(jin_lambda(['label'], fn),
                                          in_lambda(['label'], fn)))
    expected = _streaming_windows(url, _ngrams(2, delta_threshold=10)[1],
                                  predicate=in_lambda(['label'], fn))
    assert loader.total_windows == len(expected)
    _assert_windows_match(_unbatched(got, loader), expected, 2)


def _double_value(d):
    d = dict(d)
    d['value'] = d['value'] * 2
    return d


@pytest.mark.timeout(60)
def test_transform_as_jax_and_streaming(tmp_path):
    url = _write(tmp_path / 'tx', list(range(30)))
    got, loader = _stream_both(
        url, _ngrams(2), batch_size=4, num_epochs=1, shuffle=False,
        transform_spec=(JTransformSpec(_double_value,
                                       removed_fields=['label']),
                        TransformSpec(_double_value,
                                      removed_fields=['label'])))
    assert 'label' not in got[0][0]
    expected = _streaming_windows(url, _ngrams(2)[1], transform_spec=(
        TransformSpec(_double_value, removed_fields=['label'])))
    assert float(expected[0][0]['value'][0]) == 2 * float(
        expected[0][0]['ts'])
    _assert_windows_match(_unbatched(got, loader), expected, 4)


@pytest.mark.timeout(60)
def test_predicate_and_transform_resume_exact(tmp_path):
    url = _write(tmp_path / 'ptx', list(range(40)))
    fn = lambda v: v['label'] != 0  # noqa: E731
    tx = lambda d: dict(d, value=d['value'] + 1)  # noqa: E731
    kw = dict(batch_size=4, num_epochs=2, seed=5, shuffle=True,
              predicate=(jin_lambda(['label'], fn), in_lambda(['label'], fn)),
              transform_spec=(JTransformSpec(tx), TransformSpec(tx)))
    batches, _ = _stream_both(url, _ngrams(2), **kw)
    _, resumed = _both(url, _ngrams(2), **kw)
    resumed.load_state_dict({'epoch': 3 // resumed.batches_per_epoch,
                             'batch': 3 % resumed.batches_per_epoch,
                             'version': 1})
    _same_batches(list(resumed), batches[3:])


@pytest.mark.timeout(60)
def test_gap_threshold_as_jax(tmp_path):
    """Timestamps with gaps of 1, 2 and 5 under thresholds 1, 2 and 5."""
    ts = [0, 1, 2, 4, 6, 7, 12, 13, 14, 19, 24, 25, 26, 27, 30, 35, 36, 37,
          38, 40]
    url = _write(tmp_path / 'gaps', ts)
    for threshold in (1, 2, 5):
        got, loader = _stream_both(url, _ngrams(3, delta_threshold=threshold),
                                   batch_size=1, num_epochs=1, seed=2)
        for batch in got:
            steps = np.diff([int(batch[o]['ts'][0]) for o in (0, 1, 2)])
            assert np.all((steps > 0) & (steps <= threshold))


@pytest.mark.timeout(60)
def test_reader_narrowed_to_ngram_fields(tmp_path):
    url = _write(tmp_path / 'narrow', list(range(20)))
    got, loader = _stream_both(
        url, _ngrams(fields={0: ['ts', 'label'], 1: ['label']}),
        batch_size=4, num_epochs=1, shuffle=False)
    assert set(loader._read_fields) == {'ts', 'label'}
    assert set(loader._dataset.schema.fields) == {'ts', 'label', 'value'}
    assert set(got[0][0].keys()) == {'ts', 'label'}
    assert set(got[0][1].keys()) == {'label'}


@pytest.mark.timeout(60)
def test_fields_at_few_offsets_are_copied_out(tmp_path):
    """``value`` at offset 0 only of a 3-long window is a copy, not a view
    of the fused gather; ``ts`` at every offset is a view."""
    url = _write(tmp_path / 'copy', list(range(30)))
    got, loader = _stream_both(
        url, _ngrams(fields={0: ['ts', 'value'], 1: ['ts'], 2: ['ts']}),
        batch_size=4, num_epochs=1, seed=0)
    jl, _ = _both(url, _ngrams(fields={0: ['ts', 'value'], 1: ['ts'],
                                       2: ['ts']}),
                  batch_size=4, num_epochs=1, seed=0)
    assert loader._copy_fields == jl._copy_fields == {'value'}
    batch = got[0]
    assert batch[0]['value'].base is None
    assert batch[1]['ts'].base is not None


@pytest.mark.timeout(60)
def test_too_few_windows_raises_jax_words(tmp_path):
    url = _write(tmp_path / 'tiny', list(range(5)), rows_per_file=5)
    with pytest.raises(NoDataAvailableError) as terr:
        make_indexed_ngram_loader(url, _ngrams(3)[1], batch_size=16)
    with pytest.raises(Exception) as jerr:
        jmake_loader(url, _ngrams(3)[0], batch_size=16)
    assert str(terr.value) == str(jerr.value)


def test_pad_spec_refused_with_jax_words(tmp_path):
    from petastorm_tpu.indexed import IndexedDatasetReader as JReader
    from petastorm_tpu.indexed_ngram import IndexedNGramLoader as JLoader
    from petastorm_tpu_torch.indexed import IndexedDatasetReader
    from petastorm_tpu_torch.indexed_ngram import IndexedNGramLoader
    url = _write(tmp_path / 'pad', list(range(20)))
    jngram, ngram = _ngrams(2)
    with pytest.raises(ValueError) as terr:
        IndexedNGramLoader(IndexedDatasetReader(url), ngram, 4,
                           pad_spec={'value': {'max_len': 4}})
    with pytest.raises(ValueError) as jerr:
        JLoader(JReader(url), jngram, 4, pad_spec={'value': {'max_len': 4}})
    assert str(terr.value) == str(jerr.value)


def test_mesh_raises_not_implemented(tmp_path):
    """``mesh=`` is ported (the sharded loader): what still raises is a
    global batch that the mesh's ``data`` axis does not divide, in JAX's
    words (``tests/test_torch_sharded_indexed.py`` holds the sharded
    batches against JAX's)."""
    import types

    from petastorm_tpu_torch.indexed_ngram import ShardedIndexedNGramLoader
    url = _write(tmp_path / 'mesh', list(range(20)))
    mesh = types.SimpleNamespace(mesh_dim_names=('data',), shape=(3,),
                                 device_type='cpu',
                                 get_local_rank=lambda axis: 0)
    with pytest.raises(ValueError, match="over the 3 devices of mesh axis "
                                         "'data'"):
        make_indexed_ngram_loader(url, _ngrams(2)[1], batch_size=4,
                                  mesh=mesh)
    mesh.shape = (1,)
    loader = make_indexed_ngram_loader(url, _ngrams(2)[1], batch_size=4,
                                       mesh=mesh)
    assert isinstance(loader, ShardedIndexedNGramLoader)
    loader.close()


# ---------------------------------------------------------------------------
# the slice as a whole: the LM fed by either package's loader, and resumed
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_lm_steps_from_both_loaders_and_a_resume(tmp_path):
    """A small float32 LM (params from the JAX init) takes 4 AdamW steps fed
    by JAX's loader and by the port's: equal batches, losses within 1e-5.
    Then the port's run stopped after 2 steps and restored (params,
    optimizer state, loader cursor through JSON) gives the same last 2
    losses (1e-5)."""
    import copy
    import json

    import jax
    import jax.numpy as jnp
    import torch

    from petastorm_tpu.models import transformer_lm as jtlm
    from petastorm_tpu_torch.models import transformer_lm as ttlm
    from petastorm_tpu_torch.weights import params_from_jax

    schema = JUnischema('Tok', [
        JField('ts', np.int64, (), JScalarCodec(), False),
        JField('tokens', np.int32, (8,), JNdarrayCodec(), False)])
    url = 'file://' + str(tmp_path / 'tok')
    rng = np.random.default_rng(0)
    with jmaterialize(url, schema, rows_per_file=16) as w:
        w.write_rows({'ts': np.int64(i),
                      'tokens': rng.integers(0, 64, 8, dtype=np.int32)}
                     for i in range(48))
    fields = {0: ['ts', 'tokens'], 1: ['tokens']}
    jngram = JNGram(dict(fields), delta_threshold=1, timestamp_field='ts')
    ngram = NGram(dict(fields), delta_threshold=1, timestamp_field='ts')
    base = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                max_seq_len=16, attention='flash')
    jcfg = jtlm.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = ttlm.TransformerConfig(dtype=torch.float32, **base)
    jparams = jtlm.init(jax.random.PRNGKey(0), jcfg)
    kw = dict(batch_size=4, num_epochs=2, seed=3, workers_count=2)

    def seq(batch):
        return np.concatenate([np.asarray(batch[0]['tokens']),
                               np.asarray(batch[1]['tokens'])], axis=1)

    optimizer, jstep = jtlm.make_train_step(jcfg)
    opt_state = optimizer.init(jparams)
    params, jax_losses, jax_seqs = jparams, [], []
    for batch in jmake_loader(url, jngram, **kw):
        s = seq(batch)
        jax_seqs.append(s)
        params, opt_state, loss = jstep(params, opt_state,
                                        jnp.asarray(s[:, :-1]),
                                        jnp.asarray(s[:, 1:]))
        jax_losses.append(float(loss))
        if len(jax_losses) == 4:
            break

    def port_run(steps, loader, tparams, optimizer_state=None):
        optimizer, step = ttlm.make_train_step(tcfg, tparams)
        if optimizer_state is not None:
            optimizer.load_state_dict(optimizer_state)
        losses, seqs, it = [], [], iter(loader)
        for _ in range(steps):
            s = seq(next(it))
            seqs.append(s)
            t = torch.from_numpy(s).long()
            losses.append(float(step(t[:, :-1], t[:, 1:])))
        state = loader.state_dict()
        it.close()
        return losses, seqs, optimizer, state

    def fresh_params():
        return params_from_jax(jax.device_get(jparams), tcfg, device='cpu')

    losses, seqs, _, _ = port_run(
        4, make_indexed_ngram_loader(url, ngram, **kw), fresh_params())
    for got, want in zip(seqs, jax_seqs):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)

    tparams = fresh_params()
    first, _, optimizer, state = port_run(
        2, make_indexed_ngram_loader(url, ngram, **kw), tparams)
    saved = {'params': copy.deepcopy(tparams),
             'optimizer': copy.deepcopy(optimizer.state_dict()),
             'loader': json.loads(json.dumps(state))}
    restored = make_indexed_ngram_loader(url, ngram, batch_size=4,
                                         num_epochs=2, seed=3,
                                         workers_count=1)
    restored.load_state_dict(saved['loader'])
    rest, rest_seqs, _, _ = port_run(2, restored, saved['params'],
                                     saved['optimizer'])
    for got, want in zip(rest_seqs, seqs[2:]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(first + rest, losses, rtol=1e-5)
