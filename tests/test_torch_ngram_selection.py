"""NGram windows under selection: the port against the JAX package.

A store written by the JAX package holds 107 steps of 120 (every step with
``step % 9 == 4`` missing) in rows shuffled within blocks of 10, so the
timestamp sort and ``delta_threshold`` both matter, over four files of
several row groups. Two NGrams (consecutive offsets, and gapped offsets
-1 and +1) at ``delta_threshold`` 1 and 2 read it under a row predicate, a
residual filter, a row transform, row-drop partitions of 2 and 3, shard 0
of 2 and combinations. The windows, in order (one worker, row groups
unshuffled), and each timestep's values must equal JAX's exactly, as must
``ngram_chunked``; ``TorchDataLoader``'s batches must equal
``JaxDataLoader``'s.
"""

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.predicates import in_pseudorandom_split as jsplit
from petastorm_tpu.transform import TransformSpec as JTransformSpec
from petastorm_tpu.unischema import Unischema, UnischemaField

import petastorm_tpu_torch
from petastorm_tpu_torch import TorchDataLoader
from petastorm_tpu_torch.ngram import NGram as TNGram
from petastorm_tpu_torch.predicates import in_pseudorandom_split as tsplit
from petastorm_tpu_torch.transform import TransformSpec as TTransformSpec

SCHEMA = Unischema('SeqSchema', [
    UnischemaField('step', np.int64, (), ScalarCodec(), False),
    UnischemaField('tokens', np.int32, (4,), NdarrayCodec(), False),
    UnischemaField('name', str, (), ScalarCodec(), False),
])
NGRAMS = {
    'consecutive': {0: ['step', 'tokens'], 1: ['tokens']},
    'gapped': {-1: ['step'], 1: ['step', 'name']},
}


def _double_tokens(row):
    if 'tokens' in row:
        row['tokens'] = row['tokens'] * 2
    return row


CASES = {   # name: (reader keywords, chunked)
    'predicate': ({'predicate': 'split'}, False),
    'filters': ({'filters': [('step', '<', 90)]}, False),
    'transform': ({'transform': True}, False),
    'drop2': ({'shuffle_row_drop_partitions': 2}, True),
    'drop3': ({'shuffle_row_drop_partitions': 3}, True),
    'shard': ({'cur_shard': 0, 'shard_count': 2}, True),
    'predicate_drop2': ({'predicate': 'split',
                         'shuffle_row_drop_partitions': 2}, False),
    'filters_shard': ({'filters': [('step', '>=', 20)], 'cur_shard': 0,
                       'shard_count': 2}, False),
    'transform_drop3': ({'transform': True,
                         'shuffle_row_drop_partitions': 3}, False),
    'predicate_filters': ({'filters': [('step', '<', 1000)],
                           'predicate': 'split'}, False),
}


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('ngram_sel') / 'seq')
    rng = np.random.default_rng(11)
    steps = np.array([s for s in range(120) if s % 9 != 4])
    order = np.concatenate([rng.permutation(steps[i:i + 10])
                            for i in range(0, len(steps), 10)])
    tokens = rng.integers(0, 1000, (len(steps), 4)).astype(np.int32)
    with petastorm_tpu.materialize_dataset(url, SCHEMA, rows_per_file=30,
                                           row_group_size_mb=0.002) as w:
        w.write_rows({'step': np.int64(s), 'tokens': tokens[i],
                      'name': 'n%03d' % s} for i, s in enumerate(order))
    return url


def _kwargs(case, package):
    kw, _ = CASES[case]
    kw = dict(kw)
    jax_side = package is petastorm_tpu
    if kw.pop('predicate', None):
        kw['predicate'] = (jsplit if jax_side else tsplit)(
            [0.6, 0.4], 0, 'step')
    if kw.pop('transform', None):
        kw['transform_spec'] = (JTransformSpec if jax_side
                                else TTransformSpec)(_double_tokens)
    return kw


def _value(v):
    return tuple(np.asarray(v).ravel().tolist()) if np.ndim(v) else v


def _window_key(window):
    """A window (``{offset: {field: value}}``) as a hashable key."""
    return tuple((off, tuple(sorted((k, _value(v))
                                    for k, v in window[off].items())))
                 for off in sorted(window))


def _windows(package, url, ngram, case):
    """``(ngram_chunked, [window key, ...])`` of one pass in read order."""
    keys = []
    with package.make_reader(url, schema_fields=ngram, workers_count=1,
                             shuffle_row_groups=False,
                             **_kwargs(case, package)) as reader:
        chunked = reader.ngram_chunked
        if chunked:
            offsets, base, fields_at = ngram.timestep_layout(
                reader.schema.fields)
            for chunk in reader.iter_ngram_chunks():
                for start in chunk.starts:
                    keys.append(_window_key({
                        off: {n: chunk.columns[n][start + off - base]
                              for n in fields_at[off]} for off in offsets}))
        else:
            for window in reader:
                keys.append(_window_key(
                    {off: nt._asdict() for off, nt in window.items()}))
    return chunked, keys


@pytest.mark.parametrize('delta', [1, 2])
@pytest.mark.parametrize('ngram', sorted(NGRAMS))
@pytest.mark.parametrize('case', sorted(CASES))
def test_windows_equal_jax(store, case, ngram, delta):
    fields = NGRAMS[ngram]
    ref_chunked, ref = _windows(petastorm_tpu, store,
                                JNGram(fields, delta, 'step'), case)
    got_chunked, got = _windows(petastorm_tpu_torch, store,
                                TNGram(fields, delta, 'step'), case)
    assert got_chunked == ref_chunked == CASES[case][1]
    assert sorted(got) == sorted(ref) and ref
    assert got == ref                     # and in JAX's order
    if not CASES[case][0].get('shuffle_row_drop_partitions'):
        assert len(set(got)) == len(got), 'a window read twice'


def test_no_overlap_with_row_drop_raises_as_jax(store):
    for package, ngram in ((petastorm_tpu, JNGram), (petastorm_tpu_torch,
                                                     TNGram)):
        with pytest.raises(NotImplementedError, match='timestamp_overlap'):
            package.make_reader(store, schema_fields=ngram(
                NGRAMS['consecutive'], 1, 'step', timestamp_overlap=False),
                shuffle_row_drop_partitions=2)


@pytest.mark.parametrize('case', ['predicate', 'drop3', 'transform_drop3'])
def test_loader_batches_equal_jax(store, case):
    """One worker, no shuffle: the same batches, in order, as
    ``{offset: {field: (B, ...)}}``."""
    fields = NGRAMS['consecutive']
    out = []
    for package, ngram in ((petastorm_tpu, JNGram),
                           (petastorm_tpu_torch, TNGram)):
        with package.make_reader(store, schema_fields=ngram(fields, 2,
                                                            'step'),
                                 workers_count=1, shuffle_row_groups=False,
                                 **_kwargs(case, package)) as reader:
            if package is petastorm_tpu:
                loader = JaxDataLoader(reader, batch_size=5)
            else:
                loader = TorchDataLoader(reader, batch_size=5, device='cpu')
            out.append([{off: {k: np.asarray(v) for k, v in cols.items()}
                         for off, cols in b.items()} for b in loader])
    ref, got = out
    assert len(got) == len(ref) > 3
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r) == [0, 1]
        for off in r:
            assert sorted(g[off]) == sorted(r[off])
            for name in r[off]:
                np.testing.assert_array_equal(g[off][name], r[off][name])
                assert g[off][name].dtype == r[off][name].dtype


@pytest.mark.parametrize('overlap', [True, False])
@pytest.mark.parametrize('delta', [1, 2])
def test_form_ngram_matches_jax(overlap, delta):
    """The row path on its own, on rows out of timestamp order with ties
    and gaps: the same ``{offset: namedtuple}`` windows as JAX's, in
    order."""
    from petastorm_tpu_torch.unischema import Unischema as TUnischema
    from petastorm_tpu_torch.unischema import UnischemaField as TField
    rng = np.random.default_rng(delta)
    steps = rng.permutation([0, 1, 1, 2, 4, 5, 6, 9, 10, 11, 12, 14, 15])
    rows = [{'step': np.int64(s), 'tokens': rng.integers(0, 9, 4),
             'name': 'r%d' % i} for i, s in enumerate(steps)]
    tschema = TUnischema('SeqSchema', [
        TField('step', np.int64, (), None, False),
        TField('tokens', np.int64, (4,), None, False),
        TField('name', str, (), None, False)])
    out = []
    for ngram, schema in ((JNGram, SCHEMA), (TNGram, tschema)):
        ng = ngram({-1: ['step', 'name'], 1: ['tokens']}, delta, 'step',
                   timestamp_overlap=overlap)
        ng.resolve_regex_field_names(schema)
        out.append([_window_key({off: nt._asdict()
                                 for off, nt in w.items()})
                    for w in ng.form_ngram([dict(r) for r in rows], schema)])
    assert out[1] == out[0] and out[0]
