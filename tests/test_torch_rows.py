"""The port's row line against the JAX package on the same stores.

Row-granular ``make_reader`` (a field list, regexes or every field) must
yield JAX's rows, keyed by ``idx``; ``TorchDataLoader``'s row path must
batch them as ``JaxDataLoader`` does; the row shuffling buffers must draw
JAX's order from the same seed; and the MNIST MLP's forward and SGD step
must agree with JAX's within 1e-5 (float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petastorm_tpu
from examples.mnist.main import (MnistSchema as JMnistSchema,
                                 generate_synthetic_mnist as jgenerate)
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.models import mnist_mlp as jmlp
from petastorm_tpu.readers import shuffling_buffer as jbuffers

import petastorm_tpu_torch
from petastorm_tpu_torch import TorchDataLoader, make_reader
from petastorm_tpu_torch.examples.mnist.main import (
    MnistSchema, generate_synthetic_mnist as tgenerate, train as ttrain)
from petastorm_tpu_torch.models import mnist_mlp as tmlp
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch import reader as treader
from petastorm_tpu_torch.reader import make_batch_reader
from petastorm_tpu_torch.readers import shuffling_buffer as tbuffers
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.weights import mnist_params_from_jax

ROWS = 200


def _store(tmp_path, writer='jax'):
    url = 'file://' + str(tmp_path / 'mnist')
    (jgenerate if writer == 'jax' else tgenerate)(url, n=ROWS, seed=3)
    return url


def _rows_by_idx(rows):
    out = {}
    for r in rows:
        d = r._asdict()
        assert int(d['idx']) not in out, 'row %d read twice' % d['idx']
        out[int(d['idx'])] = d
    return out


def test_schemas_agree():
    assert MnistSchema.to_json() == JMnistSchema.to_json()


@pytest.mark.parametrize('writer', ['jax', 'torch'])
@pytest.mark.parametrize('fields', [None, ['idx', 'image'], ['i.*', 'dig.*']])
def test_row_reader_matches_jax(tmp_path, writer, fields):
    url = _store(tmp_path, writer)
    with petastorm_tpu.make_reader(url, schema_fields=fields,
                                   workers_count=2) as reader:
        ref = _rows_by_idx(reader)
    with make_reader(url, schema_fields=fields, workers_count=3) as reader:
        assert not reader.batched_output and reader.ngram is None
        got = _rows_by_idx(reader)
    assert sorted(got) == sorted(ref) == list(range(ROWS))
    for i in got:
        assert sorted(got[i]) == sorted(ref[i])
        for k in got[i]:
            np.testing.assert_array_equal(got[i][k], ref[i][k])
            assert np.asarray(got[i][k]).dtype == np.asarray(ref[i][k]).dtype


def test_row_reader_epochs_and_seeded_order(tmp_path):
    from petastorm_tpu_torch import materialize_dataset
    url = 'file://' + str(tmp_path / 'mnist')
    with materialize_dataset(url, MnistSchema, rows_per_file=25) as w:
        w.write_rows({'idx': np.int64(i), 'digit': np.int64(i % 10),
                      'image': np.full((28, 28), i % 256, np.uint8)}
                     for i in range(ROWS))

    def order(seed):
        with make_reader(url, num_epochs=2, workers_count=1,
                         seed=seed) as reader:
            return [int(r.idx) for r in reader]

    a = order(7)
    assert a == order(7) and sorted(a) == sorted(list(range(ROWS)) * 2)
    assert order(8) != a


def _batches(package, url, **kw):
    if package == 'jax':
        with petastorm_tpu.make_reader(url, workers_count=1,
                                       shuffle_row_groups=False) as reader:
            return [{k: np.asarray(v) for k, v in b.items()
                     if not k.startswith('_')}
                    for b in JaxDataLoader(reader, batch_size=32, **kw)]
    with make_reader(url, workers_count=1, shuffle_row_groups=False) as reader:
        out = []
        for b in TorchDataLoader(reader, batch_size=32, device='cpu', **kw):
            assert b['image'].dtype == torch.uint8
            assert b['digit'].dtype == torch.int64
            out.append({k: v.numpy() for k, v in b.items()
                        if not k.startswith('_')})
        return out


@pytest.mark.parametrize('kw', [{}, {'drop_last': True},
                                {'shuffling_queue_capacity': 64, 'seed': 1}])
def test_row_loader_matches_jax(tmp_path, kw):
    """Batch sizes as JAX's; the rows, keyed by idx, as JAX's."""
    url = _store(tmp_path)
    ref = _batches('jax', url, **kw)
    got = _batches('torch', url, **kw)
    assert [len(b['idx']) for b in got] == [len(b['idx']) for b in ref]
    expect = ROWS - ROWS % 32 if kw.get('drop_last') else ROWS
    assert sum(len(b['idx']) for b in got) == expect

    def keyed(batches):
        return {int(i): (b['image'][j], int(b['digit'][j]))
                for b in batches for j, i in enumerate(b['idx'])}

    g, r = keyed(got), keyed(ref)
    if not kw.get('drop_last'):
        assert sorted(g) == sorted(r)
    with petastorm_tpu.make_reader(url, workers_count=1) as reader:
        table = _rows_by_idx(reader)
    for i in g:
        np.testing.assert_array_equal(g[i][0], table[i]['image'])
        assert g[i][1] == int(table[i]['digit'])


def test_row_shuffling_buffer_draws_jax_order():
    items = list(range(100))
    got, ref = [], []
    for mod, out in ((tbuffers, got), (jbuffers, ref)):
        buf = mod.RandomShufflingBuffer(30, min_after_retrieve=10, seed=4)
        it = iter(items)
        for x in it:
            buf.add_many([x])
            while buf.can_retrieve() and not buf.can_add():
                out.append(buf.retrieve())
        buf.finish()
        while buf.can_retrieve():
            out.append(buf.retrieve())
    assert got == ref and sorted(got) == items
    noop = tbuffers.NoopShufflingBuffer()
    noop.add_many([1, 2, 3])
    assert [noop.retrieve() for _ in range(3)] == [1, 2, 3]


def test_unported_row_options_raise(tmp_path):
    """An unknown option raises; decode hints and NGram under a row
    predicate or a transform read, as in JAX."""
    url = _store(tmp_path, 'torch')
    # a hint on a codec without a scaled decode fails when the reader is
    # made; make_batch_reader takes no decode_hints (as JAX's)
    with pytest.raises(ValueError, match='has no decode_scaled'):
        make_reader(url, decode_hints={'image': {'scale': 2}})
    with pytest.raises(TypeError, match='decode_hints'):
        make_batch_reader(url, decode_hints={'image': {'scale': 2}})
    # every option of the JAX factories is ported (shard_by_jax_process
    # came with data and sequence parallelism): an unknown one is a
    # TypeError
    assert treader._UNPORTED == {}
    with pytest.raises(TypeError, match='no_such_option'):
        make_reader(url, no_such_option=1)
    with make_reader(url, schema_fields=NGram({0: ['idx']}, 1, 'idx'),
                     predicate=in_lambda(['digit'], lambda v: v['digit'] < 5),
                     workers_count=1) as reader:
        assert not reader.ngram_chunked
        windows = list(reader)
    with petastorm_tpu.make_reader(url, workers_count=1) as reader:
        want = sorted(int(r.idx) for r in reader if r.digit < 5)
    assert sorted(int(w[0].idx) for w in windows) == want
    with make_reader(url, schema_fields=NGram({0: ['idx']}, 1, 'idx'),
                     transform_spec=TransformSpec(),
                     workers_count=1) as reader:
        assert len(list(reader)) == ROWS
    with pytest.raises(ValueError, match='make_batch_reader'):
        make_reader([url + '/part_00000.parquet'])
    with make_reader(url, schema_fields=NGram({0: ['idx']}, 1, 'idx'),
                     workers_count=1) as reader:
        with pytest.raises(TypeError, match='iter_ngram_chunks'):
            next(reader)
    with make_reader(url, workers_count=1) as reader:
        with pytest.raises(TypeError, match='NGram'):
            next(reader.iter_ngram_chunks())


def test_read_only_columns_are_copied():
    """A scalar column decodes as a zero-copy, read-only view of arrow's
    buffer; the loader's tensor must not alias it."""
    import pyarrow as pa
    from petastorm_tpu_torch.torch_utils import _to_tensor
    col = pa.array(np.arange(4, dtype=np.int64)).to_numpy()
    assert not col.flags.writeable
    t = _to_tensor(col, False)
    t[0] = 7
    assert int(col[0]) == 0


def _cells_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_nullable_codec_cells_decode_as_jax(tmp_path):
    """JAX's ``create_test_dataset`` store: its nullable ``NdarrayCodec``
    fields hold ``None`` cells (11 of 32 in ``matrix_nullable``), which the
    port's row and columnar readers decode cell by cell, ``None`` where JAX
    has ``None``."""
    from petastorm_tpu.test_util.dataset_gen import create_test_dataset
    url = 'file://' + str(tmp_path / 'nullable')
    create_test_dataset(url, range(32), num_files=2)
    fields = ['id', 'matrix_nullable', 'string_array_nullable']
    rows, cols = {}, {}
    for name, pkg in (('jax', petastorm_tpu),
                      ('torch', petastorm_tpu_torch)):
        with pkg.make_reader(url, schema_fields=fields, workers_count=1,
                             shuffle_row_groups=False) as reader:
            rows[name] = {int(r.id): (r.matrix_nullable,
                                      r.string_array_nullable)
                          for r in reader}
        with pkg.make_columnar_reader(url, schema_fields=fields,
                                      workers_count=1,
                                      shuffle_row_groups=False) as reader:
            cols[name] = {int(i): (m, s) for batch in reader
                          for i, m, s in zip(batch.id, batch.matrix_nullable,
                                             batch.string_array_nullable)}
    for out in (rows, cols):
        assert sorted(out['torch']) == sorted(out['jax']) == list(range(32))
        for i, cells in out['jax'].items():
            assert all(_cells_equal(a, b)
                       for a, b in zip(cells, out['torch'][i])), i
    assert sum(c[0] is None for c in rows['torch'].values()) == 11
    assert sum(c[0] is None for c in cols['torch'].values()) == 11
    assert any(c[1] is None for c in cols['torch'].values())


# ---------------------------------------------------------------------------
# MNIST MLP
# ---------------------------------------------------------------------------

def _mlp_setup(seed):
    jp = jmlp.init(jax.random.PRNGKey(seed))
    tp = mnist_params_from_jax(jax.device_get(jp), device='cpu')
    rng = np.random.default_rng(seed)
    images = rng.random((16, 784), dtype=np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    return jp, tp, images, labels


def test_mlp_forward_matches():
    jp, tp, images, _ = _mlp_setup(0)
    ref = np.asarray(jmlp.forward(jp, jnp.asarray(images)))
    got = tmlp.forward(tp, torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)


def test_mlp_train_step_matches():
    jp, tp, images, labels = _mlp_setup(1)
    jp2, jloss = jmlp.train_step(jp, jnp.asarray(images), jnp.asarray(labels),
                                 5e-2)
    loss = tmlp.train_step(tp, torch.from_numpy(images),
                           torch.from_numpy(labels), 5e-2)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    for k in ('w1', 'b1', 'w2', 'b2'):
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp2[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    acc = tmlp.accuracy(tp, torch.from_numpy(images), torch.from_numpy(labels))
    ref = jmlp.accuracy(jp2, jnp.asarray(images), jnp.asarray(labels))
    assert float(acc) == pytest.approx(float(ref))


def test_mlp_params_loader_checks_leaves():
    jp = jax.device_get(jmlp.init(jax.random.PRNGKey(0), hidden=8))
    with pytest.raises(ValueError, match='leaves'):
        mnist_params_from_jax(dict(jp, extra=np.zeros(1)), device='cpu')
    own = tmlp.init(torch.Generator().manual_seed(0), hidden=8, device='cpu')
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}


def test_mnist_example_trains_on_cpu(tmp_path):
    """The example's ``train`` over one epoch of the row line: the loss
    falls and stays finite."""
    url = 'file://' + str(tmp_path / 'mnist')
    tgenerate(url, n=512, seed=0)
    _, losses, _ = ttrain(url, epochs=1, device='cpu', log=lambda _: None)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
