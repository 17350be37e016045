"""The port's TensorFlow adapter (``petastorm_tpu_torch/tf_utils.py``)
against the JAX package's (``petastorm_tpu/tf_utils.py``), on the CPU.

Every case of ``tests/test_tf_dataset.py`` runs both packages' adapter
over the same store, each reading it with its own reader on the dummy pool
unshuffled, and holds the elements equal (values, dtypes and static
shapes), the graph-mode ``tf_tensors`` (rows, a shuffling queue, NGram
windows, the batched-reader refusal in JAX's words) included.
TensorFlow is on this host only: the file skips where it is missing.
"""

import numpy as np
import pytest

tf = pytest.importorskip('tensorflow')

from petastorm_tpu import tf_utils as jtf  # noqa: E402
from petastorm_tpu.reader import make_batch_reader as jmake_batch_reader  # noqa: E402
from petastorm_tpu.reader import make_reader as jmake_reader  # noqa: E402

from petastorm_tpu_torch import tf_utils as ttf  # noqa: E402
from petastorm_tpu_torch.reader import (make_batch_reader,  # noqa: E402
                                        make_reader)

FACTORIES = {'row': (jmake_reader, make_reader),
             'batch': (jmake_batch_reader, make_batch_reader)}


def _leaves(element, prefix=()):
    """``{path: numpy}`` of a dataset element: a namedtuple, or dicts of
    them (or of tensors) by offset."""
    if hasattr(element, '_asdict'):
        element = element._asdict()
    if isinstance(element, dict):
        out = {}
        for k, v in element.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(element.numpy() if hasattr(element, 'numpy')
                               else element)}


def assert_elements_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _leaves(g), _leaves(w)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def both_datasets(url, kind='row', transform=None, **reader_kw):
    """Each package's dataset over ``url``, as lists of elements, and the
    two ``element_spec``s."""
    kw = dict(reader_pool_type='dummy', num_epochs=1,
              shuffle_row_groups=False, **reader_kw)
    out = []
    for pkg, factory in ((jtf, FACTORIES[kind][0]), (ttf, FACTORIES[kind][1])):
        with factory(url, **kw) as reader:
            dataset = pkg.make_petastorm_dataset(reader)
            if transform is not None:
                dataset = transform(dataset)
            out.append((list(dataset), dataset.element_spec))
    (want, want_spec), (got, got_spec) = out
    return got, want, got_spec, want_spec


# -- TestRowDataset -------------------------------------------------------------

def test_values_roundtrip_as_jax(synthetic_dataset):
    got, want, _, _ = both_datasets(
        synthetic_dataset.url,
        schema_fields=['id', 'matrix', 'partition_key', 'matrix_uint16',
                       'id_odd', 'sensor_name'])
    assert_elements_equal(got, want)
    by_id = {r['id']: r for r in synthetic_dataset.data}
    assert len(got) == len(by_id)
    for row in got:
        rid = int(row.id.numpy())
        np.testing.assert_array_equal(row.matrix.numpy(),
                                      by_id[rid]['matrix'])
        assert (row.partition_key.numpy().decode()
                == by_id[rid]['partition_key'])


def test_static_shapes_as_jax(synthetic_dataset):
    _, _, got, want = both_datasets(synthetic_dataset.url,
                                    schema_fields=['id', 'matrix'])
    assert tuple(got.matrix.shape) == (8, 4, 3)
    assert got == want


def test_batch_pipeline_as_jax(synthetic_dataset):
    got, want, _, _ = both_datasets(synthetic_dataset.url,
                                    transform=lambda d: d.batch(10),
                                    schema_fields=['id'])
    assert_elements_equal(got, want)
    ids = [int(i) for b in got for i in b.id.numpy()]
    assert sorted(ids) == sorted(r['id'] for r in synthetic_dataset.data)


# -- TestBatchDataset -----------------------------------------------------------

def test_batched_reader_as_jax(scalar_dataset):
    got, want, got_spec, want_spec = both_datasets(
        scalar_dataset.url, 'batch', schema_fields=['^id$', 'float64'])
    assert_elements_equal(got, want)
    assert got_spec == want_spec
    ids = [int(i) for b in got for i in b.id.numpy()]
    assert sorted(ids) == sorted(r['id'] for r in scalar_dataset.data)


def test_uint16_promotion_as_jax(synthetic_dataset):
    got, want, _, _ = both_datasets(synthetic_dataset.url,
                                    schema_fields=['id', 'matrix_uint16'])
    assert_elements_equal(got, want)
    assert got[0].matrix_uint16.dtype == tf.int32


def test_sanitize_field_values_as_jax():
    from decimal import Decimal
    values = [Decimal('1.25'), np.array([1, 2], np.uint16),
              np.array([3], np.uint32), np.datetime64('2024-01-01T01:00'),
              np.array(['a', 'bc'], object), np.float32(2.5)]
    for value in values:
        got = ttf._sanitize_field_tf_types(value)
        want = jtf._sanitize_field_tf_types(value)
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError) as got:
        ttf._sanitize_field_tf_types(None)
    with pytest.raises(RuntimeError) as want:
        jtf._sanitize_field_tf_types(None)
    assert str(got.value) == str(want.value)


# -- TestNgramDataset -----------------------------------------------------------

@pytest.fixture(scope='module')
def ngram_store(tmp_path_factory):
    from petastorm_tpu.test_util.dataset_gen import create_test_dataset
    url = 'file://' + str(tmp_path_factory.mktemp('ngram') / 'ds')
    create_test_dataset(url, range(30), num_files=2, row_group_size_mb=100)
    return url


def _ngrams(fields):
    from petastorm_tpu.ngram import NGram as JNGram

    from petastorm_tpu_torch.ngram import NGram
    return (JNGram(fields=dict(fields), delta_threshold=10,
                   timestamp_field='id'),
            NGram(fields=dict(fields), delta_threshold=10,
                  timestamp_field='id'))


def test_ngram_windows_as_jax(ngram_store):
    jngram, ngram = _ngrams({0: ['id', 'matrix'], 1: ['id']})
    kw = dict(reader_pool_type='dummy', num_epochs=1,
              shuffle_row_groups=False)
    with jmake_reader(ngram_store, schema_fields=jngram, **kw) as r:
        want = list(jtf.make_petastorm_dataset(r))
    with make_reader(ngram_store, schema_fields=ngram, **kw) as r:
        got = list(ttf.make_petastorm_dataset(r))
    assert got
    assert_elements_equal(got, want)
    for w in got:
        assert set(w.keys()) == {0, 1}
        assert int(w[1]['id'].numpy()) == int(w[0]['id'].numpy()) + 1


# -- TestTfTensorsGraphMode ----------------------------------------------------

def _session_rows(pkg, factory, url, n=None, **kw):
    """Rows of ``pkg.tf_tensors`` through a session: until the reader ends,
    or ``n``."""
    out = []
    with factory(url, reader_pool_type='dummy', shuffle_row_groups=False,
                 **kw) as reader:
        graph = tf.compat.v1.Graph()
        with graph.as_default():
            row = pkg.tf_tensors(reader)
            shapes = {k: v.shape.as_list() for k, v in row._asdict().items()}
            with tf.compat.v1.Session() as sess:
                try:
                    while n is None or len(out) < n:
                        out.append(sess.run(row))
                except tf.errors.OutOfRangeError:
                    pass
    return out, shapes


def test_rows_through_session_as_jax(synthetic_dataset):
    got, got_shapes = _session_rows(ttf, make_reader, synthetic_dataset.url,
                                    schema_fields=['id', 'matrix'])
    want, want_shapes = _session_rows(jtf, jmake_reader,
                                      synthetic_dataset.url,
                                      schema_fields=['id', 'matrix'])
    assert got_shapes == want_shapes
    assert got_shapes['matrix'] == [8, 4, 3]
    assert_elements_equal(got, want)
    assert {int(r.id) for r in got} == {r['id']
                                        for r in synthetic_dataset.data}


def test_value_exact_against_generator(synthetic_dataset):
    expected = {r['id']: r['matrix'] for r in synthetic_dataset.data}
    got, _ = _session_rows(ttf, make_reader, synthetic_dataset.url, n=1,
                           schema_fields=['id', 'matrix'])
    np.testing.assert_array_equal(got[0].matrix, expected[int(got[0].id)])


def test_shuffling_queue(synthetic_dataset):
    with make_reader(synthetic_dataset.url, schema_fields=['id'],
                     shuffle_row_groups=False, num_epochs=None,
                     reader_pool_type='dummy') as reader:
        graph = tf.compat.v1.Graph()
        with graph.as_default():
            row = ttf.tf_tensors(reader, shuffling_queue_capacity=30,
                                 min_after_dequeue=10)
            assert graph.get_tensor_by_name(
                'random_shuffling_queue_size:0') is not None
            with tf.compat.v1.Session() as sess:
                coord = tf.compat.v1.train.Coordinator()
                threads = tf.compat.v1.train.start_queue_runners(
                    sess=sess, coord=coord)
                ids = [int(sess.run(row).id) for _ in range(40)]
                coord.request_stop()
                coord.join(threads, stop_grace_period_secs=5,
                           ignore_live_threads=True)
    assert len(ids) == 40
    assert ids != sorted(ids)
    assert set(ids) <= {r['id'] for r in synthetic_dataset.data}


def test_batched_reader_refuses_queue_in_jax_words(scalar_dataset):
    with jmake_batch_reader(scalar_dataset.url,
                            reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError) as want:
            jtf.tf_tensors(reader, shuffling_queue_capacity=10)
    with make_batch_reader(scalar_dataset.url,
                           reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError,
                           match='shuffling_queue_capacity') as got:
            ttf.tf_tensors(reader, shuffling_queue_capacity=10)
    assert str(got.value) == str(want.value)


def test_ngram_windows_through_session_as_jax(tmp_path):
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import materialize_dataset
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('Seq', [
        UnischemaField('ts', np.int64, (), ScalarCodec(), False),
        UnischemaField('v', np.float32, (2,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path / 'seq')
    with materialize_dataset(url, schema, rows_per_file=100) as w:
        w.write_rows({'ts': np.int64(t), 'v': np.full(2, t, np.float32)}
                     for t in range(10))
    from petastorm_tpu.ngram import NGram as JNGram

    from petastorm_tpu_torch.ngram import NGram
    fields = {0: ['ts', 'v'], 1: ['ts', 'v']}
    out = []
    for pkg, factory, ngram in (
            (jtf, jmake_reader, JNGram(dict(fields), 1, 'ts')),
            (ttf, make_reader, NGram(dict(fields), 1, 'ts'))):
        with factory(url, schema_fields=ngram, shuffle_row_groups=False,
                     reader_pool_type='dummy') as reader:
            graph = tf.compat.v1.Graph()
            with graph.as_default():
                window = pkg.tf_tensors(reader)
                assert set(window.keys()) == {0, 1}
                with tf.compat.v1.Session() as sess:
                    out.append([sess.run(window) for _ in range(3)])
    want, got = out
    assert_elements_equal(got, want)
    assert int(got[0][1].ts) == int(got[0][0].ts) + 1
    np.testing.assert_array_equal(got[0][0].v,
                                  np.full(2, int(got[0][0].ts), np.float32))


# -- TestTfFunctionIntegration -------------------------------------------------

def test_dataset_reduces_under_tf_function(scalar_dataset, caplog):
    caplog.clear()
    with make_batch_reader(scalar_dataset.url, schema_fields=['id'],
                           reader_pool_type='dummy') as reader:
        ds = ttf.make_petastorm_dataset(reader)

        @tf.function
        def total(dataset):
            acc = tf.constant(0, tf.int64)
            for batch in dataset:
                acc += tf.reduce_sum(batch.id)
            return acc

        result = int(total(ds))
    assert result == sum(r['id'] for r in scalar_dataset.data)
    assert 'AutoGraph could not transform' not in ' '.join(caplog.messages)


def test_converter_tf_dataset_under_tf_function(tmp_path, caplog):
    import pyarrow as pa

    from petastorm_tpu_torch.converter import make_dataset_converter
    caplog.clear()
    saved = make_dataset_converter(
        pa.table({'x': np.arange(100, dtype=np.int64)}),
        parent_cache_dir_url='file://' + str(tmp_path / 'cache'),
        delete_at_exit=False)
    with saved.make_tf_dataset(num_epochs=1) as ds:

        @tf.function
        def count(dataset):
            n = tf.constant(0, tf.int64)
            for batch in dataset:
                n += tf.cast(tf.size(batch.x), tf.int64)
            return n

        assert int(count(ds)) == 100
    assert 'AutoGraph could not transform' not in ' '.join(caplog.messages)
