"""The port's process and dummy pools against its thread pool and the JAX
package's process pool, on the CPU.

The three factories read one store under ``'process'``, ``'dummy'`` and
``'thread'`` (NGram included) and give the same rows as the JAX package's
``'process'`` pool (exactly, in any order). Also: a worker's exception
reaches the consumer with its traceback; ``stop()``/``join()`` leave no
child and no pool thread; arrays arrive read-only under
``zmq_copy_buffers=True`` and as writable frame views under ``False``, as
in JAX, and the loader copies the read-only ones; a raw grid crosses as
one out-of-band
frame; a worker interpreter holds no ``torch``, ``jax`` or
``petastorm_tpu`` module. Tests that start interpreters carry a
``timeout`` mark.
"""

import functools
import logging
import operator
import sys
import threading
import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

import petastorm_tpu
from petastorm_tpu.ngram import NGram as JNGram

from petastorm_tpu_torch import (TorchDataLoader, make_batch_reader,
                                 make_columnar_reader, make_reader,
                                 materialize_dataset)
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
from petastorm_tpu_torch.readers.columnar_worker import load_columnar
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.process_pool import ProcessPool
from petastorm_tpu_torch.workers.serializers import ZeroCopySerializer
from petastorm_tpu_torch.workers.thread_pool import EmptyResultError

ROWS, SEQ = 48, 2049    # 8-row groups: raw grids of 66,592 bytes


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('pools') / 'tok')
    schema = Unischema('Tok', [
        UnischemaField('step', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (SEQ,), NdarrayCodec(), False)])
    tokens = np.random.default_rng(2).integers(0, 30000, (ROWS, SEQ),
                                               dtype=np.int32)
    with materialize_dataset(url, schema, row_group_size_mb=0.064) as w:
        w.write_rows({'step': np.int64(i), 'tokens': tokens[i]}
                     for i in range(ROWS))
    return url, tokens


def _rows(package, factory, url, pool):
    """Every delivered row of one pass as ``(step, tokens bytes)``,
    sorted; NGram windows as ``(step at 0, tokens at 0 and 1)``."""
    kw = dict(reader_pool_type=pool, workers_count=2)
    if factory == 'ngram':
        ngram = (JNGram if package is petastorm_tpu else NGram)(
            {0: ['step', 'tokens'], 1: ['tokens']}, 1, 'step')
        with package.make_reader(url, schema_fields=ngram, **kw) as reader:
            out = []
            for chunk in reader.iter_ngram_chunks():
                cols = chunk.columns
                for s in chunk.starts:
                    out.append((int(cols['step'][s]),
                                cols['tokens'][s].tobytes()
                                + cols['tokens'][s + 1].tobytes()))
        return sorted(out)
    if factory == 'rows':
        with package.make_reader(url, **kw) as reader:
            return sorted((int(r.step), np.asarray(r.tokens).tobytes())
                          for r in reader)
    make = {'columnar': package.make_columnar_reader,
            'batch': package.make_batch_reader}[factory]
    out = []
    with make(url, **kw) as reader:
        for b in reader:
            tokens = np.asarray(b.tokens)
            if tokens.dtype == object:      # the batch reader's raw cells
                tokens = [np.load(__import__('io').BytesIO(t)) for t in tokens]
            out.extend((int(s), np.asarray(t).tobytes())
                       for s, t in zip(b.step, tokens))
    return sorted(out)


@pytest.mark.timeout(240)
@pytest.mark.parametrize('factory', ['rows', 'ngram', 'columnar', 'batch'])
def test_pools_give_the_rows_of_jax_process_pool(store, factory):
    url, tokens = store
    want = _rows(petastorm_tpu, factory, url, 'process')
    # windows do not cross row groups: 6 groups of 8 rows give 42
    assert len(want) == (ROWS - ROWS // 8 if factory == 'ngram' else ROWS)
    import petastorm_tpu_torch
    for pool in ('process', 'dummy', 'thread'):
        assert _rows(petastorm_tpu_torch, factory, url, pool) == want, pool
    if factory == 'rows':
        assert want[5][1] == tokens[5].tobytes()


@pytest.mark.timeout(120)
def test_process_pool_epochs_and_reset_follow_the_seed(store):
    """Two epochs, then ``reset()`` for two more: each epoch's rows under
    the process pool, and one row-group order for one seed under the
    dummy pool and a one-thread pool."""
    url, tokens = store
    with make_columnar_reader(url, reader_pool_type='process',
                              workers_count=2, num_epochs=2,
                              seed=3) as reader:
        steps = [int(s) for b in reader for s in b.step]
        reader.reset()
        steps += [int(s) for b in reader for s in b.step]
    assert sorted(steps) == sorted(list(range(ROWS)) * 4)

    def order(pool):
        with make_columnar_reader(url, reader_pool_type=pool, num_epochs=2,
                                  workers_count=1, seed=3) as reader:
            starts = [int(b.step[0]) for b in reader]
            reader.reset()
            return starts + [int(b.step[0]) for b in reader]

    dummy = order('dummy')
    assert dummy == order('thread')        # one worker: ventilation order
    groups = ROWS // 8                      # 4 epochs of 6 row groups
    assert len(dummy) == 4 * groups and dummy[:groups] != \
        sorted(dummy[:groups]) and sorted(dummy[:groups]) == \
        sorted(dummy[-groups:])


@pytest.mark.timeout(120)
def test_worker_exception_reaches_the_consumer_with_its_traceback():
    pool = ProcessPool(2)
    pool.start(functools.partial(operator.truediv, 1.0), [1, 2, 0, 4],
               shuffle=False)
    with pytest.raises(ZeroDivisionError) as info:
        for _ in range(5):
            pool.get_results()
    pool.join()
    notes = '\n'.join(getattr(info.value, '__notes__', []))
    assert 'Traceback' in notes and 'ZeroDivisionError' in notes
    assert all(p.poll() is not None for p in pool._processes)


@pytest.mark.timeout(120)
def test_stop_and_join_leave_no_child_and_no_thread(store):
    url, _ = store
    with make_columnar_reader(url, reader_pool_type='process',
                              workers_count=3, num_epochs=None) as reader:
        next(reader)                          # stopped mid-stream
        procs = list(reader._pool._processes)
        assert len(procs) == 3 and all(p.poll() is None for p in procs)
    assert all(p.poll() is not None for p in procs)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith('petastorm-')]


@pytest.mark.timeout(120)
@pytest.mark.parametrize('copy_buffers', [True, False])
def test_received_arrays_are_writable_as_jax_and_the_loader_copies(
        store, monkeypatch, copy_buffers):
    """Arrays rebuilt over ``bytes`` frames (``zmq_copy_buffers=True``) are
    read-only, over the received ZMQ frames (``False``) writable views, in
    both packages; the loader wraps neither read-only array as a tensor."""
    url, tokens = store
    monkeypatch.setenv(DEVICE_DECODE_ENV_VAR, 'off')
    kw = dict(reader_pool_type='process', workers_count=1,
              shuffle_row_groups=False, zmq_copy_buffers=copy_buffers)
    with petastorm_tpu.make_columnar_reader(url, **kw) as reader:
        want = next(reader).tokens.flags.writeable
    with make_columnar_reader(url, **kw) as reader:
        first = next(reader)
        assert first.tokens.flags.writeable == want == (not copy_buffers)
        assert not first.tokens.flags.owndata     # a view of its frame
        with warnings.catch_warnings():
            # torch warns when it wraps a read-only array: it must not
            warnings.simplefilter('error', UserWarning)
            batches = list(TorchDataLoader(reader, batch_size=8,
                                           device='cpu'))
    got = torch.cat([b['tokens'] for b in batches])
    assert got.numpy().tobytes() == tokens[len(first.step):].tobytes()


@pytest.mark.timeout(120)
def test_raw_grid_crosses_as_one_out_of_band_frame(store):
    url, tokens = store
    with make_columnar_reader(url, workers_count=1,
                              shuffle_row_groups=False) as reader:
        plans, pieces = reader.device_decode_plans, reader.pieces
        schema = reader.stored_schema
    assert set(plans) == {'tokens'}
    from petastorm_tpu_torch.workers.thread_pool import WorkItem
    columns = load_columnar(WorkItem(pieces[0]), schema=schema,
                            names=['step', 'tokens'], plans=plans)
    grid = columns['tokens']
    assert grid.dtype == np.uint8 and grid.shape[1] == plans['tokens'].stride
    serializer = ZeroCopySerializer()
    frames = serializer.serialize_multipart(columns)
    assert len(frames) == 2 and frames[1].nbytes == grid.nbytes
    back = serializer.deserialize_multipart(
        [bytes(f) for f in frames])
    assert back['tokens'].tobytes() == grid.tobytes()
    # through the pool: the grid arrives raw, a view of its frame
    pool = ProcessPool(1, zmq_copy_buffers=False)
    pool.start(functools.partial(load_columnar, schema=schema,
                                 names=['step', 'tokens'], plans=plans),
               [WorkItem(pieces[0])], shuffle=False)
    try:
        got = pool.get_results()
    finally:
        pool.stop()
        pool.join()
    assert got['tokens'].dtype == np.uint8
    assert not got['tokens'].flags.owndata      # a view of its frame
    assert got['tokens'].tobytes() == grid.tobytes()


_PROBE = ('(__import__("petastorm_tpu_torch.readers.columnar_worker"), '
          '__import__("petastorm_tpu_torch.readers.row_worker"), '
          '__import__("petastorm_tpu_torch.readers.batch_worker"), '
          'sorted(m for m in __import__("sys").modules '
          'if m.split(".")[0] in ("torch", "jax", "petastorm_tpu")), '
          '__import__("os").environ.get("CUDA_VISIBLE_DEVICES"))[-2:]')


@pytest.mark.timeout(120)
def test_worker_interpreter_imports_no_torch_jax_or_jax_package():
    assert 'torch' in sys.modules     # the parent has torch
    pool = ProcessPool(1)
    pool.start(functools.partial(eval, _PROBE), [{}], shuffle=False)
    try:
        modules, visible = pool.get_results()
    finally:
        pool.stop()
        pool.join()
    assert modules == [] and visible == ''


def test_process_pool_names_pyzmq_when_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, 'zmq', None)
    with pytest.raises(ImportError, match='pyzmq'):
        ProcessPool(1)


def test_dummy_pool_runs_items_in_ventilation_order():
    pool = DummyPool()
    pool.start(lambda x: x * 10, [1, 2, 3], num_epochs=2, shuffle=False)
    got = []
    while True:
        try:
            got.append(pool.get_results())
        except EmptyResultError:
            break
    pool.reset(1)
    got.append(pool.get_results())
    assert got == [10, 20, 30, 10, 20, 30, 10]


def test_thread_pool_options_reach_the_pool(store, caplog):
    url, _ = store
    with caplog.at_level(logging.INFO):
        with make_batch_reader(url, workers_count=2, results_queue_size=3,
                               profiling_enabled=True) as reader:
            assert reader._pool._results.maxsize == 3
            assert sum(len(b.step) for b in reader) == ROWS
    assert 'Aggregated worker profile' in caplog.text
    with pytest.raises(ValueError, match="'thread', 'process', 'dummy'"):
        make_reader(url, reader_pool_type='fork')


def test_arrow_table_serializer_round_trips_a_batch_item():
    from petastorm_tpu_torch.workers.serializers import ArrowTableSerializer
    table = pa.table({'a': np.arange(5), 'b': ['x'] * 5})
    s = ArrowTableSerializer()
    assert s.deserialize_multipart(s.serialize_multipart(table)).equals(table)
    assert s.deserialize(s.serialize(None)) is None


_SPEC_MODULE = '''
import torch


def triple(values):
    """A device spec's function, over CPU tensors."""
    assert torch.is_tensor(values['tokens'])
    return dict(values, tokens=values['tokens'] * 3 + 1)
'''


@pytest.mark.timeout(180)
def test_device_spec_without_plans_runs_in_the_worker_interpreters(
        store, tmp_path, monkeypatch):
    """With nothing planned (decode off; a row reader), a device spec runs
    on the process pool's workers over CPU tensors, as JAX runs it on its
    workers, and gives the thread pool's rows."""
    from petastorm_tpu_torch.transform import TransformSpec
    (tmp_path / 'pool_spec_module.py').write_text(_SPEC_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    import pool_spec_module
    url, tokens = store
    monkeypatch.setenv(DEVICE_DECODE_ENV_VAR, 'off')
    spec = TransformSpec(pool_spec_module.triple, device=True)
    want = (tokens * 3 + 1).tobytes()
    for pool in ('process', 'thread'):
        with make_columnar_reader(url, reader_pool_type=pool,
                                  workers_count=2,
                                  transform_spec=spec) as reader:
            assert reader.device_decode_plans == {}
            assert reader._device_transform_spec is None   # on the workers
            batches = [b._asdict() for b in reader]
        steps = np.concatenate([b['step'] for b in batches])
        got = np.concatenate([b['tokens'] for b in batches])
        assert got[np.argsort(steps)].tobytes() == want, pool
        with make_reader(url, reader_pool_type=pool, workers_count=2,
                         transform_spec=spec) as reader:
            rows = sorted(reader, key=lambda r: int(r.step))
        assert all(isinstance(r.tokens, np.ndarray) for r in rows)
        assert np.stack([r.tokens for r in rows]).tobytes() == want, pool


_PROBE_MODULE = '''
import sys


def probe(columns):
    """Fails in an interpreter that holds torch, jax or the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m.split('.')[0] in ('torch', 'jax', 'petastorm_tpu'))
    if bad:
        raise RuntimeError('worker imported %s' % bad)
    return columns
'''


@pytest.mark.timeout(180)
def test_worker_reading_through_a_shared_cache_with_readahead_imports_no_torch(
        store, tmp_path, monkeypatch):
    """A process-pool worker that reads ahead, fills the shared cache (pass
    1) and attaches its segments (pass 2) still holds no torch, jax or JAX
    package: a transform run after the cached load on every item checks."""
    from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
    from petastorm_tpu_torch.transform import TransformSpec
    (tmp_path / 'pool_probe_module.py').write_text(_PROBE_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    import pool_probe_module
    url, tokens = store
    root = str(tmp_path / 'cache')
    for _ in range(2):
        with make_columnar_reader(
                url, reader_pool_type='process', workers_count=2,
                io_readahead=2, shuffle_row_drop_partitions=2,
                transform_spec=TransformSpec(pool_probe_module.probe),
                cache_type='shared', cache_location=root,
                cache_size_limit=1 << 26,
                cache_extra_settings={'mem_dir': str(tmp_path / 'mem')}
                ) as reader:
            steps = sorted(int(s) for b in reader for s in b.step)
        assert steps == list(range(ROWS))
    totals = SharedRowGroupCache.global_counters(root)
    assert totals['fills'] == ROWS // 8
    assert totals['hits'] == 3 * ROWS // 8     # 2 items a group, 2 passes

