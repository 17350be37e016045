"""The port's data plane against the JAX package's on the same stores.

Stores are written with numpy-seeded token rows. A store written by
``petastorm_tpu.materialize_dataset`` must batch through the port's
``make_reader`` + ``TorchDataLoader(device='cpu')`` into the same
``{0: {step, tokens}, 1: {tokens}}`` windows, by key, as through the JAX
package's ``JaxDataLoader``; a store written by the port must read back
through the JAX reader. Also: the port imports neither JAX nor the JAX
package, and its entry points refuse to run without CUDA unless told
``device='cpu'``.
"""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import petastorm_tpu
from petastorm_tpu.codecs import (NdarrayCodec as JNdarrayCodec,
                                  ScalarCodec as JScalarCodec)
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.unischema import (Unischema as JUnischema,
                                     UnischemaField as JField)

import petastorm_tpu_torch
from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                 materialize_dataset, prefetch_to_device)
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     ThreadPool)

REPO = Path(__file__).resolve().parent.parent
WIDTH = 32
ROWS = 120


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    return [{'step': np.int64(i),
             'tokens': rng.integers(0, 1000, WIDTH, dtype=np.int32)}
            for i in range(ROWS)]


def _jax_schema():
    return JUnischema('TokenSchema', [
        JField('step', np.int64, (), JScalarCodec(), False),
        JField('tokens', np.int32, (WIDTH,), JNdarrayCodec(), False)])


def _torch_schema():
    return Unischema('TokenSchema', [
        UnischemaField('step', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (WIDTH,), NdarrayCodec(), False)])


def _ngram(cls):
    return cls(fields={0: ['step', 'tokens'], 1: ['tokens']},
               delta_threshold=1, timestamp_field='step')


def _write(package, url):
    schema = _jax_schema() if package == 'jax' else _torch_schema()
    writer = (petastorm_tpu.materialize_dataset if package == 'jax'
              else materialize_dataset)
    with writer(url, schema, rows_per_file=40, row_group_size_mb=64) as w:
        w.write_rows(_rows())


def _windows_by_step(batches):
    """{step: (tokens at 0, tokens at 1)} over every window of every batch,
    plus the batch sizes."""
    out, sizes = {}, []
    for b in batches:
        steps = np.asarray(b[0]['step'])
        sizes.append(len(steps))
        for i, s in enumerate(steps):
            assert int(s) not in out, 'window %d delivered twice' % s
            out[int(s)] = (np.asarray(b[0]['tokens'][i]),
                           np.asarray(b[1]['tokens'][i]))
    return out, sizes


def _read_torch(url, drop_last=False, **kw):
    with make_reader(url, schema_fields=_ngram(NGram), num_epochs=1,
                     workers_count=2, shuffle_row_groups=False) as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu',
                                 drop_last=drop_last, **kw)
        batches = list(loader)
    for b in batches:
        assert set(b) == {0, 1} and set(b[0]) == {'step', 'tokens'}
        assert b[0]['tokens'].dtype == torch.int32
        assert b[0]['step'].dtype == torch.int64
        assert b[1]['tokens'].shape[1:] == (WIDTH,)
    return _windows_by_step(batches)


def _read_jax(url):
    with petastorm_tpu.make_reader(url, schema_fields=_ngram(JNGram),
                                   num_epochs=1, shuffle_row_groups=False,
                                   workers_count=2) as reader:
        batches = list(JaxDataLoader(reader, batch_size=8))
    return _windows_by_step(batches)


def _expected_windows():
    rows = _rows()
    # windows never cross the 40-row row groups: 39 per group
    return {i: (rows[i]['tokens'], rows[i + 1]['tokens'])
            for i in range(ROWS - 1) if (i + 1) % 40}


def _assert_same(got, ref, subset=False):
    if subset:      # drop_last leaves out the last partial batch
        assert set(got) <= set(ref)
    else:
        assert sorted(got) == sorted(ref)
    for s in got:
        np.testing.assert_array_equal(got[s][0], ref[s][0])
        np.testing.assert_array_equal(got[s][1], ref[s][1])


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_port_reader_matches_jax_loader(tmp_path, writer):
    url = 'file://' + str(tmp_path / 'tokens')
    _write(writer, url)
    ref, ref_sizes = _read_jax(url)
    got, sizes = _read_torch(url)
    _assert_same(got, ref)
    _assert_same(got, _expected_windows())
    assert sorted(sizes) == sorted(ref_sizes) == [5] + [8] * 14
    got, sizes = _read_torch(url, drop_last=True)
    _assert_same(got, _expected_windows(), subset=True)
    assert sizes == [8] * 14


def test_seeded_shuffle_is_reproducible(tmp_path):
    url = str(tmp_path / 'tokens')
    _write('torch', url)

    def order(seed):
        with make_reader(url, schema_fields=_ngram(NGram), num_epochs=2,
                         workers_count=1, seed=seed) as reader:
            loader = TorchDataLoader(reader, batch_size=8, device='cpu',
                                     shuffling_queue_capacity=16, seed=seed)
            return [b[0]['step'].tolist() for b in loader]

    a, b = order(3), order(3)
    assert a == b
    assert sum(len(x) for x in a) == 2 * len(_expected_windows())
    assert order(4) != a


def test_prefetch_to_device_cpu_passes_batches(tmp_path):
    url = str(tmp_path / 'tokens')
    _write('torch', url)
    with make_reader(url, schema_fields=_ngram(NGram), num_epochs=None,
                     workers_count=2) as reader:
        loader = TorchDataLoader(reader, batch_size=4, device='cpu')
        gen = prefetch_to_device(iter(loader), size=2, device='cpu')
        batches = [next(gen) for _ in range(30)]   # past one epoch
        gen.close()
    assert all(tuple(b[1]['tokens'].shape) == (4, WIDTH) for b in batches)


def test_prefetch_stages_no_more_than_size_ahead(monkeypatch):
    """The producer waits for a free ring slot before staging a batch: with
    the consumer holding one batch, at most ``size`` more are staged."""
    import petastorm_tpu_torch.torch_utils as tu
    staged = []
    real = tu._to_tensor

    def counting(x, pin):
        staged.append(1)
        return real(x, pin)

    monkeypatch.setattr(tu, '_to_tensor', counting)
    batches = ({'x': np.full(3, i)} for i in range(20))
    gen = prefetch_to_device(batches, size=2, device='cpu')
    first = next(gen)
    time.sleep(0.3)                 # let the producer run as far as it may
    assert int(first['x'][0]) == 0
    assert len(staged) == 1 + 2
    rest = [int(b['x'][0]) for b in gen]
    assert rest == list(range(1, 20))


def test_worker_exception_reaches_consumer():
    pool = ThreadPool(2)

    def process(item):
        if item == 3:
            raise KeyError('bad row group')
        return item

    pool.start(process, list(range(6)), num_epochs=1, shuffle=False)
    with pytest.raises(KeyError, match='bad row group'):
        for _ in range(7):
            pool.get_results()
    pool.stop()
    pool.join(timeout=10)


def test_pool_stress_delivers_each_item_once_per_epoch():
    """More workers than cores, a short switch interval: every item comes
    back exactly once per epoch (a lost or doubled result breaks it)."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = ThreadPool(4 * (os.cpu_count() or 1), results_queue_size=3)
        pool.start(lambda item: item * 2, list(range(200)), num_epochs=3,
                   seed=5, max_in_flight=7)
        got = []
        while True:
            try:
                got.append(pool.get_results())
            except EmptyResultError:
                break
        pool.stop()
        pool.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert sorted(got) == sorted(2 * i for i in range(200) for _ in range(3))


def test_unported_codec_raises(tmp_path):
    """Every codec of the JAX package is ported: a store it writes with
    ``ArrowListCodec`` reads through the port's NGram reader, and only a
    codec name neither package registers raises, naming it."""
    from petastorm_tpu.codecs import ArrowListCodec
    from petastorm_tpu_torch.codecs import codec_from_json_dict
    url = 'file://' + str(tmp_path / 'lists')
    schema = JUnischema('Lists', [
        JField('step', np.int64, (), JScalarCodec(), False),
        JField('tokens', np.int32, (4,), ArrowListCodec(), False)])
    with petastorm_tpu.materialize_dataset(url, schema) as w:
        w.write_rows({'step': np.int64(i),
                      'tokens': np.arange(4, dtype=np.int32) + i}
                     for i in range(3))
    with make_reader(url, schema_fields=NGram({0: ['step', 'tokens']}, 1,
                                              'step'),
                     workers_count=1) as reader:
        chunks = list(reader.iter_ngram_chunks())
    tokens = np.concatenate([c.columns['tokens'] for c in chunks])
    assert tokens.dtype == np.int32
    np.testing.assert_array_equal(
        tokens, np.arange(4, dtype=np.int32) + np.arange(3)[:, None])
    with pytest.raises(ValueError, match='no_such_codec'):
        codec_from_json_dict({'codec': 'no_such_codec'})


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.models import transformer_lm as ttlm
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device()
    assert resolve_device('cpu').type == 'cpu'
    with pytest.raises(RuntimeError, match='CUDA'):
        prefetch_to_device(iter([]))
    with pytest.raises(RuntimeError, match='CUDA'):
        ttlm.init(ttlm.TransformerConfig(vocab_size=8, d_model=8,
                                         n_heads=2, n_layers=1, d_ff=8))
    url = str(tmp_path / 'tokens')
    _write('torch', url)
    with make_reader(url, schema_fields=_ngram(NGram)) as reader:
        with pytest.raises(RuntimeError, match='CUDA'):
            TorchDataLoader(reader, batch_size=2)


def test_import_pulls_in_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import petastorm_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = [n for n in sys.modules if n == "jax" or n.startswith("jax.")'
        ' or n == "petastorm_tpu" or n.startswith("petastorm_tpu.")]\n'
        'assert not bad, bad\n'
        'print("clean")\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'clean' in out.stdout


def test_source_scan_finds_no_jax_import():
    pattern = re.compile(
        r'^\s*(from|import)\s+(jax|petastorm_tpu)(\.|\s|$)'
        r'|import_module\([\'"](jax|petastorm_tpu)[\'".]', re.M)
    root = Path(petastorm_tpu_torch.__file__).parent
    files = sorted(root.rglob('*.py')) + [REPO / 'chip_smoke.py',
                                          REPO / 'chip_tune_probe.py']
    hits = [(str(f), m.group(0)) for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits


#: Modules of the device-decode, process-pool, readahead, cache, lineage,
#: observability, profiler, autotune, resilience, remote-store,
#: resume-and-mixing, pod-plane, parallel, adapter and instrument slices
#: (a benchmark imports torch only when it runs); the worker side
#: (everything a worker interpreter imports), the indexed loaders and the
#: parallel package (torch only inside its functions: the reader
#: factories call ``host_shard``) must not import torch either.
SLICE_MODULES = ['petastorm_tpu_torch.ops.decode',
                 'petastorm_tpu_torch.etl.repack',
                 'petastorm_tpu_torch.workers.serializers',
                 'petastorm_tpu_torch.workers.exec_in_new_process',
                 'petastorm_tpu_torch.workers.process_pool',
                 'petastorm_tpu_torch.workers.dummy_pool',
                 'petastorm_tpu_torch.cache',
                 'petastorm_tpu_torch.sharedcache',
                 'petastorm_tpu_torch.readers.readahead',
                 'petastorm_tpu_torch.readers.piece_worker',
                 'petastorm_tpu_torch.lineage',
                 'petastorm_tpu_torch.latency',
                 'petastorm_tpu_torch.workers.stats',
                 'petastorm_tpu_torch.tracing',
                 'petastorm_tpu_torch.health',
                 'petastorm_tpu_torch.profiler',
                 'petastorm_tpu_torch.autotune',
                 'petastorm_tpu_torch.resilience',
                 'petastorm_tpu_torch.faultfs',
                 'petastorm_tpu_torch.fs',
                 'petastorm_tpu_torch.objectstore',
                 'petastorm_tpu_torch.hdfs.namenode',
                 'petastorm_tpu_torch.etl.dataset_metadata',
                 'petastorm_tpu_torch.padding',
                 'petastorm_tpu_torch.weighted_sampling_reader',
                 'petastorm_tpu_torch.indexed',
                 'petastorm_tpu_torch.indexed_ngram',
                 'petastorm_tpu_torch.indexed_mixture',
                 'petastorm_tpu_torch.checkpoint',
                 'petastorm_tpu_torch.podobs',
                 'petastorm_tpu_torch.podelastic',
                 'petastorm_tpu_torch.parallel.mesh',
                 'petastorm_tpu_torch.parallel.ring',
                 'petastorm_tpu_torch.parallel.launch',
                 'petastorm_tpu_torch.parallel.pipeline',
                 'petastorm_tpu_torch.parallel.dryrun',
                 'petastorm_tpu_torch.pyarrow_helpers.batching_table_queue',
                 'petastorm_tpu_torch.converter',
                 'petastorm_tpu_torch.tf_utils',
                 'petastorm_tpu_torch.tools.copy_dataset',
                 'petastorm_tpu_torch.etl.generate_metadata',
                 'petastorm_tpu_torch.etl.metadata_util',
                 'petastorm_tpu_torch.benchmark.cli',
                 'petastorm_tpu_torch.benchmark.throughput',
                 'petastorm_tpu_torch.benchmark.dummy_reader',
                 'petastorm_tpu_torch.benchmark.infeed',
                 'petastorm_tpu_torch.benchmark.northstar',
                 'petastorm_tpu_torch.benchmark.goodput',
                 'petastorm_tpu_torch.benchmark.device_decode',
                 'petastorm_tpu_torch.benchmark.hello_world',
                 'petastorm_tpu_torch.benchmark.decode_batch',
                 'petastorm_tpu_torch.benchmark.transport',
                 'petastorm_tpu_torch.benchmark.readahead',
                 'petastorm_tpu_torch.benchmark.shared_cache',
                 'petastorm_tpu_torch.benchmark.roofline',
                 'petastorm_tpu_torch.benchmark.autotune',
                 'petastorm_tpu_torch.benchmark.chaos',
                 'petastorm_tpu_torch.benchmark.object_store',
                 'petastorm_tpu_torch.benchmark.lineage_overhead',
                 'petastorm_tpu_torch.benchmark.trace_overhead',
                 'petastorm_tpu_torch.benchmark.latency_overhead',
                 'petastorm_tpu_torch.benchmark.health_overhead',
                 'petastorm_tpu_torch.benchmark.podobs',
                 'petastorm_tpu_torch.benchmark.podelastic',
                 'petastorm_tpu_torch.benchmark.scaling']


@pytest.mark.parametrize('module', SLICE_MODULES)
def test_slice_module_imports_no_jax_and_no_torch(module):
    code = (
        'import importlib, sys\n'
        'importlib.import_module(%r)\n'
        'bad = [n for n in sys.modules if n.split(".")[0] in '
        '("jax", "petastorm_tpu", "torch")]\n'
        'assert not bad, bad\n'
        'print("clean")\n' % module)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'clean' in out.stdout


@pytest.mark.parametrize('module', SLICE_MODULES)
def test_source_scan_of_slice_module_finds_no_jax_import(module):
    pattern = re.compile(
        r'^\s*(from|import)\s+(jax|petastorm_tpu)(\.|\s|$)'
        r'|import_module\([\'"](jax|petastorm_tpu)[\'".]', re.M)
    path = REPO / (module.replace('.', '/') + '.py')
    assert path.is_file()
    assert not [m.group(0) for m in pattern.finditer(path.read_text())]
