"""The port's north-star benches against the JAX package's, on the CPU.

Each store generator, run with the JAX generator's seed, writes a store
that reads back equal to the JAX generator's (token windows under both
codecs, png MNIST images, timestamped token chunks, synthetic ImageNet
images). Each ``run_*`` bench, at narrow widths and a few steps, returns
the JAX bench's report keys and the same steps and samples; the
``InfeedReport`` numbers are times and are held to their ranges only.
"""

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu.benchmark import northstar as jns

import petastorm_tpu_torch
from petastorm_tpu_torch.benchmark import northstar as tns

LM = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64, vocab=128)


def _rows(package, url, key):
    with package.make_reader(url, reader_pool_type='dummy', num_epochs=1,
                             shuffle_row_groups=False) as reader:
        rows = [row._asdict() for row in reader]
    return sorted(rows, key=lambda row: key(row))


def _assert_same_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            np.testing.assert_array_equal(np.asarray(g[name]),
                                          np.asarray(w[name]), err_msg=name)


def _pair(tmp_path, name, generate, **kwargs):
    urls = []
    for module in (tns, jns):
        url = 'file://' + str(tmp_path / ('%s_%s' % (name, module.__name__)))
        getattr(module, generate)(url, **kwargs)
        urls.append(url)
    return urls


@pytest.mark.parametrize('ndarray_codec', [False, True])
def test_token_store_as_jax(tmp_path, ndarray_codec):
    got, want = _pair(tmp_path, 'tok', 'generate_token_dataset', rows=40,
                      seq_len=16, vocab=64, seed=5, row_group_size_mb=0.002,
                      ndarray_codec=ndarray_codec)
    schema = tns.make_token_schema(16, ndarray_codec)
    jschema = jns.make_token_schema(16, ndarray_codec)
    assert type(schema.fields['tokens'].codec).__name__ == \
        type(jschema.fields['tokens'].codec).__name__
    key = lambda row: bytes(np.asarray(row['tokens']))       # noqa: E731
    _assert_same_rows(_rows(petastorm_tpu_torch, got, key),
                      _rows(petastorm_tpu, want, key))
    # the port's store also reads back through the JAX reader
    _assert_same_rows(_rows(petastorm_tpu, got, key),
                      _rows(petastorm_tpu, want, key))


def test_mnist_image_store_as_jax(tmp_path):
    got, want = _pair(tmp_path, 'mnist', 'generate_mnist_images_dataset',
                      rows=48, seed=3, row_group_size_mb=0.005)
    key = lambda row: int(row['idx'])                       # noqa: E731
    _assert_same_rows(_rows(petastorm_tpu_torch, got, key),
                      _rows(petastorm_tpu, want, key))


def test_timeseries_store_as_jax(tmp_path):
    got, want = _pair(tmp_path, 'ts', 'generate_timeseries_token_dataset',
                      rows=96, chunk=8, vocab=64, seed=4, rows_per_group=32)
    key = lambda row: int(row['ts'])                        # noqa: E731
    _assert_same_rows(_rows(petastorm_tpu_torch, got, key),
                      _rows(petastorm_tpu, want, key))


@pytest.mark.timeout(120)
def test_imagenet_store_as_jax(tmp_path):
    got, want = _pair(tmp_path, 'img', 'generate_imagenet_dataset', rows=6,
                      classes=3, seed=2, row_group_size_mb=0.5)
    key = lambda row: (int(row['label']), row['image'].shape,  # noqa: E731
                       bytes(row['image'][:2, :2].ravel()))
    _assert_same_rows(_rows(petastorm_tpu_torch, got, key),
                      _rows(petastorm_tpu, want, key))


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    d = tmp_path_factory.mktemp('northstar')
    urls = {name: 'file://' + str(d / name)
            for name in ('tok', 'mnist', 'ts', 'img')}
    jns.generate_token_dataset(urls['tok'], rows=128, seq_len=32, vocab=128,
                               seed=1, row_group_size_mb=0.005)
    jns.generate_mnist_images_dataset(urls['mnist'], rows=128, seed=1,
                                      row_group_size_mb=0.005)
    jns.generate_timeseries_token_dataset(urls['ts'], rows=128, chunk=8,
                                          vocab=128, seed=1,
                                          rows_per_group=32)
    jns.generate_imagenet_dataset(urls['img'], rows=16, classes=4, seed=1,
                                  row_group_size_mb=0.5)
    return urls


def _same_counts(got, want):
    assert type(got).__name__ == type(want).__name__ == 'InfeedReport'
    assert set(got.as_dict()) == set(want.as_dict())
    assert (got.steps, got.samples) == (want.steps, want.samples)
    assert got.steps > 0 and got.samples_per_sec > 0
    assert 0.0 <= got.overlap <= 1.0
    if got.overlap_pct_sync is not None:
        assert 0.0 <= got.overlap_pct_sync <= 100.0


BENCHES = {
    'mnist': ('run_mnist_train_bench', 'mnist',
              dict(batch_size=16, num_steps=3, warmup_steps=1,
                   workers_count=2, hidden=32)),
    'mnist_cached': ('run_mnist_cached_train_bench', 'mnist',
                     dict(rows=128, batch_size=32, num_steps=3,
                          workers_count=2, hidden=32)),
    'imagenet': ('run_imagenet_train_bench', 'img',
                 dict(batch_size=4, num_steps=2, warmup_steps=1,
                      workers_count=2, num_classes=4, image_size=32)),
    'imagenet_cached': ('run_imagenet_cached_train_bench', 'img',
                        dict(rows=16, batch_size=4, num_steps=2,
                             workers_count=2, num_classes=4,
                             image_size=32)),
    'transformer': ('run_transformer_train_bench', 'tok',
                    dict(batch_size=4, num_steps=3, warmup_steps=1,
                         workers_count=2, seq_len=32, **LM)),
    'ngram': ('run_ngram_transformer_train_bench', 'ts',
              dict(window=2, chunk=8, batch_size=4, num_steps=3,
                   warmup_steps=1, workers_count=2, **LM)),
    'indexed_ngram': ('run_indexed_ngram_transformer_train_bench', 'ts',
                      dict(window=2, chunk=8, batch_size=4, num_steps=3,
                           warmup_steps=1, workers_count=2, **LM)),
}


@pytest.mark.timeout(240)
@pytest.mark.parametrize('bench', sorted(BENCHES))
def test_train_bench_counts_as_jax(stores, bench, calibration_dir):
    name, store, kwargs = BENCHES[bench]
    got = getattr(tns, name)(stores[store], device='cpu', **kwargs)
    want = getattr(jns, name)(stores[store], **kwargs)
    _same_counts(got, want)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('bench', ['image_decode', 'columnar_read'])
def test_read_bench_counts_as_jax(stores, bench):
    if bench == 'image_decode':
        got = tns.run_image_decode_bench(stores['img'], workers_count=2,
                                         image_size=32)
        want = jns.run_image_decode_bench(stores['img'], workers_count=2,
                                          image_size=32)
    else:
        got = tns.run_columnar_read_bench(stores['tok'], workers_count=2)
        want = jns.run_columnar_read_bench(stores['tok'], workers_count=2)
    assert set(got) == set(want) == {'samples', 'samples_per_sec'}
    assert got['samples'] == want['samples'] > 0
    assert got['samples_per_sec'] > 0


@pytest.fixture()
def calibration_dir(tmp_path, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_CALIBRATION_DIR', str(tmp_path / 'c'))
    return tmp_path / 'c'


def test_benches_need_cuda_unless_cpu(stores, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tns.run_transformer_train_bench(stores['tok'], **BENCHES[
            'transformer'][2])


def test_lm_bench_keeps_jaxs_attention():
    """JAX's LM bench leaves ``attention`` at ``TransformerConfig``'s
    default; so does the port's, whose default is the same."""
    import inspect

    from petastorm_tpu.models import transformer_lm as jtlm

    from petastorm_tpu_torch.models import transformer_lm as ttlm
    assert ttlm.TransformerConfig().attention == \
        jtlm.TransformerConfig().attention == 'blockwise'
    for name in ('run_transformer_train_bench',
                 'run_ngram_transformer_train_bench',
                 'run_indexed_ngram_transformer_train_bench'):
        port = inspect.signature(getattr(tns, name)).parameters
        jax_ = inspect.signature(getattr(jns, name)).parameters
        assert list(port) == list(jax_) + ['device'], name
        for key, param in jax_.items():
            assert port[key].default == param.default, (name, key)


@pytest.mark.parametrize('name', [
    'run_mnist_train_bench', 'run_mnist_cached_train_bench',
    'run_imagenet_train_bench', 'run_imagenet_cached_train_bench',
    'run_image_decode_bench', 'run_columnar_read_bench',
    'generate_mnist_images_dataset', 'generate_token_dataset',
    'generate_imagenet_dataset', 'generate_timeseries_token_dataset'])
def test_signatures_as_jax(name):
    import inspect
    port = inspect.signature(getattr(tns, name)).parameters
    jax_ = inspect.signature(getattr(jns, name)).parameters
    extra = [k for k in port if k not in jax_]
    assert extra in ([], ['device']), name
    assert [k for k in port if k in jax_] == list(jax_), name
    for key, param in jax_.items():
        assert port[key].default == param.default, (name, key)


@pytest.mark.timeout(300)
def test_phase_27_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 27 at small widths on the CPU: the probes,
    the north-star LM through ``prefetch_batches``, the mnist and imagenet
    benches, the throughput command in a fresh interpreter and the two
    quick benches with their verdicts; no kernel launches (the twins
    run)."""
    import argparse

    import torch

    import chip_smoke
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ops import kernels
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    cfg = tlm.TransformerConfig(vocab_size=512, d_model=64, n_heads=2,
                                n_layers=1, d_ff=128, max_seq_len=64)
    got = chip_smoke.instruments_line(
        torch, np, tlm, kernels, argparse.Namespace(seed=0), device='cpu',
        cfg=cfg, rows=256, group_mb=0.01, lm_batch=4, lm_steps=4,
        mnist={'store': {'rows': 512, 'row_group_size_mb': 0.01},
               'bench': {'batch_size': 32, 'hidden': 64,
                         'workers_count': 2}},
        imagenet={'store': {'rows': 16, 'row_group_size_mb': 0.5},
                  'bench': {'batch_size': 4, 'image_size': 32,
                            'workers_count': 2}},
        cli_cycles=(20, 100))
    assert got == {name: 0 for name in kernels.LAUNCHES}
