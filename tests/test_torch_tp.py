"""Tensor parallelism of the port's LM against the JAX package's, on the CPU.

One train step of the LM (JAX's dry-run widths: vocab 128, d_model 64, 4
heads, 2 layers, d_ff 128, L = 32 x seq, float32) on gloo ranks (started
by ``launch_ranks`` over a ``FileStore`` under the test's temp directory)
with a ``model`` axis: ``{'model': 2}``, ``{'data': 2, 'model': 2}``,
``{'model': 4}`` with GQA 4 -> 2 (``wk`` and ``wv`` split mid-head),
``{'seq': 2, 'model': 2}`` with ring attention and ``{'model': 8}`` (half
a q head a rank), against JAX's
``make_train_step(config, mesh)`` on the same axes of virtual CPU devices
from the same parameters and batch: the loss within 1e-5 and every leaf
after the AdamW step within 1e-4. The vocabulary-parallel forward and
loss against JAX's ``forward`` and ``loss_fn`` (logits and loss within
1e-5; each rank's logits block holds V / model columns), also for a
packed batch (segment ids, loss weights) split over ``{'seq': 2, 'model':
2}`` with blockwise attention, whose documents cross the chunks. The
``examples/transformer_lm`` twin on ``{'data': 2, 'model': 2}`` against
JAX's example on the same mesh. Each collective
with a backward against the single-process autograd of the gathered
computation (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from petastorm_tpu.models import transformer_lm as jtlm
from petastorm_tpu.parallel import make_mesh as jmake_mesh

from petastorm_tpu_torch.parallel import launch_ranks

MESHES = [({'model': 2}, {}), ({'data': 2, 'model': 2}, {}),
          ({'model': 4}, {'n_kv_heads': 2}),
          ({'seq': 2, 'model': 2}, {'attention': 'ring'}),
          ({'model': 8}, {})]
IDS = ['model2', 'data2_model2', 'model4_gqa4to2', 'seq2_model2_ring',
       'model8_half_heads']
BATCH = 4


def _config(axes, extra):
    seq = axes.get('seq', 1)
    common = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2,
                  d_ff=128, max_seq_len=32 * seq, attention='blockwise')
    common.update(extra)
    import torch
    return (jtlm.TransformerConfig(dtype=jnp.float32, **common),
            dict(dtype=torch.float32, **common))


def _leaves(tree):
    out = [tree['embed'], tree['final_norm'], tree['unembed']]
    for layer in tree['layers']:
        out.extend(layer[name] for name in sorted(layer))
    return [np.asarray(x) for x in out]


def _batch(seed, axes):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, (BATCH, 32 * axes.get('seq', 1) + 1))
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(axes, devices=jax.devices()[:n])


@pytest.fixture(scope='module', params=range(len(MESHES)), ids=IDS)
def stepped(request, tmp_path_factory):
    """``(JAX loss and leaves, the port's ranks' results)``, one launch."""
    axes, extra = MESHES[request.param]
    jcfg, tkw = _config(axes, extra)
    params = jtlm.init(jax.random.PRNGKey(request.param), jcfg)
    tokens, targets = _batch(request.param, axes)
    optimizer, step = jtlm.make_train_step(jcfg, _jax_mesh(axes))
    new, _, loss = step(params, optimizer.init(params), jnp.asarray(tokens),
                        jnp.asarray(targets))
    n = int(np.prod(list(axes.values())))
    ranks = launch_ranks('torch_mesh_ranks:lm_step', n,
                         str(tmp_path_factory.mktemp('tp')),
                         args=(axes, tkw, jax.device_get(params), tokens,
                               targets), timeout_s=240)
    return float(loss), _leaves(jax.device_get(new)), ranks


@pytest.mark.timeout(300)
def test_tp_step_loss_matches_jax(stepped):
    loss, _, ranks = stepped
    for r in ranks:
        assert abs(r['losses'][0] - loss) <= 1e-5 * max(1.0, abs(loss))


@pytest.mark.timeout(300)
def test_tp_step_leaves_match_jax(stepped):
    _, leaves, ranks = stepped
    got = ranks[0]['leaves']
    assert len(got) == len(leaves)
    for g, w in zip(got, leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.timeout(300)
@pytest.mark.parametrize('axes', [{'model': 2}, {'data': 2, 'model': 2}],
                         ids=['model2', 'data2_model2'])
def test_vocab_parallel_loss_matches_jax(axes, tmp_path):
    jcfg, tkw = _config(axes, {})
    params = jtlm.init(jax.random.PRNGKey(7), jcfg)
    tokens, targets = _batch(7, axes)
    logits = jtlm.forward(params, jnp.asarray(tokens), jcfg)
    loss = jtlm.loss_fn(params, jnp.asarray(tokens), jnp.asarray(targets),
                        jcfg)
    n = int(np.prod(list(axes.values())))
    ranks = launch_ranks('torch_mesh_ranks:vocab_parallel', n, str(tmp_path),
                         args=(axes, tkw, jax.device_get(params), tokens,
                               targets), timeout_s=240)
    local_b = BATCH // axes.get('data', 1)
    for r in ranks:
        assert r['block'] == (local_b, 32, 128 // axes['model'])
        np.testing.assert_allclose(r['logits'], np.asarray(logits),
                                   atol=1e-5, rtol=1e-5)
        assert abs(r['loss'] - float(loss)) <= 1e-5 * max(1.0, float(loss))


@pytest.mark.timeout(300)
def test_packed_batch_over_a_seq_split_matches_jax(tmp_path):
    axes = {'seq': 2, 'model': 2}
    jcfg, tkw = _config(axes, {})
    params = jtlm.init(jax.random.PRNGKey(11), jcfg)
    tokens, targets = _batch(11, axes)
    # documents of 20, 27 and 17 tokens: two cross the chunk boundary
    seg = np.repeat(np.arange(3), [20, 27, 17])[None].repeat(BATCH, 0)
    seg = seg.astype(np.int32)
    weights = (np.roll(seg, -1, 1) == seg).astype(np.float32)
    kw = dict(segment_ids=jnp.asarray(seg))
    logits = jtlm.forward(params, jnp.asarray(tokens), jcfg, **kw)
    loss = jtlm.loss_fn(params, jnp.asarray(tokens), jnp.asarray(targets),
                        jcfg, weights=jnp.asarray(weights), **kw)
    ranks = launch_ranks('torch_mesh_ranks:vocab_parallel', 4, str(tmp_path),
                         args=(axes, tkw, jax.device_get(params), tokens,
                               targets, seg, weights), timeout_s=240)
    for r in ranks:
        np.testing.assert_allclose(r['logits'], np.asarray(logits),
                                   atol=1e-5, rtol=1e-5)
        assert abs(r['loss'] - float(loss)) <= 1e-5 * max(1.0, float(loss))


@pytest.mark.timeout(300)
def test_example_twin_on_a_model_mesh_matches_jax(tmp_path):
    from examples.transformer_lm import main as jmain
    from petastorm_tpu_torch.examples.transformer_lm import main as tmain
    url = 'file://' + str(tmp_path / 'tokens')
    tmain.generate_token_stream(url, n_steps=48)
    axes = {'data': 2, 'model': 2}
    jlosses, _, jcfg = jmain.train(url, steps=2, mesh=_jax_mesh(axes))
    params = jax.device_get(jtlm.init(jax.random.PRNGKey(0), jcfg))
    losses = launch_ranks('torch_mesh_ranks:example_train', 4,
                          str(tmp_path / 'ranks'),
                          args=(url, 2, axes, params), timeout_s=240)
    for got in losses:
        assert got == losses[0]
        assert np.abs(np.asarray(got) - np.asarray(jlosses)).max() < 1e-2


@pytest.mark.timeout(300)
@pytest.mark.parametrize('world', [2, 4])
def test_collective_backwards_match_autograd(world, tmp_path):
    import torch
    rng = np.random.default_rng(world)
    x = rng.standard_normal((world, 3, 4)).astype(np.float32)
    g = rng.standard_normal((world, 3, 4 * world)).astype(np.float32)
    ranks = launch_ranks('torch_mesh_ranks:collective_grads', world,
                         str(tmp_path), args=({'x': x, 'g': g},),
                         timeout_s=240)
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g)
    # the single-process computation each collective stands for: a rank's
    # loss term is sum(y_r * g_r); the replicated results (psum, the
    # invariant gather) count their loss once, so one rank's g weighs them
    whole = {
        'psum': lambda: [(xt.sum(0) * gt[0, :, :4]).sum()],
        'pvary': lambda: [sum((xt[0] * gt[r, :, :4]).sum()
                              for r in range(world))],
        'all_gather_tiled': lambda: [sum(
            (torch.cat(list(xt), 1) * gt[r]).sum() for r in range(world))],
        'all_gather_invariant': lambda: [
            (torch.cat(list(xt), 1) * gt[0]).sum()],
        'ppermute': lambda: [sum((xt[(r - 1) % world] * gt[r, :, :4]).sum()
                                 for r in range(world))],
    }
    for name, fn in whole.items():
        xt.grad = None
        fn()[0].backward()
        for r, rank in enumerate(ranks):
            y, grad = rank[name]
            if name == 'pvary':
                # every rank's x is rank 0's in the single computation
                np.testing.assert_allclose(grad, xt.grad[0].numpy(),
                                           atol=1e-5, rtol=1e-5)
                continue
            np.testing.assert_allclose(grad, xt.grad[r].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
        if name == 'ppermute':
            for r, rank in enumerate(ranks):
                np.testing.assert_array_equal(rank[name][0],
                                              x[(r - 1) % world])
    for rank in ranks:
        y, needs_grad = rank['pmax']
        np.testing.assert_array_equal(y, x.max(0))
        assert not needs_grad


# -- phase 25 of chip_smoke.py -------------------------------------------------

@pytest.mark.timeout(300)
def test_chip_smoke_tp_ep_pp_line_on_cpu(tmp_path, monkeypatch):
    """Phase 25 (a)-(c) at small widths on 4 CPU ranks: every gate holds
    (the twins run: no launches); (d) is the dry-run test's."""
    import argparse
    import os

    import torch

    import chip_smoke
    from petastorm_tpu_torch.models import transformer_lm as ttlm
    from petastorm_tpu_torch.ops import kernels
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    cfg = ttlm.TransformerConfig(vocab_size=512, d_model=64, n_heads=4,
                                 n_layers=2, d_ff=128, max_seq_len=64,
                                 attention='flash', dtype=torch.float32)
    launches = chip_smoke.tp_line(torch, np, ttlm, kernels,
                                  argparse.Namespace(seed=0), device='cpu',
                                  cfg=cfg, rows=64, steps=2, dry=False)
    assert launches == {'flash_fwd': 0, 'flash_bwd_dq': 0,
                        'flash_bwd_dkdv': 0}
    assert os.listdir(str(tmp_path)) == []
