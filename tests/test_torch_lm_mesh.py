"""The port's LM on a mesh against the JAX package's, on the CPU.

One train step of the LM (JAX's dry-run config: vocab 128, d_model 64, 4
heads, 2 layers, d_ff 128, L = 32 x seq, float32; ring attention when the
mesh has a seq axis of 2, blockwise otherwise) on ``{'data': 2}``,
``{'seq': 2}`` and ``{'data': 2, 'seq': 2}`` gloo ranks (started by
``launch_ranks`` over a ``FileStore`` under the test's temp directory),
each rank on its ``batch_spec`` block of the global batch, against JAX's
``make_train_step(config, mesh)`` on the same axes of virtual CPU
devices, from the same parameters: the loss within 1e-5 and every leaf
after the AdamW step within 1e-4. ``param_specs`` and ``batch_spec``
equal JAX's trees; the meshes the port once refused (``{'data': 2,
'model': 2}``, ``{'expert': 2}``, ``{'pipe': 2, 'seq': 2}`` with
blockwise attention over the split sequence, and a mixture of experts over
``{'data': 2}``) step like JAX's; the ring's argument errors are JAX's
words. The ``examples/transformer_lm`` twin on
``{'seq': 2}`` against JAX's example on the same mesh.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import transformer_lm as jtlm
from petastorm_tpu.parallel import make_mesh as jmake_mesh

from petastorm_tpu_torch.models import transformer_lm as ttlm
from petastorm_tpu_torch.parallel import launch_ranks

AXES = [{'data': 2}, {'seq': 2}, {'data': 2, 'seq': 2}]
BATCH = 4


def _configs(seq):
    common = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2,
                  d_ff=128, max_seq_len=32 * seq,
                  attention='ring' if seq > 1 else 'blockwise')
    return (jtlm.TransformerConfig(dtype=jnp.float32, **common),
            dict(dtype=torch.float32, **common))


def _leaves(tree):
    """``ttlm.parameters`` order of a JAX (numpy) pytree."""
    out = [tree['embed'], tree['final_norm'], tree['unembed']]
    for layer in tree['layers']:
        out.extend(layer[name] for name in sorted(layer))
    return [np.asarray(x) for x in out]


@pytest.fixture(scope='module', params=range(len(AXES)),
                ids=['data2', 'seq2', 'data2_seq2'])
def stepped(request, tmp_path_factory):
    """``(axes, JAX loss and leaves, the port's ranks' results)``."""
    axes = AXES[request.param]
    seq = axes.get('seq', 1)
    jcfg, tkw = _configs(seq)
    params = jtlm.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(request.param)
    toks = rng.integers(0, 128, (BATCH, 32 * seq + 1)).astype(np.int32)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    n = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(axes, devices=jax.devices()[:n])
    optimizer, step = jtlm.make_train_step(jcfg, mesh)
    new, _, loss = step(params, optimizer.init(params), jnp.asarray(tokens),
                        jnp.asarray(targets))
    ranks = launch_ranks('torch_mesh_ranks:lm_step', n,
                         str(tmp_path_factory.mktemp('lm')),
                         args=(axes, tkw, jax.device_get(params), tokens,
                               targets), timeout_s=240)
    return axes, float(loss), _leaves(jax.device_get(new)), ranks


@pytest.mark.timeout(300)
def test_train_step_loss_matches_jax(stepped):
    _, loss, _, ranks = stepped
    for r in ranks:
        assert abs(r['losses'][0] - loss) <= 1e-5 * max(1.0, abs(loss))


@pytest.mark.timeout(300)
def test_train_step_leaves_match_jax(stepped):
    _, _, leaves, ranks = stepped
    got = ranks[0]['leaves']
    assert len(got) == len(leaves)
    for g, w in zip(got, leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def _fake_mesh(**axes):
    """The axes of a mesh, without ranks (the specs read only these)."""
    return types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 shape=tuple(axes.values()),
                                 device_type='cpu',
                                 get_local_rank=lambda axis: 0)


@pytest.mark.parametrize('axes', [{'data': 2, 'seq': 2},
                                  {'data': 2, 'model': 2, 'expert': 2},
                                  {'model': 8}, {'seq': 8}])
@pytest.mark.parametrize('experts', [0, 4])
def test_param_specs_and_batch_spec_are_jax(axes, experts):
    jcfg = jtlm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                  n_layers=2, d_ff=64, n_experts=experts,
                                  moe_top_k=min(2, max(experts, 1)))
    tcfg = ttlm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                  n_layers=2, d_ff=64, n_experts=experts,
                                  moe_top_k=min(2, max(experts, 1)))
    jmesh = jmake_mesh(axes, devices=jax.devices()[:int(np.prod(
        list(axes.values())))])
    want = jtlm.param_specs(jcfg, jmesh)
    got = ttlm.param_specs(tcfg, _fake_mesh(**axes))
    assert [tuple(w) for w in _spec_leaves(want)] == _spec_leaves(got)
    assert tuple(jtlm.batch_spec(jmesh)) == ttlm.batch_spec(
        _fake_mesh(**axes))


def _spec_leaves(tree):
    out = [tree['embed'], tree['final_norm'], tree['unembed']]
    for layer in tree['layers']:
        out.extend(layer[name] for name in sorted(layer))
    return out


# the meshes the port refused before tensor, expert and pipeline
# parallelism came: each now steps like JAX's (blockwise attention on the
# seq split gathers the whole sequence, as XLA does)
FORMERLY_REFUSED = [({'data': 2, 'model': 2}, 0), ({'expert': 2}, 0),
                    ({'pipe': 2, 'seq': 2}, 0), ({'data': 2, 'seq': 1}, 4)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize('case', range(len(FORMERLY_REFUSED)),
                         ids=['data2_model2', 'expert2', 'pipe2_seq2',
                              'moe_data2'])
def test_formerly_refused_meshes_step_like_jax(case, tmp_path):
    axes, experts = FORMERLY_REFUSED[case]
    common = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                  max_seq_len=16 * axes.get('seq', 1), n_experts=experts,
                  moe_top_k=2 if experts else 1)
    jcfg = jtlm.TransformerConfig(dtype=jnp.float32, **common)
    params = jtlm.init(jax.random.PRNGKey(case), jcfg)
    rng = np.random.default_rng(case)
    toks = rng.integers(0, 64, (4, common['max_seq_len'] + 1)).astype(
        np.int32)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    n = int(np.prod(list(axes.values())))
    optimizer, step = jtlm.make_train_step(
        jcfg, jmake_mesh(axes, devices=jax.devices()[:n]))
    new, _, loss = step(params, optimizer.init(params), jnp.asarray(tokens),
                        jnp.asarray(targets))
    ranks = launch_ranks('torch_mesh_ranks:lm_step', n, str(tmp_path),
                         args=(axes, dict(dtype=torch.float32, **common),
                               jax.device_get(params), tokens, targets),
                         timeout_s=240)
    for r in ranks:
        assert abs(r['losses'][0] - float(loss)) <= 1e-5 * max(
            1.0, abs(float(loss)))
    for g, w in zip(ranks[0]['leaves'], _leaves(jax.device_get(new))):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_ring_argument_errors_are_jax():
    jcfg, tkw = _configs(2)
    tcfg = ttlm.TransformerConfig(**tkw)
    params = jtlm.init(jax.random.PRNGKey(0), jcfg)
    from petastorm_tpu_torch.weights import params_from_jax
    tp = params_from_jax(jax.device_get(params), tcfg, device='cpu')
    tokens = np.zeros((1, 8), np.int32)
    seg = np.zeros((1, 8), np.int32)
    jseq = jmake_mesh({'seq': 1}, devices=jax.devices()[:1])
    jdata = jmake_mesh({'data': 1}, devices=jax.devices()[:1])
    cases = [
        (dict(segment_ids=seg), jcfg, tcfg, jseq, _fake_mesh(seq=1)),
        ({}, dataclasses.replace(jcfg, attention_window=4),
         dataclasses.replace(tcfg, attention_window=4), jseq,
         _fake_mesh(seq=1)),
        ({}, jcfg, tcfg, jdata, _fake_mesh(data=1)),
        ({}, jcfg, tcfg, None, None)]
    for kw, jc, tc, jm, tm in cases:
        with pytest.raises(ValueError) as jerr:
            jtlm.forward(params, jnp.asarray(tokens), jc, mesh=jm,
                         **{k: jnp.asarray(v) for k, v in kw.items()})
        with pytest.raises(ValueError) as terr:
            ttlm.forward(tp, torch.from_numpy(tokens), tc, mesh=tm,
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert str(terr.value) == str(jerr.value)


def test_make_forward_and_unknown_attention():
    cfg = ttlm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                 n_layers=1, d_ff=64, dtype=torch.float32)
    params = ttlm.init(cfg, torch.Generator().manual_seed(0), device='cpu')
    tokens = torch.randint(0, 64, (2, 8), generator=torch.Generator()
                           .manual_seed(1))
    fn = ttlm.make_forward(cfg)
    out = fn(params, tokens)
    assert not out.requires_grad
    np.testing.assert_array_equal(
        out.numpy(), ttlm.forward(params, tokens, cfg).detach().numpy())
    with pytest.raises(ValueError, match="'flash', 'blockwise' or 'ring'"):
        ttlm.make_forward(dataclasses.replace(cfg, attention='dense'))


@pytest.mark.timeout(300)
def test_example_twin_on_a_seq_mesh_matches_jax(tmp_path):
    from examples.transformer_lm import main as jmain
    from petastorm_tpu_torch.examples.transformer_lm import main as tmain
    url = 'file://' + str(tmp_path / 'tokens')
    tmain.generate_token_stream(url, n_steps=48)
    jmesh = jmake_mesh({'seq': 2}, devices=jax.devices()[:2])
    jlosses, _, jcfg = jmain.train(url, steps=2, mesh=jmesh)
    params = jax.device_get(jtlm.init(jax.random.PRNGKey(0), jcfg))
    losses = launch_ranks('torch_mesh_ranks:example_train', 2,
                          str(tmp_path / 'ranks'),
                          args=(url, 2, {'seq': 2}, params), timeout_s=240)
    for got in losses:
        assert got == losses[0]
        assert np.abs(np.asarray(got) - np.asarray(jlosses)).max() < 1e-2


# -- phase 24 of chip_smoke.py -------------------------------------------------

@pytest.mark.timeout(300)
def test_chip_smoke_parallel_line_on_cpu(tmp_path, monkeypatch):
    """Phase 24's three launches at small widths on CPU ranks: every gate
    holds (the twins run: no launches)."""
    import argparse

    import chip_smoke
    from petastorm_tpu_torch.ops import kernels
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    cfg = ttlm.TransformerConfig(vocab_size=512, d_model=64, n_heads=2,
                                 n_layers=1, d_ff=128, max_seq_len=64,
                                 attention='flash', dtype=torch.float32)
    # 288 rows of 65 tokens in 9 row groups of 32
    launches = chip_smoke.parallel_line(
        torch, np, ttlm, kernels, argparse.Namespace(seed=0), device='cpu',
        cfg=cfg, shape=(1, 4, 64, 16), rows=64, steps=2, dp_group_mb=0.013,
        dp_steps=2, dtype=torch.float32)
    assert launches == {'flash_fwd': 0, 'flash_bwd_dq': 0,
                        'flash_bwd_dkdv': 0}
    assert os.listdir(str(tmp_path)) == []
