"""Parity of the port's transformer LM (petastorm_tpu_torch.models) with the
JAX model on the same parameters and tokens.

Parameters come from the JAX ``init`` through ``params_from_jax``; tokens are
made with numpy. Tiny float32 config (vocab 64, d_model 32, 4 heads, 2
layers, L 16). The JAX side runs ``attention='flash'``, which is its jnp path
on the CPU; the port's side runs the plain twins of its kernels. Tolerances:
logits 1e-4, loss 1e-5, gradients 1e-4, parameters after one AdamW step
1e-5 (float32 sums in different orders). The head-dim cases run d_model 256
over 2 heads (head dim 128) and over 8 (head dim 32), L 64, with the JAX
side's flash attention on its Pallas kernels in interpret mode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import transformer_lm as jtlm
from petastorm_tpu_torch.models import transformer_lm as ttlm
from petastorm_tpu_torch.weights import params_from_jax

CONFIGS = {
    'mha': dict(),
    'gqa_window': dict(n_kv_heads=2, attention_window=5),
}


def _configs(extra):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq_len=16, attention='flash', **extra)
    return (jtlm.TransformerConfig(dtype=jnp.float32, **base),
            ttlm.TransformerConfig(dtype=torch.float32, **base))


def _setup(extra, seed=0):
    jcfg, tcfg = _configs(extra)
    jparams = jtlm.init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device='cpu')
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, (2, 16)).astype(np.int32)
    targets = rng.integers(0, 64, (2, 16)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens, targets


def _leaves_jax(params):
    leaves = [params['embed'], params['final_norm'], params['unembed']]
    for layer in params['layers']:
        leaves.extend(layer[name] for name in sorted(layer))
    return [np.asarray(x) for x in leaves]


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_logits_and_loss_match(name):
    jcfg, tcfg, jp, tp, tokens, targets = _setup(CONFIGS[name])
    ref = np.asarray(jtlm.forward(jp, jnp.asarray(tokens), jcfg))
    got = ttlm.forward(tp, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4,
                               rtol=1e-4)
    ref_loss = float(jtlm.loss_fn(jp, jnp.asarray(tokens),
                                  jnp.asarray(targets), jcfg))
    got_loss = float(ttlm.loss_fn(tp, torch.from_numpy(tokens),
                                  torch.from_numpy(targets), tcfg))
    np.testing.assert_allclose(got_loss, ref_loss, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_gradients_match(name):
    jcfg, tcfg, jp, tp, tokens, targets = _setup(CONFIGS[name], seed=1)
    jgrads = jax.grad(jtlm.loss_fn)(jp, jnp.asarray(tokens),
                                    jnp.asarray(targets), jcfg)
    leaves = ttlm.parameters(tp)
    for p in leaves:
        p.requires_grad_(True)
    ttlm.loss_fn(tp, torch.from_numpy(tokens), torch.from_numpy(targets),
                 tcfg).backward()
    ref = _leaves_jax(jgrads)
    assert len(ref) == len(leaves)
    for i, (a, b) in enumerate(zip(leaves, ref)):
        np.testing.assert_allclose(a.grad.numpy(), b, atol=1e-4, rtol=1e-4,
                                   err_msg='leaf %d' % i)


def test_one_adamw_step_matches_optax():
    jcfg, tcfg, jp, tp, tokens, targets = _setup({}, seed=2)
    optimizer, step_fn = jtlm.make_train_step(jcfg)
    jp2, _, jloss = step_fn(jp, optimizer.init(jp), jnp.asarray(tokens),
                            jnp.asarray(targets))
    _, step = ttlm.make_train_step(tcfg, tp)
    loss = step(torch.from_numpy(tokens), torch.from_numpy(targets))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    for i, (a, b) in enumerate(zip(ttlm.parameters(tp), _leaves_jax(jp2))):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-5,
                                   rtol=1e-5, err_msg='leaf %d' % i)


def test_packed_weighted_loss_matches():
    """Packed batches: segment-masked attention, per-document rotary
    positions and a weighted mean, as the JAX ``loss_fn``."""
    jcfg, tcfg, jp, tp, tokens, targets = _setup({}, seed=3)
    seg = np.repeat(np.array([[0, 1, 2, 3], [4, 4, 5, 5]], np.int32), 4, 1)
    weights = (np.arange(16) % 5 != 0)[None].repeat(2, 0).astype(np.float32)
    ref = float(jtlm.loss_fn(jp, jnp.asarray(tokens), jnp.asarray(targets),
                             jcfg, segment_ids=jnp.asarray(seg),
                             weights=jnp.asarray(weights)))
    got = float(ttlm.loss_fn(tp, torch.from_numpy(tokens),
                             torch.from_numpy(targets), tcfg,
                             segment_ids=torch.from_numpy(seg),
                             weights=torch.from_numpy(weights)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_segment_positions_match():
    seg = np.array([[0, 0, 0, 1, 1, 2, 2, 2], [3, 3, 3, 3, 4, 4, 4, 4]],
                   np.int32)
    ref = np.asarray(jtlm._segment_positions(jnp.asarray(seg)))
    got = ttlm._segment_positions(torch.from_numpy(seg))
    np.testing.assert_array_equal(got.numpy(), ref)


HEAD_DIM_CONFIGS = {'head_dim_128': 2, 'head_dim_32': 8}


@pytest.mark.parametrize('name', sorted(HEAD_DIM_CONFIGS))
def test_head_dims_match_pallas_interpret(name, monkeypatch):
    """Logits, loss and every leaf's gradient at head dims 128 and 32, the
    JAX LM's flash attention run on its Pallas kernels (interpret mode)."""
    monkeypatch.setattr(jtlm, 'flash_attention', functools.partial(
        jtlm.flash_attention, backend='interpret', block_q=32, block_k=32))
    base = dict(vocab_size=128, d_model=256, n_heads=HEAD_DIM_CONFIGS[name],
                n_layers=2, d_ff=512, max_seq_len=64, attention='flash')
    jcfg = jtlm.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = ttlm.TransformerConfig(dtype=torch.float32, **base)
    assert tcfg.head_dim == 256 // HEAD_DIM_CONFIGS[name]
    jp = jtlm.init(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.device_get(jp), tcfg, device='cpu')
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 128, (2, 64)).astype(np.int32)
    targets = rng.integers(0, 128, (2, 64)).astype(np.int32)
    ref = np.asarray(jtlm.forward(jp, jnp.asarray(tokens), jcfg))
    got = ttlm.forward(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4,
                               rtol=1e-4)
    ref_loss, jgrads = jax.value_and_grad(jtlm.loss_fn)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    leaves = ttlm.parameters(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttlm.loss_fn(tp, torch.from_numpy(tokens),
                        torch.from_numpy(targets), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5,
                               rtol=1e-5)
    ref_grads = _leaves_jax(jgrads)
    assert len(ref_grads) == len(leaves)
    for i, (a, b) in enumerate(zip(leaves, ref_grads)):
        np.testing.assert_allclose(a.grad.numpy(), b, atol=1e-4, rtol=1e-4,
                                   err_msg='leaf %d' % i)


def test_unported_configs_raise():
    """Ring attention is ported (tests/test_torch_lm_mesh.py): without a
    mesh with a 'seq' axis it raises JAX's words; an unknown attention
    raises."""
    _, tcfg = _configs({})
    ring = dataclasses.replace(tcfg, attention='ring')
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="needs a mesh with a 'seq' axis"):
        ttlm.forward(ttlm.init(ring, gen, device='cpu'),
                     torch.zeros(1, 4, dtype=torch.long), ring)
    with pytest.raises(ValueError, match="'flash', 'blockwise' or 'ring'"):
        ttlm.make_train_step(ttlm.TransformerConfig(attention='dense'), {})
    gen = torch.Generator().manual_seed(0)
    params = ttlm.init(tcfg, gen, device='cpu')
    assert params['embed'].shape == (64, 32)
    assert params['layers'][0]['wk'].shape == (32, 32)
