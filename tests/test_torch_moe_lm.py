"""The port's mixture-of-experts LM against the JAX model, end to end.

Tiny float32 config (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64,
4 experts, 2 kv heads), the parameters drawn by the JAX ``init`` and loaded
through ``params_from_jax``, tokens made with numpy from a seed: logits,
aux and loss within 1e-5, the gradient of every leaf within 1e-4 (top-2
routing, flash twins and blockwise attention), the parameters after one
AdamW step within 1e-5 of optax's, and greedy top-1 and top-2 MoE decode
JAX's tokens exactly, its logits within 1e-4 of teacher forcing with
capacity for every unit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import transformer_lm as jtlm
from petastorm_tpu_torch.models import transformer_lm as ttlm
from petastorm_tpu_torch.weights import params_from_jax

E = 4


def _configs(**extra):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq_len=32, n_experts=E, attention='flash')
    base.update(extra)
    return (jtlm.TransformerConfig(dtype=jnp.float32, **base),
            ttlm.TransformerConfig(dtype=torch.float32, **base))


def _params(jcfg, tcfg, seed=0):
    jp = jtlm.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.device_get(jp), tcfg, device='cpu')


def _leaves_jax(params):
    leaves = [params['embed'], params['final_norm'], params['unembed']]
    for layer in params['layers']:
        leaves.extend(layer[name] for name in sorted(layer))
    return [np.asarray(x) for x in leaves]


# MoE + GQA (4 query heads on 2 kv heads), top-2 routing
MODELS = {
    'flash_top2': dict(moe_top_k=2, n_kv_heads=2),
    'blockwise_top2': dict(moe_top_k=2, n_kv_heads=2, attention='blockwise'),
}


def _tokens(seed, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, shape).astype(np.int32),
            rng.integers(0, 64, shape).astype(np.int32))


@pytest.mark.parametrize('name', sorted(MODELS))
def test_forward_and_loss_match(name):
    jcfg, tcfg = _configs(**MODELS[name])
    jp, tp = _params(jcfg, tcfg, seed=5)
    tokens, targets = _tokens(5)
    (ref, ref_aux), ref_loss = jax.jit(lambda p, x, y: (
        jtlm.forward(p, x, jcfg, return_aux=True),
        jtlm.loss_fn(p, x, y, jcfg)))(jp, jnp.asarray(tokens),
                                      jnp.asarray(targets))
    got, aux = ttlm.forward(tp, torch.from_numpy(tokens), tcfg,
                            return_aux=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-5,
                               rtol=1e-5)
    stats = {}
    loss = ttlm.loss_fn(tp, torch.from_numpy(tokens),
                        torch.from_numpy(targets), tcfg, moe_stats=stats)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(stats['aux']), float(ref_aux),
                               atol=1e-5, rtol=1e-5)
    assert int(stats['dropped']) >= 0


@pytest.mark.parametrize('name', sorted(MODELS))
def test_gradients_of_every_leaf_match(name):
    jcfg, tcfg = _configs(**MODELS[name])
    jp, tp = _params(jcfg, tcfg, seed=6)
    tokens, targets = _tokens(6)
    jgrads = jax.jit(jax.grad(jtlm.loss_fn), static_argnums=3)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    leaves = ttlm.parameters(tp)
    for p in leaves:
        p.requires_grad_(True)
    ttlm.loss_fn(tp, torch.from_numpy(tokens), torch.from_numpy(targets),
                 tcfg).backward()
    ref = _leaves_jax(jgrads)
    assert len(ref) == len(leaves) == 3 + 2 * 10
    for i, (a, b) in enumerate(zip(leaves, ref)):
        assert a.grad.shape == b.shape
        np.testing.assert_allclose(a.grad.numpy(), b, atol=1e-4, rtol=1e-4,
                                   err_msg='leaf %d' % i)


def test_one_adamw_step_matches_optax():
    jcfg, tcfg = _configs(**MODELS['flash_top2'])
    jp, tp = _params(jcfg, tcfg, seed=7)
    tokens, targets = _tokens(7)
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


@pytest.mark.parametrize('k', [1, 2])
def test_greedy_moe_decode_matches_jax(k):
    jcfg, tcfg = _configs(moe_top_k=k, n_kv_heads=2)
    jp, tp = _params(jcfg, tcfg, seed=8)
    prompt = np.random.default_rng(8).integers(0, 64, (3, 6)).astype(
        np.int32)
    ref = np.asarray(jtlm.generate(jp, jnp.asarray(prompt), jcfg, 10))
    got, logits = ttlm.generate(tp, torch.from_numpy(prompt), tcfg, 10,
                                return_logits=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    # teacher forcing with capacity for every unit drops nothing, as the
    # decode (capacity B * k a step) never does
    full = torch.cat([torch.from_numpy(prompt), got], 1)
    forced = ttlm.forward(tp, full[:, :-1], dataclasses.replace(
        tcfg, moe_capacity_factor=float(E)))[:, 5:]
    np.testing.assert_allclose(logits.numpy(), forced.detach().numpy(),
                               atol=1e-4, rtol=1e-4)
