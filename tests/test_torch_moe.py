"""The port's mixture-of-experts LM against the JAX model.

Tiny float32 config (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64,
4 experts), the parameters drawn by the JAX ``init`` and loaded through
``params_from_jax``, inputs made with numpy from a seed. The router must
choose JAX's experts, ties to the lower index; the sparse dispatch must
give JAX's output and aux loss with ample capacity, with drops at the
default factor 1.25, and at capacity 1 (tolerance 1e-5, float32 sums in
other orders); a dropped token gets zero gradient (1e-4). The decode's
capacity never drops, the parameters load with their shapes checked, and a
bad ``moe_top_k`` raises JAX's error. The whole model is in
``test_torch_moe_lm.py``.
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


def _layer_input(seed, shape=(2, 16, 32)):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


def _leaves_jax(params):
    leaves = [params['embed'], params['final_norm'], params['unembed']]
    for layer in params['layers']:
        leaves.extend(layer[name] for name in sorted(layer))
    return [np.asarray(x) for x in leaves]


@pytest.mark.parametrize('k', [1, 2])
def test_router_matches_jax_and_breaks_ties_low(k):
    logits = np.random.default_rng(0).standard_normal((64, E)).astype(
        np.float32)
    logits[:4] = [[1, 3, 3, 0], [2, 2, 2, 2], [0, 0, 5, 5], [4, 1, 4, 1]]
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    assert probs[0, 1] == probs[0, 2] and probs[1, 0] == probs[1, 3]
    ref_idx, ref_p = jtlm._moe_router(jnp.asarray(probs), k)
    got_idx, got_p = ttlm._moe_router(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), atol=1e-7,
                               rtol=1e-7)
    want = [[1], [0], [2], [0]] if k == 1 else [[1, 2], [0, 1], [2, 3],
                                                [0, 2]]
    np.testing.assert_array_equal(got_idx[:4].numpy(), want)


@pytest.mark.parametrize('k', [1, 2])
def test_dense_oracle_matches_jax(k):
    jcfg, tcfg = _configs(moe_top_k=k)
    jp, tp = _params(jcfg, tcfg)
    x = _layer_input(1)
    ref = jtlm._moe_ffn_dense(jnp.asarray(x), jp['layers'][0], jcfg)
    got = ttlm._moe_ffn_dense(torch.from_numpy(x), tp['layers'][0], tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# (top_k, capacity factor, explicit capacity, whether units drop)
SPARSE = {
    'top1_ample': (1, float(E), None, False),
    'top2_ample': (2, float(E), None, False),
    'top1_default_drops': (1, 1.25, None, True),
    'top2_default_drops': (2, 1.25, None, True),
    'top2_capacity_1': (2, 1.25, 1, True),
}


@pytest.mark.parametrize('case', sorted(SPARSE))
def test_sparse_dispatch_matches_jax(case):
    k, factor, capacity, drops = SPARSE[case]
    jcfg, tcfg = _configs(moe_top_k=k, moe_capacity_factor=factor)
    jp, tp = _params(jcfg, tcfg, seed=2)
    # skew the router towards expert 0 (inputs centred at +0.5) so the
    # default capacity overflows
    gate = np.array(jp['layers'][0]['gate'])
    gate[:, 0] += 0.3
    jp['layers'][0]['gate'] = jnp.asarray(gate)
    tp['layers'][0]['gate'] = torch.from_numpy(gate)
    x = _layer_input(3) + np.float32(0.5)
    ref, ref_aux = jtlm._moe_ffn(jnp.asarray(x), jp['layers'][0], jcfg,
                                 capacity=capacity)
    stats = {}
    got, aux = ttlm._moe_ffn(torch.from_numpy(x), tp['layers'][0], tcfg,
                             capacity=capacity, stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-6,
                               rtol=1e-6)
    assert (int(stats['dropped']) > 0) == drops
    dense = ttlm._moe_ffn_dense(torch.from_numpy(x), tp['layers'][0], tcfg)
    assert torch.allclose(got, dense, atol=1e-5, rtol=1e-5) == (not drops)


def test_dropped_token_gets_zero_gradient():
    """Capacity 1, every token on expert 0 (top-1): only the first token is
    kept. The others' FFN output is zero and so is their gradient, as the
    JAX ``.at[].set`` dispatch gives."""
    jcfg, tcfg = _configs(moe_top_k=1)
    jp, tp = _params(jcfg, tcfg)
    gate = np.zeros((32, E), np.float32)
    gate[:, 0] = 10.0
    jlayer = dict(jp['layers'][0], gate=jnp.asarray(gate))
    tlayer = dict(tp['layers'][0], gate=torch.from_numpy(gate))
    x = _layer_input(4, (1, 8, 32)) + np.float32(0.5)
    ref = jax.jit(jax.grad(lambda v: jnp.sum(jtlm._moe_ffn(
        v, jlayer, jcfg, capacity=1)[0])))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = ttlm._moe_ffn(xt, tlayer, tcfg, capacity=1)
    y.sum().backward()
    assert not bool(y[0, 1:].any())
    assert not bool(xt.grad[0, 1:].any()) and bool(xt.grad[0, 0].any())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_moe_decode_capacity_never_drops():
    """Every token on expert 0 at capacity factor 0.25: the decode's
    capacity (all units of the step) matches the dense oracle, and the
    default capacity drops, in the port as in JAX."""
    jcfg, tcfg = _configs(moe_top_k=1, moe_capacity_factor=0.25)
    jp, tp = _params(jcfg, tcfg, seed=1)
    gate = np.zeros((32, E), np.float32)
    gate[:, 0] = 10.0
    jlayer = dict(jp['layers'][0], gate=jnp.asarray(gate))
    tlayer = dict(tp['layers'][0], gate=torch.from_numpy(gate))
    x = _layer_input(2, (4, 1, 32))
    oracle = ttlm._moe_ffn_dense(torch.from_numpy(x), tlayer, tcfg)
    no_drop, _ = ttlm._moe_ffn(torch.from_numpy(x), tlayer, tcfg,
                               capacity=4 * tcfg.moe_top_k)
    dropped, _ = ttlm._moe_ffn(torch.from_numpy(x), tlayer, tcfg)
    ref, _ = jtlm._moe_ffn(jnp.asarray(x), jlayer, jcfg,
                           capacity=4 * jcfg.moe_top_k)
    np.testing.assert_allclose(no_drop.numpy(), oracle.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(no_drop.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    assert not torch.allclose(dropped, oracle, atol=1e-5, rtol=1e-5)
    # the decode layer routes with that capacity
    cache = ttlm.init_kv_cache(tcfg, 4, 2, device='cpu')[0]
    jcache = jtlm.init_kv_cache(jcfg, 4, 2)[0]
    out, _ = ttlm._decode_layer(torch.from_numpy(x), tlayer, tcfg, cache, 0)
    jout, _ = jtlm._decode_layer(jnp.asarray(x), jlayer, jcfg, jcache, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


def test_params_from_jax_checks_moe_leaves():
    jcfg, tcfg = _configs(moe_top_k=2)
    jp = jax.device_get(jtlm.init(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(jp, tcfg, device='cpu')
    layer = tp['layers'][1]
    assert tuple(layer['gate'].shape) == (32, E)
    assert tuple(layer['w_up'].shape) == (E, 32, 64)
    assert tuple(layer['w_down'].shape) == (E, 64, 32)
    bad = dict(jp, layers=[dict(jp['layers'][0],
                                w_down=np.zeros((E, 32, 64), np.float32)),
                           jp['layers'][1]])
    with pytest.raises(ValueError, match=r'layers\[0\].w_down has shape'):
        params_from_jax(bad, tcfg, device='cpu')
    extra = dict(jp, layers=[dict(jp['layers'][0], router_bias=np.zeros(E)),
                             jp['layers'][1]])
    with pytest.raises(ValueError, match='router_bias'):
        params_from_jax(extra, tcfg, device='cpu')
    dense_cfg = dataclasses.replace(tcfg, n_experts=0)
    with pytest.raises(ValueError, match='gate'):
        params_from_jax(jp, dense_cfg, device='cpu')
    # the port's own draw has the same structure and shapes
    own = ttlm.init(tcfg, torch.Generator().manual_seed(0), device='cpu')
    assert {n: tuple(t.shape) for n, t in own['layers'][0].items()} == {
        n: tuple(t.shape) for n, t in layer.items()}


@pytest.mark.parametrize('top_k', [0, 5])
def test_bad_moe_top_k_raises_as_jax(top_k):
    jcfg, tcfg = _configs(moe_top_k=top_k)
    with pytest.raises(ValueError) as ref:
        jtlm.init(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError) as got:
        ttlm.init(tcfg, torch.Generator().manual_seed(0), device='cpu')
    assert str(got.value) == str(ref.value)


@pytest.mark.cuda
def test_cuda_sparse_dispatch_matches_cpu():
    """The MoE FFN on the card (float32, no TF32) against the port on the
    CPU: output and aux within 1e-5, the same units dropped, and the same
    input gradient within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the card path has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tcfg = _configs(moe_top_k=2)
    tp = ttlm.init(tcfg, torch.Generator().manual_seed(0), device='cpu')
    layer = dict(tp['layers'][0])
    # skewed towards expert 0 (inputs centred at +0.5), so units drop
    layer['gate'] = layer['gate'] + torch.tensor([0.3, 0.0, 0.0, 0.0])
    x = torch.from_numpy(_layer_input(9, (4, 64, 32)) + np.float32(0.5))
    results = []
    for device in ('cpu', 'cuda'):
        xd = x.to(device, copy=True).requires_grad_(True)
        stats = {}
        y, aux = ttlm._moe_ffn(xd, {n: w.to(device) for n, w in
                                    layer.items()}, tcfg, stats=stats)
        y.square().sum().backward()
        results.append((y.detach().cpu(), float(aux), int(stats['dropped']),
                        xd.grad.cpu()))
    (y0, a0, d0, g0), (y1, a1, d1, g1) = results
    assert d0 == d1 > 0, (d0, d1)
    torch.testing.assert_close(y1, y0, atol=1e-5, rtol=1e-5)
    assert abs(a1 - a0) <= 1e-5 * (1 + abs(a0))
    torch.testing.assert_close(g1, g0, atol=1e-4, rtol=1e-4)
