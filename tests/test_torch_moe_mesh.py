"""The port's mixture-of-experts LM on a mesh against the JAX package's, on
the CPU: routing over the global token stream.

One train step of the MoE LM (vocab 128, d_model 64, 4 heads, 2 layers,
d_ff 128, float32, ``moe_capacity_factor`` 1.0, so experts overflow) on
gloo ranks (``launch_ranks`` over a ``FileStore`` under the test's temp
directory): ``{'expert': 2}`` top-2, ``{'data': 2, 'expert': 2}`` top-1
and top-2, and JAX's 8-rank ``{'data': 2, 'seq': 2, 'model': 2}`` MoE +
ring (``tests/test_models.py``'s ``test_train_step_moe_ring_full_mesh``),
against JAX's ``make_train_step(config, mesh)`` on the same axes of
virtual CPU devices from the same parameters and batch: the loss within
1e-5 and every leaf after the AdamW step within 1e-4; the forward's aux
loss against JAX's within 1e-5. Every layer's routing (each unit's
expert, slot and drop) equals the port's one process on the global
batch, exactly; and on each case's batch, routing each rank's tokens
alone would drop other units at layer 0 (checked from the same record),
so a per-rank router fails these tests.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import transformer_lm as jtlm
from petastorm_tpu.parallel import make_mesh as jmake_mesh

from petastorm_tpu_torch.models import transformer_lm as ttlm
from petastorm_tpu_torch.parallel import launch_ranks
from petastorm_tpu_torch.weights import params_from_jax

CASES = [({'expert': 2}, dict(n_experts=4, moe_top_k=2)),
         ({'data': 2, 'expert': 2}, dict(n_experts=4, moe_top_k=1)),
         ({'data': 2, 'expert': 2}, dict(n_experts=4, moe_top_k=2)),
         ({'data': 2, 'seq': 2, 'model': 2},
          dict(n_experts=2, moe_top_k=1, attention='ring'))]
IDS = ['expert2_top2', 'data2_expert2_top1', 'data2_expert2_top2',
       'data2_seq2_model2_ring']
BATCH = 4


def _configs(axes, extra):
    common = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2,
                  d_ff=128, max_seq_len=32 * axes.get('seq', 1),
                  attention='blockwise', moe_capacity_factor=1.0)
    common.update(extra)
    return (jtlm.TransformerConfig(dtype=jnp.float32, **common),
            dict(dtype=torch.float32, **common))


def _leaves(tree):
    out = [tree['embed'], tree['final_norm'], tree['unembed']]
    for layer in tree['layers']:
        out.extend(layer[name] for name in sorted(layer))
    return [np.asarray(x) for x in out]


@pytest.fixture(scope='module', params=range(len(CASES)), ids=IDS)
def stepped(request, tmp_path_factory):
    axes, extra = CASES[request.param]
    jcfg, tkw = _configs(axes, extra)
    params = jtlm.init(jax.random.PRNGKey(request.param), jcfg)
    rng = np.random.default_rng(10 + request.param)
    toks = rng.integers(0, 128, (BATCH, jcfg.max_seq_len + 1))
    toks = toks.astype(np.int32)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    n = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(axes, devices=jax.devices()[:n])
    optimizer, step = jtlm.make_train_step(jcfg, mesh)
    new, _, loss = step(params, optimizer.init(params), jnp.asarray(tokens),
                        jnp.asarray(targets))
    _, aux = jtlm.forward(params, jnp.asarray(tokens),
                          jtlm.TransformerConfig(**{
                              **jcfg.__dict__, 'attention': 'blockwise'}),
                          return_aux=True)
    host = jax.device_get(params)
    ranks = launch_ranks('torch_mesh_ranks:moe_step', n,
                         str(tmp_path_factory.mktemp('moe')),
                         args=(axes, tkw, host, tokens, targets),
                         timeout_s=240)
    # the port in one process on the global batch
    one = ttlm.TransformerConfig(**{**tkw, 'attention': 'blockwise'})
    stats = {'routes': []}
    with torch.no_grad():
        ttlm.forward(params_from_jax(host, one, device='cpu'),
                     torch.from_numpy(tokens), one, moe_stats=stats)
    return dict(axes=axes, cfg=one, loss=float(loss), aux=float(aux),
                leaves=_leaves(jax.device_get(new)), ranks=ranks,
                routes=[{k: v.numpy() for k, v in r.items()}
                        for r in stats['routes']])


@pytest.mark.timeout(300)
def test_moe_mesh_step_matches_jax(stepped):
    for r in stepped['ranks']:
        assert abs(r['losses'][0] - stepped['loss']) <= 1e-5 * max(
            1.0, abs(stepped['loss']))
        assert abs(r['aux'] - stepped['aux']) <= 1e-5 * max(
            1.0, stepped['aux'])
    got = stepped['ranks'][0]['leaves']
    assert len(got) == len(stepped['leaves'])
    for g, w in zip(got, stepped['leaves']):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def _per_rank_kept(route, axes, cfg):
    """Layer 0's drops had every data x seq rank routed its own tokens:
    the same experts (a token's choice depends on it alone), local
    capacity and order."""
    b, l = BATCH, cfg.max_seq_len
    k, e = cfg.moe_top_k, cfg.n_experts
    nd, ns = axes.get('data', 1), axes.get('seq', 1)
    expert = route['expert'].reshape(b, l, k)
    kept = np.zeros((b, l, k), bool)
    bl, ll = b // nd, l // ns
    for di in range(nd):
        for si in range(ns):
            local = expert[di * bl:(di + 1) * bl, si * ll:(si + 1) * ll]
            units = local.reshape(-1)
            cap = max(1, int(math.ceil(units.size / e
                                       * cfg.moe_capacity_factor)))
            seen = np.zeros(e, int)
            mask = np.zeros(units.size, bool)
            for u, ex in enumerate(units):
                mask[u] = seen[ex] < cap
                seen[ex] += 1
            kept[di * bl:(di + 1) * bl, si * ll:(si + 1) * ll] = \
                mask.reshape(local.shape)
    return kept.reshape(-1)


@pytest.mark.timeout(300)
def test_moe_mesh_routes_the_global_stream(stepped):
    want = stepped['routes']
    assert len(want) == stepped['cfg'].n_layers
    for r in stepped['ranks']:
        for got, ref in zip(r['routes'], want):
            for key in ('expert', 'slot', 'kept'):
                np.testing.assert_array_equal(got[key], ref[key])
    assert not all(w['kept'].all() for w in want), 'no unit was dropped'
    if len([a for a in ('data', 'seq') if stepped['axes'].get(a, 1) > 1]):
        per_rank = _per_rank_kept(want[0], stepped['axes'], stepped['cfg'])
        assert (per_rank != want[0]['kept']).any(), (
            'routing per rank would drop the same units: the batch does '
            'not tell global routing from per-rank routing')
