"""Parity of the port's attention (petastorm_tpu_torch.ops.attention) with the
JAX package's Pallas flash kernels run in interpret mode.

The same numpy inputs go through ``_pallas_flash`` / ``_pallas_flash_backward``
(``interpret=True``) and through the port's CPU path, which is the plain
PyTorch twin of each CUDA kernel (K1 forward, K2 dq, K3 dk/dv). All float32;
tolerance ``atol = rtol = 2e-5`` (the two sum in different block orders:
Pallas blocks of 16, the twins blocks of 512). The cases run at head dim 16,
and again at ``HEAD_DIMS`` (32 and 128, which the kernels are built for, and
80, which a CUDA launch pads to 128). A CUDA-marked test holds the kernels
themselves against the twins on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops.attention import (_pallas_flash,
                                         _pallas_flash_backward,
                                         flash_attention as jax_flash)
from petastorm_tpu_torch.ops import attention as tatt
from petastorm_tpu_torch.ops import kernels

TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK = 16
HEAD_DIMS = [32, 80, 128]

# (name, q heads, kv heads, Lq, Lk, causal, window, segmented)
CASES = [
    ('causal', 2, 2, 40, 40, True, None, False),
    ('non_causal_cross', 2, 2, 40, 24, False, None, False),
    ('ragged', 2, 2, 37, 37, True, None, False),
    ('gqa', 4, 2, 40, 40, True, None, False),
    ('segments_masked_row', 2, 2, 40, 40, True, None, True),
    ('window', 2, 2, 40, 40, True, 8, False),
]


def _inputs(seed, h, hkv, lq, lk, d=16, segmented=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((1, hkv, lk, d)).astype(np.float32)
    v = rng.standard_normal((1, hkv, lk, d)).astype(np.float32)
    do = rng.standard_normal((1, h, lq, d)).astype(np.float32)
    segs = {}
    if segmented:
        # two documents; kv position 0 carries an id no query has, so query
        # row 0 (causal: sees only k=0) is fully masked
        seg_q = np.where(np.arange(lq) < lq // 2, 0, 1)[None].astype(np.int32)
        seg_kv = np.where(np.arange(lk) < lk // 2, 0, 1)[None].astype(np.int32)
        seg_kv[0, 0] = 7
        segs = {'segment_ids': seg_q, 'kv_segment_ids': seg_kv}
    return q, k, v, do, segs


def _jax_segs(segs):
    return {k: jnp.asarray(v) for k, v in segs.items()}


def _torch_segs(segs):
    return {k: torch.from_numpy(v) for k, v in segs.items()}


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_forward_matches_pallas_interpret(case):
    _check_forward(case, 16)


@pytest.mark.parametrize('d', HEAD_DIMS)
@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_forward_matches_pallas_interpret_head_dims(case, d):
    _check_forward(case, d)


def _check_forward(case, d):
    _, h, hkv, lq, lk, causal, window, segmented = case
    q, k, v, _, segs = _inputs(1, h, hkv, lq, lk, d, segmented=segmented)
    o_ref, lse_ref = _pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, BLOCK, BLOCK,
        interpret=True, with_lse=True, window=window, **_jax_segs(segs))
    o, lse = tatt.flash_attention_with_lse(*_t(q, k, v), causal=causal,
                                           window=window, **_torch_segs(segs))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)
    if segmented:   # the fully masked row: o = 0, lse = -1e30
        assert lse[0, 0, 0] == torch.tensor(kernels.NEG_INF)
        assert not o[0, :, 0].any()


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_backward_matches_pallas_interpret(case):
    _check_backward(case, 16)


@pytest.mark.parametrize('d', HEAD_DIMS)
@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_backward_matches_pallas_interpret_head_dims(case, d):
    _check_backward(case, d)


def _check_backward(case, d):
    _, h, hkv, lq, lk, causal, window, segmented = case
    q, k, v, do, segs = _inputs(2, h, hkv, lq, lk, d, segmented=segmented)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = _pallas_flash(jq, jk, jv, causal, BLOCK, BLOCK, interpret=True,
                           with_lse=True, window=window, **_jax_segs(segs))
    ref = _pallas_flash_backward(jq, jk, jv, o, lse, jdo, causal=causal,
                                 block_q=BLOCK, block_k=BLOCK, interpret=True,
                                 window=window, **_jax_segs(segs))
    got = tatt.flash_backward(*_t(q, k, v, np.array(o), np.array(lse),
                                  do), causal=causal, window=window,
                              **_torch_segs(segs))
    for name, a, b in zip(('dq', 'dk', 'dv'), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


AUTOGRAD_CASES = [CASES[0], CASES[3], CASES[4]]
AUTOGRAD_IDS = ['causal', 'gqa', 'segments_masked_row']


@pytest.mark.parametrize('case', AUTOGRAD_CASES, ids=AUTOGRAD_IDS)
def test_autograd_matches_jax_grad(case):
    _check_autograd(case, 16)


@pytest.mark.parametrize('d', HEAD_DIMS)
@pytest.mark.parametrize('case', AUTOGRAD_CASES, ids=AUTOGRAD_IDS)
def test_autograd_matches_jax_grad_head_dims(case, d):
    _check_autograd(case, d)


def _check_autograd(case, d):
    _, h, hkv, lq, lk, causal, window, segmented = case
    q, k, v, w, segs = _inputs(3, h, hkv, lq, lk, d, segmented=segmented)

    def jax_loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
                      backend='interpret', window=window, **_jax_segs(segs))
        return jnp.sum(o * jnp.asarray(w))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    o = tatt.flash_attention(tq, tk, tv, causal=causal, window=window,
                             **_torch_segs(segs))
    (o * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip(('dq', 'dk', 'dv'), (tq.grad, tk.grad, tv.grad),
                          ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_blockwise_matches_flash_forward():
    q, k, v, _, segs = _inputs(4, 2, 2, 40, 40, segmented=True)
    tq, tk, tv = _t(q, k, v)
    ref, _ = tatt.flash_attention_with_lse(tq, tk, tv, causal=True,
                                           **_torch_segs(segs))
    got = tatt.blockwise_attention(tq, tk, tv, causal=True, block_k=16,
                                   **_torch_segs(segs))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_cpu_wrappers_count_no_launch():
    kernels.reset_launch_counts()
    q, k, v, do, _ = _inputs(5, 2, 2, 40, 40)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tatt.flash_attention(tq, tk, tv).sum().backward()
    assert kernels.LAUNCHES == {'flash_fwd': 0, 'flash_bwd_dq': 0,
                                'flash_bwd_dkdv': 0, 'normalize': 0}


def test_invalid_geometry_raises():
    q = torch.zeros(1, 3, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match='GQA'):
        tatt.flash_attention(q, k, k)
    with pytest.raises(ValueError, match='window requires causal'):
        tatt.flash_attention(q, q, q, causal=False, window=4)


def _no_keys(seed, dtype=torch.float32):
    """q, k, v, do, lse, delta of 2 heads x 40 queries and no kv position
    (lse as the forward leaves it: -1e30)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((2, 40, 64)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((2, 40, 64)).astype(np.float32))
    kv = torch.zeros(2, 0, 64)
    lse = torch.full((2, 40), kernels.NEG_INF)
    return ([x.to(dtype) for x in (q, kv, kv.clone(), do)]
            + [lse, torch.zeros(2, 40)])


def test_dq_twin_is_zero_without_keys():
    """No kv position: every p is 0, so the twin's dq is zeros."""
    dq = kernels.flash_bwd_dq_plain(*_no_keys(7), n_heads=2, n_kv_heads=2)
    assert dq.shape == (2, 40, 64) and not dq.any()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_dq_without_keys_is_zero_without_launch(dtype):
    """Lk = 0: the CUDA wrapper returns zeros and launches nothing (a TMA
    map of 0 rows cannot be encoded; run on a GPU host)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    ops = [x.cuda() for x in _no_keys(7, getattr(torch, dtype))]
    kernels.reset_launch_counts()
    dq = kernels.flash_bwd_dq(*ops, n_heads=2, n_kv_heads=2)
    assert kernels.LAUNCHES['flash_bwd_dq'] == 0
    assert dq.shape == (2, 40, 64) and dq.is_cuda and not dq.any()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_kernels_match_plain_twins(dtype):
    """K1-K3 on the card against their plain twins run in float32 on the CPU
    on the same values: atol = rtol = 1e-4 for float32 outputs. In bfloat16,
    o (K1), dq (K2) and dk, dv (K3), which the tensor-core kernels compute
    from p and ds rounded to bf16, within ``kernels.flash_gate_limit`` (run
    on a GPU host)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    dt = getattr(torch, dtype)
    q, k, v, do, segs = _inputs(6, 4, 2, 300, 300, d=64, segmented=True)
    dev = [torch.from_numpy(x).cuda().to(dt) for x in (q, k, v, do)]
    host = [x.cpu().float() for x in dev]
    tsegs = _torch_segs(segs)
    kw = dict(causal=True, window=128)
    dsegs = {n: s.cuda() for n, s in tsegs.items()}

    o, lse = tatt.flash_attention_with_lse(*dev[:3], **kw, **dsegs)
    o_ref, lse_ref = tatt.flash_attention_with_lse(*host[:3], **kw, **tsegs)
    torch.testing.assert_close(lse.cpu(), lse_ref, atol=1e-4, rtol=1e-4)
    grads = tatt.flash_backward(*dev[:3], o, lse, dev[3], **kw, **dsegs)
    ref = tatt.flash_backward(*host[:3], o.cpu().float(), lse.cpu(), host[3],
                              **kw, **tsegs)
    if dt == torch.float32:
        for got, want in zip((o,) + tuple(grads), (o_ref,) + tuple(ref)):
            torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        return
    # bounds of the one rounding of p / ds (the backward's from the o and
    # lse it was given), per q head, summed per group for dk / dv
    dims = tatt._FlashDims(host[0].shape, host[1].shape)
    seg_q, seg_kv = dims.segments(tsegs['segment_ids'],
                                  tsegs['kv_segment_ids'], 'cpu')
    flat_o = dims.flat_q(o.cpu().float())
    flat_lse = lse.cpu().reshape(dims.flat, dims.q_len)
    bounds = kernels.flash_rounding_bounds(
        dims.flat_q(host[0]), dims.flat_kv(host[1]), dims.flat_kv(host[2]),
        dims.flat_q(host[3]), flat_lse,
        (dims.flat_q(host[3]) * flat_o).sum(-1), n_heads=dims.n_heads,
        n_kv_heads=dims.n_kv_heads, causal=True, window=128, seg_q=seg_q,
        seg_kv=seg_kv)
    checks = [('o', o, o_ref, dims.unflat_q(bounds['o'])),
              ('dq', grads[0], ref[0], dims.unflat_q(bounds['dq']))]
    for name, got, want in zip(('dk', 'dv'), grads[1:], ref[1:]):
        summed = dims.sum_head_groups(bounds[name], torch.float32)
        checks.append((name, got, want, dims.unflat_kv(summed)))
    for name, got, want, bound in checks:
        limit = kernels.flash_gate_limit(want, bound, got.dtype)
        bad = (got.cpu().float() - want).abs() > limit
        assert not bool(bad.any()), '%s: %d elements beyond the gate' % (
            name, int(bad.sum()))
