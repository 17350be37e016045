"""Head dims of the port's flash kernels (K1 forward, K2 dq, K3 dk/dv).

The kernels are instantiated at ``kernels.HEAD_DIMS`` (bf16 32, 64, 128;
float32 16, 32, 64, 128). A launch at another head dim up to 128 pads q, k,
v and do with zero columns to the next instantiated one, keeps the scale of
the true head dim and cuts the outputs back. On the CPU the padding is held
against the plain twins at the true head dim (float32, within 1e-6: zero
columns add exact zeros, but the sums may be blocked differently), and the
head-dim table and its raise past 128 are checked. On the card (``-m
cuda``) every new instantiation and the padded head dims 80 and 96 are held
against the twins run in float32 on the same values: atol = rtol = 1e-4 for
float32 outputs, ``kernels.flash_gate_limit`` for the bf16 tensor-core
outputs; K4 at 8 channels is bit-equal to its twin. This file imports no
JAX, so its card tests run where JAX is not installed.
"""

import math

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops import kernels

PAD_TOL = dict(atol=1e-6, rtol=1e-6)

# (name, q heads, kv heads, Lq, Lk, causal, window, segmented)
CASES = [
    ('causal_ragged', 2, 2, 300, 300, True, None, False),
    ('non_causal_cross', 2, 2, 300, 170, False, None, False),
    ('gqa', 8, 2, 256, 256, True, None, False),
    ('segments_masked_row', 2, 2, 300, 300, True, None, True),
    ('window', 2, 2, 512, 512, True, 128, False),
]
SMALL_CASES = [('causal', 2, 2, 40, 40, True, None, False),
               ('gqa_segments', 4, 2, 37, 37, True, None, True),
               ('non_causal_window_free', 2, 2, 40, 24, False, None, False)]


def _operands(seed, case, d):
    """float32 q, k, v, do of one batch row, and the kernels' keywords."""
    _, h, hkv, lq, lk, causal, window, segmented = case
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q, k, v, do = rnd(h, lq, d), rnd(hkv, lk, d), rnd(hkv, lk, d), rnd(h, lq,
                                                                         d)
    kw = dict(n_heads=h, n_kv_heads=hkv, causal=causal, window=window)
    if segmented:
        seg_q = (torch.arange(lq) >= lq // 2).int()
        seg_kv = (torch.arange(lk) >= lk // 2).int()
        seg_kv[0] = 7                  # q row 0 sees only k=0: fully masked
        kw['seg_q'] = seg_q.expand(h, lq).contiguous()
        kw['seg_kv'] = seg_kv.expand(hkv, lk).contiguous()
    return q, k, v, do, kw


def test_head_dim_table():
    """Each instantiated head dim launches as itself; any other up to 128
    as the next one; past 128 raises naming 128."""
    for dtype, widths in kernels.HEAD_DIMS.items():
        for width in widths:
            assert kernels.launch_head_dim(width, dtype) == width
    assert kernels.launch_head_dim(80, torch.bfloat16) == 128
    assert kernels.launch_head_dim(48, torch.float32) == 64
    assert kernels.launch_head_dim(8, torch.bfloat16) == 32
    assert kernels.launch_head_dim(8, torch.float32) == 16
    for dtype in kernels.HEAD_DIMS:
        with pytest.raises(ValueError, match='at most 128'):
            kernels.launch_head_dim(192, dtype)


def test_pad_and_unpad_shapes():
    x = torch.ones(2, 5, 80)
    (p,) = kernels.pad_heads(128, x)
    assert p.shape == (2, 5, 128) and p.is_contiguous()
    assert torch.equal(p[..., :80], x) and not p[..., 80:].any()
    assert kernels.pad_heads(80, x)[0] is x
    (u,) = kernels.unpad(80, p)
    assert torch.equal(u, x) and u.is_contiguous()


@pytest.mark.parametrize('d', [48, 80, 96])
@pytest.mark.parametrize('case', SMALL_CASES, ids=[c[0] for c in SMALL_CASES])
def test_padded_forward_equals_twin_at_true_head_dim(case, d):
    """Pad to the launch width, run the twin with the true head dim's
    scale, cut back: o and lse equal the twin at the true head dim."""
    q, k, v, _, kw = _operands(d, case, d)
    width = kernels.launch_head_dim(d, torch.bfloat16)
    o_ref, lse_ref = kernels.flash_fwd_plain(q, k, v, **kw)
    o, lse = kernels.flash_fwd_plain(*kernels.pad_heads(width, q, k, v),
                                     scale=1.0 / math.sqrt(d), **kw)
    (o,) = kernels.unpad(d, o)
    torch.testing.assert_close(o, o_ref, **PAD_TOL)
    torch.testing.assert_close(lse, lse_ref, **PAD_TOL)


@pytest.mark.parametrize('d', [48, 80, 96])
@pytest.mark.parametrize('case', SMALL_CASES, ids=[c[0] for c in SMALL_CASES])
def test_padded_backward_equals_twin_at_true_head_dim(case, d):
    """The same for dq (K2) and dk, dv (K3), given the true head dim's o,
    lse and delta; the padded columns of dq, dk and dv are exact zeros."""
    q, k, v, do, kw = _operands(100 + d, case, d)
    width = kernels.launch_head_dim(d, torch.bfloat16)
    o, lse = kernels.flash_fwd_plain(q, k, v, **kw)
    delta = (do * o).sum(-1)
    ref = (kernels.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
           *kernels.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, **kw))
    padded = kernels.pad_heads(width, q, k, v, do)
    scale = 1.0 / math.sqrt(d)
    wide = (kernels.flash_bwd_dq_plain(*padded, lse, delta, scale=scale, **kw),
            *kernels.flash_bwd_dkdv_plain(*padded, lse, delta, scale=scale,
                                          **kw))
    for name, got, want in zip(('dq', 'dk', 'dv'), wide, ref):
        assert not got[..., d:].any(), name
        torch.testing.assert_close(kernels.unpad(d, got)[0], want,
                                   msg=name, **PAD_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')


def _beyond(got, ref, bound):
    """Elements of ``got`` beyond the gate of the twin's ``ref``: the bf16
    gate where ``bound`` is given, else atol = rtol = 1e-4."""
    got, ref = got.cpu().float(), ref.float()
    assert bool(torch.isfinite(got).all())
    if bound is None:
        limit = 1e-4 * (1 + ref.abs())
    else:
        limit = kernels.flash_gate_limit(ref, bound, torch.bfloat16)
    return int(((got - ref).abs() > limit).sum())


def _card_case(case, d, dtype, seed):
    """K1-K3 on the card against their float32 twins on the CPU on the
    same values; returns {output: elements beyond the gate}."""
    q, k, v, do, kw = _operands(seed, case, d)
    q, k, v, do = (x.to(dtype).float() for x in (q, k, v, do))
    o_ref, lse_ref = kernels.flash_fwd_plain(q, k, v, **kw)
    delta = (do * o_ref).sum(-1)
    dq_ref = kernels.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = kernels.flash_bwd_dkdv_plain(q, k, v, do, lse_ref, delta,
                                                  **kw)
    bounds = ({} if dtype == torch.float32 else
              kernels.flash_rounding_bounds(q, k, v, do, lse_ref, delta,
                                            **kw))
    dev = [x.cuda().to(dtype) for x in (q, k, v, do)]
    kwd = {n: (t.cuda() if torch.is_tensor(t) else t) for n, t in kw.items()}
    lse_d, delta_d = lse_ref.cuda(), delta.cuda()
    kernels.reset_launch_counts()
    o, lse = kernels.flash_fwd(*dev[:3], **kwd)
    dq = kernels.flash_bwd_dq(*dev, lse_d, delta_d, **kwd)
    dk, dv = kernels.flash_bwd_dkdv(*dev, lse_d, delta_d, **kwd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {'flash_fwd': 1, 'flash_bwd_dq': 1,
                                'flash_bwd_dkdv': 1, 'normalize': 0}
    assert o.shape == q.shape and dq.shape == q.shape and dk.shape[-1] == d
    out = {'lse': _beyond(lse, lse_ref, None)}
    for name, got, ref in (('o', o, o_ref), ('dq', dq, dq_ref),
                           ('dk', dk, dk_ref), ('dv', dv, dv_ref)):
        out[name] = _beyond(got, ref, bounds.get(name))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('d,dtype', [(32, 'bfloat16'), (128, 'bfloat16'),
                                     (32, 'float32'), (128, 'float32'),
                                     (80, 'bfloat16'), (96, 'float32')])
@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_cuda_head_dims_match_plain_twins(case, d, dtype):
    """Each new instantiation (and a padded head dim) of K1-K3 against the
    twins in every edge case (run on a GPU host)."""
    _needs_card()
    beyond = _card_case(case, d, getattr(torch, dtype), seed=d)
    assert not any(beyond.values()), beyond


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_cuda_head_dim_past_128_raises(dtype):
    """A CUDA launch at head dim 192 raises naming 128, and launches
    nothing (run on a GPU host)."""
    _needs_card()
    x = torch.zeros(2, 64, 192, device='cuda', dtype=getattr(torch, dtype))
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match='at most 128'):
        kernels.flash_fwd(x, x, x, n_heads=2, n_kv_heads=2)
    assert kernels.LAUNCHES['flash_fwd'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_cuda_normalize_eight_channels_bit_equal(dtype):
    """K4 at C = 8 with a distinct mean and std a channel, bit for bit
    against its twin, over every uint8 value in every channel (run on a GPU
    host)."""
    _needs_card()
    v = np.arange(256, dtype=np.uint8).reshape(2, 16, 8)
    images = np.stack([np.roll(v, i) for i in range(8)], axis=-1)
    mean = torch.linspace(0.1, 0.8, 8)
    inv = 1.0 / torch.linspace(0.2, 0.5, 8)
    x = torch.from_numpy(images).cuda()
    dt = getattr(torch, dtype)
    kernels.reset_launch_counts()
    got = kernels.normalize(x, mean, inv, dt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['normalize'] == 1
    ref = kernels.normalize_plain(torch.from_numpy(images), mean, inv, dt)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.timeout(300)
def test_phase_29_northstar_lm_rehearses_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 29 (d) at small widths on the CPU: the
    north-star LM on flash and on blockwise attention, fed through
    ``prefetch_batches``; the first batch's flash loss and gradients
    against blockwise; the step counts; no kernel launches (the twins
    run)."""
    import argparse

    import chip_smoke
    from petastorm_tpu_torch.models import transformer_lm as tlm
    widths = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2,
                  d_ff=128, max_seq_len=32)
    url = 'file://' + str(tmp_path / 'northstar')
    chip_smoke.write_token_rows(np, url, 256, 33, 512, 0)
    losses = {}
    for mode in ('flash', 'blockwise'):
        report, launches, losses[mode] = chip_smoke.northstar_lm(
            torch, np, tlm, kernels, argparse.Namespace(seed=0), url, mode,
            device='cpu', widths=widths)
        assert report.steps == chip_smoke.NS_STEPS
        assert report.samples == chip_smoke.NS_STEPS * chip_smoke.NS_BATCH
        assert not any(launches.values())
    assert math.isfinite(losses['flash'])
    assert abs(losses['flash'] - losses['blockwise']) < 1e-2
