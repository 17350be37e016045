"""Head dims of the port's flash kernels (K1 forward, K2 dq, K3 dk/dv).

The kernels are instantiated at ``kernels.HEAD_DIMS`` (bf16 32, 64, 128,
256; float32 16, 32, 64, 128, 256), and past 256 the wide kernels take any
multiple of 64. A launch at another head dim pads q, k, v and do with zero
columns to the next width the kernels take, keeps the scale of the true
head dim and cuts the outputs back. On the CPU the padding is held against
the plain twins at the true head dim (float32, within 1e-6: zero columns
add exact zeros, but the sums may be blocked differently), and the
head-dim table and its raise past ``kernels.MAX_HEAD_DIM`` are checked. On
the card (``-m cuda``) every instantiation past 16 (32, 128, 256), the wide
kernels at 320, 512, 576 and 1024, and the padded head dims 16 and 24
(bf16, launched at 32), 80, 96, 160, 192 and 300 are held against the twins
run in float32 on the same values: atol = rtol = 1e-4 for float32 outputs,
``kernels.flash_gate_limit`` for the bf16 tensor-core outputs; K2 and K3 at
head dim 32 give bit-equal outputs from two launches; K4 at 8 channels is
bit-equal to its twin.
This file imports no JAX, so its card tests run where JAX is not
installed.
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
    ('mqa', 8, 1, 256, 256, True, None, False),
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
    """Each instantiated head dim launches as itself, 256 among them; any
    other up to 256 as the next one (192 at 256); past 256 at the next
    multiple of 64 (257 and 300 at 320, 576 as itself, 1000 at 1024), up to
    the grid's limit of 65,535 slices of 128 columns, past which it raises
    naming that limit."""
    for dtype, widths in kernels.HEAD_DIMS.items():
        assert 256 in widths and kernels.WIDE_STEP == 64
        for width in widths:
            assert kernels.launch_head_dim(width, dtype) == width
        assert kernels.launch_head_dim(192, dtype) == 256
        assert kernels.launch_head_dim(129, dtype) == 256
        for d, width in ((257, 320), (300, 320), (320, 320), (512, 512),
                         (576, 576), (1000, 1024), (1024, 1024)):
            assert kernels.launch_head_dim(d, dtype) == width
        assert kernels.MAX_HEAD_DIM == 65535 * 128
        assert (kernels.launch_head_dim(kernels.MAX_HEAD_DIM, dtype)
                == kernels.MAX_HEAD_DIM)
        with pytest.raises(ValueError, match='grid limit of 65535'):
            kernels.launch_head_dim(kernels.MAX_HEAD_DIM + 1, dtype)
    assert kernels.launch_head_dim(80, torch.bfloat16) == 128
    assert kernels.launch_head_dim(48, torch.float32) == 64
    assert kernels.launch_head_dim(8, torch.bfloat16) == 32
    assert kernels.launch_head_dim(8, torch.float32) == 16


def test_pad_and_unpad_shapes():
    x = torch.ones(2, 5, 80)
    (p,) = kernels.pad_heads(128, x)
    assert p.shape == (2, 5, 128) and p.is_contiguous()
    assert torch.equal(p[..., :80], x) and not p[..., 80:].any()
    assert kernels.pad_heads(80, x)[0] is x
    (u,) = kernels.unpad(80, p)
    assert torch.equal(u, x) and u.is_contiguous()


PADDED = [48, 80, 96, 160, 192, 224, 300]


@pytest.mark.parametrize('d', PADDED)
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


@pytest.mark.parametrize('d', PADDED)
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


@pytest.mark.parametrize('case', SMALL_CASES, ids=[c[0] for c in SMALL_CASES])
def test_padded_wide_head_dim_is_bit_exact(case):
    """D 600, launched at 640: with q, k, v and do multiples of 1/4 in [-2,
    2], every sum over the head dim is exact in float32 (its partial sums
    are multiples of 1/16 below 2^14), so the 40 zero columns change no
    bit: o, lse, dq, dk and dv of the padded twins, cut back, equal the
    twins at the true head dim, and the padded columns are zeros. (On
    normal operands the two sums over 600 and 640 columns are blocked
    differently and differ by float32 rounding, about 3e-6.)"""
    d = 600
    width = kernels.launch_head_dim(d, torch.bfloat16)
    assert width == 640
    q, k, v, do, kw = _operands(d, case, d)
    q, k, v, do = (torch.round(x * 4).clamp(-8, 8) / 4 for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    o_ref, lse_ref = kernels.flash_fwd_plain(q, k, v, **kw)
    delta = (do * o_ref).sum(-1)
    ref = (o_ref, kernels.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta,
                                             **kw),
           *kernels.flash_bwd_dkdv_plain(q, k, v, do, lse_ref, delta, **kw))
    padded = kernels.pad_heads(width, q, k, v, do)
    o, lse = kernels.flash_fwd_plain(*padded[:3], scale=scale, **kw)
    assert torch.equal(lse, lse_ref)
    got = (o, kernels.flash_bwd_dq_plain(*padded, lse, delta, scale=scale,
                                         **kw),
           *kernels.flash_bwd_dkdv_plain(*padded, lse, delta, scale=scale,
                                         **kw))
    for name, g, want in zip(('o', 'dq', 'dk', 'dv'), got, ref):
        assert not g[..., d:].any(), name
        assert torch.equal(kernels.unpad(d, g)[0], want), name


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
                                     (16, 'bfloat16'), (24, 'bfloat16'),
                                     (32, 'float32'), (128, 'float32'),
                                     (80, 'bfloat16'), (96, 'float32'),
                                     (256, 'bfloat16'), (256, 'float32'),
                                     (192, 'bfloat16'), (160, 'float32'),
                                     (320, 'bfloat16'), (320, 'float32'),
                                     (512, 'bfloat16'), (512, 'float32'),
                                     (576, 'bfloat16'), (576, 'float32'),
                                     (1024, 'bfloat16'), (1024, 'float32'),
                                     (300, 'bfloat16')])
@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_cuda_head_dims_match_plain_twins(case, d, dtype):
    """Each instantiation past 16 and the wide kernels at 320, 512, 576 and
    1024 (and a padded head dim) of K1-K3 against the twins in every edge
    case (run on a GPU host)."""
    _needs_card()
    beyond = _card_case(case, d, getattr(torch, dtype), seed=d)
    assert not any(beyond.values()), beyond


@pytest.mark.cuda
@pytest.mark.parametrize('d', [32, 24, 16])
@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_cuda_d32_backward_is_deterministic(case, d):
    """K2 and K3 at head dim 32 (and at 24 and 16, launched at 32), bf16,
    launched twice on the same inputs: dq, dk and dv bit-equal (each kernel
    sums its tiles in one fixed order, with no atomics; run on a GPU
    host)."""
    _needs_card()
    q, k, v, do, kw = _operands(300 + d, case, d)
    q, k, v, do = (x.cuda().to(torch.bfloat16) for x in (q, k, v, do))
    kw = {n: (t.cuda() if torch.is_tensor(t) else t) for n, t in kw.items()}
    o, lse = kernels.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    runs = [(kernels.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *kernels.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(('dq', 'dk', 'dv'), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize('d', [320, 512, 576])
@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_cuda_wide_backward_is_deterministic(case, d):
    """K2 and K3 past head dim 256 (K2 at 320 and 512 on its cluster
    kernel, each block's partial scores summed from block 0 up through
    distributed shared memory; at 576 both on their streaming kernels),
    bf16, launched twice on the same inputs: dq, dk and dv bit-equal, MQA
    included (run on a GPU host)."""
    _needs_card()
    q, k, v, do, kw = _operands(400 + d, case, d)
    q, k, v, do = (x.cuda().to(torch.bfloat16) for x in (q, k, v, do))
    kw = {n: (t.cuda() if torch.is_tensor(t) else t) for n, t in kw.items()}
    o, lse = kernels.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    runs = [(kernels.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *kernels.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(('dq', 'dk', 'dv'), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_cuda_head_dim_past_128_raises(dtype):
    """A CUDA launch past 256, at head dim 320, launches each of K1-K3 once
    (the wide kernels); past ``kernels.MAX_HEAD_DIM`` a launch raises naming
    the grid's limit and launches nothing (run on a GPU host). (The name is
    from when 128 was the widest and 320 raised.)"""
    _needs_card()
    dt = getattr(torch, dtype)
    x = torch.zeros(2, 64, 320, device='cuda', dtype=dt)
    lse = torch.zeros(2, 64, device='cuda')
    kernels.reset_launch_counts()
    o, _ = kernels.flash_fwd(x, x, x, n_heads=2, n_kv_heads=2)
    dq = kernels.flash_bwd_dq(x, x, x, x, lse, lse, n_heads=2, n_kv_heads=2)
    dk, dv = kernels.flash_bwd_dkdv(x, x, x, x, lse, lse, n_heads=2,
                                    n_kv_heads=2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {'flash_fwd': 1, 'flash_bwd_dq': 1,
                                'flash_bwd_dkdv': 1, 'normalize': 0}
    assert o.shape == dq.shape == dk.shape == dv.shape == x.shape
    assert not (o.any() or dq.any() or dk.any() or dv.any())
    wide = torch.zeros(1, 1, kernels.MAX_HEAD_DIM + 64, device='cuda',
                       dtype=dt)
    lse1 = torch.zeros(1, 1, device='cuda')
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match='grid limit of 65535'):
        kernels.flash_fwd(wide, wide, wide, n_heads=1, n_kv_heads=1)
    with pytest.raises(ValueError, match='grid limit of 65535'):
        kernels.flash_bwd_dq(wide, wide, wide, wide, lse1, lse1, n_heads=1,
                             n_kv_heads=1)
    with pytest.raises(ValueError, match='grid limit of 65535'):
        kernels.flash_bwd_dkdv(wide, wide, wide, wide, lse1, lse1, n_heads=1,
                               n_kv_heads=1)
    assert not any(kernels.LAUNCHES.values())


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


def test_phase_30_gemma_widths():
    """``chip_smoke.py``'s phase 30 (c) model: gemma-2b's published widths
    (8 heads of 256 over one kv head, vocab 256,000, d_ff 16,384), cut to
    8 of its 18 layers: 1,929,414,656 parameters, counted from the shapes
    ``init`` gives (the count held against ``init`` itself at narrow
    widths), whose float32 weights, gradients and AdamW moments (16 bytes
    a parameter) leave room on an 80 GB card; launched at head dim 256."""
    import chip_smoke
    from petastorm_tpu_torch.models import transformer_lm as tlm

    def count(c):
        kv = c.kv_heads * c.head_dim
        layer = (2 * c.d_model + 2 * c.d_model ** 2 + 2 * c.d_model * kv
                 + 3 * c.d_model * c.d_ff)
        return 2 * c.vocab_size * c.d_model + c.d_model + c.n_layers * layer

    small = tlm.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                  n_kv_heads=1, n_layers=2, d_ff=48)
    params = tlm.init(small, torch.Generator().manual_seed(0), device='cpu')
    assert count(small) == sum(p.numel() for p in tlm.parameters(params))
    cfg = chip_smoke.gemma_config(tlm)
    assert (cfg.head_dim, cfg.kv_heads, cfg.attention) == (256, 1, 'flash')
    assert (cfg.vocab_size, cfg.d_model, cfg.d_ff, cfg.n_layers) == (
        256000, 2048, 16384, 8)
    assert count(cfg) == 1_929_414_656
    assert 16 * count(cfg) < 32e9
    assert kernels.launch_head_dim(cfg.head_dim, cfg.dtype) == 256


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


def test_phase_31_rehearses_on_the_cpu():
    """``chip_smoke.py``'s phase 31 at small widths on the CPU: (b)'s
    absorbed-MLA operands (v's rope columns zero, q scaled by sqrt(D /
    192)) through the public ``flash_attention`` forward and backward,
    held against the twins under ``flash_gate_limit`` with no kernel
    launched; (c)'s model is the flagship with one 512-wide head, launched
    at 512; (d)'s bounds at the MLA shape (128 q heads over one kv head,
    2,098,176 live pairs a head) are the operations' 4, 6 and 8 D FLOP a
    pair over the bf16 peak, with K3's float32 partials written per q
    head."""
    import chip_smoke
    from petastorm_tpu_torch.models import transformer_lm as tlm
    gen = torch.Generator().manual_seed(0)
    shape = (1, 8, 64, 320)
    q, k, v, do = chip_smoke.mla_operands(torch, gen, 'cpu', shape)
    assert q.shape == (1, 8, 64, 320) and k.shape == v.shape == (1, 1, 64,
                                                                   320)
    assert not v[..., 320 - chip_smoke.MLA_ROPE:].any()
    assert v[..., :320 - chip_smoke.MLA_ROPE].any()
    errs, launches, peak, _ = chip_smoke.mla_case(
        torch, kernels, torch.Generator().manual_seed(1), 'cpu', shape)
    assert not any(launches.values()) and peak == 0
    assert set(errs) == {'o', 'dq', 'dk', 'dv'}
    assert all(math.isfinite(e) for e in errs.values())
    cfg = chip_smoke.wider_lm_config(tlm)
    assert (cfg.head_dim, cfg.n_heads, cfg.kv_heads, cfg.d_model,
            cfg.n_layers, cfg.max_seq_len) == (512, 1, 1, 512, 4, 2048)
    assert kernels.launch_head_dim(cfg.head_dim, cfg.dtype) == 512
    assert chip_smoke.MLA_SHAPE == (1, 128, 2048, 576)
    bound = chip_smoke.bounds(chip_smoke.MLA_SHAPE, chip_smoke.MLA_HKV)
    pairs = 128 * 2_098_176
    for name, flop in (('flash_fwd', 4), ('flash_bwd_dq', 6),
                       ('flash_bwd_dkdv', 8)):
        ms, by, flops = bound[name]
        assert flops == flop * 576 * pairs and by == 'operations'
        assert ms == pytest.approx(flops / chip_smoke.PEAK_BF16_FLOPS * 1e3)
    assert bound['flash_fwd'][0] == pytest.approx(0.6257, abs=1e-4)
    # H x D = 512 at (8, 1, 2048, 512): the bounds of the other rows
    wide = chip_smoke.bounds(chip_smoke.WIDER_PATHS[512])
    path = chip_smoke.bounds(chip_smoke.PATH_SHAPE)
    for name in wide:
        assert wide[name] == path[name]


def test_ptxas_instances_name_the_head_dim_32_kernels():
    """``chip_smoke.ptxas_instances`` files the head dim 32 backward kernels
    (K2's ``dq_sm90_kernel<32>``, K3's ``dkdv_sm90_d32_kernel`` in both
    output dtypes) under K2 and K3 at head dim 32, beside the other
    instantiations."""
    import chip_smoke

    def entry(name, regs, spill=0):
        return ("ptxas info    : Compiling entry function '%s' for 'sm_90a'\n"
                'ptxas info    : Function properties for %s\n'
                '    0 bytes stack frame, %d bytes spill stores, %d bytes '
                'spill loads\nptxas info    : Used %d registers\n'
                % (name, name, spill, spill, regs))
    log = ''.join([
        entry('_ZN5flash53_GLOBAL__N__9f0f383c_20_flash_bwd_dq_sm90_cu_f212f7'
              '2a14dq_sm90_kernelILi32EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PKiS6'
              '_P13__nv_bfloat16iiiiiifi', 143),
        entry('_ZN5flash50_GLOBAL__N__965bde5d_17_flash_bwd_sm90_cu_11078b7f'
              '20dkdv_sm90_d32_kernelI13__nv_bfloat16EEv14CUtensorMap_stS3_S3'
              '_S3_PKfS5_PKiS7_PT_S9_iiiiiifi', 168),
        entry('_ZN5flash50_GLOBAL__N__965bde5d_17_flash_bwd_sm90_cu_11078b7f'
              '20dkdv_sm90_d32_kernelIfEEv14CUtensorMap_stS2_S2_S2_PKfS4_PKiS6'
              '_PT_S8_iiiiiifi', 168, 8),
        entry('_ZN5flash53_GLOBAL__N__9f0f383c_20_flash_bwd_dq_sm90_cu_f212f7'
              '2a14dq_sm90_kernelILi64EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PKiS6'
              '_P13__nv_bfloat16iiiiiifi', 154)])
    got = chip_smoke.ptxas_instances(log)
    assert got['flash_bwd_dq'] == [
        {'dtype': 'bfloat16', 'head_dim': 32, 'registers': 143,
         'spill_stores': 0, 'spill_loads': 0},
        {'dtype': 'bfloat16', 'head_dim': 64, 'registers': 154,
         'spill_stores': 0, 'spill_loads': 0}]
    assert got['flash_bwd_dkdv'] == [
        {'dtype': 'bfloat16', 'head_dim': 32, 'registers': 168,
         'spill_stores': 0, 'spill_loads': 0, 'out': 'bfloat16'},
        {'dtype': 'bfloat16', 'head_dim': 32, 'registers': 168,
         'spill_stores': 8, 'spill_loads': 8, 'out': 'float32'}]


def test_bounds_carry_the_exponentials_term():
    """``chip_smoke.bounds`` takes the largest of the tensor operations,
    the compulsory bytes and one 2^x a live pair over the special-function
    rate (16 a clock an SM x 132 SMs x 1,980 MHz by default): at (8, 16,
    2048, 32) K1 and K2 are bound by the exponentials, 268,566,528 pairs
    in 0.0642 ms, and K3 by its operations (0.0695 ms); at (8, 4, 2048,
    128) and at the flagship's (8, 8, 2048, 64) every kernel stays bound by
    its operations."""
    import chip_smoke
    assert chip_smoke.EXP_RATE == pytest.approx(16 * 132 * 1.98e9)
    pairs = 8 * 16 * 2048 * 2049 // 2
    assert pairs == 268_566_528
    d32 = chip_smoke.bounds((8, 16, 2048, 32))
    for name in ('flash_fwd', 'flash_bwd_dq'):
        ms, by, _ = d32[name]
        assert by == 'exponentials'
        assert ms == pytest.approx(pairs / chip_smoke.EXP_RATE * 1e3)
        assert ms == pytest.approx(0.0642, abs=1e-4)
    ms, by, flops = d32['flash_bwd_dkdv']
    assert by == 'operations' and flops == 8 * 32 * pairs
    assert ms == pytest.approx(0.0695, abs=1e-4)
    for shape in ((8, 4, 2048, 128), chip_smoke.PATH_SHAPE):
        for name, (ms, by, flops) in chip_smoke.bounds(shape).items():
            assert by == 'operations', (shape, name)
            assert ms == pytest.approx(flops / chip_smoke.PEAK_BF16_FLOPS
                                       * 1e3)
    # a slower special-function rate moves the bound with it
    slow = chip_smoke.bounds((8, 16, 2048, 32),
                             exp_per_s=chip_smoke.EXP_RATE / 2)
    assert slow['flash_fwd'][0] == pytest.approx(2 * d32['flash_fwd'][0])
    assert slow['flash_bwd_dkdv'][1] == 'exponentials'


def test_exp_rate_falls_back_to_the_max_clock(monkeypatch):
    """``chip_smoke.exp_rate``: 16 a clock an SM x the card's SMs x the
    max SM clock that ``nvidia-smi`` reports, or 1,980 MHz where the query
    fails."""
    import subprocess
    import types
    import chip_smoke
    props = types.SimpleNamespace(multi_processor_count=132)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        get_device_properties=lambda i: props))

    def no_smi(*a, **kw):
        raise FileNotFoundError('nvidia-smi')
    monkeypatch.setattr(subprocess, 'run', no_smi)
    assert chip_smoke.exp_rate(fake) == pytest.approx(chip_smoke.EXP_RATE)

    def smi(*a, **kw):
        return types.SimpleNamespace(stdout='1755\n')
    monkeypatch.setattr(subprocess, 'run', smi)
    props.multi_processor_count = 114
    assert chip_smoke.exp_rate(fake) == pytest.approx(16 * 114 * 1755e6)


def test_ptxas_instances_name_the_hopper_k1_kernels():
    """K1's Hopper schedule runs in ``fwd_persistent_sm90_kernel<D>``:
    ``chip_smoke.ptxas_instances`` files its head dim 32 and 128
    instances under K1 at those head dims, beside ``fwd_sm90_kernel<64>``
    and ``<256>``."""
    import chip_smoke

    def entry(kernel, d, regs, spill=0):
        name = ('_ZN5flash50_GLOBAL__N__1b2c3d4e_17_flash_fwd_sm90_cu_8a9b0c1d'
                '%d%sILi%dEEEv14CUtensorMap_stS2_S2_PKiS4_P13__nv_bfloat16Pfi'
                'iiiiiifi' % (len(kernel), kernel, d))
        return ("ptxas info    : Compiling entry function '%s' for 'sm_90a'\n"
                'ptxas info    : Function properties for %s\n'
                '    0 bytes stack frame, %d bytes spill stores, %d bytes '
                'spill loads\nptxas info    : Used %d registers\n'
                % (name, name, spill, spill, regs))
    got = chip_smoke.ptxas_instances(
        entry('fwd_sm90_kernel', 256, 168)
        + entry('fwd_persistent_sm90_kernel', 128, 168, 12)
        + entry('fwd_sm90_kernel', 64, 166)
        + entry('fwd_persistent_sm90_kernel', 32, 168))
    assert got['flash_fwd'] == [
        {'dtype': 'bfloat16', 'head_dim': d, 'registers': r,
         'spill_stores': sp, 'spill_loads': sp}
        for d, r, sp in ((256, 168, 0), (128, 168, 12), (64, 166, 0),
                         (32, 168, 0))]


def test_ptxas_instances_name_the_wide_cluster_kernels():
    """K2's wide backward up to head dim 512 runs in
    ``dq_wide_cluster_sm90_kernel<NB>`` (NB 3 or 4), beside the streaming
    ``dq_wide_sm90_kernel`` past it: ``chip_smoke.ptxas_instances`` files
    both under K2 at head dim 'past 256', with K3's
    ``dkdv_wide_sm90_kernel`` under K3, and none at another head dim."""
    import chip_smoke

    def entry(source, kernel, args, regs, spill=0):
        name = ('_ZN5flash50_GLOBAL__N__965bde5d_%d%s_cu_11078b7f%d%s%s'
                % (len(source) + 3, source, len(kernel), kernel, args))
        return ("ptxas info    : Compiling entry function '%s' for 'sm_90a'\n"
                'ptxas info    : Function properties for %s\n'
                '    0 bytes stack frame, %d bytes spill stores, %d bytes '
                'spill loads\nptxas info    : Used %d registers\n'
                % (name, name, spill, spill, regs))
    tail = 'EEv14CUtensorMap_stS2_S2_S2_PKfS4_PKiS6_P13__nv_bfloat16iiiiiiifi'
    log = ''.join([
        entry('flash_bwd_dq_sm90', 'dq_wide_cluster_sm90_kernel', 'ILi3' + tail,
              168),
        entry('flash_bwd_dq_sm90', 'dq_wide_cluster_sm90_kernel', 'ILi4' + tail,
              168, 16),
        entry('flash_bwd_dq_sm90', 'dq_wide_sm90_kernel',
              'E14CUtensorMap_stS0_S0_S0_PKfS2_PKiS4_P13__nv_bfloat16iiiiiiifi',
              168),
        entry('flash_bwd_sm90', 'dkdv_wide_sm90_kernel',
              'IfEEv14CUtensorMap_stS2_S2_S2_PKfS4_PKiS6_PT_S8_iiiiiiifi',
              168, 64)])
    got = chip_smoke.ptxas_instances(log)
    wide = lambda regs, spill=0: {
        'dtype': 'bfloat16', 'head_dim': 'past 256', 'registers': regs,
        'spill_stores': spill, 'spill_loads': spill}
    assert got['flash_bwd_dq'] == [wide(168), wide(168, 16), wide(168)]
    assert got['flash_bwd_dkdv'] == [wide(168, 64)]
