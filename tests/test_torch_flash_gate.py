"""The gate of the bf16 tensor-core flash kernels (K1 forward, K2 dq, K3
dk/dv).

Those kernels round p (K1), ds (K2), and p and ds (K3), to nearest bf16
before their second products, where the float32 twins do not. Their
outputs are held to ``kernels.flash_gate_limit``: half a bf16 ulp + 2^-8 B
+ 1e-5 (1 + |ref|), with B from ``kernels.flash_rounding_bounds``; and, on
non-negative q, k, v and do with delta = 0 (so p, ds and every term of o,
dq, dk and dv are non-negative), the mean signed error over the mean of
2^-8 B must lie within ``kernels.BIAS_LIMIT`` (``kernels.rounding_bias``),
which rounding to nearest meets and truncation does not.

On the CPU an emulation of the kernels' arithmetic (below, not in the
package: the twin with p and ds rounded blockwise at each kernel's kv
tile) stands in for the kernels: the gate accepts it, and the bias check
rejects its truncating variants (p truncated for o and dv, ds alone for dk
and dq). On the card (``-m cuda``) broken copies of the kernels, built
alone, must each be rejected by the gate.
"""

import math

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops import kernels

D = 64
TILE = 128            # kv rows per tile of K1 (the online-softmax step)
TILE_DQ = 64          # kv rows per tile of K2

# (name, q heads, kv heads, Lq, Lk, causal, window, segmented)
CASES = [
    ('causal_ragged', 2, 2, 300, 300, True, None, False),
    ('non_causal_cross', 2, 2, 300, 170, False, None, False),
    ('gqa', 4, 2, 256, 256, True, None, False),
    ('segments_masked_row', 2, 2, 300, 300, True, None, True),
    ('window', 2, 2, 384, 384, True, 128, False),
]


def _bf16_values(rng, shape, nonneg=False):
    """float32 values a bf16 tensor holds, made from numpy's generator."""
    x = rng.standard_normal(shape).astype(np.float32)
    if nonneg:
        x = np.abs(x)
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _operands(seed, h, hkv, lq, lk, segmented=False, nonneg=False,
              low_scores=False):
    """q, k, v, do (|x| with ``nonneg``). With ``low_scores`` q = |x| + 3
    and k = -(|x| + 3), so every score q k^T / 8 lies near -115 and
    exp(-lse) overflows float32."""
    rng = np.random.default_rng(seed)
    q = _bf16_values(rng, (h, lq, D), nonneg)
    k = _bf16_values(rng, (hkv, lk, D), nonneg)
    if low_scores:
        q, k = _nearest(q.abs() + 3), _nearest(-(k.abs() + 3))
    v = _bf16_values(rng, (hkv, lk, D), nonneg)
    do = _bf16_values(rng, (h, lq, D), nonneg)
    kw = {}
    if segmented:   # kv position 0 has an id no query has: q row 0 is empty
        seg_q = (torch.arange(lq) >= lq // 2).int()
        seg_kv = (torch.arange(lk) >= lk // 2).int()
        seg_kv[0] = 7
        kw = dict(seg_q=seg_q.expand(h, lq).contiguous(),
                  seg_kv=seg_kv.expand(hkv, lk).contiguous())
    return q, k, v, do, kw


def _nearest(x):
    return x.to(torch.bfloat16).float()


def _truncate(x):
    """float32 -> bf16 toward zero (the low 16 bits dropped)."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _emulate_fwd(q, k, v, rnd, *, n_heads, n_kv_heads, causal=True,
                 window=None, seg_q=None, seg_kv=None):
    """K1's arithmetic: online softmax over kv tiles of 128, p rounded by
    ``rnd`` before p v, l summed from the unrounded p, o rounded to bf16."""
    _, _, lq, lk, d = kernels._geometry(q, k, n_heads, n_kv_heads, window)
    scale = 1.0 / math.sqrt(d)
    q32, k32, v32, sk = kernels._plain_setup(q, k, v, seg_q, seg_kv,
                                             n_heads, n_kv_heads)
    q_pos = torch.arange(lq)
    o = torch.zeros(q.shape[0], lq, d)
    m = torch.full((q.shape[0], lq), kernels.NEG_INF)
    l = torch.zeros(q.shape[0], lq)
    for k0, k1 in kernels._kv_blocks(lk, TILE):
        mask = kernels._block_mask(q_pos, torch.arange(k0, k1), lk, causal,
                                   window, seg_q,
                                   None if sk is None else sk[:, k0:k1])
        s = torch.einsum('bqd,bkd->bqk', q32, k32[:, k0:k1]) * scale
        s = torch.where(mask, s, torch.full_like(s, kernels.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum('bqk,bkd->bqd', rnd(p),
                                               v32[:, k0:k1])
        m = m_new
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    return (o / safe_l[..., None]).to(torch.bfloat16)


def _emulate_dkdv(q, k, v, do, lse, delta, rnd, *, n_heads, n_kv_heads,
                  causal=True, window=None, seg_q=None, seg_kv=None,
                  rnd_ds=None):
    """K3's arithmetic: p and ds from lse as the twin has them, rounded by
    ``rnd`` (ds by ``rnd_ds`` if given) before p^T do and ds^T q; bf16
    outputs (float32 under GQA)."""
    rnd_ds = rnd if rnd_ds is None else rnd_ds
    _, _, lq, lk, d = kernels._geometry(q, k, n_heads, n_kv_heads, window)
    scale = 1.0 / math.sqrt(d)
    q32, k32, v32, sk = kernels._plain_setup(q, k, v, seg_q, seg_kv,
                                             n_heads, n_kv_heads)
    q_pos = torch.arange(lq)
    dks, dvs = [], []
    for k0, k1 in kernels._kv_blocks(lk, TILE):
        mask = kernels._block_mask(q_pos, torch.arange(k0, k1), lk, causal,
                                   window, seg_q,
                                   None if sk is None else sk[:, k0:k1])
        p, ds = kernels._recompute_p_ds(q32, do, k32[:, k0:k1],
                                        v32[:, k0:k1], lse, delta, mask,
                                        scale)
        dvs.append(torch.einsum('bqk,bqd->bkd', rnd(p), do))
        dks.append(torch.einsum('bqk,bqd->bkd', rnd_ds(ds), q32))
    out = torch.float32 if n_heads != n_kv_heads else torch.bfloat16
    return torch.cat(dks, 1).to(out), torch.cat(dvs, 1).to(out)


def _emulate_dq(q, k, v, do, lse, delta, rnd, *, n_heads, n_kv_heads,
                causal=True, window=None, seg_q=None, seg_kv=None):
    """K2's arithmetic: ds from lse as the twin has it, rounded by ``rnd``
    per kv tile of 64 before ds k, summed in float32, dq rounded to
    bf16."""
    _, _, lq, lk, d = kernels._geometry(q, k, n_heads, n_kv_heads, window)
    scale = 1.0 / math.sqrt(d)
    q32, k32, v32, sk = kernels._plain_setup(q, k, v, seg_q, seg_kv,
                                             n_heads, n_kv_heads)
    q_pos = torch.arange(lq)
    dq = torch.zeros_like(q32)
    for k0, k1 in kernels._kv_blocks(lk, TILE_DQ):
        mask = kernels._block_mask(q_pos, torch.arange(k0, k1), lk, causal,
                                   window, seg_q,
                                   None if sk is None else sk[:, k0:k1])
        _, ds = kernels._recompute_p_ds(q32, do, k32[:, k0:k1],
                                        v32[:, k0:k1], lse, delta, mask,
                                        scale)
        dq = dq + torch.einsum('bqk,bkd->bqd', rnd(ds), k32[:, k0:k1])
    return dq.to(torch.bfloat16)


OUTPUTS = ('o', 'dq', 'dk', 'dv')


def _case(seed, case, nonneg=False, low_scores=False):
    """Operands, geometry keywords, the twins' outputs and the bounds.
    With ``nonneg`` delta is 0: ds = p (do v^T) scale is then non-negative
    too (and so is k), so a truncated ds biases dq and dk as a truncated p
    biases o and dv."""
    _, h, hkv, lq, lk, causal, window, segmented = case
    q, k, v, do, segs = _operands(seed, h, hkv, lq, lk, segmented, nonneg,
                                  low_scores)
    kw = dict(n_heads=h, n_kv_heads=hkv, causal=causal, window=window,
              **segs)
    o, lse = kernels.flash_fwd_plain(q, k, v, **kw)
    delta = torch.zeros_like(lse) if nonneg else (do * o).sum(-1)
    dq = kernels.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = kernels.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, **kw)
    bounds = kernels.flash_rounding_bounds(q, k, v, do, lse, delta, **kw)
    refs = {'o': o, 'dq': dq, 'dk': dk, 'dv': dv}
    return (q, k, v, do, lse, delta), kw, refs, bounds


def _emulate(ops, kw, rnd, rnd_ds=None):
    q, k, v, do, lse, delta = ops
    dk, dv = _emulate_dkdv(q, k, v, do, lse, delta, rnd, rnd_ds=rnd_ds, **kw)
    dq = _emulate_dq(q, k, v, do, lse, delta,
                     rnd if rnd_ds is None else rnd_ds, **kw)
    return {'o': _emulate_fwd(q, k, v, rnd, **kw), 'dq': dq, 'dk': dk,
            'dv': dv}


def _n_beyond(got, ref, bound):
    limit = kernels.flash_gate_limit(ref, bound, got.dtype)
    return int(((got.float() - ref.float()).abs() > limit).sum())


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_gate_accepts_rounded_emulation(case):
    ops, kw, refs, bounds = _case(11, case)
    got = _emulate(ops, kw, _nearest)
    for name in OUTPUTS:
        assert got[name].dtype == (torch.float32 if name in ('dk', 'dv')
                                   and kw['n_heads'] != kw['n_kv_heads']
                                   else torch.bfloat16)
        assert _n_beyond(got[name], refs[name], bounds[name]) == 0, name
    if case[-1]:    # the fully masked row stays exactly 0
        assert not got['o'][:, 0].any()


def test_gate_accepts_rounded_emulation_at_low_scores():
    """Every score near -115, so exp(-lse) overflows float32 (the card case
    that holds K2's kv-tail mask): the twins stay finite and the rounded
    emulation within the gate."""
    ops, kw, refs, bounds = _case(11, CASES[1], low_scores=True)
    assert float(ops[4].max()) < -88
    got = _emulate(ops, kw, _nearest)
    for name in OUTPUTS:
        assert bool(torch.isfinite(refs[name]).all()), name
        assert _n_beyond(got[name], refs[name], bounds[name]) == 0, name


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_old_half_ulp_gate_is_too_tight_for_rounded_p(case):
    """Why the gate changed: the emulation, right by construction, has
    elements beyond half a bf16 ulp + 1e-5 (1 + |ref|) of the twin, in dq
    alone as in o, dk and dv together."""
    ops, kw, refs, _ = _case(12, case)
    got = _emulate(ops, kw, _nearest)
    zero = {n: torch.zeros_like(r) for n, r in refs.items()}
    assert sum(_n_beyond(got[n], refs[n], zero[n])
               for n in ('o', 'dk', 'dv')) > 0
    assert _n_beyond(got['dq'], refs['dq'], zero['dq']) > 0


@pytest.mark.parametrize('output', ['o', 'dq', 'dk', 'dv'])
def test_bias_check_rejects_truncation(output):
    """Non-negative q, k, v and do, delta 0: rounding to nearest passes the
    gate without bias; truncating p (o, dv), or ds alone (dq, dk), reads a
    clear negative bias."""
    case = ('nonneg', 2, 2, 512, 512, True, None, False)
    ops, kw, refs, bounds = _case(13, case, nonneg=True)
    nearest = _emulate(ops, kw, _nearest)
    for name in OUTPUTS:
        assert _n_beyond(nearest[name], refs[name], bounds[name]) == 0, name
        assert abs(kernels.rounding_bias(nearest[name], refs[name],
                                         bounds[name])) < kernels.BIAS_LIMIT
    if output in ('dq', 'dk'):
        truncated = _emulate(ops, kw, _nearest, rnd_ds=_truncate)
        assert abs(kernels.rounding_bias(truncated['dv'], refs['dv'],
                                         bounds['dv'])) < kernels.BIAS_LIMIT
    else:
        truncated = _emulate(ops, kw, _truncate)
    bias = kernels.rounding_bias(truncated[output], refs[output],
                                 bounds[output])
    assert bias < -kernels.BIAS_LIMIT, bias


@pytest.mark.parametrize('case', [CASES[0], CASES[2], CASES[3]],
                         ids=['causal_ragged', 'gqa', 'segments_masked_row'])
def test_bounds_match_their_definition(case):
    """B of o, dq, dv and dk against a dense computation: sum_j (p_j / l)
    |v_j|, sum_j |ds_j| |k_j|, sum_i p_i |do_i|, sum_i |ds_i| |q_i| (per q
    head under GQA)."""
    ops, kw, _, bounds = _case(14, case)
    q, k, v, do, lse, delta = ops
    _, h, hkv, lq, lk, causal, window, _ = case
    idx = kernels.kv_index(h, h, hkv)
    k, v = k[idx], v[idx]
    qp, kp = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
    mask = (qp >= kp) if causal else torch.ones(lq, lk, dtype=torch.bool)
    mask = mask.expand(h, lq, lk)
    if 'seg_q' in kw:
        mask = mask & (kw['seg_q'][:, :, None] == kw['seg_kv'][idx][:, None])
    s = torch.einsum('bqd,bkd->bqk', q, k) / math.sqrt(D)
    p = torch.where(mask & (lse > kernels.NEG_INF / 2)[..., None],
                    torch.exp(s - lse[..., None]), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    dense_o = (p / torch.where(l == 0, torch.ones_like(l), l)) @ v.abs()
    ds = p * (do @ v.transpose(1, 2) - delta[..., None]) / math.sqrt(D)
    torch.testing.assert_close(bounds['o'], dense_o, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bounds['dv'], p.transpose(1, 2) @ do.abs(),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bounds['dk'],
                               ds.abs().transpose(1, 2) @ q.abs(),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bounds['dq'], ds.abs() @ k.abs(),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card: broken copies of K1, K2 and K3 must fail the gate
# ---------------------------------------------------------------------------

_TRUNCATE = ('__floats2bfloat162_rn(lo, hi)',
             '__halves2bfloat162(__float2bfloat16_rz(lo), '
             '__float2bfloat16_rz(hi))')

# mutant: (kernel, file, what is replaced, by what)
MUTANTS = {
    'fwd_p_truncated': ('flash_fwd', 'sm90.cuh') + _TRUNCATE,
    'fwd_causal_diagonal_unmasked': (
        'flash_fwd', 'flash_fwd_sm90.cu',
        'const bool diag = causal && k0 + kRowsK - 1 > r0;',
        'const bool diag = false;'),
    'fwd_pv_transpose_flipped': ('flash_fwd', 'flash_fwd_sm90.cu',
                                 'wgmma_rs_tile<D, 1>(acc, a[kk]',
                                 'wgmma_rs_tile<D, 0>(acc, a[kk]'),
    'dkdv_p_ds_truncated': ('flash_bwd_dkdv', 'sm90.cuh') + _TRUNCATE,
    'dkdv_ds_truncated': (
        'flash_bwd_dkdv', 'flash_bwd_sm90.cu',
        'to_a_frag(dp, kk, dsa[kk]);',
        'for (int r = 8 * kk; r < 8 * kk + 8; ++r) '
        'dp[r] = __uint_as_float(__float_as_uint(dp[r]) & 0xffff0000u); '
        'to_a_frag(dp, kk, dsa[kk]);'),
    'dkdv_causal_diagonal_unmasked': (
        'flash_bwd_dkdv', 'flash_bwd_sm90.cu',
        'const bool diag = causal && kr0 + 63 > q0;',
        'const bool diag = false;'),
    'dkdv_dsq_transpose_flipped': ('flash_bwd_dkdv', 'flash_bwd_sm90.cu',
                                   'wgmma_rs_tile<D, 1>(dk_acc, dsa[kk]',
                                   'wgmma_rs_tile<D, 0>(dk_acc, dsa[kk]'),
    'dq_ds_truncated': ('flash_bwd_dq', 'sm90.cuh') + _TRUNCATE,
    'dq_causal_diagonal_unmasked': (
        'flash_bwd_dq', 'flash_bwd_dq_sm90.cu',
        'const bool diag = causal && k0 + kRowsK - 1 > r0;',
        'const bool diag = false;'),
    'dq_dsk_transpose_flipped': ('flash_bwd_dq', 'flash_bwd_dq_sm90.cu',
                                 'wgmma_rs_tile<D, 1>(dq_acc, dsa[kk]',
                                 'wgmma_rs_tile<D, 0>(dq_acc, dsa[kk]'),
    'dq_window_edge_unmasked': (
        'flash_bwd_dq', 'flash_bwd_dq_sm90.cu',
        '(causal && window > 0 && r0 + 63 - k0 >= window)', 'false'),
    'dq_kv_tail_unmasked': ('flash_bwd_dq', 'flash_bwd_dq_sm90.cu',
                            'k0 + kRowsK > Lk || ', ''),
}
# flash_bwd.cu's C entry points call into both sm90 backward files, and a
# library missing either fails to load (ctypes binds every symbol at once)
_BWD_SOURCES = ('flash_bwd.cu', 'flash_bwd_sm90.cu', 'flash_bwd_dq_sm90.cu')
_KERNEL_SOURCES = {'flash_fwd': ('flash_fwd.cu', 'flash_fwd_sm90.cu'),
                   'flash_bwd_dq': _BWD_SOURCES,
                   'flash_bwd_dkdv': _BWD_SOURCES}

# (label, case, operands: None, 'nonneg' or 'low_scores'). K2's kv tail:
# TMA fills K rows past Lk with zeros, so ds k adds exact zeros there even
# unmasked, unless ds is not finite: exp(-lse) overflows float32 where every
# score of a row lies below about -88, and inf * 0 is NaN. Only the
# non-causal case has kv-tail tiles off the diagonal.
CARD_CASES = [
    ('causal 512', ('causal', 2, 2, 512, 512, True, None, False), None),
    ('non-causal 300x170', CASES[1], None),
    ('non-causal 300x170, scores near -115', CASES[1], 'low_scores'),
    ('segments 300', CASES[3], None),
    ('window 384', CASES[4], None),
    ('non-negative 512', ('nonneg', 2, 2, 512, 512, True, None, False),
     'nonneg'),
]


def gate_verdicts(name):
    """For kernel ``name`` (the one bound in ``kernels._lib``): per card case,
    the elements beyond the limit and the bias ratio of each output."""
    out = {}
    for label, case, kind in CARD_CASES:
        nonneg = kind == 'nonneg'
        ops, kw, refs, bounds = _case(15, case, nonneg,
                                      low_scores=kind == 'low_scores')
        q, k, v, do, lse, delta = (x.cuda() for x in ops)
        kwd = {n: (t.cuda() if torch.is_tensor(t) else t)
               for n, t in kw.items()}
        q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
        if name == 'flash_fwd':
            got = dict(zip(('o',), kernels.flash_fwd(q, k, v, **kwd)[:1]))
        elif name == 'flash_bwd_dq':
            got = {'dq': kernels.flash_bwd_dq(q, k, v, do, lse, delta,
                                              **kwd)}
        else:
            got = dict(zip(('dk', 'dv'), kernels.flash_bwd_dkdv(
                q, k, v, do, lse, delta, **kwd)))
        torch.cuda.synchronize()
        for n, g in got.items():
            g = g.cpu()
            finite = bool(torch.isfinite(g).all())
            out['%s %s' % (label, n)] = (
                _n_beyond(g, refs[n], bounds[n]) if finite else -1,
                kernels.rounding_bias(g, refs[n], bounds[n]) if nonneg
                else None)
    return out


def _rejected(verdict):
    n_bad, bias = verdict
    return n_bad != 0 or (bias is not None
                          and not abs(bias) < kernels.BIAS_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize('kernel', sorted(_KERNEL_SOURCES))
def test_gate_accepts_kernel_on_card(kernel):
    """The built kernels pass every card case of the gate (run on a GPU
    host)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    verdicts = gate_verdicts(kernel)
    print('%s: %s' % (kernel, verdicts))
    assert not any(_rejected(v) for v in verdicts.values()), verdicts


@pytest.mark.cuda
@pytest.mark.parametrize('mutant', sorted(MUTANTS))
def test_gate_rejects_broken_kernel(mutant, tmp_path, monkeypatch):
    """A broken copy of K1, K2 or K3, built alone on the card, fails the
    gate in some card case: truncated p (or p and ds, or ds alone), the
    causal mask dropped on the diagonal tile (K2: or on the window's edge
    tile, or on the kv-tail tile), the transpose bit of P V (or dS K, or
    dS^T Q) flipped."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    import ctypes
    import shutil
    import subprocess
    kernel, name, old, new = MUTANTS[mutant]
    csrc = tmp_path / 'csrc'
    shutil.copytree(kernels._CSRC, csrc)
    src = (csrc / name).read_text()
    assert old in src
    (csrc / name).write_text(src.replace(old, new))
    so = tmp_path / 'libmutant.so'
    flags = [f for f in kernels._NVCC_FLAGS if f not in ('-Xptxas', '-v')]
    subprocess.run([kernels._nvcc(), *flags, '-o', str(so),
                    *(str(csrc / n) for n in _KERNEL_SOURCES[kernel])],
                   check=True, capture_output=True)
    lib = kernels.bind(ctypes.CDLL(str(so)),
                       {kernel: kernels._SIGNATURES[kernel]})
    monkeypatch.setattr(kernels, '_lib', lib)
    verdicts = gate_verdicts(kernel)
    rejected = [c for c, v in verdicts.items() if _rejected(v)]
    print('mutant %s rejected by: %s; verdicts %s'
          % (mutant, rejected, verdicts))
    assert rejected, verdicts
