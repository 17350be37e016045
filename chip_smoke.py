#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printing one line or a few:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the four CUDA kernels from ``csrc/`` in one ``nvcc`` call
   (bf16 K1, K2, K3 on Hopper's tensor cores: ``flash_fwd_sm90.cu``,
   ``flash_bwd_dq_sm90.cu``, ``flash_bwd_sm90.cu``; float32 K1-K3 on the
   FP32 cores: ``flash_fwd.cu``, ``flash_bwd.cu``; K4 ``normalize.cu``);
3. kernels: the registers and spills of each kernel (``ptxas -v``); K1
   (forward), K2 (dq) and K3 (dk/dv) against their plain PyTorch twins run
   in float32 on the same values, at the training shape (8, 8, 2048, 64)
   bf16 causal and at edge shapes in bf16 and in float32 (ragged L=300,
   non-causal 300 x 170, GQA 8->2, segment ids with a fully masked row,
   window 128). Float32 outputs: atol = rtol = 1e-4. bf16 o, dq, dk and dv
   come from the tensor-core kernels, which round p (K1), ds (K2), or p and
   ds (K3) to bf16 before the second product: within half a bf16 ulp of
   the twin + 2^-8 B + 1e-5 (1 + |ref|) (``kernels.flash_gate_limit``, B
   what that rounding can move the output); and on non-negative q, k, v
   and do with delta = 0 (so p, ds and every term of o, dq, dk and dv are
   non-negative), the mean signed error within +-0.1 of the mean 2^-8 B
   (``kernels.BIAS_LIMIT``: rounding to nearest has no bias; truncation
   has). K4 (image normalisation) against its
   twin bit for bit, over every uint8 value in every channel (mean 0 / std 1
   in bf16, ImageNet mean/std in bf16 and in float32), at the image line's
   batch shape (64, 224, 224, 3) and on a misaligned input with a tail;
4. reference: the full-width LM's loss and gradients on a small input,
   flash kernels against the plain blockwise attention; the full-width image
   CNN's loss on 8 images of 224 x 224 with K4 and with the twin's
   normalisation, bit for bit;
5. LM main path: a Parquet token store written with ``materialize_dataset``,
   read through ``make_reader`` (NGram) -> ``TorchDataLoader`` ->
   ``prefetch_to_device``, and AdamW steps of the flagship transformer LM
   (vocab 32000, d_model 512, 8 heads, 4 layers, d_ff 2048, L 2048, bf16,
   ``attention='flash'``), with each kernel's launch count over those steps;
6. image main path: a png ``CompressedImageCodec`` store of 256 synthetic
   variable-size images (375 x 500, each side +-20%), trained on by the
   example's ``train()`` on the card: ``make_columnar_reader`` with the
   resize to 224 x 224 on 8 worker threads -> ``TorchDataLoader`` ->
   ``prefetch_to_device``, and SGD steps of the image CNN (widths
   64/128/256, 2 blocks, 16 classes, bf16, batch 64), with K4's launch
   count and the device's busy share over 2 profiled steps;
7. MNIST line: a 2048-row store read row by row through ``make_reader`` ->
   ``TorchDataLoader`` (shuffling) -> MLP SGD steps for one epoch;
8. batch line: a 60,000-row MNIST-size store (``idx``, ``digit``, and the
   28 x 28 image under ``ArrowListCodec``, about 47 row groups) read
   through ``make_batch_reader`` with ``filters`` (``idx`` < 54000: the
   last 6,000 rows held out by footer statistics and the residual
   predicate), a hash split (``in_pseudorandom_split``, 0.9) and shard 0
   of 2 -> ``TorchDataLoader`` (shuffling, batch 512, ``drop_last``) ->
   ``prefetch_to_device`` -> MLP SGD steps. The delivered ``idx`` set is
   held against one worked out with pyarrow and ``hashlib`` alone; the
   reader alone is timed over one more pass; and a small hive-partitioned
   plain store is read with a partition filter and held against
   ``pq.read_table(filters=...)``;
9. times: each kernel's time at its path shape beside its bound, its plain
   twin's time, and a library call's time as a yardstick (never used by
   the port): ``scaled_dot_product_attention`` for the forward, aten's
   flash-attention backward (dq, dk and dv in one call) for K2 and K3
   together, and none for K4 (no PyTorch call computes it; ``x.to(bf16)``,
   which moves the same bytes, is printed as a yardstick of bytes).

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing results.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12            # float32 outside the tensor cores

PATH_SHAPE = (8, 8, 2048, 64)     # B, H, L, head_dim of the LM's attention
TOL_F32 = 1e-4                    # atol = rtol: float32 sums in other order
STEPS = 5                         # main-path train steps (the first warms up)
BATCH = 8                         # windows of 2048 tokens per step
ROWS = 320                        # store rows: 2 row groups, 318 windows
REPS = 20                         # timed launches per kernel (median)

IMAGE_CODEC = 'png'               # cv2 is on the card: decode runs there
IMAGE_ROWS = 256                  # image store rows (~12 row groups)
IMAGE_BATCH = 64
IMAGE_SIZE = 224
IMAGE_CLASSES = 16
IMAGE_STEPS = 6                   # image main-path steps (the first warms up)
IMAGE_WORKERS = 8
K4_SHAPE = (IMAGE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
K4_LOOP = 100                     # K4 launches between two events
MNIST_ROWS = 2048
BATCH_LINE_ROWS = 60000           # MNIST's training set
BATCH_LINE_HOLDOUT = 54000        # filters keep idx < 54000
BATCH_LINE_SPLIT = 0.9            # in_pseudorandom_split([0.9, 0.1], 0)
BATCH_LINE_SHARDS = 2             # cur_shard 0 of 2
BATCH_LINE_BATCH = 512
BATCH_LINE_LR = 0.1

KERNELS = {
    'flash_fwd': ('petastorm_tpu_torch/csrc/flash_fwd_sm90.cu',
                  'petastorm_tpu/ops/attention.py:260'),
    'flash_bwd_dq': ('petastorm_tpu_torch/csrc/flash_bwd_dq_sm90.cu',
                     'petastorm_tpu/ops/attention.py:658'),
    'flash_bwd_dkdv': ('petastorm_tpu_torch/csrc/flash_bwd_sm90.cu',
                       'petastorm_tpu/ops/attention.py:706'),
    'normalize': ('petastorm_tpu_torch/csrc/normalize.cu',
                  'petastorm_tpu/ops/normalize.py:21'),
}


FLASH = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkdv')


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# phase 3: kernels against plain twins
# ---------------------------------------------------------------------------

def _operands(torch, gen, b, h, hkv, lq, lk, d, dtype, nonneg=False):
    """q, k, v, do; with ``nonneg`` each is |randn|."""
    def rnd(*shape):
        x = torch.randn(*shape, generator=gen, device='cuda')
        return (x.abs() if nonneg else x).to(dtype)
    return (rnd(b * h, lq, d), rnd(b * hkv, lk, d), rnd(b * hkv, lk, d),
            rnd(b * h, lq, d))


def _max_err(torch, got, ref, label, kernels=None, bound=None):
    """Max abs error of a kernel output against the float32 twin. Given a
    ``bound`` (a bf16 output of a tensor-core kernel, which rounds p or ds
    to bf16 before its second product): ``kernels.flash_gate_limit``. Else
    (a float32 output) atol = rtol = TOL_F32."""
    check(bool(torch.isfinite(got).all()), '%s: non-finite output' % label)
    ref = ref.float()
    err = (got.float() - ref).abs()
    if bound is not None:
        limit = kernels.flash_gate_limit(ref, bound, got.dtype)
    else:
        limit = TOL_F32 * (1 + ref.abs())
    bad = err > limit
    check(not bool(bad.any()),
          '%s: %d elements beyond the limit (max abs err %.3g)'
          % (label, int(bad.sum()), float(err.max())))
    return float(err.max()) if err.numel() else 0.0


def compare_case(torch, kernels, label, gen, *, b, h, hkv, lq, lk, d, dtype,
                 causal=True, window=None, segmented=False, nonneg=False):
    """Each kernel on ``dtype`` operands against its twin on the same
    values widened to float32 (exact), so the twin's sums stand before any
    rounding to ``dtype``. With ``nonneg`` the backward passes get delta =
    0, so ds = p (do v^T) scale >= 0 and a truncated ds biases dq and dk.
    Returns the max abs error per kernel."""
    q, k, v, do = _operands(torch, gen, b, h, hkv, lq, lk, d, dtype, nonneg)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    kw = dict(n_heads=h, n_kv_heads=hkv, causal=causal, window=window)
    if segmented:
        seg = (torch.arange(lq, device='cuda') >= lq // 2).int()
        kw['seg_q'] = seg.expand(b * h, lq).contiguous()
        seg_kv = (torch.arange(lk, device='cuda') >= lk // 2).int()
        seg_kv[0] = 7            # q row 0 sees only k=0: fully masked
        kw['seg_kv'] = seg_kv.expand(b * hkv, lk).contiguous()
    o, lse = kernels.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = kernels.flash_fwd_plain(q32, k32, v32, **kw)
    # both backward passes see the twin's o and lse
    delta = (do32 * o_ref).sum(-1) * (0.0 if nonneg else 1.0)
    bound = ({} if dtype == torch.float32 else
             kernels.flash_rounding_bounds(q32, k32, v32, do32, lse_ref,
                                           delta, **kw))
    torch.cuda.synchronize()
    errs = {'flash_fwd': max(
        _max_err(torch, o, o_ref, label + ' o', kernels, bound.get('o')),
        _max_err(torch, lse, lse_ref, label + ' lse'))}
    if segmented:
        check(bool((lse[:, 0] == kernels.NEG_INF).all())
              and not bool(o[:, 0].any()),
              '%s: fully masked row must give o=0, lse=-1e30' % label)
    dq = kernels.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
    dq_ref = kernels.flash_bwd_dq_plain(q32, k32, v32, do32, lse_ref, delta,
                                        **kw)
    dk, dv = kernels.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = kernels.flash_bwd_dkdv_plain(q32, k32, v32, do32,
                                                  lse_ref, delta, **kw)
    torch.cuda.synchronize()
    want = torch.float32 if h != hkv else dtype   # GQA: float32 partials
    check(dk.dtype == want and dq.dtype == dtype and o.dtype == dtype,
          '%s: output dtypes o %s dq %s dk %s' % (label, o.dtype, dq.dtype,
                                                  dk.dtype))
    errs['flash_bwd_dq'] = _max_err(torch, dq, dq_ref, label + ' dq',
                                    kernels, bound.get('dq'))
    errs['flash_bwd_dkdv'] = max(
        _max_err(torch, dk, dk_ref, label + ' dk', kernels, bound.get('dk')),
        _max_err(torch, dv, dv_ref, label + ' dv', kernels, bound.get('dv')))
    bias = ''
    if nonneg:
        ratios = {n: kernels.rounding_bias(g, r, bound[n]) for n, g, r in
                  (('o', o, o_ref), ('dq', dq, dq_ref), ('dk', dk, dk_ref),
                   ('dv', dv, dv_ref))}
        bias = '; bias o %+.4f dq %+.4f dk %+.4f dv %+.4f (limit +-%g)' % (
            ratios['o'], ratios['dq'], ratios['dk'], ratios['dv'],
            kernels.BIAS_LIMIT)
        check(all(abs(r) < kernels.BIAS_LIMIT for r in ratios.values()),
              '%s: rounding bias beyond +-%g: %r'
              % (label, kernels.BIAS_LIMIT, ratios))
    if dtype == torch.float32:
        limits = 'atol=rtol=%g' % TOL_F32
    else:
        limits = 'o, dq, dk, dv: half bf16 ulp + 2^-8 B + 1e-5(1+|ref|)'
    log('kernels %-26s max_abs_err fwd %.3g dq %.3g dkdv %.3g (limit %s)%s'
        % (label, errs['flash_fwd'], errs['flash_bwd_dq'],
           errs['flash_bwd_dkdv'], limits, bias))
    return errs


def ptxas_summary(log_text):
    """One line per kernel entry from nvcc's ``-Xptxas -v`` report: its
    (mangled) name, registers and spill stores/loads."""
    import re
    entry = re.compile(r"entry function '(\S+)'.*?(\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    return ['%s: %s registers, spill %s/%s B' % (name, regs, st, ld)
            for name, st, ld, regs in entry.findall(log_text)]


# ---------------------------------------------------------------------------
# phase 4 / 5: LM reference and main path
# ---------------------------------------------------------------------------

def reference_check(torch, tlm, seed):
    """Full-width model on a (1, 256) input: the flash path's loss and
    gradients against the plain blockwise attention's."""
    import dataclasses
    cfg = tlm.TransformerConfig(attention='flash')
    gen = torch.Generator().manual_seed(seed)
    params = tlm.init(cfg, gen, device='cuda')
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 256), generator=gen)
    tokens, targets = toks[0].cuda(), toks[1].cuda()
    results = []
    for mode in ('flash', 'blockwise'):
        leaves = tlm.parameters(params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        c = dataclasses.replace(cfg, attention=mode)
        loss = tlm.loss_fn(params, tokens, targets, c)
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in leaves]))
    (lf, gf), (lb, gb) = results
    check(math.isfinite(lf) and abs(lf - lb) < 1e-2,
          'reference: flash loss %r vs blockwise %r' % (lf, lb))
    rel = max(float((a - b).norm() / (b.norm() + 1e-12))
              for a, b in zip(gf, gb))
    check(rel < 5e-2, 'reference: gradient relative error %.3g' % rel)
    log('reference loss flash %.6f blockwise %.6f |dL| %.3g, max grad '
        'rel err %.3g (tol loss 1e-2, grad 5e-2)' % (lf, lb, abs(lf - lb),
                                                     rel))


def write_store(np, url, seq_len, vocab, rows, seed):
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('TokenSchema', [
        UnischemaField('step', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(),
                       False)])
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (rows, seq_len), dtype=np.int32)
    with materialize_dataset(url, schema, rows_per_file=rows // 2,
                             row_group_size_mb=64) as w:
        w.write_rows({'step': np.int64(i), 'tokens': tokens[i]}
                     for i in range(rows))


def main_path(torch, np, tlm, kernels, args):
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.ngram import NGram
    cfg = tlm.TransformerConfig(attention='flash')
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'tokens')
        start = time.perf_counter()
        write_store(np, url, cfg.max_seq_len, cfg.vocab_size, ROWS,
                    args.seed)
        log('store %d rows x %d tokens written in %.2f s'
            % (ROWS, cfg.max_seq_len, time.perf_counter() - start))
        params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                          device='cuda')
        _, step = tlm.make_train_step(cfg, params)
        ngram = NGram(fields={0: ['step', 'tokens'], 1: ['tokens']},
                      delta_threshold=1, timestamp_field='step')
        losses, times = [], []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with make_reader(url, schema_fields=ngram, num_epochs=None,
                         workers_count=4, seed=args.seed) as reader:
            loader = TorchDataLoader(reader, batch_size=BATCH,
                                     drop_last=True, device='cuda')
            batches = prefetch_to_device(iter(loader), size=2)
            with contextlib.closing(batches):
                for i in range(STEPS):
                    t0 = time.perf_counter()
                    batch = next(batches)
                    tokens = batch[0]['tokens']
                    nxt = batch[1]['tokens'][:, 0]
                    targets = torch.cat([tokens[:, 1:], nxt[:, None]], 1)
                    check(tokens.is_cuda and tuple(tokens.shape)
                          == (BATCH, cfg.max_seq_len),
                          'batch tokens %s on %s'
                          % (tuple(tokens.shape), tokens.device))
                    loss = float(step(tokens, targets))
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    losses.append(loss)
                    times.append(dt)
                    log('step %d loss %.6f time %.2f ms tokens/s %.0f'
                        % (i, loss, dt * 1e3,
                           BATCH * cfg.max_seq_len / dt))
                launches = dict(kernels.LAUNCHES)
                if args.profile:
                    def run_step():
                        batch = next(batches)
                        tokens = batch[0]['tokens']
                        nxt = batch[1]['tokens'][:, :1]
                        step(tokens, torch.cat([tokens[:, 1:], nxt], 1))
                    profile_steps(torch, run_step, 2, 'flash', 'LM')
    check(all(math.isfinite(x) for x in losses), 'non-finite loss')
    check(all(launches[k] > 0 for k in FLASH),
          'a kernel was not launched on the main path: %r' % launches)
    steady = times[1:] or times
    log('main path %d steps, loss %.4f -> %.4f, steady step %.2f ms, '
        '%.0f tokens/s, launches %s'
        % (len(losses), losses[0], losses[-1],
           statistics.median(steady) * 1e3,
           BATCH * cfg.max_seq_len / statistics.median(steady),
           json.dumps(launches)))
    return launches


def profile_steps(torch, run_step, n, match, label):
    """Profile ``n`` more train steps (``run_step()`` runs one): device time
    by kernel (top 12) to standard error, and one line with the device's
    busy share of the wall time and the share of device time in kernels
    whose name contains ``match``. Returns the busy share (%)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    # device-side events only: CPU ops and autograd ranges carry the time
    # of the kernels they launched too, and would count it twice
    dev = [(getattr(e, 'self_device_time_total', None)
            or getattr(e, 'self_cuda_time_total', 0), e.key)
           for e in prof.key_averages()
           if getattr(e, 'device_type', None) == DeviceType.CUDA]
    dev = sorted((t, k) for t, k in dev if t > 0)[::-1]
    busy = sum(t for t, _ in dev)
    print('profile %s, %d steps: wall %.0f us, device busy %.0f us (%.1f%%)'
          % (label, n, wall_us, busy, 100 * busy / wall_us), file=sys.stderr)
    for t, k in dev[:12]:
        print('  %10.0f us %5.1f%%  %s' % (t, 100 * t / max(busy, 1), k[:90]),
              file=sys.stderr)
    log('profile %s %d steps: wall %.0f us, device busy %.1f%% of wall, '
        '%s kernels %.1f%% of device time'
        % (label, n, wall_us, 100 * busy / wall_us, match,
           100 * sum(t for t, k in dev if match in k) / max(busy, 1)))
    return 100 * busy / wall_us


# ---------------------------------------------------------------------------
# phase 6 / 7: image and MNIST lines
# ---------------------------------------------------------------------------

def k4_check(torch, kernels, seed):
    """K4 against its twin, bit for bit; returns the max abs error (0)."""
    from petastorm_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
    v = torch.arange(256, dtype=torch.uint8).reshape(2, 16, 8)
    exhaustive = torch.stack([v, v.roll(1), v.roll(2)], -1).cuda()
    gen = torch.Generator(device='cuda').manual_seed(seed)
    batch = torch.randint(0, 256, K4_SHAPE, generator=gen, device='cuda',
                          dtype=torch.uint8)
    flat = torch.arange(1 + 7 * 5 * 3, device='cuda').to(torch.uint8)
    tail = flat[1:].view(1, 7, 5, 3)    # storage offset 1, 105 = 6 x 16 + 9
    zero_one = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    imagenet = (IMAGENET_MEAN, IMAGENET_STD)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [('all uint8 x 3 ch, 0/1 bf16', exhaustive, zero_one, bf16),
             ('all uint8 x 3 ch, imagenet bf16', exhaustive, imagenet, bf16),
             ('all uint8 x 3 ch, imagenet f32', exhaustive, imagenet, f32),
             ('batch %s 0/1 bf16' % (K4_SHAPE,), batch, zero_one, bf16),
             ('batch %s imagenet bf16' % (K4_SHAPE,), batch, imagenet, bf16),
             ('misaligned + tail, imagenet f32', tail, imagenet, f32)]
    worst = 0.0
    for label, x, (mean, std), dtype in cases:
        m = torch.tensor(mean, dtype=torch.float32)
        inv = 1.0 / torch.tensor(std, dtype=torch.float32)
        got = kernels.normalize(x, m, inv, dtype)
        ref = kernels.normalize_plain(x, m, inv, dtype)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == bf16 else torch.int32
        differ = int((got.view(bits) != ref.view(bits)).sum())
        err = float((got.float() - ref.float()).abs().max())
        worst = max(worst, err)
        log('kernels normalize %-36s %d of %d elements differ in any bit, '
            'max_abs_err %.3g (limit: bit-equal)'
            % (label, differ, got.numel(), err))
        check(differ == 0 and got.dtype == dtype and got.shape == x.shape,
              'normalize %s: %d elements differ from the twin'
              % (label, differ))
    return worst


def image_reference_check(torch, kernels, seed):
    """The full-width CNN's loss on 8 images of 224 x 224, with K4 and with
    the twin's normalisation, on the same parameters: bit for bit."""
    from petastorm_tpu_torch.models import image_cnn as cnn
    from petastorm_tpu_torch.ops.normalize import normalize_images
    params = cnn.init(torch.Generator().manual_seed(seed),
                      num_classes=IMAGE_CLASSES, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(seed + 1)
    x = torch.randint(0, 256, (8, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen,
                      device='cuda', dtype=torch.uint8)
    labels = torch.randint(0, IMAGE_CLASSES, (8,), generator=gen,
                           device='cuda')
    zero, one = torch.zeros(3), torch.ones(3)
    with torch.no_grad():
        k4 = cnn.loss_fn(params, normalize_images(x, (0.0, 0.0, 0.0),
                                                  (1.0, 1.0, 1.0)), labels)
        plain = cnn.loss_fn(params, kernels.normalize_plain(
            x, zero, one, torch.bfloat16), labels)
    check(math.isfinite(k4.item()) and torch.equal(k4, plain),
          'image reference: K4 loss %r vs twin %r' % (k4.item(),
                                                      plain.item()))
    log('reference image CNN loss with K4 %.9f, with the twin %.9f '
        '(limit: bit-equal)' % (k4.item(), plain.item()))


def image_main_path(torch, kernels, args):
    """The example's ``train()`` on the card at its defaults, from a png
    store; two more steps profiled on the same pipeline."""
    from petastorm_tpu_torch.examples.imagenet.generate_imagenet import (
        generate, synthetic_rows)
    from petastorm_tpu_torch.examples.imagenet.main import train
    from petastorm_tpu_torch.models import image_cnn as cnn
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'images')
        start = time.perf_counter()
        n = generate(url, synthetic_rows(IMAGE_ROWS, classes=IMAGE_CLASSES,
                                         seed=args.seed),
                     row_group_size_mb=8, image_codec=IMAGE_CODEC)
        log('store %d rows, image (None, None, 3) uint8 under '
            'CompressedImageCodec(%r), 375 x 500 +-20%%, written in %.2f s'
            % (n, IMAGE_CODEC, time.perf_counter() - start))
        seen = {}

        def then(batches, step):
            seen['launches'] = dict(kernels.LAUNCHES)

            def run_step():
                b = next(batches)
                images = b['image']
                check(images.is_cuda and images.dtype == torch.uint8
                      and tuple(images.shape) == K4_SHAPE,
                      'image batch %s %s on %s' % (
                          images.dtype, tuple(images.shape), images.device))
                step(images, b['label'])
            seen['busy'] = profile_steps(torch, run_step, 2, 'normalize',
                                         'image')

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        params, losses, times = train(
            url, batch_size=IMAGE_BATCH, steps=IMAGE_STEPS,
            workers_count=IMAGE_WORKERS, num_classes=IMAGE_CLASSES,
            image_size=IMAGE_SIZE, seed=args.seed, log_every=1,
            log=lambda line: log('image ' + line), then=then)
    launches = seen['launches']
    # a step on a batch already on the card with the reader gone: what the
    # step costs without the input pipeline beside it
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    images = torch.randint(0, 256, K4_SHAPE, generator=gen, device='cuda',
                           dtype=torch.uint8)
    labels = torch.randint(0, IMAGE_CLASSES, (IMAGE_BATCH,), generator=gen,
                           device='cuda')
    step = cnn.make_train_step(params, lr=1e-3)
    alone = []
    for _ in range(4):
        t0 = time.perf_counter()
        step(images, labels)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - t0)
    check(all(math.isfinite(x) for x in losses), 'image: non-finite loss')
    check(launches['normalize'] == IMAGE_STEPS,
          'K4 launched %d times in %d image steps'
          % (launches['normalize'], IMAGE_STEPS))
    steady = statistics.median(t for _, t in times[1:])
    log('image main path %d steps, loss %.4f -> %.4f, steady step %.2f ms '
        '(batch wait %.2f ms), %.0f images/s, device busy %.1f%%, K4 '
        'launches %d; step alone on a batch on the card, reader stopped: '
        '%.2f ms'
        % (len(losses), losses[0], losses[-1], steady * 1e3,
           statistics.median(w for w, _ in times[1:]) * 1e3,
           IMAGE_BATCH / steady, seen['busy'], launches['normalize'],
           statistics.median(alone[1:]) * 1e3))
    return launches


def mnist_line(torch, args):
    from petastorm_tpu_torch.examples.mnist.main import (
        generate_synthetic_mnist, train)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'mnist')
        generate_synthetic_mnist(url, n=MNIST_ROWS, seed=args.seed)
        start = time.perf_counter()
        params, losses, acc = train(url, epochs=1, device='cuda',
                                    seed=args.seed, log=log)
        torch.cuda.synchronize()
        dt = time.perf_counter() - start
    check(params['w1'].is_cuda, 'MNIST params are not on the card')
    check(all(math.isfinite(x) for x in losses), 'MNIST: non-finite loss')
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(last < first, 'MNIST loss did not fall: %.4f -> %.4f'
          % (first, last))
    log('mnist %d rows, %d steps in %.2f s, loss %.4f -> %.4f (first and '
        'last 4 steps), accuracy %.3f' % (MNIST_ROWS, len(losses), dt, first,
                                          last, acc))


def write_mnist_list_store(np, url, rows, seed):
    """The MNIST example's rows, the image stored as an arrow list."""
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import ArrowListCodec, ScalarCodec
    from petastorm_tpu_torch.examples.mnist.main import synthetic_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('MnistListSchema', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('digit', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (28, 28), ArrowListCodec(),
                       False)])
    with materialize_dataset(url, schema, row_group_size_mb=1) as w:
        w.write_rows(synthetic_rows(rows, seed))


def expected_selection(path, holdout, split, shards):
    """What the batch line's reader must deliver, worked out with pyarrow
    and hashlib alone: ``(row groups, row groups whose min idx < holdout,
    row groups of shard 0, set of idx)``. The row groups in (file, row
    group) order; those whose footer min ``idx`` is below the holdout;
    every ``shards``-th of them from the first; of their rows, those with
    ``idx`` < holdout whose md5 bucket lies in [0, split)."""
    import hashlib
    import pyarrow.parquet as pq
    groups = []
    for name in sorted(os.listdir(path)):
        if name.endswith('.parquet') and not name.startswith(('_', '.')):
            md = pq.ParquetFile(os.path.join(path, name)).metadata
            col = md.schema.names.index('idx')
            groups.extend((os.path.join(path, name), rg,
                           md.row_group(rg).column(col).statistics.min)
                          for rg in range(md.num_row_groups))
    kept = [(f, rg) for f, rg, lo in groups if lo < holdout]
    shard = kept[::shards]
    want = set()
    for f, rg in shard:
        for idx in pq.ParquetFile(f).read_row_group(
                rg, columns=['idx']).column('idx').to_pylist():
            bucket = (int(hashlib.md5(str(idx).encode('utf-8')).hexdigest(),
                          16) / float(1 << 128))
            if idx < holdout and bucket < split:
                want.add(idx)
    return [(f, rg) for f, rg, _ in groups], kept, shard, want


def hive_filter_check(np, root):
    """A plain hive-partitioned store (no metadata) read with a partition
    filter: the same rows as ``pq.read_table(filters=...)``."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from petastorm_tpu_torch import make_batch_reader
    n = 2000
    ids = np.arange(n, dtype=np.int64)
    table = pa.table({'id': ids, 'value': ids * 0.5,
                      'name': ['row_%d' % i for i in ids],
                      'split': np.where(ids % 5 == 0, 'val', 'train')})
    pq.write_to_dataset(table, root, partition_cols=['split'])
    filters = [('split', '=', 'train')]
    with make_batch_reader('file://' + root, filters=filters,
                           workers_count=2) as reader:
        got = {}
        for b in reader:
            for i, v, name, split in zip(b.id, b.value, b.name, b.split):
                check(int(i) not in got, 'hive: id %d read twice' % i)
                got[int(i)] = (float(v), name, split)
    ref = pq.read_table(root, filters=filters).to_pydict()
    want = {i: (v, name, str(s)) for i, v, name, s in
            zip(ref['id'], ref['value'], ref['name'], ref['split'])}
    check(got == want and len(want) == 1600,
          'hive: %d rows, pyarrow %d, equal %s' % (len(got), len(want),
                                                   got == want))
    return len(got)


def batch_line(torch, np, args, device='cuda', rows=BATCH_LINE_ROWS,
               holdout=BATCH_LINE_HOLDOUT):
    """The selection surface at MNIST's size: store -> make_batch_reader
    (filters, hash split, shard) -> TorchDataLoader -> prefetch_to_device
    -> MLP SGD steps on ``device``. The reader-alone pass must deliver the
    independently reckoned ``idx`` set exactly; the training pass, which
    drops the last short batch, a subset short by less than one batch."""
    from petastorm_tpu_torch import (TorchDataLoader, make_batch_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.models import mnist_mlp
    from petastorm_tpu_torch.predicates import in_pseudorandom_split
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        path = os.path.join(d, 'mnist')
        url = 'file://' + path
        start = time.perf_counter()
        write_mnist_list_store(np, url, rows, args.seed)
        log('batch store %d rows (idx, digit, image 28 x 28 uint8 under '
            'ArrowListCodec) written in %.2f s'
            % (rows, time.perf_counter() - start))
        groups, kept, shard, want = expected_selection(
            path, holdout, BATCH_LINE_SPLIT, BATCH_LINE_SHARDS)
        filters = [('idx', '<', holdout)]

        def reader(**kw):
            return make_batch_reader(
                url, filters=filters, predicate=in_pseudorandom_split(
                    [BATCH_LINE_SPLIT, 1 - BATCH_LINE_SPLIT], 0, 'idx'),
                num_epochs=1, seed=args.seed, workers_count=4, **kw)

        with reader() as r:
            pruned = [(p.path, p.row_group) for p in r.pieces]
        check(pruned == kept, 'batch: %d row groups after pruning, the '
              'footers say %d' % (len(pruned), len(kept)))
        start = time.perf_counter()
        seen = []
        with reader(cur_shard=0, shard_count=BATCH_LINE_SHARDS) as r:
            sharded = [(p.path, p.row_group) for p in r.pieces]
            for b in r:
                seen.append(b.idx)
        alone = time.perf_counter() - start
        seen = np.concatenate(seen)
        check(sharded == shard, 'batch: shard 0 holds %d row groups, the '
              'footers say %d' % (len(sharded), len(shard)))
        check(len(np.unique(seen)) == len(seen) and set(seen.tolist()) == want,
              'batch: reader delivered %d idx (%d unique), reckoned %d'
              % (len(seen), len(np.unique(seen)), len(want)))
        log('batch row groups %d, after pruning %d, after sharding %d; '
            'reader alone (no model) %d rows in %.3f s, %.0f rows/s; '
            'delivered idx set == reckoned (%d rows)'
            % (len(groups), len(pruned), len(sharded), len(seen), alone,
               len(seen) / alone, len(want)))

        params = mnist_mlp.init(torch.Generator().manual_seed(args.seed),
                                device=device)
        losses, delivered = [], []
        start = time.perf_counter()
        with reader(cur_shard=0, shard_count=BATCH_LINE_SHARDS) as r:
            loader = TorchDataLoader(r, batch_size=BATCH_LINE_BATCH,
                                     shuffling_queue_capacity=4096,
                                     drop_last=True, seed=args.seed,
                                     device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            with contextlib.closing(batches):
                for batch in batches:
                    images = batch['image']
                    check(images.device.type == device
                          and images.dtype == torch.uint8
                          and tuple(images.shape) == (BATCH_LINE_BATCH, 28,
                                                      28),
                          'batch: images %s %s on %s' % (
                              images.dtype, tuple(images.shape),
                              images.device))
                    x = images.reshape(BATCH_LINE_BATCH, -1).float() / 255.0
                    losses.append(mnist_mlp.train_step(
                        params, x, batch['digit'], BATCH_LINE_LR))
                    delivered.append(batch['idx'])
        losses = [float(x) for x in losses]
        if device == 'cuda':
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
    delivered = torch.cat(delivered).cpu().numpy()
    check(params['w1'].device.type == device,
          'batch: parameters are not on %s' % device)
    check(len(np.unique(delivered)) == len(delivered)
          and set(delivered.tolist()) <= want
          and len(want) - len(delivered) == len(want) % BATCH_LINE_BATCH,
          'batch: trained on %d idx (%d unique) of %d reckoned'
          % (len(delivered), len(np.unique(delivered)), len(want)))
    check(all(math.isfinite(x) for x in losses), 'batch: non-finite loss')
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(last < first, 'batch: loss did not fall: %.4f -> %.4f'
          % (first, last))
    log('batch line %d steps of %d on %s in %.2f s (%.0f rows/s), loss '
        '%.4f -> %.4f (first and last 4 steps); losses %s'
        % (len(losses), BATCH_LINE_BATCH, device, wall,
           len(delivered) / wall, first, last,
           ' '.join('%.4f' % x for x in losses)))
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        n = hive_filter_check(np, os.path.join(d, 'hive'))
    log('batch hive store: split=train read with a partition filter, %d '
        'rows == pq.read_table(filters=...)' % n)


# ---------------------------------------------------------------------------
# phase 9: times
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


def bounds(shape):
    """(bound_ms, bound_by, flops) per kernel at the causal bf16 path shape:
    operations over the bf16 tensor-core peak against compulsory bytes
    (each input read once, each output written once) over HBM rate."""
    b, h, l, d = shape
    pairs = b * h * l * (l + 1) // 2            # live causal (q, k) pairs
    elem = b * h * l * d * 2                    # one bf16 (B, H, L, D)
    row = b * h * l * 4                         # one float32 (B, H, L)
    work = {'flash_fwd': (4 * d * pairs, 4 * elem + row),
            'flash_bwd_dq': (6 * d * pairs, 5 * elem + 2 * row),
            'flash_bwd_dkdv': (8 * d * pairs, 6 * elem + 2 * row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     'operations' if t_ops >= t_bytes else 'bytes', flops)
    return out


def timings(torch, kernels, gen, reps):
    b, h, l, d = PATH_SHAPE
    q, k, v, do = _operands(torch, gen, b, h, h, l, l, d, torch.bfloat16)
    kw = dict(n_heads=h, n_kv_heads=h, causal=True)
    o, lse = kernels.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    runs = {
        'flash_fwd': (lambda: kernels.flash_fwd(q, k, v, **kw),
                      lambda: kernels.flash_fwd_plain(q, k, v, **kw)),
        'flash_bwd_dq': (
            lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
            lambda: kernels.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                               **kw)),
        'flash_bwd_dkdv': (
            lambda: kernels.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw),
            lambda: kernels.flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                 **kw)),
    }
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {'ms': time_ms(torch, kern, reps),
                     'plain_ms': time_ms(torch, plain, max(3, reps // 4))}
    # yardsticks only: the port never calls these
    q4, k4, v4, do4 = (x.view(b, h, l, d) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out['flash_fwd']['library_ms'] = time_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=True), reps)
    out['flash_fwd']['library'] = 'scaled_dot_product_attention'
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True)
    o4, lse4, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    lib_bwd = aten._scaled_dot_product_flash_attention_backward
    bwd_ms = time_ms(torch, lambda: lib_bwd(do4, q4, k4, v4, o4, lse4, cum_q,
                                            cum_k, max_q, max_k, 0.0, True,
                                            seed, offset), reps)
    for name in ('flash_bwd_dq', 'flash_bwd_dkdv'):
        # one call computes dq, dk and dv: compare it with K2 + K3 together
        out[name]['library_ms'] = bwd_ms
        out[name]['library'] = ('_scaled_dot_product_flash_attention_backward'
                                ' (dq, dk, dv in one call)')
    return out


def loop_ms(torch, fn, n):
    """Device time of one ``fn()`` from ``n`` calls between two events. A
    sleep kernel queued first keeps the card busy while the host enqueues
    the calls, so the events time the launches back to back and not the
    host's launch rate; median of 5 such loops."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)          # ~25 ms at 2 GHz
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / n)
    return statistics.median(samples)


def k4_times(torch, kernels, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randint(0, 256, K4_SHAPE, generator=gen, device='cuda',
                      dtype=torch.uint8)
    zero, one = torch.zeros(3), torch.ones(3)
    bf16 = torch.bfloat16
    nbytes = x.numel() * (1 + 2)        # read uint8 once, write bf16 once
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 3 * x.numel() / PEAK_F32_FLOPS
    return {
        'ms': loop_ms(torch, lambda: kernels.normalize(x, zero, one, bf16),
                      K4_LOOP),
        'plain_ms': loop_ms(
            torch, lambda: kernels.normalize_plain(x, zero, one, bf16), 20),
        'yardstick_ms': loop_ms(torch, lambda: x.to(bf16), K4_LOOP),
        'bound': (max(t_bytes, t_ops) * 1e3,
                  'bytes' if t_bytes >= t_ops else 'operations'),
    }


# ---------------------------------------------------------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the weights, the store and the inputs')
    parser.add_argument('--profile', action='store_true',
                        help='profile two more main-path steps (device time '
                        'by kernel to standard error)')
    parser.add_argument('--ptxas-log', action='store_true',
                        help="print nvcc's register/shared-memory report")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 twins: full
    torch.backends.cudnn.allow_tf32 = False         # float32, no TF32

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])

    wall = start = time.perf_counter()
    kernels.build()
    log('build %.1f s (nvcc, one call, 4 kernels, %s)'
        % (time.perf_counter() - start,
           'cached' if kernels.BUILD_INFO['cached'] else 'fresh'))
    for line in ptxas_summary(kernels.BUILD_INFO['log']):
        log('ptxas ' + line)
    if args.ptxas_log:
        print(kernels.BUILD_INFO['log'], file=sys.stderr)

    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    b, h, l, d = PATH_SHAPE
    errs = compare_case(torch, kernels, 'path bf16 causal', gen, b=b, h=h,
                        hkv=h, lq=l, lk=l, d=d, dtype=torch.bfloat16)
    edges = [('ragged L=300', dict(b=2, h=2, hkv=2, lq=300, lk=300)),
             ('non-causal 300x170', dict(b=1, h=2, hkv=2, lq=300, lk=170,
                                         causal=False)),
             ('gqa 8->2', dict(b=1, h=8, hkv=2, lq=256, lk=256)),
             ('segments masked row', dict(b=2, h=2, hkv=2, lq=300, lk=300,
                                          segmented=True)),
             ('window=128', dict(b=1, h=2, hkv=2, lq=512, lk=512,
                                 window=128))]
    for dtype, tag in ((torch.bfloat16, 'bf16'), (torch.float32, 'f32')):
        for label, shape in edges:
            case = compare_case(torch, kernels, '%s %s' % (tag, label), gen,
                                d=64, dtype=dtype, **shape)
            if dtype == torch.bfloat16:
                for name, err in case.items():
                    errs[name] = max(errs[name], err)
    case = compare_case(torch, kernels, 'bf16 non-negative q,k,v,do', gen,
                        b=2, h=4, hkv=4, lq=1024, lk=1024, d=64,
                        dtype=torch.bfloat16, nonneg=True)
    for name, err in case.items():
        errs[name] = max(errs[name], err)

    phase = time.perf_counter()
    errs['normalize'] = k4_check(torch, kernels, args.seed)
    log('phase K4 check %.1f s' % (time.perf_counter() - phase))

    reference_check(torch, tlm, args.seed)
    phase = time.perf_counter()
    image_reference_check(torch, kernels, args.seed)
    log('phase image reference %.1f s' % (time.perf_counter() - phase))

    launches = main_path(torch, np, tlm, kernels, args)
    phase = time.perf_counter()
    launches['normalize'] = image_main_path(torch, kernels,
                                            args)['normalize']
    log('phase image main path %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    mnist_line(torch, args)
    log('phase MNIST line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    batch_line(torch, np, args)
    log('phase batch line %.1f s' % (time.perf_counter() - phase))

    times = timings(torch, kernels, gen, REPS)
    bound = bounds(PATH_SHAPE)
    phase = time.perf_counter()
    k4 = k4_times(torch, kernels, args.seed)
    log('phase K4 times %.1f s' % (time.perf_counter() - phase))
    times['normalize'] = {
        'ms': k4['ms'], 'plain_ms': k4['plain_ms'], 'library_ms': None,
        'library': 'none: no single PyTorch call computes this function',
        'yardstick_ms': k4['yardstick_ms'],
        'yardstick': 'x.to(torch.bfloat16): the same bytes, not the function'}
    bound['normalize'] = k4['bound']
    table = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        row = {'name': name, 'route': 'cuda', 'source': source,
               'replaces': replaces, 'status': 'ported',
               'launches': launches[name],
               'max_abs_err': errs[name], 'ms': t['ms'],
               'plain_ms': t['plain_ms'], 'bound_ms': bound[name][0],
               'bound_by': bound[name][1],
               'library_ms': t['library_ms'], 'library': t['library']}
        if 'yardstick_ms' in t:
            row.update(yardstick_ms=t['yardstick_ms'],
                       yardstick=t['yardstick'])
        table.append(row)
        rate = ('%.1f TFLOP/s, ' % (bound[name][2] / t['ms'] / 1e9)
                if name in FLASH else '')
        log('time %-15s %.4f ms, %s%.1f%% of its bound (bound %.4f ms by %s, '
            'plain %.4f ms, library %s: %s%s)'
            % (name, t['ms'], rate, 100 * bound[name][0] / t['ms'],
               bound[name][0], bound[name][1], t['plain_ms'],
               'n/a' if t['library_ms'] is None
               else '%.4f ms' % t['library_ms'], t['library'],
               '; yardstick %.4f ms, %s' % (t['yardstick_ms'],
                                            t['yardstick'])
               if 'yardstick_ms' in t else ''))
    bwd = times['flash_bwd_dq']['ms'] + times['flash_bwd_dkdv']['ms']
    aten = times['flash_bwd_dq']['library_ms']
    log('time backward K2 + K3 %.4f ms, aten flash backward (dq, dk, dv) '
        '%.4f ms: %.2fx' % (bwd, aten, bwd / aten))
    log('wall %.1f s' % (time.perf_counter() - wall))
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
