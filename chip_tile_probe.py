"""K1-K3 (bf16) builds timed against each other on one card, in one call.

    python3 chip_tile_probe.py [--head-dim 128 | --shape B H L D]
                               [--variants ...]
                               [--checkouts DIR ...] [--parent [DIR]]
                               [--rounds 2] [--reps 30]

Builds: ``sources`` (the package's library), each of ``--variants`` (a copy
of ``petastorm_tpu_torch/csrc`` with a few lines replaced, below), and the
``petastorm_tpu_torch/csrc`` of each of ``--checkouts`` (say, the parent
commit unpacked with ``git archive``), named by its directory. Each build
is compiled alone (one ``nvcc`` call) and bound in place of the package's
library; a checkout's C entry points must take the flash arguments the
sources' wrappers pass. ``--parent`` adds the checkout at ``DIR``
(``_archive/parent`` by default: the parent commit unpacked there with
``git archive``), timed as ``parent``.

Variants of K1 (flash forward) at head dims 32 and 128, each the sources'
Hopper schedule without one of its parts: ``k1_exp2f`` puts exp2f's
full-range 2^x back in place of ex2.approx; ``k1_branch_mask`` the mask's
branch an element in place of its selects; ``k1_live_on_diagonal``
``Mask::live`` in place of the causal test alone on a causal band's
diagonal tile; ``k1_not_persistent`` a block an item in place of a block
an SM; ``k1_round_robin`` a block's items in plain round robin (b, G + b,
...) in place of every other row reversed; ``k1_d128_64rows_288`` the parent's 64-row kv tiles in a 288-thread
block (168 registers, no setmaxnreg) at D 128; ``k1_d128_2_stages`` 2
stages in place of 3 at D 128; ``diag_k1_no_exp`` leaves its exponential
out (p = s scale2 - m: timed, never checked).
Variants of K3 (flash dk/dv): ``k3_d128_168regs`` is what setmaxnreg buys
it at head dim 128: the sources' block (384 threads, the producer
warpgroup handing its registers to the two consumer warpgroups, 232 a
thread) against a 288-thread block at the 168 registers its launch bound
allows, where ptxas spills. ``k3_d64_realloc`` gives head dim 64 the
384-thread block too, where the sources' 288 threads spill 16 bytes.
Variants of K2 and K3 at head dim 32: ``d32_exp2f`` puts exp2f's
full-range 2^x back in place of ex2.approx; ``diag_d32_no_softmax`` leaves
out the elementwise work (p = s), to see what it costs (its outputs are
wrong: timed, never checked). Variants of K2 and K3 past head dim 256:
``k2_wide_cluster_all`` runs K2's cluster kernel wherever a cluster of
up to 8 blocks spans D (the sources take it up to 2 blocks, D 512),
``k2_wide_streaming`` nowhere; ``diag_k2_cluster_local`` has each block
of the clusters read its own partials in place of the cluster's, and
``diag_k2_wide_no_restream`` and ``diag_k3_wide_no_restream`` the
streaming kernels with their fixed operand (K2's Q and dO, K3's K and V)
loaded at the first tile only: the traffic model's test (timed, never
checked). ``parent_*`` variants edit the checkout given
with ``--parent`` instead: the parent commit's head dim 32 kernels on two
blocks an SM, with ex2.approx, with the mask a select in one loop, with
K3's 4 stages and 384-thread block, without the exponential.
Every build prints ptxas's performance warnings (a serialized wgmma).

First every build's ``ptxas`` registers and spills of the bf16 kernels;
with ``--sass``, each other build's machine code (``cuobjdump -sass``)
against the sources', kernel by kernel, for every kernel both builds
have (one line each: identical, or the first instruction that differs);
then, in the first round, each build's K1-K3 against the float32 twins
(``chip_smoke.compare_case``: the edge shapes and the causal path shape at
``--head-dim``, under its gates); then each round times every build in
turn, the order reversed from one round to the next, at the path shape of
``--head-dim`` (``chip_smoke``'s (8, 16, 2048, 32), (8, 8, 2048, 64),
(8, 4, 2048, 128), (8, 2, 2048, 256) or (8, 1, 2048, 512), or at 576
DeepSeek-V3's absorbed-MLA shape (1, 128, 2048, 576) over one kv head;
or at ``--shape``, say the north-star LM's attention (8, 8, 256, 32); bf16
causal; ``chip_smoke.timings``: ``--reps`` launches back to back between
two CUDA events, median of 5 such loops, and the median of as many single
calls, each between two events, beside SDPA and a library backward). Past
head dim 256 a checkout from before the wide kernels fails its launches:
give it with ``--rounds 0`` (machine code only). The last line is one JSON
object of every timing. Needs a CUDA device and ``nvcc``.
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# variant: [(source, what is replaced, by what)]
VARIANTS = {
    'k3_d128_168regs': [
        ('flash_bwd_sm90.cu', 'static constexpr bool kRealloc = D == 128;',
         'static constexpr bool kRealloc = false;')],
    'k3_d64_realloc': [
        ('flash_bwd_sm90.cu', 'static constexpr bool kRealloc = D == 128;',
         'static constexpr bool kRealloc = D >= 64;')],
    # a diagnostic of the head dim 32 kernels: the exponentials and the
    # elementwise work left out (p = s)
    'diag_d32_no_softmax': [
        ('flash_bwd_sm90.cu', 'const float p = ex2(sc[r] * scale2 - st[c]);',
         'const float p = sc[r];'),
        ('flash_bwd_sm90.cu', 'sc[r] = ex2(sc[r] * scale2 - st[c]);', ''),
        ('flash_bwd_sm90.cu',
         'dp[r] = sc[r] * (dp[r] - st[kRowsQ + c]) * scale;',
         'dp[r] += sc[r];'),
        ('flash_bwd_dq_sm90.cu',
         'const float p = ex2(sc[r] * scale2 - lse2[h]);',
         'const float p = sc[r];'),
        ('flash_bwd_dq_sm90.cu',
         'dp[r] = (live ? p : 0.f) * (dp[r] - dlt[h]) * scale;',
         'dp[r] += live ? p : 0.f;'),
        ('flash_bwd_dq_sm90.cu',
         'dp[r] = ex2(sc[r] * scale2 - lse2[h]) * (dp[r] - dlt[h]) * scale;',
         'dp[r] += sc[r];')],
    # ... and with exp2f's full-range 2^x in place of ex2.approx
    'd32_exp2f': [
        (name, '= ex2(', '= exp2f(')
        for name in ('flash_bwd_sm90.cu', 'flash_bwd_dq_sm90.cu')],
    # K1's Hopper schedule (head dims 32 and 128) without each of its parts
    'k1_exp2f': [('flash_fwd_sm90.cu', '= ex2(', '= exp2f(')],
    'k1_branch_mask': [
        ('flash_fwd_sm90.cu',
         '      sc[r] = mask.live(qpos[h], k0 + c, sq[h], seg != nullptr ? '
         'seg[c] : 0)\n                  ? sc[r] : neg_inf();\n',
         '      if (!mask(qpos[h], k0 + c, sq[h], seg != nullptr ? seg[c] '
         ': 0))\n        sc[r] = neg_inf();\n'),
        ('flash_fwd_sm90.cu',
         'sc[r] = k0 + c <= qpos[h] ? sc[r] : neg_inf();',
         'if (k0 + c > qpos[h]) sc[r] = neg_inf();')],
    'k1_live_on_diagonal': [
        ('flash_fwd_sm90.cu',
         'sc[r] = k0 + c <= qpos[h] ? sc[r] : neg_inf();',
         'sc[r] = mask.live(qpos[h], k0 + c, sq[h], 0) ? sc[r] : neg_inf();')],
    'k1_not_persistent': [
        ('flash_fwd_sm90.cu',
         'const int grid = (int)(items < sms ? items : sms);',
         'const int grid = (int)items;')],
    'k1_round_robin': [('flash_fwd_sm90.cu',
                        '((k & 1) ? G - 1 - b : b)', 'b')],
    'k1_d128_64rows_288': [
        ('flash_fwd_sm90.cu', 'constexpr int kRowsKH = 128;',
         'constexpr int kRowsKH = 64;'),
        ('flash_fwd_sm90.cu', 'static constexpr bool kRealloc = true;',
         'static constexpr bool kRealloc = D == 32;')],
    'k1_d128_2_stages': [
        ('flash_fwd_sm90.cu',
         'static constexpr int kStages = D == 32 ? 4 : 3;',
         'static constexpr int kStages = D == 32 ? 4 : 2;')],
    # a diagnostic of K1's Hopper schedule: the exponential left out
    'diag_k1_no_exp': [('flash_fwd_sm90.cu',
                        'sc[r] = ex2(fmaf(sc[r], scale2, neg_m[h]));',
                        'sc[r] = fmaf(sc[r], scale2, neg_m[h]);')],
    # K2's wide kernel on a cluster wherever one spans D (up to kClusterMax
    # blocks), or nowhere: the streaming kernel at every D past 256
    'k2_wide_cluster_all': [
        ('flash_bwd_dq_sm90.cu', 'constexpr int kDqClusterBlocks = 2;',
         'constexpr int kDqClusterBlocks = kClusterMax;')],
    'k2_wide_streaming': [
        ('flash_bwd_dq_sm90.cu', 'constexpr int kDqClusterBlocks = 2;',
         'constexpr int kDqClusterBlocks = 0;')],
    # a diagnostic of K2's cluster kernel wherever one spans D: each block
    # reads its own partials n times in place of the cluster's (the
    # exchange's barriers kept; timed, never checked)
    'diag_k2_cluster_local': [
        ('flash_bwd_dq_sm90.cu', 'constexpr int kDqClusterBlocks = 2;',
         'constexpr int kDqClusterBlocks = kClusterMax;'),
        ('sm90.cuh', 'x[r] = ld_cluster4(cluster_map(slot + j * stride, r));',
         'x[r] = ld_cluster4(slot + j * stride);')],
}
# ... and the streaming kernels without their restreaming: K2's Q and dO
# chunks (K3's K and V) loaded at the first tile only, so each byte of the
# fixed operand crosses from L2 once a block (timed, never checked)
VARIANTS['diag_k2_wide_no_restream'] = VARIANTS['k2_wide_streaming'] + [
    ('flash_bwd_dq_sm90.cu',
     '          mbar_arrive_tx(full, C::kChunk);\n'
     '          tma_load_3d(dst, &tmQ, full, col, q0, bh);\n'
     '          tma_load_3d(dst + C::kOffDO, &tmDO, full, col, q0, bh);\n',
     '          mbar_arrive_tx(full, i == 0 ? C::kChunk : 2 * C::kChunkK);\n'
     '          if (i == 0) {\n'
     '            tma_load_3d(dst, &tmQ, full, col, q0, bh);\n'
     '            tma_load_3d(dst + C::kOffDO, &tmDO, full, col, q0, bh);\n'
     '          }\n')]
VARIANTS['diag_k3_wide_no_restream'] = [
    ('flash_bwd_sm90.cu',
     '          mbar_arrive_tx(full, C::kChunk);\n'
     '          tma_load_3d(dst, &tmK, full, col, k0, kvh);\n'
     '          tma_load_3d(dst + C::kOffV, &tmV, full, col, k0, kvh);\n',
     '          mbar_arrive_tx(full, i == 0 ? C::kChunk : 2 * C::kChunkQ);\n'
     '          if (i == 0) {\n'
     '            tma_load_3d(dst, &tmK, full, col, k0, kvh);\n'
     '            tma_load_3d(dst + C::kOffV, &tmV, full, col, k0, kvh);\n'
     '          }\n')]
# Variants of the parent's head dim 32 kernels (the Tile<32> instantiations
# of dq_sm90_kernel and dkdv_sm90_kernel that this PR's commit replaced),
# built from the checkout given with --parent.
PARENT_VARIANTS = {
    # two blocks an SM (ptxas then caps a thread at 96 registers and spills)
    'parent_d32_two_blocks': [
        ('flash_bwd_sm90.cu', '__launch_bounds__(Bwd<D>::kThreads, 1)',
         '__launch_bounds__(Bwd<D>::kThreads, D == 32 ? 2 : 1)'),
        ('flash_bwd_dq_sm90.cu', '__launch_bounds__(Dq<D>::kThreads, 1)',
         '__launch_bounds__(Dq<D>::kThreads, D == 32 ? 2 : 1)')],
    'parent_d32_ex2_approx': [
        ('sm90.cuh', 'constexpr float kLog2e = 1.4426950408889634f;',
         'constexpr float kLog2e = 1.4426950408889634f;\n'
         '__device__ __forceinline__ float ex2f(float x) {\n'
         '  float y;\n'
         '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
         '  return y;\n}'),
        ('flash_bwd_sm90.cu', 'exp2f(', 'ex2f('),
        ('flash_bwd_dq_sm90.cu', 'exp2f(', 'ex2f(')],
    # the mask as a select: every term evaluated, no branch an element
    'parent_d32_select': [
        ('flash_common.cuh', '    return ok;\n  }\n',
         '    return ok;\n  }\n'
         '  __device__ __forceinline__ bool live(int qp, int kp, int sq,\n'
         '                                       int sk) const {\n'
         '    const bool in_band = (qp >= kp) & ((window <= 0) |\n'
         '                                       (qp - kp < window));\n'
         '    return (kp < Lk) & (qp < Lq) & (sq == sk) & (!causal | '
         'in_band);\n  }\n'),
        ('flash_bwd_sm90.cu',
         '      if (need_mask &&\n'
         '          !mask(q0 + c, kpos[(r >> 1) & 1],\n'
         '                reinterpret_cast<const int*>(st)[2 * kRowsQ + c],\n'
         '                sk[(r >> 1) & 1]))\n'
         '        p = 0.f;\n',
         '      p = (!need_mask |\n'
         '           mask.live(q0 + c, kpos[(r >> 1) & 1],\n'
         '                     reinterpret_cast<const int*>(st)[2 * kRowsQ '
         '+ c],\n'
         '                     sk[(r >> 1) & 1])) ? p : 0.f;\n'),
        ('flash_bwd_dq_sm90.cu',
         '      if (need_mask &&\n'
         '          !mask(qpos[h], k0 + c, sq[h],\n'
         '                segk != nullptr ? seg_tile[s * kRowsK + c] : 0))\n'
         '        p = 0.f;\n',
         '      p = (!need_mask |\n'
         '           mask.live(qpos[h], k0 + c, sq[h],\n'
         '                     segk != nullptr ? seg_tile[s * kRowsK + c] '
         ': 0)) ? p : 0.f;\n')],
    'parent_k3_d32_realloc': [
        ('flash_bwd_sm90.cu', 'static constexpr bool kRealloc = D == 128;',
         'static constexpr bool kRealloc = D == 128 || D == 32;')],
    'parent_k3_4_stages': [
        ('flash_bwd_sm90.cu', 'constexpr int kStages = 2;',
         'constexpr int kStages = 4;')],
    'parent_diag_no_exp': [
        ('flash_bwd_sm90.cu', 'exp2f(', '('),
        ('flash_bwd_dq_sm90.cu', 'exp2f(', '(')],
}
PARENT_VARIANTS['parent_d32_two_blocks_ex2'] = (
    PARENT_VARIANTS['parent_d32_two_blocks']
    + PARENT_VARIANTS['parent_d32_ex2_approx'])
# the parent's templates with the mask a select and ex2.approx (what the
# head dim 32 kernels change in the elementwise work), and with K3's 4
# stages and 384-thread block too
PARENT_VARIANTS['parent_d32_select_ex2'] = (
    PARENT_VARIANTS['parent_d32_select']
    + PARENT_VARIANTS['parent_d32_ex2_approx'])
PARENT_VARIANTS['parent_d32_select_ex2_k3_4_stages_realloc'] = (
    PARENT_VARIANTS['parent_d32_select_ex2']
    + PARENT_VARIANTS['parent_k3_4_stages']
    + PARENT_VARIANTS['parent_k3_d32_realloc'])
#: Variants whose outputs are knowingly wrong (a step of the work left
#: out, to see what it costs): timed, never held against the twins.
DIAGNOSTIC = {'parent_diag_no_exp', 'diag_d32_no_softmax',
              'diag_k1_no_exp', 'diag_k2_cluster_local', 'diag_k2_wide_no_restream',
              'diag_k3_wide_no_restream'}


def build_variant(kernels, csrc_from, edits, tmpdir):
    """The library of the sources in ``csrc_from`` with ``edits``; returns
    (lib, nvcc report, path of the library)."""
    csrc = os.path.join(tmpdir, 'csrc')
    shutil.copytree(csrc_from, csrc)
    for name, old, new in edits:
        path = os.path.join(csrc, name)
        src = open(path).read()
        if old not in src:
            raise RuntimeError('%s: %r not found' % (name, old))
        with open(path, 'w') as f:
            f.write(src.replace(old, new))
    so = os.path.join(tmpdir, 'lib.so')
    proc = subprocess.run(
        [kernels._nvcc(), *kernels._NVCC_FLAGS, '-o', so,
         *(os.path.join(csrc, n) for n in sorted(os.listdir(csrc))
           if n.endswith('.cu'))], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError('nvcc failed:\n' + proc.stdout + proc.stderr)
    lib = kernels.bind(ctypes.CDLL(so), kernels._SIGNATURES)
    return lib, proc.stdout + proc.stderr, so


def sass(kernels, so):
    """{kernel: [instructions]} of a library's machine code. A kernel is
    named by its mangled name with the source's anonymous namespace (a
    hash of the file) cut out, and the float32 backward's block rows
    (a template argument of 64 since head dim 256 took 32) dropped, so two
    builds of the same kernel get the same name."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), 'cuobjdump')
    text = subprocess.run([tool, '-sass', so], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        head = re.match(r'\s*Function : (\S+)', line)
        if head:
            name = re.sub(r'\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}', '',
                          head.group(1))
            name = re.sub(r'((?:dq|dkdv)_kernelI\w*?Li\d+E)Li64E', r'\1',
                          name)
            out[name] = []
        elif name is not None:
            ins = re.match(r'\s*/\*[0-9a-f]{4}\*/\s+(.*?)\s*;', line)
            if ins:
                out[name].append(ins.group(1))
    return out


def compare_sass(kernels, libs):
    """One line a kernel of each build that the sources' build also has:
    its machine code identical to the sources', or where it first
    differs."""
    ref = sass(kernels, libs['sources'][2])
    for name, (_, _, so) in libs.items():
        if name == 'sources':
            continue
        other = sass(kernels, so)
        for kernel in sorted(set(ref) & set(other)):
            a, b = ref[kernel], other[kernel]
            diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                        None if len(a) == len(b) else min(len(a), len(b)))
            print('sass %s %s: %s' % (
                name, kernel, 'identical (%d instructions)' % len(a)
                if diff is None else 'differs at instruction %d of %d/%d: '
                '%r vs %r' % (diff, len(a), len(b),
                              a[diff] if diff < len(a) else None,
                              b[diff] if diff < len(b) else None)),
                  flush=True)


def backward_ms(torch, kernels, gen, reps, shape, hkv):
    """{K2, K3: device ms} at the causal bf16 ``shape`` (``hkv`` kv
    heads): ``chip_smoke.loop_ms`` of ``reps`` launches back to back."""
    import chip_smoke
    b, h, l, d = shape
    q, k, v, do = chip_smoke._operands(torch, gen, b, h, hkv, l, l, d,
                                       torch.bfloat16)
    kw = dict(n_heads=h, n_kv_heads=hkv, causal=True)
    o, lse = kernels.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    return {
        'flash_bwd_dq': chip_smoke.loop_ms(torch, lambda: kernels.flash_bwd_dq(
            q, k, v, do, lse, delta, **kw), reps),
        'flash_bwd_dkdv': chip_smoke.loop_ms(
            torch, lambda: kernels.flash_bwd_dkdv(q, k, v, do, lse, delta,
                                                  **kw), reps)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--head-dim', type=int, default=128,
                        choices=(32, 64, 128, 256, 512, 576))
    parser.add_argument('--variants', nargs='*', default=list(VARIANTS),
                        choices=list(VARIANTS) + list(PARENT_VARIANTS))
    parser.add_argument('--checkouts', nargs='*', default=[],
                        help='checkouts whose kernels are built and timed, '
                             'each named by its directory')
    parser.add_argument('--parent', nargs='?', default=None,
                        const=os.path.join(ROOT, '_archive', 'parent'),
                        help='add the parent commit unpacked at this '
                             'directory (default _archive/parent)')
    parser.add_argument('--shape', type=int, nargs=4, default=None,
                        metavar=('B', 'H', 'L', 'D'),
                        help='time at this (batch, heads, length, head dim) '
                             'instead of the head dim\'s path shape')
    parser.add_argument('--sass', action='store_true',
                        help="compare each build's machine code with the "
                             "sources', kernel by kernel")
    parser.add_argument('--no-check', action='store_true',
                        help='time the builds without holding them against '
                             'the twins first (the card tests do that)')
    parser.add_argument('--backward-only', action='store_true',
                        help='time K2 and K3 alone (the device time of '
                             '--reps launches back to back), without K1, '
                             'the twins and the library calls')
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--reps', type=int, default=30)
    args = parser.parse_args(argv)
    if args.shape:
        args.head_dim = args.shape[3]
    import torch
    if not torch.cuda.is_available():
        print('chip_tile_probe: no CUDA device; nothing was run',
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from petastorm_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 twins
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    chip_smoke.CARD = card
    print(card, flush=True)
    shape = {**chip_smoke.HEAD_DIM_PATHS, 64: chip_smoke.PATH_SHAPE,
             256: chip_smoke.WIDE_PATH, 512: chip_smoke.WIDER_PATHS[512],
             576: chip_smoke.MLA_SHAPE}.get(args.head_dim)
    if args.shape:
        shape = tuple(args.shape)
    if shape is None:
        parser.error('no path shape at head dim %d: give --shape'
                     % args.head_dim)
    hkv = chip_smoke.MLA_HKV if shape == chip_smoke.MLA_SHAPE else shape[1]
    libs = {'sources': (kernels.build(), kernels.BUILD_INFO['log'],
                        kernels.BUILD_INFO['path'])}
    if set(args.variants) & set(PARENT_VARIANTS) and not args.parent:
        parser.error('variants of the parent need --parent')
    parent_csrc = os.path.join(args.parent or '', 'petastorm_tpu_torch',
                               'csrc')
    builds = [(name, parent_csrc, PARENT_VARIANTS[name])
              if name in PARENT_VARIANTS else
              (name, str(kernels._CSRC), VARIANTS[name])
              for name in args.variants]
    checkouts = args.checkouts + ([args.parent] if args.parent else [])
    builds += [(os.path.basename(os.path.normpath(path)),
                os.path.join(path, 'petastorm_tpu_torch', 'csrc'), [])
               for path in checkouts]
    tmpdirs = [tempfile.mkdtemp(prefix='chip_tile_probe_') for _ in builds]
    try:
        start = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(builds) or 1) as pool:
            built = pool.map(lambda b, tmp: build_variant(kernels, b[1], b[2],
                                                          tmp),
                             builds, tmpdirs)
            for (name, _, _), lib in zip(builds, built):
                libs[name] = lib
        print('%d builds in %.1f s (nvcc, all at once)'
              % (len(builds), time.perf_counter() - start), flush=True)
        for name, (_, report, _) in libs.items():
            for line in chip_smoke.ptxas_summary(report):
                if 'sm90' in line:
                    print('ptxas %s %s' % (name, line), flush=True)
            for line in report.splitlines():
                if 'Performance' in line or 'serialized' in line:
                    print('ptxas %s %s' % (name, line.strip()), flush=True)
        if args.sass:
            compare_sass(kernels, libs)
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = {'card': card, 'shape': shape, 'timings': []}
        b, h, l, d = shape
        for rnd in range(args.rounds):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in order:
                kernels._lib = libs[name][0]
                if rnd == 0 and name not in DIAGNOSTIC and not args.no_check:
                    for label, edge in chip_smoke.EDGE_CASES:
                        chip_smoke.compare_case(
                            torch, kernels, '%s D=%d %s' % (name, d, label),
                            gen, d=d, dtype=torch.bfloat16, **edge)
                    chip_smoke.compare_case(
                        torch, kernels, '%s D=%d path' % (name, d), gen,
                        b=b, h=h, hkv=hkv, lq=l, lk=l, d=d,
                        dtype=torch.bfloat16)
                if args.backward_only:
                    row = {'round': rnd, 'build': name}
                    row.update(backward_ms(torch, kernels, gen, args.reps,
                                           shape, hkv))
                    out['timings'].append(row)
                    print('round %d %-15s D=%d K2 %.4f K3 %.4f ms'
                          % (rnd, name, d, row['flash_bwd_dq'],
                             row['flash_bwd_dkdv']), flush=True)
                    continue
                t = chip_smoke.timings(torch, kernels, gen, args.reps, shape,
                                       hkv)
                row = {'round': rnd, 'build': name}
                row.update({k: t[k]['ms'] for k in chip_smoke.FLASH})
                row.update(sdpa_ms=t['flash_fwd']['library_ms'],
                           aten_bwd_ms=t['flash_bwd_dq']['library_ms'])
                row['call_ms'] = {k: t[k]['call_ms'] for k in chip_smoke.FLASH}
                row['call_ms'].update(
                    sdpa=t['flash_fwd']['library_call_ms'],
                    aten_bwd=t['flash_bwd_dq']['library_call_ms'])
                out['timings'].append(row)
                print('round %d %-15s D=%d K1 %.4f K2 %.4f K3 %.4f ms (%s '
                      '%.4f, %s %.4f); one call K1 %.4f K2 %.4f K3 %.4f, '
                      'library %.4f, %.4f'
                      % (rnd, name, d, row['flash_fwd'], row['flash_bwd_dq'],
                         row['flash_bwd_dkdv'], t['flash_fwd']['library'],
                         row['sdpa_ms'], t['flash_bwd_dq']['library'],
                         row['aten_bwd_ms'],
                         *(row['call_ms'][k] for k in (*chip_smoke.FLASH,
                                                       'sdpa', 'aten_bwd'))),
                      flush=True)
    finally:
        for tmp in tmpdirs:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
