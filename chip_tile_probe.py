"""K1-K3 (bf16) builds timed against each other on one card, in one call.

    python3 chip_tile_probe.py [--head-dim 128] [--variants ...]
                               [--checkouts DIR ...] [--rounds 2] [--reps 30]

Builds: ``sources`` (the package's library), each of ``--variants`` (a copy
of ``petastorm_tpu_torch/csrc`` with a few lines replaced, below), and the
``petastorm_tpu_torch/csrc`` of each of ``--checkouts`` (say, the parent
commit unpacked with ``git archive``), named by its directory. Each build
is compiled alone (one ``nvcc`` call) and bound in place of the package's
library; a checkout's C entry points must take the flash arguments the
sources' wrappers pass.

Variants of K3 (flash dk/dv): ``k3_d128_168regs`` is what setmaxnreg buys
it at head dim 128: the sources' block (384 threads, the producer
warpgroup handing its registers to the two consumer warpgroups, 232 a
thread) against a 288-thread block at the 168 registers its launch bound
allows, where ptxas spills. ``k3_d64_realloc`` gives head dim 64 the
384-thread block too, where the sources' 288 threads spill 16 bytes.

First every build's ``ptxas`` registers and spills of the bf16 kernels;
then, in the first round, each build's K1-K3 against the float32 twins
(``chip_smoke.compare_case``: the edge shapes and the causal path shape at
``--head-dim``, under its gates); then each round times every build in
turn, the order reversed from one round to the next, at the path shape of
``--head-dim`` (``chip_smoke``'s (8, 16, 2048, 32), (8, 8, 2048, 64) or
(8, 4, 2048, 128), bf16 causal; ``chip_smoke.timings``: median of
``--reps`` CUDA-event-timed launches, beside SDPA and aten's flash
backward). The last line is one JSON object of every timing. Needs a CUDA
device and ``nvcc``.
"""
import argparse
import ctypes
import json
import os
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
}


def build_variant(kernels, csrc_from, edits, tmpdir):
    """The library of the sources in ``csrc_from`` with ``edits``; returns
    (lib, nvcc report)."""
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
    return lib, proc.stdout + proc.stderr


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--head-dim', type=int, default=128,
                        choices=(32, 64, 128))
    parser.add_argument('--variants', nargs='*', default=list(VARIANTS),
                        choices=list(VARIANTS))
    parser.add_argument('--checkouts', nargs='*', default=[],
                        help='checkouts whose kernels are built and timed, '
                             'each named by its directory')
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--reps', type=int, default=30)
    args = parser.parse_args(argv)
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
    shape = {**chip_smoke.HEAD_DIM_PATHS,
             64: chip_smoke.PATH_SHAPE}[args.head_dim]
    libs = {'sources': (kernels.build(), kernels.BUILD_INFO['log'])}
    builds = [(name, str(kernels._CSRC), VARIANTS[name])
              for name in args.variants]
    builds += [(os.path.basename(os.path.normpath(path)),
                os.path.join(path, 'petastorm_tpu_torch', 'csrc'), [])
               for path in args.checkouts]
    tmpdirs = []
    try:
        for name, csrc, edits in builds:
            tmpdirs.append(tempfile.mkdtemp(prefix='chip_tile_probe_'))
            start = time.perf_counter()
            libs[name] = build_variant(kernels, csrc, edits, tmpdirs[-1])
            print('%s built in %.1f s' % (name, time.perf_counter() - start),
                  flush=True)
        for name, (_, report) in libs.items():
            for line in chip_smoke.ptxas_summary(report):
                if 'sm90' in line:
                    print('ptxas %s %s' % (name, line), flush=True)
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = {'card': card, 'shape': shape, 'timings': []}
        b, h, l, d = shape
        for rnd in range(args.rounds):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in order:
                kernels._lib = libs[name][0]
                if rnd == 0:
                    for label, edge in chip_smoke.EDGE_CASES:
                        chip_smoke.compare_case(
                            torch, kernels, '%s D=%d %s' % (name, d, label),
                            gen, d=d, dtype=torch.bfloat16, **edge)
                    chip_smoke.compare_case(
                        torch, kernels, '%s D=%d path' % (name, d), gen,
                        b=b, h=h, hkv=h, lq=l, lk=l, d=d,
                        dtype=torch.bfloat16)
                t = chip_smoke.timings(torch, kernels, gen, args.reps, shape)
                row = {'round': rnd, 'build': name}
                row.update({k: t[k]['ms'] for k in chip_smoke.FLASH})
                row.update(sdpa_ms=t['flash_fwd']['library_ms'],
                           aten_bwd_ms=t['flash_bwd_dq']['library_ms'])
                out['timings'].append(row)
                print('round %d %-15s D=%d K1 %.4f K2 %.4f K3 %.4f ms (SDPA '
                      '%.4f, aten backward %.4f)'
                      % (rnd, name, d, row['flash_fwd'], row['flash_bwd_dq'],
                         row['flash_bwd_dkdv'], row['sdpa_ms'],
                         row['aten_bwd_ms']), flush=True)
    finally:
        for tmp in tmpdirs:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
