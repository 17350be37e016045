"""Phase 19 (a) of ``chip_smoke.py`` alone, several runs at each row-group
size: how often the autotune controller widens the png line on the card.

    python3 chip_tune_probe.py --runs 6 --group-mb 1 2 8

Each run writes the 256-image png store in row groups of about the given
size, reads it on one worker thread under the controller into CNN steps on
K4 (``chip_smoke.tuned_png_line``) and holds phase 19 (a)'s gates; a run
whose gate fails is counted, not fatal. The last line is one JSON object:
the failed gates by row-group size. Needs one CUDA device.
"""
import argparse
import json
import os
import sys
import tempfile
import time
import types


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--runs', type=int, default=6,
                        help='runs at each row-group size')
    parser.add_argument('--group-mb', type=int, nargs='+', default=[1],
                        help='row-group sizes (MB), taken in turn')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('chip_tune_probe: no CUDA device; nothing was run',
              file=sys.stderr)
        return 2
    import numpy as np
    import chip_smoke as cs
    from petastorm_tpu_torch.autotune import AUTOTUNE_DIR_ENV_VAR
    from petastorm_tpu_torch.ops import kernels
    from petastorm_tpu_torch.profiler import CALIBRATION_DIR_ENV_VAR
    cs.CARD = cs.subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(cs.CARD)
    kernels.build()
    seed = types.SimpleNamespace(seed=args.seed)
    failed = {mb: [] for mb in args.group_mb}
    for n in range(args.runs * len(args.group_mb)):
        mb = args.group_mb[n % len(args.group_mb)]
        with tempfile.TemporaryDirectory(dir=cs.ROOT,
                                         prefix='.smoke-store-') as d:
            os.environ[CALIBRATION_DIR_ENV_VAR] = os.path.join(d, 'cal')
            scratch = os.path.join(d, 'scratch')
            os.environ[AUTOTUNE_DIR_ENV_VAR] = scratch
            start = time.perf_counter()
            try:
                cs.tuned_png_line(torch, np, kernels, seed, d, 'cuda',
                                  scratch, cs.IMAGE_ROWS, cs.IMAGE_BATCH,
                                  cs.IMAGE_SIZE, group_mb=mb)
                verdict = 'held'
            except RuntimeError as e:
                failed[mb].append(str(e))
                verdict = 'failed: %s' % e
            cs.log('run %d, row groups of %d MB: %s (%.1f s)'
                   % (n, mb, verdict, time.perf_counter() - start))
    print(json.dumps({'runs': args.runs, 'failed': failed}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
