"""The decode ceiling and two timing bars of ``chip_smoke.py``'s phase 28,
read over longer windows than the quick benchmark twins take.

    python3 chip_bar_probe.py [--pairs 20] [--device cpu] \
        [--parts decode autotune podelastic] [--recovery]

1. ``decode``: ``decode_batch``'s mnist store at its full size (16,384 png
   rows). The 1-worker batched line, median of 5 passes, as
   ``decode_batch`` measures it; then the calibrated single-stream decode
   ceiling probed three ways, three times each: as ``decode_batch`` probes
   it (``reader.profile`` inside a live 1-worker reader), quiet on the 3
   sampled row groups (no reader running), and quiet on every row group.
   Each ceiling is printed with the line's share of it.
2. ``autotune``: the autotune bench's quick slow-io line (its pinned shim
   and hand-tuned grid), then ``--pairs`` pairs with the controller off
   and on, the order flipped each pair, and as many pairs off and off: the
   null, what the host's noise alone puts between two passes. With
   ``--recovery`` the pairs follow the bench's own sequence: its
   mis-tuned pass and its 30 s recovery run under the controller first.
3. ``podelastic``: the podelastic bench's quick store under the trace;
   ``--pairs`` pairs of plain lease-grid delivery then the elastic plane
   (the bench's order), as many the other way round, and as many of plain
   delivery twice (the null).

A pair's delta is ``100 * (first - second) / first`` in the null and
``100 * (plain - plane) / plain`` otherwise, so a positive delta is a cost.
Each part prints one JSON line; the last line holds all of them. The
device (CUDA unless ``--device cpu``) is where the calibration stages.
Temporary directories are removed at the end.
"""
import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time


def spread(deltas):
    """Median, quartiles and the count of positive deltas of a pair set."""
    q = statistics.quantiles(deltas, n=4) if len(deltas) > 1 else deltas * 3
    return {'pairs': len(deltas), 'median_pct': round(statistics.median(
        deltas), 2), 'q1_pct': round(q[0], 2), 'q3_pct': round(q[2], 2),
        'positive': sum(d > 0 for d in deltas),
        'deltas_pct': [round(d, 2) for d in deltas]}


def delta(first, second):
    return 100.0 * (first - second) / first if first else 0.0


def decode_part(tmpdir, target, repeats=3):
    from petastorm_tpu_torch import profiler
    from petastorm_tpu_torch.benchmark import decode_batch
    from petastorm_tpu_torch.benchmark.northstar import (
        generate_mnist_images_dataset)
    from petastorm_tpu_torch.etl.dataset_metadata import (
        infer_or_load_unischema, load_row_groups)
    from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM

    path = os.path.join(tmpdir, 'mnist')
    url = 'file://' + path
    generate_mnist_images_dataset(url, rows=16384)
    decode_batch._run_pass(url, True, 1)       # priming, discarded
    runs = [decode_batch._run_pass(url, True, 1)['samples_per_sec']
            for _ in range(5)]
    line = statistics.median(runs)
    schema, _ = infer_or_load_unischema(path, LOCAL_FILESYSTEM)
    pieces = load_row_groups(path, filesystem=LOCAL_FILESYSTEM)
    ceilings = {'live_3_groups': [], 'quiet_3_groups': [],
                'quiet_all_groups': []}
    for n in range(repeats):
        # a fresh calibration directory: 'auto' probes instead of loading
        os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = os.path.join(
            tmpdir, 'cal%d' % n)
        ceilings['live_3_groups'].append(decode_batch._profile_line(
            url, 1, line, target)['binding_ceiling_samples_per_s'])
        for key, groups in (('quiet_3_groups', 3),
                            ('quiet_all_groups', len(pieces))):
            cal = profiler.calibrate(path, pieces, schema,
                                     sample_row_groups=groups, save=False,
                                     device=target)
            ceilings[key].append(cal['ceilings']['decode'])
    return {'part': 'decode', 'rows': 16384, 'row_groups': len(pieces),
            'line_samples_per_s': line, 'line_runs': runs,
            'ceilings_samples_per_s': ceilings,
            'line_pct_of_median_ceiling': {
                k: round(100.0 * line / statistics.median(v), 2)
                for k, v in ceilings.items()}}


def autotune_part(tmpdir, target, pairs, recovery=False):
    from petastorm_tpu_torch import profiler
    from petastorm_tpu_torch.autotune import AUTOTUNE_DIR_ENV_VAR
    from petastorm_tpu_torch.benchmark import autotune
    from petastorm_tpu_torch.benchmark.northstar import (
        generate_mnist_images_dataset)

    path = os.path.join(tmpdir, 'autotune')
    scratch = os.path.join(tmpdir, 'arbitration')
    os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = os.path.join(
        tmpdir, 'autotune-cal')
    os.environ[AUTOTUNE_DIR_ENV_VAR] = scratch
    rows, pass_s = 512, 2.0                        # the quick bench's sizes
    generate_mnist_images_dataset('file://' + path, rows=rows,
                                  row_group_size_mb=0.05)
    make_slow_fs = autotune._pin_slow_io(path, rows, target)[0]
    grid, (workers, readahead) = autotune._hand_tune(path, make_slow_fs,
                                                     pass_s)
    if recovery:
        autotune._measure_rate(path, make_slow_fs(), 1, 0, pass_s)
        autotune._recovery_run(path, make_slow_fs(),
                               0.8 * max(grid.values()), 30.0, scratch,
                               target)

    def rate(tuned):
        return autotune._steady_rate(path, make_slow_fs, workers, readahead,
                                     pass_s, tuned, scratch, target)

    on_off, null = [], []
    for pair in range(pairs):
        order = (False, True) if pair % 2 == 0 else (True, False)
        rates = {tuned: rate(tuned) for tuned in order}
        on_off.append(delta(rates[False], rates[True]))
        null.append(delta(rate(False), rate(False)))
    return {'part': 'autotune', 'rows': rows, 'pass_s': pass_s,
            'grid': grid, 'config': {'workers': workers,
                                     'io_readahead': readahead},
            'after_recovery_run': recovery,
            'controller_off_on': spread(on_off), 'null_off_off': spread(null)}


def podelastic_part(tmpdir, pairs):
    from petastorm_tpu_torch.benchmark import podelastic

    dataset = podelastic._make_dataset(tmpdir, 240)   # the quick bench's
    try:
        plain, plane = podelastic._clean_passes(dataset, tmpdir, 8, seed=20)
        plain()
        plane('warmup')
        ordered, flipped, null = [], [], []
        for i in range(pairs):
            off = plain()
            ordered.append(delta(off, plane('a%d' % i)))
            on = plane('b%d' % i)
            flipped.append(delta(plain(), on))
            null.append(delta(plain(), plain()))
    finally:
        dataset.close()
    return {'part': 'podelastic', 'rows': 240, 'batch_size': 8,
            'plain_then_plane': spread(ordered),
            'plane_then_plain': spread(flipped),
            'null_plain_plain': spread(null)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--pairs', type=int, default=20)
    parser.add_argument('--device', default='cuda',
                        help="where calibration stages: 'cuda' or 'cpu'")
    parser.add_argument('--parts', nargs='+',
                        default=['decode', 'autotune', 'podelastic'])
    parser.add_argument('--recovery', action='store_true',
                        help="autotune: the bench's recovery run first")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    target = resolve_cli_device(args.device, 'chip_bar_probe.py')
    import subprocess
    card = None
    if target.type == 'cuda':
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(card, flush=True)
    out = {'card': card, 'cpu_count': os.cpu_count(), 'parts': []}
    tmpdir = tempfile.mkdtemp(prefix='chip_bar_probe_')
    try:
        for part in args.parts:
            start = time.perf_counter()
            if part == 'decode':
                result = decode_part(tmpdir, target)
            elif part == 'autotune':
                result = autotune_part(tmpdir, target, args.pairs,
                                       args.recovery)
            else:
                result = podelastic_part(tmpdir, args.pairs)
            result['seconds'] = round(time.perf_counter() - start, 1)
            out['parts'].append(result)
            print(json.dumps(result), flush=True)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
