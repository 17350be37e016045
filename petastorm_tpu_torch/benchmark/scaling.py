"""Decode-parallel worker scaling (JAX ``benchmark/scaling.py``).

Runs the mnist north-star train bench at workers in {1, 2, 4, 8} and
records the samples/sec + overlap curve together with the host's core
count: the measurement behind the claim that the worker pool scales decode
across cores. On a single-core host the curve is expected (and recorded)
to be flat: decode is CPU-bound and the workers time-slice one core.

The MLP steps run on ``device`` (the CUDA device unless ``device='cpu'``;
without CUDA it raises). On CUDA the bench takes JAX's accelerator sizes
(16,384 rows, batch 512, hidden 2048), on the CPU JAX's CPU sizes (2,048
rows, batch 128, hidden 256, 15 steps). The store is written to a scratch
directory and removed afterwards; the result is written to
``output_path`` only when the caller names one.

Usage::

    python -m petastorm_tpu_torch.benchmark.scaling [output.json] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile


def run(output_path: str = None, worker_counts=(1, 2, 4, 8),
        rows: int = 16384, batch_size: int = 512, num_steps: int = 60,
        device=None) -> dict:
    """The worker curve on ``device``; writes the result to
    ``output_path`` when one is given and returns it."""
    from petastorm_tpu_torch.benchmark import northstar
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.profiler import device_name

    target = resolve_device(device)
    platform = 'gpu' if target.type == 'cuda' else 'cpu'
    on_accel = target.type != 'cpu'
    if not on_accel:
        rows, batch_size, num_steps = 2048, 128, 15
    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_scaling_')
    url = 'file://' + os.path.join(tmpdir, 'mnist_{}'.format(rows))
    try:
        northstar.generate_mnist_images_dataset(url, rows=rows)
        hidden = 2048 if on_accel else 256
        curve = []
        for workers in worker_counts:
            report = northstar.run_mnist_train_bench(
                url, batch_size=batch_size, num_steps=num_steps,
                workers_count=workers, hidden=hidden, device=target)
            entry = {'workers': workers}
            entry.update(report.as_dict())
            curve.append(entry)
            print('workers={}: {:.0f} samples/sec, {:.2f}% overlap'.format(
                workers, report.samples_per_sec, 100 * report.overlap),
                file=sys.stderr)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    result = {
        'workload': 'mnist_train northstar (png decode -> MLP step)',
        'platform': platform,
        'host_cpu_count': os.cpu_count(),
        'batch_size': batch_size,
        'num_steps': num_steps,
        'rows': rows,
        'curve': curve,
        'note': ('read the two columns separately: SAMPLES/SEC is flat on a '
                 '1-core host (decode is CPU-bound; workers time-slice the '
                 'core, so no real decode scaling is possible), while '
                 'OVERLAP% can still RISE with workers: more workers '
                 'deepen effective read-ahead, so per-step stalls are '
                 'partially absorbed by buffered batches and re-attributed '
                 'from stall to compute. Rising overlap at flat throughput '
                 'is queueing/attribution, NOT decode scaling. True scaling '
                 'needs host_cpu_count real cores to back the pool; the '
                 'device is {}.'.format(device_name(target))),
    }
    if output_path:
        from petastorm_tpu_torch.utils import atomic_write
        atomic_write(output_path, lambda f: json.dump(result, f, indent=2))
    return result


def _check_exact(result: dict) -> None:
    bad = [e for e in result['curve'] if not e['samples_per_sec'] > 0]
    assert not bad, 'no samples/s at {}'.format(bad)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='mnist train bench at 1, 2, 4 and 8 decode workers')
    parser.add_argument('output', nargs='?', default=None,
                        help='write the JSON result here too')
    parser.add_argument('--device', default='cuda',
                        help="where the MLP steps run: 'cuda' (the "
                             "default; raises without CUDA) or 'cpu'")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(
        args.device, 'python -m petastorm_tpu_torch.benchmark.scaling')
    result = run(args.output, device=device)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
