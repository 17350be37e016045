"""Lineage-layer overhead benchmark (JAX
``benchmark/lineage_overhead.py``): items/s with default-on sample lineage
vs ``PETASTORM_TPU_LINEAGE=0``.

The lineage layer's contract is "always-on within noise": one provenance
record per row-group item on the worker side, one ring insert per item on
the consumer side, and per-row work only as a single vectorized ``int64``
column through the loader's shuffling buffer, no per-row Python objects
anywhere. This bench quantifies that on the row reader +
:class:`~petastorm_tpu_torch.torch_utils.TorchDataLoader` path (the
deepest lineage plumbing: envelopes, registration, packed source columns,
batch provenance; the loader stages each batch to ``device``, the CUDA
device unless ``device='cpu'``; without CUDA it raises) with the same
alternating-pass protocol as ``trace_overhead`` / ``health_overhead``:

1. **Baseline passes**: ``PETASTORM_TPU_LINEAGE=0`` (no envelopes, no
   ledgers, no source columns), full consumption through the loader.
2. **Lineage passes**: lineage at its default (on), identical
   configuration; each pass also records that the layer ran: every
   batch carries ``_provenance`` and the coverage audit reports the
   consumed epochs complete.
3. Modes alternate with the within-pair order flipped each pair so monotone
   host drift bills both modes equally; the headline is the **median** of
   each mode and

   ``overhead_pct = 100 * (baseline_median - lineage_median) / baseline_median``.

The full run asserts **overhead < 5%**; ``quick`` shrinks the store and
asserts a looser bar (sub-second passes are noise-dominated; the quick
gate catches a rewrite that puts Python objects on the per-row path, not
the headline number).

Usage (output is always JSON)::

    python -m petastorm_tpu_torch.benchmark.lineage_overhead [--quick] \
        [--no-check] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
import time

from petastorm_tpu_torch.benchmark.readahead import generate_readahead_dataset
from petastorm_tpu_torch.lineage import LINEAGE_ENV_VAR, PROVENANCE_KEY


def _run_pass(url: str, lineage: bool, epochs: int, workers: int,
              batch_size: int = 16, target=None) -> dict:
    """One full loader-consumption pass onto ``target`` (a resolved
    device); returns items/s and, for lineage passes, the audit verdict +
    batch-provenance evidence."""
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.torch_utils import TorchDataLoader

    saved = os.environ.get(LINEAGE_ENV_VAR)
    os.environ[LINEAGE_ENV_VAR] = '1' if lineage else '0'
    try:
        with make_reader(url, reader_pool_type='thread',
                         workers_count=workers, shuffle_row_groups=False,
                         num_epochs=epochs) as reader:
            loader = TorchDataLoader(reader, batch_size=batch_size,
                                     shuffling_queue_capacity=4 * batch_size,
                                     device=target)
            start = time.perf_counter()
            rows = 0
            provenanced = 0
            for batch in loader:
                rows += len(batch['id'])
                if PROVENANCE_KEY in batch:
                    provenanced += 1
            wall = time.perf_counter() - start
            out = {
                'rows': rows,
                'wall_s': round(wall, 4),
                'items_per_s': round(rows / wall, 1) if wall else 0.0,
                'provenanced_batches': provenanced,
            }
            if lineage:
                report = reader.lineage.coverage_report()
                out['audit_complete'] = report['complete']
                out['epochs_audited'] = len(report['epochs'])
    finally:
        if saved is None:
            os.environ.pop(LINEAGE_ENV_VAR, None)
        else:
            os.environ[LINEAGE_ENV_VAR] = saved
    return out


def run_lineage_overhead_bench(quick: bool = False, check: bool = True,
                               dataset_path: str = None,
                               device=None) -> dict:
    """Alternating lineage-on/off passes, the loader staging to ``device``
    (CUDA unless ``'cpu'``; without CUDA it raises); returns one JSON-able
    dict. ``quick`` shrinks the store (looser overhead bar);
    ``check=False`` reports without asserting."""
    from petastorm_tpu_torch.device import resolve_device

    target = resolve_device(device)
    rows = 384 if quick else 4096
    rows_per_group = 8
    epochs = 2 if quick else 3
    workers = 2
    passes = 3 if quick else 7
    max_overhead_pct = _max_overhead_pct(quick)

    tmpdir = None
    if dataset_path is None:
        tmpdir = tempfile.mkdtemp(
            prefix='petastorm_tpu_torch_lineage_bench_')
        dataset_path = tmpdir
    url = 'file://' + dataset_path
    try:
        generate_readahead_dataset(url, rows=rows,
                                   rows_per_group=rows_per_group)

        def run_pass(on, n_epochs):
            return _run_pass(url, on, n_epochs, workers, target=target)

        # one discarded priming pass: cold page cache / codec compilation
        # must not bill either mode
        run_pass(False, 1)

        # best-of-two attempts in quick mode: transient host load must not
        # flip the sub-second quick gate (same discipline as trace_overhead)
        baseline = lineage = None
        overhead_pct = 0.0
        for _attempt in range(2 if quick else 1):
            baseline, lineage = [], []
            for i in range(passes):
                # alternate the within-pair order: host drift is monotone
                # over seconds, and a fixed order would bill it to one mode
                if i % 2 == 0:
                    baseline.append(run_pass(False, epochs))
                    lineage.append(run_pass(True, epochs))
                else:
                    lineage.append(run_pass(True, epochs))
                    baseline.append(run_pass(False, epochs))
            base_med = statistics.median(r['items_per_s'] for r in baseline)
            lineage_med = statistics.median(r['items_per_s'] for r in lineage)
            overhead_pct = (100.0 * (base_med - lineage_med) / base_med
                            if base_med else 0.0)
            if overhead_pct < max_overhead_pct:
                break

        last = lineage[-1]
        result = {
            'quick': quick,
            'rows': rows,
            'epochs': epochs,
            'workers': workers,
            'passes_per_mode': passes,
            'baseline_items_per_s': base_med,
            'lineage_items_per_s': lineage_med,
            'overhead_pct': round(overhead_pct, 2),
            'audit_complete': last['audit_complete'],
            'epochs_audited': last['epochs_audited'],
            'provenanced_batches': last['provenanced_batches'],
            'baseline_runs': [r['items_per_s'] for r in baseline],
            'lineage_runs': [r['items_per_s'] for r in lineage],
        }
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            _check_exact(result)
            assert all(r['provenanced_batches'] == 0 for r in baseline), (
                'PETASTORM_TPU_LINEAGE=0 must disable all publication')
            assert_bars(_bars(result))
        return result
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


def _max_overhead_pct(quick: bool) -> float:
    return 25.0 if quick else 5.0


def _bars(result: dict) -> list:
    """The timing bar: the plane's cost in items/s, median of the
    alternating pairs."""
    return [('overhead %', result['overhead_pct'], '<',
             _max_overhead_pct(result['quick']))]


def _check_exact(result: dict) -> None:
    """The plane ran: batch provenance on the lineage passes and a
    complete audit of the consumed epochs."""
    assert result['audit_complete'] is True, (
        'a clean full-consumption pass must audit complete')
    assert result['provenanced_batches'] > 0, (
        'lineage passes must actually attach batch provenance')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='lineage-layer overhead benchmark (items/s on vs off)')
    parser.add_argument('--quick', action='store_true',
                        help='small store/fewer passes')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the overhead assertion')
    parser.add_argument('--device', default='cuda',
                        help="where the loader stages: 'cuda' (the "
                             "default; raises without CUDA) or 'cpu'")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(
        args.device,
        'python -m petastorm_tpu_torch.benchmark.lineage_overhead')
    result = run_lineage_overhead_bench(quick=args.quick,
                                        check=not args.no_check,
                                        device=device)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
