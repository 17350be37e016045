"""Latency-plane overhead benchmark (JAX
``benchmark/latency_overhead.py``): items/s with default-on streaming
histograms + SLO monitoring vs ``PETASTORM_TPU_LATENCY=0``.

The tail-latency plane's contract is "always-on within noise": every
observation is one arithmetic bucket index plus two integer adds under a
lock, worker deltas ride the existing accounting message, and the e2e
anchor is one dict insert per ventilated item. This bench quantifies that
on the row reader + :class:`~petastorm_tpu_torch.torch_utils.TorchDataLoader`
path (worker io/decode observations, queue-wait/deserialize at delivery,
infeed/train spans, ventilate-to-batch e2e correlation, plus an armed
``SLOMonitor``; the loader stages each batch to ``device``, the CUDA device
unless ``device='cpu'``; without CUDA it raises) with the same
alternating-pass protocol as ``trace_overhead`` / ``health_overhead`` /
``lineage_overhead``:

1. **Baseline passes**: ``PETASTORM_TPU_LATENCY=0`` (no histograms
   anywhere: ``ReaderStats.latency is None``, workers carry no delta
   accumulators), full consumption through the loader.
2. **Latency passes**: the plane at its default (on) with SLO targets
   armed; each pass records that the subsystem ran: the per-stage
   histograms are populated (io/decode/queue_wait/e2e all counted), the
   derived p99 keys are nonzero, and the SLO verdict evaluated.
3. Modes alternate with the within-pair order flipped each pair, and the
   headline is the **median of per-pair deltas**: each pair's two passes
   run back to back, so the pair delta cancels drift slower than one
   pair, and the median across pairs rejects the odd loaded-host pair:

   ``overhead_pct = median_i(100 * (baseline_i - latency_i) / baseline_i)``.

4. Each pass also records its **process CPU time** (``getrusage``, worker
   threads included: the pool is thread-based). On an oversubscribed
   host, wall-clock medians inherit scheduler noise far above the effect
   size; CPU time is scheduling-immune and measures the *work* the plane
   adds. ``cpu_overhead_pct`` is the tight gate (<2% full run); the
   wall-clock figure gates at <5%.

The full run asserts **overhead < 5%** and records the serial io+decode
roofline of the store (a dummy-pool raw-reader pass, the ``shared_cache``
bench's protocol) so the headline carries roofline context. ``quick``
shrinks the store and asserts a looser bar (sub-second passes are
noise-dominated; the quick gate catches a rewrite that puts per-row
Python on the record path, not the headline number).

Usage (output is always JSON)::

    python -m petastorm_tpu_torch.benchmark.latency_overhead [--quick] \
        [--no-check] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import statistics
import tempfile
import time

from petastorm_tpu_torch.benchmark.readahead import generate_readahead_dataset
from petastorm_tpu_torch.latency import LATENCY_ENV_VAR


def _run_pass(url: str, latency: bool, epochs: int, workers: int,
              batch_size: int = 16, target=None) -> dict:
    """One full loader-consumption pass onto ``target`` (a resolved
    device); returns items/s and, for latency passes, the
    populated-histogram + SLO evidence."""
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.torch_utils import TorchDataLoader

    saved = os.environ.get(LATENCY_ENV_VAR)
    os.environ[LATENCY_ENV_VAR] = '1' if latency else '0'
    try:
        slo = (dict(p99_e2e_ms=60_000.0, min_samples_per_s=0.001)
               if latency else None)
        with make_reader(url, reader_pool_type='thread',
                         workers_count=workers, shuffle_row_groups=False,
                         num_epochs=epochs, slo=slo) as reader:
            loader = TorchDataLoader(reader, batch_size=batch_size,
                                     shuffling_queue_capacity=4 * batch_size,
                                     device=target)
            usage_before = resource.getrusage(resource.RUSAGE_SELF)
            start = time.perf_counter()
            rows = 0
            for batch in loader:
                rows += len(batch['id'])
            wall = time.perf_counter() - start
            usage_after = resource.getrusage(resource.RUSAGE_SELF)
            cpu_s = ((usage_after.ru_utime - usage_before.ru_utime)
                     + (usage_after.ru_stime - usage_before.ru_stime))
            out = {
                'rows': rows,
                'wall_s': round(wall, 4),
                'cpu_s': round(cpu_s, 4),
                'items_per_s': round(rows / wall, 1) if wall else 0.0,
            }
            if latency:
                summary = reader.latency.summary() if reader.latency else {}
                out['histogram_counts'] = {
                    stage: entry['count'] for stage, entry in summary.items()}
                snap = reader.stats.snapshot()
                out['queue_wait_p99_s'] = round(
                    snap.get('queue_wait_p99_s', 0.0), 6)
                out['e2e_latency_p99_s'] = round(
                    snap.get('e2e_latency_p99_s', 0.0), 6)
                verdict = reader.slo.evaluate()
                out['slo_evaluated'] = verdict['evaluations'] >= 1
                out['slo_breached'] = verdict['breached']
            else:
                out['latency_plane_absent'] = reader.latency is None
    finally:
        if saved is None:
            os.environ.pop(LATENCY_ENV_VAR, None)
        else:
            os.environ[LATENCY_ENV_VAR] = saved
    return out


def _serial_roofline(url: str) -> dict:
    """Serial io+decode ceiling of the store: a dummy-pool raw-reader pass
    (no loader, no threading) — the ``shared_cache`` bench's roofline
    protocol, giving the headline its required roofline context."""
    from petastorm_tpu_torch.reader import make_reader
    with make_reader(url, reader_pool_type='dummy', num_epochs=1,
                     shuffle_row_groups=False) as reader:
        start = time.perf_counter()
        rows = sum(1 for _ in reader)
        wall = time.perf_counter() - start
    return {'rows': rows,
            'samples_per_sec': round(rows / wall, 1) if wall else 0.0}


def run_latency_overhead_bench(quick: bool = False, check: bool = True,
                               dataset_path: str = None,
                               device=None) -> dict:
    """Alternating latency-on/off passes, the loader staging to ``device``
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
    # wall-clock gate = this protocol's noise floor (layers that measure ~0
    # in CPU time read a few percent either way); the scheduling-immune
    # CPU-time gate is the tight one
    max_overhead_pct, max_cpu_overhead_pct = _max_overheads_pct(quick)

    tmpdir = None
    if dataset_path is None:
        tmpdir = tempfile.mkdtemp(
            prefix='petastorm_tpu_torch_latency_bench_')
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
        roofline = _serial_roofline(url)

        # best-of-two attempts in quick mode: transient host load must not
        # flip the sub-second quick gate (same discipline as trace_overhead)
        baseline = latency = None
        overhead_pct = 0.0
        for _attempt in range(2 if quick else 1):
            baseline, latency = [], []
            for i in range(passes):
                # alternate the within-pair order: host drift is monotone
                # over seconds, and a fixed order would bill it to one mode
                if i % 2 == 0:
                    baseline.append(run_pass(False, epochs))
                    latency.append(run_pass(True, epochs))
                else:
                    latency.append(run_pass(True, epochs))
                    baseline.append(run_pass(False, epochs))
            base_med = statistics.median(r['items_per_s'] for r in baseline)
            latency_med = statistics.median(r['items_per_s']
                                            for r in latency)
            pair_deltas = [
                100.0 * (b['items_per_s'] - l['items_per_s'])
                / b['items_per_s']
                for b, l in zip(baseline, latency) if b['items_per_s']]
            overhead_pct = statistics.median(pair_deltas)
            base_cpu = statistics.median(r['cpu_s'] for r in baseline)
            latency_cpu = statistics.median(r['cpu_s'] for r in latency)
            cpu_overhead_pct = (100.0 * (latency_cpu - base_cpu) / base_cpu
                                if base_cpu else 0.0)
            if (overhead_pct < max_overhead_pct
                    and cpu_overhead_pct < max_cpu_overhead_pct):
                break

        last = latency[-1]
        roofline_sps = roofline['samples_per_sec']
        result = {
            'quick': quick,
            'rows': rows,
            'epochs': epochs,
            'workers': workers,
            'passes_per_mode': passes,
            'baseline_items_per_s': base_med,
            'latency_items_per_s': latency_med,
            'overhead_pct': round(overhead_pct, 2),
            'overhead_statistic': 'median of per-pair deltas',
            'pair_deltas_pct': [round(d, 2) for d in pair_deltas],
            'baseline_cpu_s': round(base_cpu, 3),
            'latency_cpu_s': round(latency_cpu, 3),
            'cpu_overhead_pct': round(cpu_overhead_pct, 2),
            'spread_pct': round(
                100.0 * (max(r['items_per_s'] for r in baseline)
                         - min(r['items_per_s'] for r in baseline))
                / base_med, 1) if base_med else None,
            'histogram_counts': last['histogram_counts'],
            'queue_wait_p99_s': last['queue_wait_p99_s'],
            'e2e_latency_p99_s': last['e2e_latency_p99_s'],
            'slo_evaluated': last['slo_evaluated'],
            'baseline_runs': [r['items_per_s'] for r in baseline],
            'latency_runs': [r['items_per_s'] for r in latency],
            # serial io+decode ceiling: the loader path pays collation on
            # top of io+decode, so its fraction of this ceiling is context
            # for the headline, not a target
            'roofline': {
                'samples_per_sec': roofline_sps,
                'protocol': 'serial dummy-pool raw-reader pass '
                            '(shared_cache bench protocol)',
                'roofline_pct': round(100.0 * latency_med / roofline_sps, 2)
                if roofline_sps else None,
            },
        }
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            _check_exact(result)
            assert all(r.get('latency_plane_absent') for r in baseline), (
                'PETASTORM_TPU_LATENCY=0 must create no histogram state')
            assert_bars(_bars(result))
        return result
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


def _max_overheads_pct(quick: bool) -> tuple:
    """The bars on the items/s and the process CPU time overheads."""
    return (25.0, 10.0) if quick else (5.0, 2.0)


def _bars(result: dict) -> list:
    """The timing bars: the plane's cost in items/s, and in process CPU
    time (the scheduling-immune statistic), medians of the pairs."""
    items, cpu = _max_overheads_pct(result['quick'])
    return [('overhead %', result['overhead_pct'], '<', items),
            ('cpu overhead %', result['cpu_overhead_pct'], '<', cpu)]


def _check_exact(result: dict) -> None:
    """The plane ran: every stage's histogram populated, a live e2e p99
    and an evaluated SLO verdict."""
    counts = result['histogram_counts']
    for stage in ('io', 'decode', 'queue_wait', 'e2e_batch',
                  'infeed_wait'):
        assert counts.get(stage, 0) > 0, (
            'the measured run must actually populate the {} '
            'histogram; counts={}'.format(stage, counts))
    assert result['e2e_latency_p99_s'] > 0.0, (
        'the derived e2e p99 must be live in the measured run')
    assert result['slo_evaluated'], (
        'the armed SLO monitor must have evaluated')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='latency-plane overhead benchmark (items/s on vs off)')
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
        'python -m petastorm_tpu_torch.benchmark.latency_overhead')
    result = run_latency_overhead_bench(quick=args.quick,
                                        check=not args.no_check,
                                        device=device)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
