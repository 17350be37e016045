"""Health-layer overhead benchmark (JAX ``benchmark/health_overhead.py``):
items/s with heartbeats + watchdog + debug endpoint on vs fully off.

The live health layer's contract is "always-on cheap": worker heartbeats are
a few attribute assignments per stage, the watchdog is one low-frequency
evaluation thread, and the debug endpoint an idle accept loop — none of it
on the per-item hot path. Expected overhead: ~0. This bench quantifies that
on the row reader path with the same alternating-pass protocol as
``benchmark/trace_overhead.py``:

1. **Baseline passes** — ``make_reader`` with ``PETASTORM_TPU_HEALTH=0``
   (every beat call site compiled out, no watchdog, no endpoint), full
   consumption, items/s recorded.
2. **Health passes** — identical reader with heartbeats on (the default)
   PLUS the full live layer armed: ``stall_timeout=2`` (watchdog ticking at
   0.5 s) and ``debug_port=0`` (HTTP server bound and accepting).
3. Modes alternate (off, on, off, on, ...) with the within-pair order
   flipped each pair, so monotone host drift bills both modes equally; the
   headline is the **median** of each mode and

   ``overhead_pct = 100 * (baseline_median - health_median) / baseline_median``.

Each health pass also asserts the layer actually ran: heartbeat entities
were published for the ventilator and every worker, and the watchdog's
verdict on the completed pass is ``healthy`` — the artifact records that the
measured run exercised the real subsystem, not a disabled stub.

The full run asserts **overhead < 5%** (the expectation is ~0);
``--quick`` shrinks the store and asserts a looser bar (sub-second passes
are noise-dominated; the quick gate catches a rewrite that makes
heartbeats accidentally hot, not the headline number). Nothing here
touches a device.

Usage (output is always JSON)::

    python -m petastorm_tpu_torch.benchmark.health_overhead [--quick] \
        [--no-check]
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
from petastorm_tpu_torch.health import HEALTH_ENV_VAR


def _run_pass(url: str, health: bool, epochs: int, workers: int) -> dict:
    """One full consumption pass on the row reader; returns items/s and,
    for health passes, the published entities + watchdog verdict."""
    from petastorm_tpu_torch.reader import make_reader

    saved = os.environ.get(HEALTH_ENV_VAR)
    os.environ[HEALTH_ENV_VAR] = '1' if health else '0'
    kwargs = {}
    if health:
        # the whole live layer, armed: heartbeats + watchdog + endpoint
        kwargs = dict(stall_timeout=2, debug_port=0)
    try:
        with make_reader(url, reader_pool_type='thread',
                         workers_count=workers, shuffle_row_groups=False,
                         num_epochs=epochs, **kwargs) as reader:
            start = time.perf_counter()
            rows = sum(1 for _ in reader)
            wall = time.perf_counter() - start
            out = {
                'rows': rows,
                'wall_s': round(wall, 4),
                'items_per_s': round(rows / wall, 1) if wall else 0.0,
            }
            if health:
                heartbeats = reader.health.heartbeats()
                out['entities'] = sorted(heartbeats)
                out['verdict'] = reader.watchdog.evaluate()['state']
                out['debug_port'] = reader.debug_port
    finally:
        if saved is None:
            os.environ.pop(HEALTH_ENV_VAR, None)
        else:
            os.environ[HEALTH_ENV_VAR] = saved
    return out


def run_health_overhead_bench(quick: bool = False, check: bool = True,
                              dataset_path: str = None) -> dict:
    """Alternating health-on/health-off passes; returns one JSON-able dict.
    ``quick`` shrinks the store (looser overhead bar);
    ``check=False`` reports without asserting."""
    rows = 384 if quick else 4096
    rows_per_group = 8
    epochs = 2 if quick else 3
    workers = 2
    passes = 3 if quick else 7
    max_overhead_pct = _max_overhead_pct(quick)

    tmpdir = None
    if dataset_path is None:
        tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_health_bench_')
        dataset_path = tmpdir
    url = 'file://' + dataset_path
    try:
        generate_readahead_dataset(url, rows=rows,
                                   rows_per_group=rows_per_group)
        # one discarded priming pass: cold page cache / codec compilation
        # must not bill either mode
        _run_pass(url, False, 1, workers)

        # best-of-two attempts in quick mode: transient host load must not
        # flip the sub-second quick gate (same discipline as trace_overhead)
        baseline = health = None
        overhead_pct = 0.0
        for _attempt in range(2 if quick else 1):
            baseline, health = [], []
            for i in range(passes):
                # alternate the within-pair order: host drift is monotone
                # over seconds, and a fixed order would bill it to one mode
                if i % 2 == 0:
                    baseline.append(_run_pass(url, False, epochs, workers))
                    health.append(_run_pass(url, True, epochs, workers))
                else:
                    health.append(_run_pass(url, True, epochs, workers))
                    baseline.append(_run_pass(url, False, epochs, workers))
            base_med = statistics.median(r['items_per_s'] for r in baseline)
            health_med = statistics.median(r['items_per_s'] for r in health)
            overhead_pct = (100.0 * (base_med - health_med) / base_med
                            if base_med else 0.0)
            if overhead_pct < max_overhead_pct:
                break

        last_health = health[-1]
        result = {
            'quick': quick,
            'rows': rows,
            'epochs': epochs,
            'workers': workers,
            'passes_per_mode': passes,
            'baseline_items_per_s': base_med,
            'health_items_per_s': health_med,
            'overhead_pct': round(overhead_pct, 2),
            'entities': last_health['entities'],
            'verdict': last_health['verdict'],
            'baseline_runs': [r['items_per_s'] for r in baseline],
            'health_runs': [r['items_per_s'] for r in health],
        }
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            _check_exact(result)
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
    """The plane ran: a ``healthy`` verdict on the completed pass, with
    heartbeats of the ventilator and the workers."""
    assert result['verdict'] == 'healthy', (
        'a clean full-consumption pass must classify healthy, got '
        '{!r}'.format(result['verdict']))
    assert 'ventilator' in result['entities'] and any(
        e.startswith('worker-') for e in result['entities']), (
        'health passes must actually publish heartbeats, got '
        '{}'.format(result['entities']))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='health-layer overhead benchmark (items/s on vs off)')
    parser.add_argument('--quick', action='store_true',
                        help='small store/fewer passes')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the overhead assertion')
    args = parser.parse_args(argv)
    result = run_health_overhead_bench(quick=args.quick,
                                       check=not args.no_check)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
