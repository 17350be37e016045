"""Chaos benchmark (JAX ``benchmark/chaos.py``): hedged + retried reads
vs plain reads under injected heavy-tail read latency, plus the fault
plane's clean-path overhead.

The tail-at-scale claim of the hedging layer is that a duplicate read fired
when the primary exceeds the live threshold converts stragglers from
p99-defining events into near-median reads. Local disks have no tail, so
this bench injects one with the seeded :mod:`petastorm_tpu_torch.faultfs`
``read-hangs`` scenario (an occasional ``read()`` stalls ``hang_s``: the
straggling-replica shape; the injector's cooldown window models the
re-request landing on a healthy replica):

1. **Clean pair (overhead gate).** Alternating passes with the fault plane
   OFF (``retry=False, hedge=False``) vs the default-on retry layer: the
   median per-pair delta must stay inside the <5% noise floor: resilience
   must be free when nothing fails.
2. **Unhedged tail pass.** Retry on, hedge off, hangs injected: every
   straggler lands in full in the end-to-end batch latency, so the e2e p99
   is the hang.
3. **Hedged tail pass.** Same seed-fresh scenario with ``hedge=`` armed: a
   stalled primary is raced by a duplicate read and the p99 collapses
   toward the hedge threshold. Gate: **unhedged e2e p99 >= 2x hedged**.

Nothing here touches a device.

Usage::

    python -m petastorm_tpu_torch.benchmark.chaos [--quick] [--no-check]
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import tempfile
import time

from petastorm_tpu_torch.benchmark.readahead import (
    columnar_reader, generate_readahead_dataset)
from petastorm_tpu_torch.faultfs import FaultInjector, FaultyFilesystem

_HEDGE_THRESHOLD_S = 0.05


def _run_pass(dataset_path: str, filesystem, retry, hedge,
              num_epochs: int) -> dict:
    """One measured read pass (1 thread worker, no shuffle, columnar path);
    returns throughput + the end-to-end p99 + the resilience counters."""
    reader = columnar_reader(dataset_path, filesystem,
                             num_epochs=num_epochs, retry=retry, hedge=hedge)
    groups = 0
    rows = 0
    start = time.perf_counter()
    try:
        for batch in reader:
            groups += 1
            rows += len(batch.id)
        reader.audit().assert_complete()
    finally:
        wall = time.perf_counter() - start
        snapshot = reader.stats.snapshot()
        reader.stop()
        reader.join()
    return {
        'wall_s': round(wall, 4),
        'row_groups': groups,
        'rows': rows,
        'items_per_s': round(groups / wall, 2) if wall else 0.0,
        'rows_per_s': round(rows / wall, 1) if wall else 0.0,
        'e2e_p99_s': round(snapshot['e2e_latency_p99_s'], 5),
        'io_retries': snapshot['io_retries'],
        'io_hedges': snapshot['io_hedges'],
        'io_hedge_wins': snapshot['io_hedge_wins'],
    }


def run_chaos_bench(quick: bool = False, check: bool = True) -> dict:
    """Hedged vs unhedged under injected tail latency + clean-path overhead
    pairs; returns one JSON-able dict."""
    from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM

    rows = 96 if quick else 256
    num_epochs = 2
    pairs = 2 if quick else 3
    hang_s = 0.2 if quick else 0.4
    seed = 1616

    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_chaos_bench_')
    try:
        generate_readahead_dataset('file://' + tmpdir, rows=rows,
                                   rows_per_group=8)
        base_fs = LOCAL_FILESYSTEM

        def tail_fs():
            # a FRESH injector per pass: both passes replay the exact same
            # seeded fault sequence, so hedged-vs-unhedged is apples to
            # apples by construction
            return FaultyFilesystem(base_fs, FaultInjector(
                'read-hangs', seed=seed, hang_rate=0.1, hang_s=hang_s))

        # 1. clean-path overhead: fault plane OFF vs default retry ON,
        # alternating pairs (median-of-pairs, the overhead-bench protocol)
        deltas = []
        off_rates, on_rates = [], []
        for _ in range(pairs):
            off = _run_pass(tmpdir, base_fs, retry=False, hedge=False,
                            num_epochs=num_epochs)
            on = _run_pass(tmpdir, base_fs, retry=True, hedge=False,
                           num_epochs=num_epochs)
            off_rates.append(off['rows_per_s'])
            on_rates.append(on['rows_per_s'])
            deltas.append((off['rows_per_s'] - on['rows_per_s'])
                          / off['rows_per_s'] * 100.0)
        overhead_pct = statistics.median(deltas)
        clean_off_rate = statistics.median(off_rates)
        clean_on_rate = statistics.median(on_rates)

        # 2 + 3. the tail: unhedged vs hedged over the same fault sequence
        unhedged = _run_pass(tmpdir, tail_fs(), retry=True, hedge=False,
                             num_epochs=num_epochs)
        hedged = _run_pass(tmpdir, tail_fs(), retry=True,
                           hedge=_HEDGE_THRESHOLD_S, num_epochs=num_epochs)
        p99_ratio = (unhedged['e2e_p99_s'] / hedged['e2e_p99_s']
                     if hedged['e2e_p99_s'] else 0.0)

        result = {
            'benchmark': 'chaos',
            'quick': quick,
            'rows': rows,
            'epochs': num_epochs,
            'scenario': {'name': 'read-hangs', 'seed': seed,
                         'hang_rate': 0.1, 'hang_s': hang_s,
                         'hedge_threshold_s': _HEDGE_THRESHOLD_S},
            'clean': {
                'pairs': pairs,
                'fault_plane_off_rows_per_s': clean_off_rate,
                'fault_plane_on_rows_per_s': clean_on_rate,
                'overhead_pct': round(overhead_pct, 2),
                'per_pair_deltas_pct': [round(d, 2) for d in deltas],
            },
            'unhedged': unhedged,
            'hedged': hedged,
            'e2e_p99_speedup': round(p99_ratio, 2),
            'throughput_speedup': round(
                hedged['items_per_s'] / unhedged['items_per_s'], 2)
            if unhedged['items_per_s'] else 0.0,
            # roofline context: the fault-plane-off clean pass IS this
            # protocol's ceiling; the default-on plane's fraction of it is
            # the (absence of) clean-path cost
            'roofline': {
                'rows_per_s': clean_off_rate,
                'roofline_pct': round(
                    100.0 * clean_on_rate / clean_off_rate, 2)
                if clean_off_rate else None,
            },
        }
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            _check_exact(result)
            assert_bars(_bars(result))
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _bars(result: dict) -> list:
    """The timing bars: hedged and retried reads recover the unhedged
    end-to-end p99 under injected tail latency, and the fault plane costs
    the clean path no more than the noise floor."""
    quick = result['quick']
    unhedged, hedged = result['unhedged'], result['hedged']
    return [('unhedged / hedged e2e p99',
             unhedged['e2e_p99_s'] / hedged['e2e_p99_s']
             if hedged['e2e_p99_s'] else 0.0, '>=',
             1.3 if quick else 2.0),
            ('clean-path overhead %', result['clean']['overhead_pct'], '<=',
             15.0 if quick else 5.0)]


def _check_exact(result: dict) -> None:
    hedged = result['hedged']
    assert hedged['io_hedges'] > 0, 'no hedges fired under the tail'
    assert hedged['io_hedge_wins'] > 0, 'no hedged read ever won'


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='hedged vs unhedged reads under injected tail latency')
    parser.add_argument('--quick', action='store_true',
                        help='small store/epochs')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the p99/overhead assertions')
    args = parser.parse_args(argv)
    result = run_chaos_bench(quick=args.quick, check=not args.no_check)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
