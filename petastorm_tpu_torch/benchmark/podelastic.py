"""Elastic pod membership benchmark (JAX ``benchmark/podelastic.py``):
the clean-path cost of the lease plane, and host-death recovery vs a
simulated full restart.

Every delivered batch pays one REAL ranged row-group read through the
recorded object-store trace (the ``object_store`` bench's trace-replay
discipline): the lease plane's per-batch cost (heartbeat, delivery-claim
fence, cursor checkpoint) is measured against realistic infeed fetch
latencies, not against a bare page-cache ``gather``.

Phases:

1. **Clean-path overhead.** Alternating single-host epoch passes over the
   identical lease grid under fresh same-seed traces: baseline delivers
   every batch straight off the
   :class:`~petastorm_tpu_torch.podelastic.LeasePlan` grid (no
   membership, no ledger), elastic-on runs the full plane. Median
   per-pair delta must stay under the 5% noise floor: the plane is
   default-off, but when on it must not tax the un-failed path.
2. **Rebalance latency.** K hosts register, one leaves; a survivor's
   ``rebalance()`` (observe the death, rendezvous-reassign, read the dead
   host's cursors + delivery claims) is timed standalone over several
   trials: the wall-clock gap between "a host is observably dead" and
   "its rows are flowing again".
3. **Recovery vs full restart.** A K-host epoch under the deterministic
   ``host-death`` chaos scenario: the epoch completes on survivors and
   the pod certificate must certify exactly-once. The elastic wall time
   is compared against the simulated alternative: tear the whole pod
   down at the death point and re-run the epoch from scratch
   (``restart_total_s = time_to_death + clean_epoch_s``), the recovery
   story a static-shard pod is stuck with.

Nothing here touches a device.

Usage::

    python -m petastorm_tpu_torch.benchmark.podelastic [--quick] \
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

_OVERHEAD_NOISE_FLOOR_PCT = 5.0
_CHAOS_SPEC = 'host-death:42'
_TRACE_NAME = 's3-us-east-1'


def _make_dataset(tmpdir: str, rows: int):
    import numpy as np

    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
    from petastorm_tpu_torch.indexed import IndexedDatasetReader
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('ElasticBench', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
    ])
    path = os.path.join(tmpdir, 'ds')
    url = 'file://' + path
    with materialize_dataset(url, schema, row_group_size_mb=0.001) as w:
        w.write_rows([{'idx': np.int64(i)} for i in range(rows)])
    return IndexedDatasetReader(url)


def _traced_reader(seed: int):
    """A fresh ranged reader over the recorded object-store trace: a
    fresh same-seed injector per pass replays the identical latency
    sequence, so alternating passes compare the coordination plane, not
    store noise."""
    from petastorm_tpu_torch.faultfs import FaultInjector, FaultyFilesystem
    from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM
    from petastorm_tpu_torch.objectstore import ParallelRangeReader

    return ParallelRangeReader(FaultyFilesystem(
        LOCAL_FILESYSTEM,
        FaultInjector('trace-replay', seed=seed, trace=_TRACE_NAME)))


def _batch_fetch(dataset, reader, rows):
    """The per-batch infeed fetch: ranged reads of the batch's two leading
    distinct row groups through the traced store. (A production infeed
    reads EVERY group the shuffled batch touches, ~7 here, so this is a
    conservative per-batch cost and the measured plane overhead is an
    upper bound.)"""
    import numpy as np
    piece_ids = np.unique(np.searchsorted(
        dataset.row_offsets, rows, side='right') - 1)[:2]
    for piece_id in piece_ids:
        piece = dataset.pieces[int(piece_id)]
        reader.read_row_group(piece.path, piece.row_group)


def _clean_passes(dataset, tmpdir: str, batch_size: int, seed: int):
    """Two single-host passes over the identical lease grid under the
    trace, each returning its samples/s: plain grid delivery, and the full
    elastic plane (called with a tag naming its coordination directory)."""
    from petastorm_tpu_torch.podelastic import ElasticPodSim, LeasePlan

    plan = LeasePlan(dataset.row_offsets, batch_size,
                     min(len(dataset.pieces), 2), seed=seed)
    total_rows = plan.total_batches() * batch_size

    def baseline_pass() -> float:
        reader = _traced_reader(seed)
        start = time.perf_counter()
        for lease in range(plan.num_leases):
            for batch in range(plan.batches_per_lease(lease)):
                rows = plan.batch_rows(lease, 0, batch)
                dataset.gather(rows)
                _batch_fetch(dataset, reader, rows)
        wall = time.perf_counter() - start
        return total_rows / wall if wall else 0.0

    def elastic_pass(tag: str) -> float:
        reader = _traced_reader(seed)
        coord = os.path.join(tmpdir, 'overhead_{}'.format(tag))
        sim = ElasticPodSim(dataset, coord, k_hosts=1,
                            batch_size=batch_size,
                            num_leases=plan.num_leases, seed=seed)
        delivered = [0]

        def on_batch(cols, lease, batch):
            delivered[0] += len(cols['idx'])
            # the bench dataset's idx column IS the global row index
            _batch_fetch(dataset, reader, cols['idx'])

        start = time.perf_counter()
        sim.run_epoch(0, on_batch=on_batch)
        wall = time.perf_counter() - start
        sim.close()
        return delivered[0] / wall if wall else 0.0

    return baseline_pass, elastic_pass


def _clean_overhead(dataset, tmpdir: str, batch_size: int, pairs: int,
                    seed: int):
    """Alternating single-host passes: plain grid delivery vs the full
    elastic plane (median-of-pairs, the overhead-bench protocol)."""
    baseline_pass, elastic_pass = _clean_passes(dataset, tmpdir, batch_size,
                                                seed)
    # warmup (discarded): page cache, lazy imports, footer first-touch
    baseline_pass()
    elastic_pass('warmup')
    deltas_pct, off_rates, on_rates = [], [], []
    for i in range(pairs):
        off = baseline_pass()
        on = elastic_pass('p{}'.format(i))
        off_rates.append(off)
        on_rates.append(on)
        deltas_pct.append((off - on) / off * 100.0 if off else 0.0)
    return {
        'pairs': pairs,
        'baseline_samples_per_s': round(statistics.median(off_rates), 1),
        'elastic_on_samples_per_s': round(statistics.median(on_rates), 1),
        'overhead_pct': round(statistics.median(deltas_pct), 2),
        'per_pair_deltas_pct': [round(d, 2) for d in deltas_pct],
    }


def _rebalance_latency(dataset, tmpdir: str, batch_size: int, k_hosts: int,
                       trials: int, seed: int):
    """Time a survivor's full takeover step (observe the death,
    rendezvous-reassign, read the dead host's cursors + delivery claims)
    standalone, over fresh pods."""
    from petastorm_tpu_torch.podelastic import (ElasticHost, LeaseLedger,
                                          LeasePlan, PodMembership)

    plan = LeasePlan(dataset.row_offsets, batch_size,
                     min(len(dataset.pieces), 2 * k_hosts), seed=seed)
    samples = []
    for trial in range(trials):
        coord = os.path.join(tmpdir, 'rebalance_{}'.format(trial))
        members = [PodMembership(coord, host_id='host-{}'.format(i))
                   for i in range(k_hosts)]
        ledger = LeaseLedger(coord)
        hosts = [ElasticHost(dataset, plan, members[i], ledger,
                             host_index=i) for i in range(k_hosts)]
        for host in hosts:
            host.rebalance(0)
        # every host makes some progress, then the last one dies
        for _ in range(3):
            for host in hosts:
                host.step(0)
        members[-1].leave()
        survivor = hosts[0]
        start = time.perf_counter()
        survivor.rebalance(0)
        samples.append(time.perf_counter() - start)
        for member in members[:-1]:
            member.leave()
    return {
        'trials': trials,
        'rebalance_latency_s': round(statistics.median(samples), 6),
        'rebalance_latency_max_s': round(max(samples), 6),
    }


def _recovery_leg(dataset, tmpdir: str, batch_size: int, k_hosts: int,
                  seed: int):
    """A K-host epoch under deterministic host-death chaos (every batch
    paying its traced infeed fetch), timed against the simulated
    full-restart alternative."""
    from petastorm_tpu_torch.faultfs import CHAOS_ENV_VAR, reset_chaos_cache
    from petastorm_tpu_torch.podelastic import ElasticPodSim

    def timed_epoch(tag: str, chaos: bool):
        prior = os.environ.get(CHAOS_ENV_VAR)
        if chaos:
            os.environ[CHAOS_ENV_VAR] = _CHAOS_SPEC
        else:
            os.environ.pop(CHAOS_ENV_VAR, None)
        reset_chaos_cache()
        try:
            reader = _traced_reader(seed)
            coord = os.path.join(tmpdir, 'recovery_{}'.format(tag))
            sim = ElasticPodSim(dataset, coord, k_hosts=k_hosts,
                                batch_size=batch_size, seed=seed)
            rows = [0]
            death_elapsed = [None]
            start = time.perf_counter()

            def on_batch(cols, lease, batch):
                rows[0] += len(cols['idx'])
                _batch_fetch(dataset, reader, cols['idx'])
                if sim.deaths and death_elapsed[0] is None:
                    death_elapsed[0] = time.perf_counter() - start

            report = sim.run_epoch(0, on_batch=on_batch)
            wall = time.perf_counter() - start
            certificate = sim.certificate(0)
            sim.close()
            return wall, rows[0], death_elapsed[0], report, certificate
        finally:
            if prior is None:
                os.environ.pop(CHAOS_ENV_VAR, None)
            else:
                os.environ[CHAOS_ENV_VAR] = prior
            reset_chaos_cache()

    clean_s, clean_rows, _, _, _ = timed_epoch('clean', chaos=False)
    elastic_s, rows, death_elapsed, report, certificate = timed_epoch(
        'death', chaos=True)
    # a static-shard pod must throw away the partial epoch and re-run it
    # from scratch: time-to-death is sunk cost, then one full clean epoch
    time_to_death = death_elapsed if death_elapsed is not None else 0.0
    restart_s = time_to_death + clean_s
    return {
        'k_hosts': k_hosts,
        'deaths': report['deaths'],
        'rows_delivered': rows,
        'time_to_death_s': round(time_to_death, 4),
        'elastic_total_s': round(elastic_s, 4),
        'restart_total_s': round(restart_s, 4),
        'elastic_samples_per_s': round(rows / elastic_s, 1)
        if elastic_s else 0.0,
        'restart_samples_per_s': round(rows / restart_s, 1)
        if restart_s else 0.0,
        'speedup_x': round(restart_s / elastic_s, 2) if elastic_s else 0.0,
        'leases_rebalanced': report['counters']['leases_rebalanced'],
        'rows_resumed': report['counters']['rows_resumed'],
        'certificate_ok': certificate['ok'],
        'certificate_problems': certificate['problems'],
    }


def run_podelastic_bench(quick: bool = False, check: bool = True) -> dict:
    """The protocol above; ``quick`` shrinks the dataset (same
    certificates, same overhead gate at a looser floor)."""
    rows = 240 if quick else 720
    batch_size = 8
    pairs = 2 if quick else 3
    trials = 3 if quick else 5
    k_hosts = 3
    seed = 20

    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_podelastic_bench_')
    try:
        dataset = _make_dataset(tmpdir, rows)
        try:
            overhead = _clean_overhead(dataset, tmpdir, batch_size,
                                       pairs=pairs, seed=seed)
            rebalance = _rebalance_latency(dataset, tmpdir, batch_size,
                                           k_hosts, trials=trials,
                                           seed=seed)
            recovery = _recovery_leg(dataset, tmpdir, batch_size, k_hosts,
                                     seed=seed)
        finally:
            dataset.close()

        result = {
            'benchmark': 'podelastic',
            'quick': quick,
            'rows': rows,
            'k_hosts': k_hosts,
            'trace': {'name': _TRACE_NAME, 'seed': seed},
            'clean': overhead,
            'rebalance': rebalance,
            'recovery': recovery,
            'roofline': {
                'baseline_samples_per_s':
                    overhead['baseline_samples_per_s'],
                'roofline_pct': round(
                    100.0 * overhead['elastic_on_samples_per_s']
                    / overhead['baseline_samples_per_s'], 2)
                if overhead['baseline_samples_per_s'] else None,
                'note': 'elastic-on single-host epoch throughput as % of '
                        'the plain lease-grid delivery baseline on the '
                        'same traced store — the ceiling the lease plane '
                        'runs under when nothing fails',
            },
        }
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            assert_bars(_bars(result)[:1])
            _check_exact(result)
            assert_bars(_bars(result)[1:])
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _bars(result: dict) -> list:
    """The timing bars: the elastic lease plane's cost on the clean path
    within the noise floor, and elastic recovery faster than a tear-down
    and restart."""
    recovery = result['recovery']
    return [('overhead %', result['clean']['overhead_pct'], '<=',
             15.0 if result['quick'] else _OVERHEAD_NOISE_FLOOR_PCT),
            ('elastic recovery s', recovery['elastic_total_s'], '<',
             recovery['restart_total_s'])]


def _check_exact(result: dict) -> None:
    """A death seen, the exactly-once certificate ok across it, and at
    least one lease moved to a survivor."""
    recovery = result['recovery']
    assert recovery['deaths'], (
        'the host-death scenario must have killed a host')
    assert recovery['certificate_ok'] is True, (
        'exactly-once must certify across the rebalance: '
        '{}'.format(recovery['certificate_problems']))
    assert recovery['leases_rebalanced'] >= 1, (
        'the dead host\'s leases must have moved to survivors')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='elastic pod membership: clean-path overhead, '
                    'rebalance latency, host-death recovery vs restart')
    parser.add_argument('--quick', action='store_true',
                        help='small dataset, looser overhead floor')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the overhead/certificate '
                             'assertions')
    args = parser.parse_args(argv)
    result = run_podelastic_bench(quick=args.quick, check=not args.no_check)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
