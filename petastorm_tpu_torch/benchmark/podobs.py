"""Pod-observability benchmark (JAX ``benchmark/podobs.py``): the
default-on cost of the pod plane, and a K-host merged decode-once
certificate through the production aggregation path.

Phases:

1. **Instrumentation overhead.** Alternating ranged read passes under
   fresh same-seed recorded object-store traces (the ``object_store``
   bench's trace-replay discipline), read-plane observability OFF vs ON
   (``range_fetch`` spans + ``io_range`` latency recorded per range, the
   hot-path cost the default-on discipline must bound): median per-pair
   delta must stay under the 5% noise floor at realistic request
   latencies.
2. **K-host merged certificate.** K=3 shared-cache roots ("hosts"): the
   cold host fills every synthetic row group once, the warm hosts
   peer-attach each one. Every root serves ``/observe/snapshot`` (a real
   ``DebugServer``) and a :class:`~petastorm_tpu_torch.podobs.PodObserver`
   polls + merges: the certificate must certify ``sum(fills) == row
   groups`` with ``peer_hits == (K-1) x row groups`` exact, and the
   pod-merged latency percentiles must be **bit-identical** to a
   histogram that recorded every observation directly (the phase-1
   passes provide the observations: real recorded ``io_range`` durations
   split across the simulated hosts).
3. **Partial pod.** The same poll with one dead peer appended: the
   verdict must degrade to the named ``partial_pod`` and the certificate
   must refuse to certify (``ok: false``), never a silent shrink of the
   denominator.

Nothing here touches a device.

Usage::

    python -m petastorm_tpu_torch.benchmark.podobs [--quick] [--no-check]
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


def _dataset_pieces(dataset_path: str):
    import pyarrow.parquet as pq
    paths = []
    for dirpath, _dirnames, filenames in os.walk(dataset_path):
        for name in filenames:
            if name.endswith('.parquet') and not name.startswith('_'):
                paths.append(os.path.join(dirpath, name))
    pieces = []
    for path in sorted(paths):
        metadata = pq.ParquetFile(path).metadata
        pieces.extend((path, rg) for rg in range(metadata.num_row_groups))
    return pieces


def _observe_overhead(traced_fs, pieces, pairs: int, epochs: int):
    """Alternating ranged passes under fresh same-seed recorded traces,
    read-plane observability off vs on (median-of-pairs, the
    overhead-bench protocol, as the ``object_store`` bench's hedge leg:
    the trace replays identical request latencies in both passes, so the
    per-pair delta isolates the instrumentation at REALISTIC object-store
    latencies, not against a bare page-cache read). Returns the overhead
    record and the REAL ``io_range`` latency deltas the observing passes
    recorded (phase 2's bit-identity input)."""
    from petastorm_tpu_torch.objectstore import ParallelRangeReader

    recorded_deltas = []

    def ranged_pass(observing: bool) -> float:
        reader = ParallelRangeReader(traced_fs(), observe_spans=observing,
                                     observe_latency=observing)
        rows = 0
        start = time.perf_counter()
        for _ in range(epochs):
            for path, row_group in pieces:
                rows += reader.read_row_group(path, row_group).num_rows
        wall = time.perf_counter() - start
        if observing:
            reader.take_spans()
            deltas = reader.take_latency()
            if deltas:
                recorded_deltas.append(deltas)
        return rows / wall if wall else 0.0

    # warmup (discarded): page cache, lazy imports, pyarrow first-touch:
    # the measured pairs must isolate the instrumentation, not cold-start
    ranged_pass(observing=False)
    ranged_pass(observing=True)
    recorded_deltas.clear()
    deltas_pct, off_rates, on_rates = [], [], []
    for _ in range(pairs):
        off = ranged_pass(observing=False)
        on = ranged_pass(observing=True)
        off_rates.append(off)
        on_rates.append(on)
        deltas_pct.append((off - on) / off * 100.0 if off else 0.0)
    overhead = {
        'pairs': pairs,
        'epochs_per_pass': epochs,
        'baseline_items_per_s': round(statistics.median(off_rates), 1),
        'podobs_on_items_per_s': round(statistics.median(on_rates), 1),
        'overhead_pct': round(statistics.median(deltas_pct), 2),
        'per_pair_deltas_pct': [round(d, 2) for d in deltas_pct],
    }
    return overhead, recorded_deltas


def _split_deltas_across_hosts(recorded_deltas, k_hosts: int):
    """Fold the recorded per-pass latency deltas into K per-host
    accumulators AND one direct accumulator (as if a single histogram had
    observed everything): the merged-vs-direct bit-identity fixture."""
    from petastorm_tpu_torch.latency import LatencyDeltas
    per_host = [LatencyDeltas() for _ in range(k_hosts)]
    direct = LatencyDeltas()
    for i, deltas in enumerate(recorded_deltas):
        per_host[i % k_hosts].absorb(deltas)
        direct.absorb(deltas)
    return per_host, direct


def _deltas_state_map(deltas):
    """A ``LatencyDeltas`` accumulator as the ``{stage: state}`` histogram
    export (``LatencyHistogram.state()`` shape) a snapshot carries."""
    out = {}
    for stage, entry in (deltas.drain() or {}).items():
        out[stage] = {
            'buckets': [[i, n] for i, n in sorted(entry['buckets'].items())
                        if n],
            'sum': entry['sum'],
            'count': entry['count'],
        }
    return out


def _pod_certificate_leg(tmpdir: str, n_groups: int, host_state_maps):
    """K=3 cache roots: cold host fills, warm hosts peer-attach, then the
    PRODUCTION aggregation path (per-root ``/observe/snapshot`` +
    ``PodObserver``) certifies decode-once and merges the per-host
    histograms."""
    import numpy as np

    from petastorm_tpu_torch.health import DebugServer
    from petastorm_tpu_torch.podobs import (PodObserver, make_observe_fn,
                                      state_percentiles)
    from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
    from petastorm_tpu_torch.workers.stats import LATENCY_HISTOGRAMS_KEY

    k_hosts = len(host_state_maps)
    roots = [os.path.join(tmpdir, 'pod_host_{}'.format(i))
             for i in range(k_hosts)]
    cold = SharedRowGroupCache(
        roots[0], 1 << 28, mem_dir=os.path.join(tmpdir, 'pod_mem_0'))

    def payload(group: int):
        return {'x': np.arange(group, group + 64, dtype=np.int64)}

    fills = [0]

    def fill_for(group: int):
        def fill():
            fills[0] += 1
            return payload(group)
        return fill

    try:
        endpoint = '127.0.0.1:{}'.format(cold.serve_peers())
        # cold host decodes every group once
        for group in range(n_groups):
            cold.get('group_{}'.format(group), fill_for(group))
        # warm hosts must be served by the pod, never decode
        warm = [SharedRowGroupCache(
            roots[i], 1 << 28,
            mem_dir=os.path.join(tmpdir, 'pod_mem_{}'.format(i)),
            peers=[endpoint]) for i in range(1, k_hosts)]
        try:
            for cache in warm:
                for group in range(n_groups):
                    cache.get('group_{}'.format(group), fill_for(group))
        finally:
            for cache in warm:
                cache.close()
    finally:
        cold.close()

    obs_servers = []
    try:
        for i, root in enumerate(roots):
            states = host_state_maps[i]
            obs = DebugServer(
                lambda: {'state': 'healthy'},
                observe_fn=make_observe_fn(
                    snapshot_fn=(lambda states=states:
                                 {LATENCY_HISTOGRAMS_KEY: states}),
                    health_fn=lambda: {'state': 'healthy'},
                    cache_counters_fn=(
                        lambda root=root:
                        SharedRowGroupCache.global_counters(root)),
                    host='pod_host_{}'.format(i)))
            obs.start()
            obs_servers.append(obs)
        peers = ['127.0.0.1:{}'.format(obs.port) for obs in obs_servers]
        observer = PodObserver(peers, expected_row_groups=n_groups)
        report = observer.report()
        observer.assert_certificate(report)
        # phase 3: one dead peer -> named partial_pod, certificate refuses
        dead_observer = PodObserver(peers + ['127.0.0.1:9'],
                                    expected_row_groups=n_groups)
        dead_report = dead_observer.report()
    finally:
        for obs in obs_servers:
            obs.stop()

    merged = report['latency_histograms']
    pod_percentiles = {stage: state_percentiles(state)
                       for stage, state in merged.items()}
    return {
        'k_hosts': k_hosts,
        'row_groups': n_groups,
        'local_fill_calls': fills[0],
        'verdict': report['verdict'],
        'certificate': report['certificate'],
        'merged_latency': report['latency'],
        'pod_percentiles': pod_percentiles,
        'partial_pod': {
            'verdict': dead_report['verdict'],
            'unreachable': len(dead_report['unreachable']),
            'certificate_ok': dead_report['certificate']['ok'],
            'problems': dead_report['certificate']['problems'],
        },
    }


def run_podobs_bench(quick: bool = False, check: bool = True) -> dict:
    """The protocol above; ``quick`` shrinks the store (same certificates,
    same overhead gate at a looser floor)."""
    from petastorm_tpu_torch.benchmark.readahead import \
        generate_readahead_dataset
    from petastorm_tpu_torch.faultfs import FaultInjector, FaultyFilesystem
    from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM
    from petastorm_tpu_torch.podobs import state_percentiles

    rows = 96 if quick else 256
    rows_per_group = 8
    pairs = 2 if quick else 3
    epochs = 1 if quick else 2
    n_groups = 12 if quick else 32
    k_hosts = 3
    trace_name = 's3-us-east-1'
    seed = 19

    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_podobs_bench_')
    try:
        dataset = os.path.join(tmpdir, 'ds')
        generate_readahead_dataset('file://' + dataset, rows=rows,
                                   rows_per_group=rows_per_group)
        base_fs = LOCAL_FILESYSTEM
        pieces = _dataset_pieces(dataset)

        def traced_fs():
            # a FRESH same-seed injector per pass: both passes replay the
            # identical recorded latency sequence
            return FaultyFilesystem(base_fs, FaultInjector(
                'trace-replay', seed=seed, trace=trace_name))

        # 1. default-on overhead, alternating passes under the trace
        overhead, recorded = _observe_overhead(traced_fs, pieces,
                                               pairs=pairs, epochs=epochs)

        # 2. + 3. the production aggregation path over K simulated hosts,
        # fed the REAL per-pass recordings phase 1 produced
        per_host, direct = _split_deltas_across_hosts(recorded, k_hosts)
        host_state_maps = [_deltas_state_map(d) for d in per_host]
        direct_state_map = _deltas_state_map(direct)
        pod = _pod_certificate_leg(tmpdir, n_groups, host_state_maps)
        direct_percentiles = {stage: state_percentiles(state)
                              for stage, state in direct_state_map.items()}
        merge_bit_identical = (pod['pod_percentiles'] == direct_percentiles
                               and bool(direct_percentiles))

        result = {
            'benchmark': 'podobs',
            'quick': quick,
            'rows': rows,
            'trace': {'name': trace_name, 'seed': seed},
            'overhead': overhead,
            'pod': pod,
            'merge_bit_identical': merge_bit_identical,
            'direct_percentiles': direct_percentiles,
            'roofline': {
                'baseline_items_per_s': overhead['baseline_items_per_s'],
                'roofline_pct': round(
                    100.0 * overhead['podobs_on_items_per_s']
                    / overhead['baseline_items_per_s'], 2)
                if overhead['baseline_items_per_s'] else None,
                'note': 'podobs-on ranged read throughput as % of the '
                        'podobs-off baseline on the same store — the '
                        'measured ceiling the default-on plane runs under',
            },
        }
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            assert_bars(_bars(result))
            _check_exact(result)
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _bars(result: dict) -> list:
    """The timing bar: the cost of the default-on pod observability on the
    ranged read path, within the noise floor."""
    return [('overhead %', result['overhead']['overhead_pct'], '<=',
             15.0 if result['quick'] else _OVERHEAD_NOISE_FLOOR_PCT)]


def _check_exact(result: dict) -> None:
    """The certificate with exact fills and peer hits, merged percentiles
    bit-identical to direct recording, and the partial pod refused."""
    from petastorm_tpu_torch.podobs import PARTIAL_POD

    pod = result['pod']
    certificate, n_groups, k_hosts = (pod['certificate'], pod['row_groups'],
                                      pod['k_hosts'])
    assert certificate['ok'] is True, (
        'the K={} pod certificate must certify: {}'.format(
            k_hosts, certificate['problems']))
    assert certificate['fills'] == n_groups, (
        'pod fills {} != {} row groups'.format(
            certificate['fills'], n_groups))
    assert certificate['peer_hits'] == (k_hosts - 1) * n_groups, (
        'expected {} peer hits exactly, counted {}'.format(
            (k_hosts - 1) * n_groups, certificate['peer_hits']))
    assert result['merge_bit_identical'], (
        'pod-merged percentiles must be bit-identical to direct '
        'recording; merged {} vs direct {}'.format(
            pod['pod_percentiles'], result['direct_percentiles']))
    assert pod['partial_pod']['verdict'] == PARTIAL_POD, (
        'a dead peer must yield the named {} verdict, got '
        '{}'.format(PARTIAL_POD, pod['partial_pod']['verdict']))
    assert pod['partial_pod']['certificate_ok'] is False, (
        'an unreachable host must make the certificate refuse to '
        'certify')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='pod observability: default-on overhead, K-host '
                    'merged decode-once certificate, partial-pod verdict')
    parser.add_argument('--quick', action='store_true',
                        help='small store, looser overhead floor')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the overhead/certificate '
                             'assertions')
    args = parser.parse_args(argv)
    result = run_podobs_bench(quick=args.quick, check=not args.no_check)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
