"""Object-store read-plane benchmark (JAX ``benchmark/object_store.py``):
serial vs prebuffer vs coalesced parallel ranged reads under a recorded
latency trace, the hedge clean-path overhead, the raw ranged-ingest
ceiling, pod-wide cache dedup, and trace-replay determinism.

Local disks have none of an object store's latency structure, so the
read-plane passes run against :mod:`petastorm_tpu_torch.faultfs`'s
``trace-replay`` scenario: every ``read()`` replays a first-byte-latency +
bandwidth sample drawn deterministically from the recorded
``petastorm_tpu_torch/traces/s3-us-east-1.json`` trace, keyed on (seed,
path, byte range). Phases:

1. **Read-plane passes.** Every row group read three ways over a fresh
   seeded trace: ``serial`` (plain ``pq.ParquetFile`` over the store
   handle), ``prebuffer`` (Arrow's coalesced pre-buffered reads) and
   ``ranged`` (:class:`petastorm_tpu_torch.objectstore.ParallelRangeReader`:
   footer-planned, gap-merged, bounded-parallel range fetches). Rows must
   be bit-identical across the three; gate: **ranged >= 2x serial**
   row-group read throughput.
2. **Hedge clean-path overhead.** Alternating ranged passes under fresh
   same-seed traces, resilience off vs per-range hedging armed: median
   per-pair delta must stay under the 5% noise floor (per-request hedging
   must be free when nothing straggles).
3. **Ranged-ingest ceiling.** The planned ranges of every row group
   fetched raw (no parquet assembly) on the clean store: the MB/s ceiling
   the ranged read path runs under, recorded as roofline context.
4. **Pod-wide dedup.** K=3 cache roots ("hosts") x M=2 readers, each
   host's shared cache serving ``GET /peercache/<digest>`` and listing
   the others as ``peers=``. The cold host fills every row group once;
   the remaining hosts then read concurrently and satisfy every miss
   from a peer. Certificate: **sum of ``fills`` across roots == row
   groups** and **sum of ``peer_hits`` == (K-1) x row groups**; aggregate
   samples/s must beat the per-host serial baseline.
5. **Determinism.** Two identical hedged ranged passes over fresh
   same-seed injectors: injected-fault counts, the replayed latency tally
   (rounded to microseconds) and the hedge/retry counters must be
   identical: the trace is a replayable experiment, not a noise source.

Nothing here touches a device.

Usage::

    python -m petastorm_tpu_torch.benchmark.object_store [--quick] \
        [--no-check]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import tempfile
import threading
import time

from petastorm_tpu_torch.faultfs import FaultInjector, FaultyFilesystem

_MB = 1024.0 * 1024.0

TRACE_NAME = 's3-us-east-1'
_SEED = 18
_PEER_FILL_HEDGE_DISABLED = None


def _dataset_pieces(dataset_path: str):
    """``(pieces, rows)`` where pieces are (file path, row group) pairs in
    deterministic (path, ordinal) order."""
    import pyarrow.parquet as pq
    paths = []
    for dirpath, _dirnames, filenames in os.walk(dataset_path):
        for name in filenames:
            if name.endswith('.parquet') and not name.startswith('_'):
                paths.append(os.path.join(dirpath, name))
    pieces, rows = [], 0
    for path in sorted(paths):
        metadata = pq.ParquetFile(path).metadata
        rows += metadata.num_rows
        pieces.extend((path, rg) for rg in range(metadata.num_row_groups))
    return pieces, rows


def _table_digest(digest, table) -> None:
    """Fold one row-group table into a running bit-identity digest (column
    order is schema order, identical across read modes)."""
    for name in table.column_names:
        digest.update(name.encode('utf-8'))
        digest.update(str(table.column(name).to_pylist()).encode('utf-8'))


def _read_plane_pass(filesystem, pieces, mode: str) -> dict:
    """Read every row group through one read mode; returns throughput,
    the bit-identity digest and the store's request accounting."""
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.objectstore import ParallelRangeReader
    digest = hashlib.sha256()
    rows = 0
    ranged = ParallelRangeReader(filesystem) if mode == 'ranged' else None
    start = time.perf_counter()
    for path, row_group in pieces:
        if ranged is not None:
            table = ranged.read_row_group(path, row_group)
        else:
            with filesystem.open(path, 'rb') as handle:
                if mode == 'prebuffer':
                    try:
                        pf = pq.ParquetFile(handle, pre_buffer=True)
                    except TypeError:    # pyarrow predating the kwarg
                        pf = pq.ParquetFile(handle)
                elif mode == 'serial':
                    pf = pq.ParquetFile(handle)
                else:
                    raise ValueError('unknown read mode {!r}'.format(mode))
                table = pf.read_row_group(row_group)
        rows += table.num_rows
        _table_digest(digest, table)
    wall = time.perf_counter() - start
    injector = getattr(filesystem, 'injector', None)
    result = {
        'wall_s': round(wall, 4),
        'rows': rows,
        'row_groups': len(pieces),
        'rows_per_s': round(rows / wall, 1) if wall else 0.0,
        'row_groups_per_s': round(len(pieces) / wall, 2) if wall else 0.0,
        'store_requests': filesystem.read_calls,
        'store_bytes': filesystem.bytes_read,
        'digest': digest.hexdigest(),
    }
    if injector is not None:
        result['trace_reads'] = injector.injected.get('trace_reads', 0)
        result['trace_latency_s'] = round(
            injector.injected_s.get('trace_latency_s', 0.0), 4)
    if ranged is not None:
        result['range_events'] = ranged.take_events()
    return result


#: Clean-path hedge threshold: above the trace's worst injected delay
#: (first-byte clamp 0.45s + sub-ms bandwidth terms), so the hedge plane
#: is ARMED on every range but never fires: the overhead measured is the
#: pure cost of the hedging machinery at realistic request latencies.
_CLEAN_PATH_THRESHOLD_S = 1.0


def _hedge_overhead(traced_fs, pieces, pairs: int, epochs: int) -> dict:
    """Alternating ranged passes under fresh same-seed traces, resilience
    off vs per-range hedge armed (median-of-pairs, the overhead-bench
    protocol). Same seed -> both passes replay the identical latency
    sequence, so the per-pair delta isolates the hedge wrapper itself."""
    from petastorm_tpu_torch.objectstore import ParallelRangeReader
    from petastorm_tpu_torch.resilience import ResilientIO

    hedges_fired = 0

    def ranged_pass(hedged: bool) -> float:
        nonlocal hedges_fired
        resilience = (ResilientIO(hedge_options=dict(
            threshold_s=_CLEAN_PATH_THRESHOLD_S)) if hedged else None)
        reader = ParallelRangeReader(traced_fs(), resilience=resilience)
        rows = 0
        start = time.perf_counter()
        for _ in range(epochs):
            for path, row_group in pieces:
                rows += reader.read_row_group(path, row_group).num_rows
        wall = time.perf_counter() - start
        if resilience is not None:
            resilience.drain()
            hedges_fired += resilience.take_events().get('io_hedges', 0)
        return rows / wall if wall else 0.0

    deltas, plain_rates, hedged_rates = [], [], []
    for _ in range(pairs):
        plain = ranged_pass(hedged=False)
        hedged = ranged_pass(hedged=True)
        plain_rates.append(plain)
        hedged_rates.append(hedged)
        deltas.append((plain - hedged) / plain * 100.0 if plain else 0.0)
    return {
        'pairs': pairs,
        'epochs_per_pass': epochs,
        'threshold_s': _CLEAN_PATH_THRESHOLD_S,
        'hedges_fired': hedges_fired,
        'plain_rows_per_s': round(statistics.median(plain_rates), 1),
        'hedged_rows_per_s': round(statistics.median(hedged_rates), 1),
        'overhead_pct': round(statistics.median(deltas), 2),
        'per_pair_deltas_pct': [round(d, 2) for d in deltas],
    }


def _ranged_ingest_ceiling(base_fs, pieces, rows: int) -> dict:
    """Raw parallel range fetch throughput over every planned row-group
    range on the clean store (no parquet assembly) — the ceiling the
    ranged read path runs under — plus the assembled clean ranged read
    rate, whose fraction of the raw ceiling is the parquet-assembly
    cost."""
    from petastorm_tpu_torch.objectstore import ParallelRangeReader
    reader = ParallelRangeReader(base_fs)
    total = 0
    start = time.perf_counter()
    for path, row_group in pieces:
        total += reader.fetch_row_group_bytes(path, row_group)
    raw_wall = time.perf_counter() - start
    assembled_rows = 0
    start = time.perf_counter()
    for path, row_group in pieces:
        assembled_rows += reader.read_row_group(path, row_group).num_rows
    assembled_wall = time.perf_counter() - start
    return {
        'bytes': total,
        'wall_s': round(raw_wall, 4),
        'mb_per_s': round(total / _MB / raw_wall, 2) if raw_wall else 0.0,
        'rows_per_s': round(rows / raw_wall, 1) if raw_wall else 0.0,
        'assembled_rows_per_s': round(assembled_rows / assembled_wall, 1)
        if assembled_wall else 0.0,
    }


def _determinism(base_fs, pieces) -> dict:
    """Two hedged ranged passes over fresh same-seed trace injectors; the
    injected tallies and the fired hedge/retry counters must replay
    exactly. The hedge threshold sits below the trace's smallest
    first-byte latency so every range hedges in both runs (win/loss split
    is a wall-clock race and is reported, not gated)."""
    from petastorm_tpu_torch.objectstore import ParallelRangeReader
    from petastorm_tpu_torch.resilience import ResilientIO, resolve_retry

    def traced_pass() -> dict:
        injector = FaultInjector('trace-replay', seed=_SEED, trace=TRACE_NAME)
        filesystem = FaultyFilesystem(base_fs, injector)
        resilience = ResilientIO(retry_options=resolve_retry(True),
                                 hedge_options=dict(threshold_s=0.001))
        reader = ParallelRangeReader(filesystem, resilience=resilience)
        for path, row_group in pieces:
            reader.read_row_group(path, row_group)
        resilience.drain()
        events = resilience.take_events()
        return {
            'injected': dict(injector.injected),
            'injected_s': {k: round(v, 6)
                           for k, v in injector.injected_s.items()},
            'io_hedges': events.get('io_hedges', 0),
            'io_hedge_wins': events.get('io_hedge_wins', 0),
            'io_retries': events.get('io_retries', 0),
        }

    first, second = traced_pass(), traced_pass()
    return {
        'runs': 2,
        'first': first,
        'second': second,
        'identical_injected': first['injected'] == second['injected'],
        'identical_injected_s': first['injected_s'] == second['injected_s'],
        'identical_hedge_retry': (
            first['io_hedges'] == second['io_hedges']
            and first['io_retries'] == second['io_retries']),
    }


# -- pod-wide dedup ------------------------------------------------------------

def _consume_all(url: str, **reader_kwargs) -> dict:
    from petastorm_tpu_torch import make_columnar_reader
    start = time.perf_counter()
    samples = 0
    groups = 0
    with make_columnar_reader(url, num_epochs=1, **reader_kwargs) as reader:
        for batch in reader:
            samples += len(batch.id)
            groups += 1
    wall = time.perf_counter() - start
    return {
        'wall_s': round(wall, 4),
        'samples': samples,
        'row_groups': groups,
        'samples_per_sec': round(samples / wall, 1) if wall else 0.0,
    }


def _run_host_fleet(url: str, readers: int, kwargs) -> dict:
    """M concurrent reader threads attaching one host's cache root; the
    fleet window is the slowest member's wall (the members overlap)."""
    results = [None] * readers
    errors = []

    def member(i):
        try:
            results[i] = _consume_all(url, **kwargs)
        except BaseException as e:  # noqa: BLE001 - re-raised in the parent
            errors.append(e)

    threads = [threading.Thread(
        target=member, args=(i,), daemon=True,
        name='petastorm-tpu-objectstore-bench-{}'.format(i))
        for i in range(readers)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    samples = sum(r['samples'] for r in results)
    window = max(r['wall_s'] for r in results)
    return {
        'wall_s': round(window, 4),
        'samples': samples,
        'aggregate_samples_per_sec': round(samples / window, 1)
        if window else 0.0,
        'per_reader': results,
    }


def _pod_dedup(url: str, tmpdir: str, k_hosts: int, readers_per_host: int,
               n_groups: int) -> dict:
    """K cache roots, each serving its peers; the cold host fills once,
    the remaining hosts peer-attach concurrently. Sequential peer mode
    (no ``peer_hedge_s``): the fills==row_groups certificate needs the
    fill path gated on an actual all-peers miss, not on a race."""
    from petastorm_tpu_torch.sharedcache import SharedRowGroupCache

    baseline = _consume_all(url, reader_pool_type='dummy',
                            shuffle_row_groups=False)

    roots = [os.path.join(tmpdir, 'pod_host_{}'.format(i))
             for i in range(k_hosts)]
    servers = [SharedRowGroupCache(
        root, 1 << 30, mem_dir=os.path.join(tmpdir, 'pod_mem_{}'.format(i)))
        for i, root in enumerate(roots)]
    try:
        endpoints = ['127.0.0.1:{}'.format(server.serve_peers())
                     for server in servers]

        def host_kwargs(i):
            peers = [ep for j, ep in enumerate(endpoints) if j != i]
            return dict(
                reader_pool_type='thread', workers_count=2,
                shuffle_row_groups=False,
                cache_type='shared', cache_location=roots[i],
                cache_size_limit=1 << 30,
                cache_extra_settings={
                    'mem_dir': os.path.join(tmpdir, 'pod_mem_{}'.format(i)),
                    'peers': peers,
                    'peer_hedge_s': _PEER_FILL_HEDGE_DISABLED})

        # stage 1: the cold host decodes the whole store (intra-host
        # single-flight: its M readers fill each group once)
        cold = _run_host_fleet(url, readers_per_host, host_kwargs(0))
        # stage 2: the remaining hosts read concurrently; every miss is
        # served from the cold host's pod endpoint
        warm_hosts = [None] * (k_hosts - 1)
        warm_errors = []

        def warm_host(i):
            try:
                warm_hosts[i - 1] = _run_host_fleet(url, readers_per_host,
                                                    host_kwargs(i))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                warm_errors.append(e)

        threads = [threading.Thread(
            target=warm_host, args=(i,), daemon=True,
            name='petastorm-tpu-objectstore-pod-{}'.format(i))
            for i in range(1, k_hosts)]
        start = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        warm_wall = time.perf_counter() - start
        if warm_errors:
            raise warm_errors[0]
    finally:
        for server in servers:
            server.close()

    # the production aggregation path: each root serves
    # /observe/snapshot and a PodObserver polls and merges, as a real
    # pod's aggregator runs; the hand-rolled global_counters sums stay
    # below as an independent cross-check
    from petastorm_tpu_torch.health import DebugServer
    from petastorm_tpu_torch.podobs import PodObserver, make_observe_fn
    obs_servers = []
    try:
        for i, root in enumerate(roots):
            obs = DebugServer(
                lambda: {'state': 'healthy'},
                observe_fn=make_observe_fn(
                    cache_counters_fn=(
                        lambda root=root:
                        SharedRowGroupCache.global_counters(root)),
                    host='pod_host_{}'.format(i)))
            obs.start()
            obs_servers.append(obs)
        observer = PodObserver(
            ['127.0.0.1:{}'.format(obs.port) for obs in obs_servers],
            expected_row_groups=n_groups)
        pod_report = observer.report()
    finally:
        for obs in obs_servers:
            obs.stop()
    certificate = pod_report['certificate']

    per_host = [SharedRowGroupCache.global_counters(root) for root in roots]
    fills = sum(c.get('fills', 0) for c in per_host)
    peer_hits = sum(c.get('peer_hits', 0) for c in per_host)
    peer_errors = sum(c.get('peer_errors', 0) for c in per_host)
    assert certificate['fills'] == fills, (
        'PodObserver-merged fills ({}) disagree with the hand-summed '
        'global_counters ({})'.format(certificate['fills'], fills))
    assert certificate['peer_hits'] == peer_hits, (
        'PodObserver-merged peer_hits ({}) disagree with the hand-summed '
        'global_counters ({})'.format(certificate['peer_hits'], peer_hits))
    total_samples = cold['samples'] + sum(h['samples'] for h in warm_hosts)
    total_wall = cold['wall_s'] + warm_wall
    aggregate = total_samples / total_wall if total_wall else 0.0
    return {
        'k_hosts': k_hosts,
        'readers_per_host': readers_per_host,
        'protocol': 'staged: cold host fills once, remaining hosts '
                    'peer-attach concurrently (sequential peer mode)',
        'aggregation': 'PodObserver poll of per-root /observe/snapshot '
                       'endpoints, cross-checked against hand-summed '
                       'global_counters',
        'baseline_samples_per_sec': baseline['samples_per_sec'],
        'cold_host': cold,
        'warm_hosts': warm_hosts,
        'total_samples': total_samples,
        'total_wall_s': round(total_wall, 4),
        'aggregate_samples_per_sec': round(aggregate, 1),
        'fills': fills,
        'peer_hits': peer_hits,
        'peer_errors': peer_errors,
        'row_groups': n_groups,
        'per_host_counters': per_host,
        'certificate': certificate,
        'decoded_once_pod_wide': bool(certificate.get('ok')),
    }


# -- the protocol --------------------------------------------------------------

def run_object_store_bench(quick: bool = False, check: bool = True) -> dict:
    """The protocol above; ``quick`` shrinks the store (same certificates,
    looser throughput bars for starved hosts)."""
    from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM

    from petastorm_tpu_torch.benchmark.readahead import generate_readahead_dataset

    rows = 96 if quick else 256
    rows_per_group = 8
    # trace-replay sleeps dominate the hedge-overhead passes, so the
    # per-pair windows are already stable at small epoch counts
    pairs = 2 if quick else 3
    epochs = 1 if quick else 2

    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_object_store_bench_')
    try:
        dataset = os.path.join(tmpdir, 'ds')
        url = 'file://' + dataset
        generate_readahead_dataset(url, rows=rows,
                                   rows_per_group=rows_per_group)
        base_fs = LOCAL_FILESYSTEM
        pieces, total_rows = _dataset_pieces(dataset)
        n_groups = len(pieces)

        def traced_fs():
            # a FRESH injector per pass: every mode replays the exact same
            # recorded latency sequence, so serial vs ranged is apples to
            # apples by construction
            return FaultyFilesystem(base_fs, FaultInjector(
                'trace-replay', seed=_SEED, trace=TRACE_NAME))

        # 1. the read plane under the recorded trace
        modes = {mode: _read_plane_pass(traced_fs(), pieces, mode)
                 for mode in ('serial', 'prebuffer', 'ranged')}
        bit_identical = (modes['serial']['digest']
                         == modes['prebuffer']['digest']
                         == modes['ranged']['digest'])
        speedup = (modes['ranged']['rows_per_s']
                   / modes['serial']['rows_per_s']
                   if modes['serial']['rows_per_s'] else 0.0)

        # 2. per-range hedging must be free on the clean path
        hedge = _hedge_overhead(traced_fs, pieces, pairs=pairs,
                                epochs=epochs)

        # 3. the raw ingest ceiling (roofline context for the artifact)
        ingest = _ranged_ingest_ceiling(base_fs, pieces, total_rows)
        clean_ranged = ingest['assembled_rows_per_s']
        roofline_pct = (round(100.0 * clean_ranged / ingest['rows_per_s'], 2)
                        if ingest['rows_per_s'] else None)

        # 4. pod-wide dedup
        pod = _pod_dedup(url, tmpdir, k_hosts=3, readers_per_host=2,
                         n_groups=n_groups)

        # 5. the trace must replay exactly
        determinism = _determinism(base_fs, pieces[:max(4, n_groups // 4)]
                                   if quick else pieces)

        result = {
            'benchmark': 'object_store',
            'quick': quick,
            'rows': total_rows,
            'row_groups': n_groups,
            'trace': {'name': TRACE_NAME, 'seed': _SEED},
            'modes': modes,
            'bit_identical': bit_identical,
            'ranged_vs_serial_speedup': round(speedup, 2),
            'hedge_overhead': hedge,
            'roofline': {
                'ranged_ingest_mb_per_s': ingest['mb_per_s'],
                'ranged_ingest_rows_per_s': ingest['rows_per_s'],
                'clean_ranged_rows_per_s': clean_ranged,
                'roofline_pct': roofline_pct,
                'note': 'raw planned-range fetch throughput (no parquet '
                        'assembly) is the ceiling the ranged read path '
                        'runs under',
            },
            'pod': pod,
            'determinism': determinism,
        }
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            _check_exact(result)
            assert_bars(_bars(result))
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _bars(result: dict) -> list:
    """The timing bars: ranged reads over serial row-group reads under
    the recorded trace, the per-range hedge's clean-path cost within the
    noise floor, and the pod's aggregate over the per-host serial
    baseline."""
    quick = result['quick']
    pod = result['pod']
    modes = result['modes']
    serial = modes['serial']['rows_per_s']
    return [('ranged / serial rows/s',
             modes['ranged']['rows_per_s'] / serial if serial else 0.0, '>=',
             1.5 if quick else 2.0),
            ('hedge overhead %', result['hedge_overhead']['overhead_pct'],
             '<=', 15.0 if quick else 5.0),
            ('pod / serial baseline',
             pod['aggregate_samples_per_sec'] / pod['baseline_samples_per_sec']
             if pod['baseline_samples_per_sec'] else 0.0, '>=',
             0.8 if quick else 1.0)]


def _check_exact(result: dict) -> None:
    """Bit-identical rows across the three planes, no hedge on the clean
    path, the pod's exact fills and peer hits, and a trace that replays
    exactly."""
    modes, hedge = result['modes'], result['hedge_overhead']
    pod, determinism = result['pod'], result['determinism']
    n_groups = result['row_groups']
    assert result['bit_identical'], (
        'serial/prebuffer/ranged reads must return bit-identical '
        'rows; digests {} / {} / {}'.format(
            modes['serial']['digest'][:12],
            modes['prebuffer']['digest'][:12],
            modes['ranged']['digest'][:12]))
    assert hedge['hedges_fired'] == 0, (
        'the clean-path overhead pair must never fire a hedge '
        '(threshold {}s sits above the trace tail); {} '
        'fired'.format(_CLEAN_PATH_THRESHOLD_S, hedge['hedges_fired']))
    assert pod['fills'] == n_groups, (
        'the pod must decode each of the {} row groups exactly '
        'once; counted {} fills across {} roots'.format(
            n_groups, pod['fills'], pod['k_hosts']))
    assert pod['peer_hits'] == (pod['k_hosts'] - 1) * n_groups, (
        'every warm-host miss must be served by a peer: expected '
        '{} peer hits, counted {}'.format(
            (pod['k_hosts'] - 1) * n_groups, pod['peer_hits']))
    assert determinism['identical_injected'], (
        'same seed + trace must inject identical fault counts '
        'across runs')
    assert determinism['identical_injected_s'], (
        'same seed + trace must replay an identical latency tally '
        'across runs')
    assert determinism['identical_hedge_retry'], (
        'same seed + trace must fire identical hedge/retry '
        'counters across runs')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='object-store read plane: ranged reads under a '
                    'recorded trace, pod-wide cache dedup')
    parser.add_argument('--quick', action='store_true',
                        help='small store, looser throughput bars')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the speedup/dedup/'
                             'determinism assertions')
    args = parser.parse_args(argv)
    result = run_object_store_bench(quick=args.quick,
                                    check=not args.no_check)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
