"""Goodput-plane benchmark (JAX ``benchmark/goodput.py``): the default-on
cost of per-step goodput accounting, and proof the verdicts point at the
right side. The loader passes run ``TorchDataLoader`` for ``device`` (the
CUDA device unless ``device='cpu'``).

Phases (see ``docs/goodput.md``):

1. **Instrumentation overhead.** Alternating loader epochs over the same
   token store, ``PETASTORM_TPU_GOODPUT`` off vs on (structural off: the
   off pass has no monitor object at all). Median per-pair delta must
   stay under the 5% noise floor — the goodput hooks ride the loader's
   existing instrumented iteration path, so the marginal cost is a few
   dict writes per step.
2. **Stall classification.** Two rigged training loops over the same
   store: a *slow-data* leg (the decode path sleeps, the consumer is
   instant) whose :meth:`~petastorm_tpu_torch.goodput.GoodputMonitor.explain_step`
   must say ``data-stall``, and a *slow-compute* leg (instant data, the
   consumer sleeps each step) that must say ``compute-bound`` — the
   benchmark proving the decomposition attributes blame to the correct
   side before anyone trusts it on a real pod.
3. **Pod merge.** K simulated hosts' summed-seconds states merged by
   :func:`~petastorm_tpu_torch.podobs.check_pod_goodput`: the pod totals must
   be bit-identical to one monitor recording every step directly
   (binary-exact step durations, so float summation order cannot hide
   drift), the per-stage ``device_step`` histograms must merge
   bit-identically, and the rigged straggler host must be **named**.
4. **Kill switch.** ``PETASTORM_TPU_GOODPUT=0`` is structural: no monitor
   on the loader, no registration on the reader, no ``goodput_*``
   seconds or derived fractions in the snapshot, no
   ``device_step``/``host_overhead`` latency observations, and the
   ``/goodput`` route 404s.

CLI::

    python -m petastorm_tpu_torch.benchmark.goodput [--quick] [--no-check] \
        [--device cpu]
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

#: Binary-exact (infeed_s, train_wall_s) step lists per simulated host —
#: float addition over these is associative, so the pod-merge totals must
#: match direct recording BIT-identically, not approximately.
_POD_HOST_STEPS = {
    'pod_host_0': [(0.25, 0.75), (0.0, 1.0), (0.125, 0.875)],
    'pod_host_1': [(0.5, 0.5), (0.25, 0.75), (0.0, 1.0)],
    'pod_host_2': [(1.5, 0.5), (1.75, 0.25), (2.0, 0.5)],   # the straggler
}


def _loader_pass(url, goodput_on: bool, transform_fn=None,
                 consumer_sleep_s: float = 0.0, batch_size: int = 16,
                 device=None):
    """One loader epoch; returns ``(items_per_s, monitor_or_None)``. The
    kill switch is flipped via the env var around loader CONSTRUCTION —
    the structural off path, exactly what a production job toggles."""
    from petastorm_tpu_torch.goodput import GOODPUT_ENV_VAR
    from petastorm_tpu_torch.reader import make_columnar_reader
    from petastorm_tpu_torch.torch_utils import TorchDataLoader

    previous = os.environ.get(GOODPUT_ENV_VAR)
    os.environ[GOODPUT_ENV_VAR] = '1' if goodput_on else '0'
    try:
        rows = 0
        with make_columnar_reader(url, num_epochs=1, workers_count=1,
                                  shuffle_row_groups=False) as reader:
            with TorchDataLoader(reader, batch_size=batch_size,
                                 transform_fn=transform_fn,
                                 device=device) as loader:
                start = time.perf_counter()
                for batch in loader:
                    rows += len(next(iter(batch.values())))
                    if consumer_sleep_s:
                        time.sleep(consumer_sleep_s)
                wall = time.perf_counter() - start
                monitor = loader.goodput
        return (rows / wall if wall else 0.0), monitor
    finally:
        if previous is None:
            os.environ.pop(GOODPUT_ENV_VAR, None)
        else:
            os.environ[GOODPUT_ENV_VAR] = previous


def _overhead_leg(url, pairs: int, device=None) -> dict:
    """Alternating off/on epochs, median-of-pairs (the repo's overhead
    protocol: warmup pair discarded, per-pair deltas isolate the
    instrumentation from machine drift)."""
    _loader_pass(url, goodput_on=False, device=device)
    _loader_pass(url, goodput_on=True, device=device)
    deltas_pct, off_rates, on_rates = [], [], []
    for _ in range(pairs):
        off, _ = _loader_pass(url, goodput_on=False, device=device)
        on, _ = _loader_pass(url, goodput_on=True, device=device)
        off_rates.append(off)
        on_rates.append(on)
        deltas_pct.append((off - on) / off * 100.0 if off else 0.0)
    return {
        'pairs': pairs,
        'baseline_items_per_s': round(statistics.median(off_rates), 1),
        'goodput_on_items_per_s': round(statistics.median(on_rates), 1),
        'overhead_pct': round(statistics.median(deltas_pct), 2),
        'per_pair_deltas_pct': [round(d, 2) for d in deltas_pct],
    }


def _classification_leg(url, stall_sleep_s: float, device=None) -> dict:
    """The rigged slow-data / slow-compute loops; each leg reports the
    explain_step verdict of its worst (longest-stall vs longest-wall)
    step plus the cumulative fractions."""

    def slow_data(batch):
        time.sleep(stall_sleep_s)       # the DATA path is the slow side
        return batch

    _, stalled = _loader_pass(url, goodput_on=True, transform_fn=slow_data,
                              device=device)
    _, compute = _loader_pass(url, goodput_on=True,
                              consumer_sleep_s=stall_sleep_s, device=device)

    def leg(monitor):
        summary = monitor.summary()
        verdict = monitor.explain_step()
        return {
            'steps': summary['steps'],
            'goodput_fraction': summary['goodput_fraction'],
            'data_stall_fraction': summary['data_stall_fraction'],
            'verdict': verdict['verdict'],
            'explanation': verdict['explanation'],
        }

    return {'stall_sleep_ms': stall_sleep_s * 1000.0,
            'slow_data': leg(stalled), 'slow_compute': leg(compute)}


def _pod_merge_leg(min_goodput: float) -> dict:
    """K per-host monitors vs one direct recorder: summed-seconds totals
    and device_step histograms must merge bit-identically, and
    ``check_pod_goodput`` must name the rigged straggler."""
    from petastorm_tpu_torch.goodput import GoodputMonitor
    from petastorm_tpu_torch.latency import PipelineLatency
    from petastorm_tpu_torch.podobs import (check_pod_goodput,
                                            merge_histogram_states,
                                            state_percentiles)

    monitors, planes = {}, {}
    direct = GoodputMonitor()
    direct_plane = PipelineLatency()
    for host in sorted(_POD_HOST_STEPS):
        plane = planes[host] = PipelineLatency()
        monitor = monitors[host] = GoodputMonitor(latency=plane, host=host)
        for infeed_s, wall_s in _POD_HOST_STEPS[host]:
            monitor.note_fetch(infeed_s)
            monitor.finish_step(wall_s)
            direct.note_fetch(infeed_s)
            direct.finish_step(wall_s)
            direct_plane.record('device_step', wall_s)

    pod = check_pod_goodput(
        {host: monitor.summary() for host, monitor in monitors.items()},
        min_goodput=min_goodput)
    direct_state = direct.state()
    totals_bit_identical = all(
        pod['totals'][key] == direct_state[key]
        for key in ('steps', 'total_s', 'stall_s', 'h2d_s', 'device_s',
                    'host_s'))
    merged = merge_histogram_states(
        [{'device_step': planes[h].histograms['device_step'].state()}
         for h in sorted(planes)])['device_step']
    direct_hist = direct_plane.histograms['device_step'].state()
    histograms_bit_identical = (
        merged['buckets'] == direct_hist['buckets']
        and merged['count'] == direct_hist['count'])
    return {
        'k_hosts': len(monitors),
        'min_goodput': min_goodput,
        'pod_goodput_fraction': pod['goodput_fraction'],
        'pod_data_stall_fraction': pod['data_stall_fraction'],
        'straggler': pod['straggler'],
        'ok': pod['ok'],
        'problems': pod['problems'],
        'totals_bit_identical': totals_bit_identical,
        'histograms_bit_identical': histograms_bit_identical,
        'merged_device_step_percentiles': state_percentiles(merged),
    }


def _kill_switch_leg(url, device=None) -> dict:
    """Structural-off proof: no monitor, no registration, no counters, no
    latency stages, and a live debug server whose ``/goodput`` 404s."""
    from http.client import HTTPConnection

    from petastorm_tpu_torch.goodput import GOODPUT_ENV_VAR
    from petastorm_tpu_torch.reader import make_columnar_reader
    from petastorm_tpu_torch.torch_utils import TorchDataLoader
    from petastorm_tpu_torch.workers.stats import LATENCY_HISTOGRAMS_KEY

    previous = os.environ.get(GOODPUT_ENV_VAR)
    os.environ[GOODPUT_ENV_VAR] = '0'
    try:
        with make_columnar_reader(url, num_epochs=1, workers_count=1,
                                  shuffle_row_groups=False,
                                  debug_port=0) as reader:
            with TorchDataLoader(reader, batch_size=16,
                                 device=device) as loader:
                no_monitor = loader.goodput is None
                for _ in loader:
                    pass
                not_registered = reader._goodput is None
                snapshot = reader._stats_snapshot()
                # probe while the reader (and its debug server) is live —
                # the loader's __exit__ joins the reader
                conn = HTTPConnection('127.0.0.1', reader.debug_port,
                                      timeout=10)
                try:
                    conn.request('GET', '/goodput')
                    route_status = conn.getresponse().status
                finally:
                    conn.close()
        histograms = snapshot.get(LATENCY_HISTOGRAMS_KEY) or {}
        return {
            'no_monitor_object': no_monitor,
            'not_registered_on_reader': not_registered,
            'no_seconds_recorded': snapshot.get('goodput_total_s', 0.0) == 0.0,
            'no_derived_fractions': 'goodput_fraction' not in snapshot,
            'no_stage_observations': all(
                histograms.get(stage, {}).get('count', 0) == 0
                for stage in ('device_step', 'host_overhead')),
            'goodput_route_status': route_status,
        }
    finally:
        if previous is None:
            os.environ.pop(GOODPUT_ENV_VAR, None)
        else:
            os.environ[GOODPUT_ENV_VAR] = previous


def run_goodput_bench(quick: bool = False, check: bool = True,
                      device=None) -> dict:
    """The goodput protocol: the four legs, then (``check``) their verdicts.
    ``quick`` shrinks the store and pair count (same classification and
    merge proofs, the overhead gate at a looser floor). The loader passes
    make their batches for ``device`` (CUDA unless ``'cpu'``; without CUDA
    it raises)."""
    from petastorm_tpu_torch.benchmark.northstar import generate_token_dataset
    from petastorm_tpu_torch.device import resolve_device

    device = resolve_device(device)
    rows = 192 if quick else 1024
    seq_len = 32 if quick else 64
    pairs = 2 if quick else 4
    stall_sleep_s = 0.01 if quick else 0.02
    min_goodput = 0.75

    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_goodput_bench_')
    try:
        url = 'file://' + os.path.join(tmpdir, 'tok')
        generate_token_dataset(url, rows=rows, seq_len=seq_len, vocab=256,
                               seed=21, row_group_size_mb=0.05,
                               ndarray_codec=True)

        overhead = _overhead_leg(url, pairs=pairs, device=device)
        classification = _classification_leg(url, stall_sleep_s, device)
        pod = _pod_merge_leg(min_goodput)
        kill_switch = _kill_switch_leg(url, device)

        result = {
            'benchmark': 'goodput',
            'quick': quick,
            'rows': rows,
            'overhead': overhead,
            'classification': classification,
            'pod': pod,
            'kill_switch': kill_switch,
            'roofline': {
                'baseline_items_per_s': overhead['baseline_items_per_s'],
                'roofline_pct': round(
                    100.0 * overhead['goodput_on_items_per_s']
                    / overhead['baseline_items_per_s'], 2)
                if overhead['baseline_items_per_s'] else None,
                'note': 'goodput-on loader throughput as % of the '
                        'goodput-off baseline on the same store — the '
                        'measured ceiling the default-on plane runs under',
            },
        }
        if check:
            _check_overhead(result, quick)
            _check_verdicts(result)
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _check_overhead(result: dict, quick: bool) -> None:
    """The timing gate: the default-on plane's median cost a loader pass
    (its quick passes last milliseconds, so a loaded host moves it)."""
    overhead = result['overhead']
    max_overhead = 15.0 if quick else _OVERHEAD_NOISE_FLOOR_PCT
    assert overhead['overhead_pct'] <= max_overhead, (
        'default-on goodput accounting costs {:.2f}% on the loader '
        'path — beyond the {}% noise floor'.format(
            overhead['overhead_pct'], max_overhead))


def _check_verdicts(result: dict) -> None:
    """The structural gates: the rigged legs' verdicts, the pod merge's
    bit-identical totals and named straggler, and the kill switch."""
    classification = result['classification']
    pod = result['pod']
    kill_switch = result['kill_switch']
    assert classification['slow_data']['verdict'] == 'data-stall', (
        'the rigged slow-data loop must classify as data-stall, '
        'got {!r}'.format(classification['slow_data']['verdict']))
    assert (classification['slow_compute']['verdict']
            == 'compute-bound'), (
        'the rigged slow-compute loop must classify as '
        'compute-bound, got {!r}'.format(
            classification['slow_compute']['verdict']))
    assert pod['totals_bit_identical'], (
        'pod goodput totals must be bit-identical to direct '
        'recording')
    assert pod['histograms_bit_identical'], (
        'merged device_step histograms must be bit-identical to '
        'direct recording')
    assert pod['straggler']['host'] == 'pod_host_2', (
        'the rigged straggler must be named, got {!r}'.format(
            pod['straggler']))
    assert pod['ok'] is False and any(
        'pod_host_2' in p for p in pod['problems']), (
        'the min_goodput breach must name the straggler host')
    assert all(kill_switch[key] for key in (
        'no_monitor_object', 'not_registered_on_reader',
        'no_seconds_recorded', 'no_derived_fractions',
        'no_stage_observations')), (
        'the kill switch must be structural: {}'.format(kill_switch))
    assert kill_switch['goodput_route_status'] == 404, (
        '/goodput must 404 under the kill switch, got {}'.format(
            kill_switch['goodput_route_status']))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='goodput plane: default-on overhead, slow-data vs '
                    'slow-compute classification, pod merge + straggler, '
                    'structural kill switch')
    parser.add_argument('--quick', action='store_true',
                        help='small store and fewer pairs')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the overhead/verdict '
                             'assertions')
    parser.add_argument('--device', default='cuda',
                        help="where the loader's batches go: 'cuda' (the "
                             "default; raises without CUDA) or 'cpu'")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(
        args.device, 'python -m petastorm_tpu_torch.benchmark.goodput')
    result = run_goodput_bench(quick=args.quick, check=not args.no_check,
                               device=device)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
