"""Autotune benchmark (JAX ``benchmark/autotune.py``): a deliberately
mis-tuned reader must recover, an already-tuned reader must not be
degraded.

The controller's value claim is closed-loop: tuning knowledge (readahead
depth, "more workers can be slower") should stop being something a user
must discover by hand. Local disks are too fast to leave a mis-tuned
reader anything to recover (with io essentially free, every knob is within
noise of every other), so this bench runs the mnist-image line through the
``SlowFilesystem`` shim, with the per-read delay pinned so the storage
ceiling is about the measured decode ceiling (io:decode about 1:1, where
readahead is worth about 2x and ``io_readahead=0`` is a real mis-tuning).
The protocol:

1. **Pin the shim**: a no-delay counting pass measures reads-per-row-group;
   a cold probe measures the decode ceiling; the per-read delay is derived
   so one row group's synthetic I/O is about its decode time.
2. **Calibrate cold** through the delayed shim (``profiler.calibrate``,
   saved, staging to ``device``: the CUDA device unless ``device='cpu'``;
   without CUDA it raises): the controller's first tick loads this cached
   artifact instead of probing under load, which would both perturb the
   measured window and under-measure the ceilings.
3. **Hand-tune by measurement**: a small grid WITHOUT the controller,
   ``(w=1, ra=1)``, ``(w=1, ra=2)``, ``(w=default, ra=1)``; the best
   measured rows/s is the hand-tuned reference (the grid decides, not an
   assumption: on a 1-core host w=1 wins, on a big host more workers may).
4. **Recovery**: a mis-tuned reader (``workers=1, io_readahead=0``) streams
   under the controller; the trailing-window rate is sampled each second.
   Full gate: **>= 80% of the hand-tuned rate within 60s**, with the
   action log, time-to-threshold and final config recorded.
5. **Steady guard**: the hand-tuned config, controller OFF vs ON, in
   alternating pairs (order flipped per pair, headline = median of
   per-pair deltas, which cancels drift). Full gate: the controller costs
   **<= 5%** on a reader that is already right: its hysteresis and
   quarantine must keep it quiet.

The result carries roofline context (the recovered rate against the
calibrated binding ceiling), the controller's own prediction grading, and
the model replay checks. ``quick`` shrinks the store and loosens the
gates.

Usage (output is always JSON)::

    python -m petastorm_tpu_torch.benchmark.autotune [--quick] \
        [--no-check] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from collections import deque

from petastorm_tpu_torch.benchmark.readahead import (SlowFilesystem,
                                                     columnar_reader)

#: Trailing window (seconds) the recovery loop rates over: long enough to
#: smooth row-group granularity, short enough to watch convergence happen.
TRAIL_S = 5.0


def _make_reader(dataset_path, slow_fs, workers, io_readahead, num_epochs,
                 autotune=False):
    """A columnar reader over the shim filesystem (the readahead bench's
    construction: the filesystem factory returns the wrapped instance)."""
    return columnar_reader(dataset_path, slow_fs, workers=workers,
                           num_epochs=num_epochs, io_readahead=io_readahead,
                           autotune=autotune)


def _measure_rate(dataset_path, slow_fs, workers, io_readahead,
                  duration_s: float, warm_s: float = 1.0,
                  autotune=False) -> dict:
    """Stream continuously; rows/s over ``duration_s`` after a ``warm_s``
    discard window."""
    reader = _make_reader(dataset_path, slow_fs, workers, io_readahead,
                          num_epochs=None, autotune=autotune)
    rows = 0
    marked = None
    rate = 0.0
    report = None
    try:
        start = time.perf_counter()
        for batch in reader:
            rows += len(batch.idx)
            now = time.perf_counter()
            if marked is None and now - start >= warm_s:
                marked = (now, rows)
            if marked is not None and now - marked[0] >= duration_s:
                rate = (rows - marked[1]) / (now - marked[0])
                break
        if reader.autotune is not None:
            report = reader.autotune.report()
    finally:
        reader.stop()
        reader.join()
    return {'samples_per_sec': round(rate, 1), 'autotune': report}


def _recovery_run(dataset_path, slow_fs, target_rate: float,
                  budget_s: float, scratch: str, target=None) -> dict:
    """Stream a mis-tuned reader (w1, ra0) under the controller; sample the
    trailing-window rate until it clears ``target_rate`` and settles, or
    the budget runs out."""
    reader = _make_reader(
        dataset_path, slow_fs, workers=1, io_readahead=0, num_epochs=None,
        autotune=dict(tick_interval_s=1.0, calibrate='auto',
                      scratch_dir=scratch, device=target))
    assert reader.autotune is not None
    samples = []            # (elapsed_s, trailing_rate)
    reached_at = None
    try:
        start = time.perf_counter()
        window = deque()    # (ts, rows_cumulative)
        rows = 0
        last_sample = start
        for batch in reader:
            rows += len(batch.idx)
            now = time.perf_counter()
            window.append((now, rows))
            while window and now - window[0][0] > TRAIL_S:
                window.popleft()
            elapsed = now - start
            if now - last_sample >= 1.0 and len(window) >= 2:
                last_sample = now
                span = window[-1][0] - window[0][0]
                trailing = ((window[-1][1] - window[0][1]) / span
                            if span > 0 else 0.0)
                samples.append((round(elapsed, 2), round(trailing, 1)))
                if reached_at is None and trailing >= target_rate:
                    reached_at = elapsed
                # converged: threshold held long enough for the controller
                # to grade its move — no need to burn the whole budget
                if reached_at is not None and elapsed >= reached_at + 8.0:
                    break
            if elapsed >= budget_s:
                break
        span = (window[-1][0] - window[0][0]) if len(window) >= 2 else 0.0
        final_rate = ((window[-1][1] - window[0][1]) / span
                      if span > 0 else 0.0)
        report = reader.autotune.report()
    finally:
        reader.stop()
        reader.join()
    return {
        'samples_per_sec': round(final_rate, 1),
        'seconds_to_threshold': (round(reached_at, 2)
                                 if reached_at is not None else None),
        'timeline': samples[-30:],
        'final_config': report['config'],
        'actions_total': report['actions_total'],
        'reverts_total': report['reverts_total'],
        'actions': [{k: a.get(k) for k in
                     ('tick', 'knob', 'direction', 'from', 'applied',
                      'policy', 'predicted_gain_pct', 'measured_delta_pct',
                      'prediction_error_pct', 'graded')}
                    for a in report['actions']],
        'prediction': report['prediction'],
    }


def _pin_slow_io(dataset_path, rows, target):
    """Steps 1-2 of the protocol. Pin the shim: reads per row group (a
    counting pass) and the decode ceiling (a cold probe) give the per-read
    delay for io:decode = 1:1. Then calibrate cold through the delayed
    shim and cache the artifact: the controller's first tick loads it
    instead of probing under load. Returns ``(make_slow_fs, calibration,
    reads_per_group, rows_per_group, delay_per_read)``."""
    from petastorm_tpu_torch import profiler
    from petastorm_tpu_torch.etl.dataset_metadata import (
        infer_or_load_unischema, load_row_groups)
    from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM

    base_fs = LOCAL_FILESYSTEM
    counting_fs = SlowFilesystem(base_fs)
    groups = 0
    reader = _make_reader(dataset_path, counting_fs, 1, 0, num_epochs=1)
    try:
        for _ in reader:
            groups += 1
    finally:
        reader.stop()
        reader.join()
    reads_per_group = max(1.0, counting_fs.read_calls / groups)
    rows_per_group = rows / groups
    schema, _ = infer_or_load_unischema(dataset_path, base_fs)
    pieces = load_row_groups(dataset_path, filesystem=base_fs)
    cold = profiler.calibrate(dataset_path, pieces, schema, save=False,
                              device=target, filesystem=base_fs)
    decode_ceiling = (cold.get('ceilings') or {}).get('decode') or 1.0
    io_s_per_group = rows_per_group / decode_ceiling
    delay_per_read = io_s_per_group / reads_per_group

    def make_slow_fs():
        return SlowFilesystem(base_fs, seconds_per_read=delay_per_read)

    calibration = profiler.calibrate(dataset_path, pieces, schema,
                                     save=True, device=target,
                                     filesystem=make_slow_fs())
    return (make_slow_fs, calibration, reads_per_group, rows_per_group,
            delay_per_read)


def _hand_tune(dataset_path, make_slow_fs, pass_s: float):
    """Step 3: the grid's rates by measurement, and the best
    ``(workers, io_readahead)`` of it."""
    from petastorm_tpu_torch.benchmark.northstar import _default_workers
    grid_configs = {'w1_ra1': (1, 1), 'w1_ra2': (1, 2)}
    default_workers = _default_workers()
    if default_workers > 1:
        grid_configs['w{}_ra1'.format(default_workers)] = (default_workers, 1)
    grid = {name: _measure_rate(dataset_path, make_slow_fs(), w, ra,
                                pass_s)['samples_per_sec']
            for name, (w, ra) in grid_configs.items()}
    return grid, grid_configs[max(grid, key=grid.get)]


def _steady_rate(dataset_path, make_slow_fs, workers, io_readahead,
                 pass_s: float, tuned: bool, scratch, target) -> float:
    """One pass of the steady guard: samples/s of the hand-tuned config
    with the controller on (``tuned``) or off."""
    options = (dict(tick_interval_s=1.0, calibrate='auto',
                    scratch_dir=scratch, device=target)
               if tuned else False)
    return _measure_rate(dataset_path, make_slow_fs(), workers, io_readahead,
                         pass_s, autotune=options)['samples_per_sec']


def run_autotune_bench(quick: bool = False, check: bool = True,
                       device=None) -> dict:
    """Mis-tuned recovery and the steady guard on the slow-io mnist line;
    calibration stages to ``device`` (CUDA unless ``'cpu'``; without CUDA
    it raises)."""
    from petastorm_tpu_torch import profiler
    from petastorm_tpu_torch.autotune import AUTOTUNE_DIR_ENV_VAR
    from petastorm_tpu_torch.benchmark.northstar import (
        generate_mnist_images_dataset)
    from petastorm_tpu_torch.device import resolve_device

    target = resolve_device(device)

    rows = 512 if quick else 2048
    pass_s = 2.0 if quick else 4.0
    budget_s = 30.0 if quick else 60.0
    pairs = 2 if quick else 3
    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_autotune_bench_')
    dataset_path = os.path.join(tmpdir, 'ds')
    scratch = os.path.join(tmpdir, 'arbitration')
    saved_cal = os.environ.get(profiler.CALIBRATION_DIR_ENV_VAR)
    saved_arb = os.environ.get(AUTOTUNE_DIR_ENV_VAR)
    os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = os.path.join(tmpdir, 'cal')
    os.environ[AUTOTUNE_DIR_ENV_VAR] = scratch
    try:
        # small row groups: the row group is the readahead/ventilation unit,
        # and the knobs need granularity to show up in a trailing window
        generate_mnist_images_dataset('file://' + dataset_path, rows=rows,
                                      row_group_size_mb=0.05)
        cpu = os.cpu_count() or 1
        (make_slow_fs, calibration, reads_per_group,
         rows_per_group, delay_per_read) = _pin_slow_io(dataset_path, rows,
                                                        target)
        grid, (hand_workers, hand_ra) = _hand_tune(dataset_path,
                                                   make_slow_fs, pass_s)
        hand_tuned = max(grid.values())

        # mis-tuned start rate (no controller) for the artifact's "before"
        mistuned = _measure_rate(dataset_path, make_slow_fs(), 1, 0,
                                 pass_s)['samples_per_sec']

        # 4. recovery under the controller
        recovery = _recovery_run(dataset_path, make_slow_fs(),
                                 0.8 * hand_tuned, budget_s, scratch, target)
        recovery['recovery_fraction'] = round(
            recovery['samples_per_sec'] / hand_tuned, 4) if hand_tuned else 0

        # 5. steady guard: hand-tuned config, controller off vs on, paired
        deltas, pair_records = [], []
        for pair in range(pairs):
            order = (False, True) if pair % 2 == 0 else (True, False)
            rates = {tuned: _steady_rate(dataset_path, make_slow_fs,
                                         hand_workers, hand_ra, pass_s,
                                         tuned, scratch, target)
                     for tuned in order}
            baseline, tuned_rate = rates[False], rates[True]
            delta = (100.0 * (baseline - tuned_rate) / baseline
                     if baseline else 0.0)
            deltas.append(delta)
            pair_records.append({'baseline': baseline,
                                 'autotuned': tuned_rate,
                                 'delta_pct': round(delta, 2)})
        deltas.sort()
        steady_delta = deltas[len(deltas) // 2]

        ceilings = calibration.get('ceilings') or {}
        binding = min((s for s in ('io', 'decode') if ceilings.get(s)),
                      key=lambda s: ceilings[s], default=None)
        binding_ceiling = ceilings.get(binding) if binding else None
        roofline_fraction = (
            round(recovery['samples_per_sec'] / binding_ceiling, 4)
            if binding_ceiling else None)
        result = {
            'quick': quick,
            'benchmark': 'autotune_mnist_slow_io',
            'rows': rows,
            'cpu_count': cpu,
            'protocol': {
                'pass_duration_s': pass_s,
                'recovery_budget_s': budget_s,
                'trailing_window_s': TRAIL_S,
                'steady_pairs': pairs,
                'tick_interval_s': 1.0,
                'pool': 'thread',
                'rows_per_group': round(rows_per_group, 1),
                'delay_per_read_s': round(delay_per_read, 6),
                'reads_per_group': round(reads_per_group, 1),
            },
            'ceilings_samples_per_sec': {
                k: v for k, v in ceilings.items() if v},
            'hand_tuned': {
                'config': {'workers': hand_workers,
                           'io_readahead': hand_ra},
                'samples_per_sec': hand_tuned,
                'grid': grid,
            },
            'mistuned': {
                'config': {'workers': 1, 'io_readahead': 0},
                'samples_per_sec': mistuned,
            },
            'recovered': recovery,
            'steady': {
                'config': {'workers': hand_workers,
                           'io_readahead': hand_ra},
                'median_delta_pct': round(steady_delta, 2),
                'pairs': pair_records,
            },
            'roofline': {
                'binding_stage': binding,
                'binding_ceiling_samples_per_s': binding_ceiling,
                'roofline_fraction': roofline_fraction,
                'roofline_pct': (round(100.0 * roofline_fraction, 2)
                                 if roofline_fraction is not None else None),
            },
            'model_checks': profiler.replay_against_artifacts(),
        }
        if check:
            _check(result)
        return result
    finally:
        if saved_cal is None:
            os.environ.pop(profiler.CALIBRATION_DIR_ENV_VAR, None)
        else:
            os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = saved_cal
        if saved_arb is None:
            os.environ.pop(AUTOTUNE_DIR_ENV_VAR, None)
        else:
            os.environ[AUTOTUNE_DIR_ENV_VAR] = saved_arb
        shutil.rmtree(tmpdir, ignore_errors=True)


def _check_exact(result: dict) -> None:
    """At least one controller action on the mis-tuned reader, and every
    model replay check ok."""
    assert result['recovered']['actions_total'] >= 1, (
        'the controller took no action on a reader mis-tuned by '
        'construction')
    failed = [c for c in result['model_checks'] if not c['ok']]
    assert not failed, 'model replay checks failed: {}'.format(failed)


def _bars(result: dict) -> list:
    """The timing bars. Quick mode runs sub-second windows on a possibly
    loaded host, where absolute rates drift far more than the effect size
    across passes minutes apart: its signal is the controller's own
    grading (pre/post windows measured back to back around its move),
    whose best move must show a gain. The full run holds the recovery to
    80% of the hand-tuned rate (:func:`_check` also asks that the rate
    was reached inside the budget). Both hold the steady
    guard: the controller on an already-tuned reader, median of pairs."""
    quick = result['quick']
    recovered = result['recovered']
    if quick:
        graded = [a['measured_delta_pct'] for a in recovered['actions']
                  if a.get('measured_delta_pct') is not None]
        bars = [('best graded move delta %', max(graded) if graded else None,
                 '>', 0.0)]
    else:
        bars = [('recovery fraction', recovered['recovery_fraction'], '>=',
                 0.8)]
    bars.append(('steady median delta %', result['steady'][
        'median_delta_pct'], '<=', 15.0 if quick else 5.0))
    return bars


def _check(result: dict) -> None:
    from petastorm_tpu_torch.benchmark import assert_bars
    _check_exact(result)
    assert_bars(_bars(result))
    if not result['quick']:
        assert result['recovered']['seconds_to_threshold'] is not None, (
            'the 80% threshold was never reached inside the {}s budget'
            .format(result['protocol']['recovery_budget_s']))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='autotune controller benchmark: mis-tuned recovery + '
                    'already-tuned non-degradation on the slow-io mnist '
                    'line')
    parser.add_argument('--quick', action='store_true',
                        help='small store, loose gates')
    parser.add_argument('--no-check', action='store_true',
                        help='measure and print without asserting gates')
    parser.add_argument('--out', metavar='PATH', default=None,
                        help='also write the JSON result to PATH')
    parser.add_argument('--device', default='cuda',
                        help="where calibration stages: 'cuda' (the "
                             "default; raises without CUDA) or 'cpu'")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(
        args.device, 'python -m petastorm_tpu_torch.benchmark.autotune')
    result = run_autotune_bench(quick=args.quick, check=not args.no_check,
                                device=device)
    blob = json.dumps(result, indent=2, sort_keys=True)
    print(blob)
    if args.out:
        from petastorm_tpu_torch.utils import atomic_write
        atomic_write(args.out, lambda f: f.write(blob + '\n'))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
