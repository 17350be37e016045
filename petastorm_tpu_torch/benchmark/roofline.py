"""Roofline benchmark (JAX ``benchmark/roofline.py``): the mnist decode
line judged against a *measured* per-stage ceiling.

Protocol:

1. **Calibrate.** Run the profiler's micro-probes against the mnist store:
   storage sequential/parquet read bandwidth, per-codec decode throughput
   through the codecs, ``ZeroCopySerializer`` transport bandwidth, and
   host-to-device staging to ``device`` (the CUDA device unless
   ``device='cpu'``; without CUDA it raises). Ceilings are rows/sec of THIS
   dataset's rows on THIS host, cached per (host, dataset digest, device).
2. **Measure.** One warmed, traced pass of the columnar read path over the
   whole store: the decode line every north-star image bench is bound by.
3. **Attribute.** The span intervals of the measured pass, interval-union
   per stage (not summed: readahead, decode and infeed overlap by design):
   per-stage busy fraction of the wall, critical stage, overlap seconds.
4. **Verdict + advice.** ``reader.profile()`` reports measured samples/s
   as a % of the binding stage's ceiling, and the what-if advisor replays
   its throughput model for ranked knob recommendations; the model is
   direction-checked against the repo's recorded artifacts.

The check mode asserts the binding stage (``decode`` on a png store while
decode undercuts io at this worker count), a sane roofline fraction (>0
and bounded above by sampling noise), a monotone worker model in the
advisor, and every artifact replay check.

Usage (output is always JSON)::

    python -m petastorm_tpu_torch.benchmark.roofline [--quick] \
        [--no-check] [--workers N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

#: Measurement noise bound: the ceilings are probed over SAMPLED row groups,
#: so a full-store measurement can land slightly above them; beyond this the
#: calibration (not the pipeline) is wrong: the same threshold at which
#: ``build_profile`` attaches its buffer-drain/stale-calibration warning.
from petastorm_tpu_torch.profiler import SANE_FRACTION_LIMIT as MAX_SANE_FRACTION


def run_roofline_bench(quick: bool = False, check: bool = True,
                       workers_count: int = None, device=None) -> dict:
    """Calibrate + measure + attribute + advise on the mnist decode line;
    the staging probe stages to ``device`` (CUDA unless ``'cpu'``; without
    CUDA it raises)."""
    from petastorm_tpu_torch import make_columnar_reader, profiler
    from petastorm_tpu_torch.benchmark.northstar import (
        _default_workers, generate_mnist_images_dataset)
    from petastorm_tpu_torch.device import resolve_device

    target = resolve_device(device)

    rows = 2048 if quick else 16384
    workers = workers_count or _default_workers()
    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_roofline_bench_')
    dataset = os.path.join(tmpdir, 'ds')
    url = 'file://' + dataset
    # the bench must not depend on (or pollute) the user's calibration
    # cache: point the artifact dir into the bench scratch
    saved_env = os.environ.get(profiler.CALIBRATION_DIR_ENV_VAR)
    os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = os.path.join(tmpdir, 'cal')
    try:
        generate_mnist_images_dataset(url, rows=rows)

        def one_pass(trace):
            n = 0
            groups = 0
            with make_columnar_reader(url, num_epochs=1,
                                      reader_pool_type='thread',
                                      workers_count=workers,
                                      shuffle_row_groups=False,
                                      trace=trace) as reader:
                start = time.perf_counter()
                for batch in reader:
                    n += len(batch.idx)
                    groups += 1
                wall = time.perf_counter() - start
                if not trace:
                    return n, groups, wall, None
                # profile INSIDE the context: probes + attribution run on
                # demand after the measured window, never inside it
                prof = reader.profile(calibrate='auto',
                                      samples_per_sec=n / wall,
                                      device=target)
            return n, groups, wall, prof

        one_pass(trace=False)                       # warm: page cache, pool
        samples, groups, wall, profile = one_pass(trace=True)
        measured = samples / wall if wall else 0.0

        calibration = profiler.load_calibration(
            profile['dataset_digest'], profiler.device_name(target))
        attribution = profile['attribution']
        # the advisor's monotonicity contract, checked on the live ceilings
        ceilings = {k: float(v) for k, v in profile['ceilings'].items()}
        cpu_count = profile['cpu_count']
        curve = [profiler.predict_throughput(ceilings, workers=w,
                                             cpu_count=cpu_count,
                                             io_overlap=True)
                 for w in range(1, 9)]
        monotone = all(b >= a - 1e-9 for a, b in zip(curve, curve[1:]))
        model_checks = profiler.replay_against_artifacts()
        result = {
            'quick': quick,
            'benchmark': 'roofline_mnist_decode',
            'rows': rows,
            'row_groups': groups,
            'workers': workers,
            'cpu_count': cpu_count,
            'measured_samples_per_sec': round(measured, 1),
            'ceilings_samples_per_sec': profile['ceilings'],
            'effective_ceilings_samples_per_sec':
                profile['effective_ceilings'],
            'roofline': {
                'binding_stage': profile['binding_stage'],
                'binding_ceiling_samples_per_s':
                    profile['binding_ceiling_samples_per_s'],
                'roofline_fraction': profile['roofline_fraction'],
                'roofline_pct': round(
                    100.0 * (profile['roofline_fraction'] or 0.0), 2),
            },
            'attribution': attribution,
            'advisor': profile['advisor'],
            'advisor_worker_curve': [round(c, 1) for c in curve],
            'advisor_monotone': monotone,
            'model_checks': model_checks,
            'probes': {
                'storage': (calibration or {}).get('probes', {}).get(
                    'storage'),
                'decode_per_codec': ((calibration or {}).get('probes', {})
                                     .get('decode') or {}).get('per_codec'),
            },
        }
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            assert profile['calibrated'], 'calibration probes must have run'
            _check_exact(result)
            assert_bars(_bars(result))
        return result
    finally:
        if saved_env is None:
            os.environ.pop(profiler.CALIBRATION_DIR_ENV_VAR, None)
        else:
            os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = saved_env
        shutil.rmtree(tmpdir, ignore_errors=True)


def _bars(result: dict) -> list:
    """The timing bars: the measured line's fraction of its binding
    ceiling, in (0, the profiler's sane limit]."""
    fraction = result['roofline']['roofline_fraction']
    return [('roofline fraction', fraction, '>', 0.0),
            ('roofline fraction', fraction, '<=', MAX_SANE_FRACTION)]


def _check_exact(result: dict) -> None:
    """The verdict's logic on this run's ceilings: a calibration on disk,
    decode undercutting io on a png store, the binding stage the lowest
    effective ceiling (``decode`` while decode undercuts io at this worker
    count), a monotone advisor, every artifact replay check ok, and span
    attribution that kept the decode stage."""
    assert result['probes']['storage'] is not None, (
        'calibration probes must have run')
    ceilings = {k: float(v)
                for k, v in result['ceilings_samples_per_sec'].items()}
    binding = result['roofline']['binding_stage']
    workers, cpu_count = result['workers'], result['cpu_count']
    # the png store is decode-bound PER STREAM by construction: one
    # core must decode slower than it reads warm parquet
    assert ceilings['decode'] < ceilings['io'], (
        'single-stream decode ({:.0f}/s) must undercut the storage '
        'ceiling ({:.0f}/s) on a png store'.format(
            ceilings['decode'], ceilings['io']))
    effective = {k: float(v) for k, v in
                 result['effective_ceilings_samples_per_sec'].items()}
    assert binding == min(effective, key=effective.get), (
        'binding stage must be the lowest effective ceiling')
    if ceilings['decode'] * min(workers, cpu_count) < ceilings['io']:
        # enough cores can legitimately move the wall to io; only
        # when decode still undercuts io at this worker count must
        # the verdict name it (a many-core host is not a failure)
        assert binding == 'decode', (
            'decode undercuts io at {} workers ({} cores) but the '
            'verdict named {!r}'.format(workers, cpu_count, binding))
    assert result['advisor_monotone'], (
        'the advisor model must never predict fewer samples/s for '
        'more workers: {}'.format(result['advisor_worker_curve']))
    bad = [c for c in result['model_checks'] if not c['ok']]
    assert not bad, (
        'model replay against recorded artifacts failed: {}'.format(bad))
    attribution = result['attribution']
    assert attribution['source'] == 'spans', (
        'the traced pass must attribute from span intervals')
    assert 'decode' in attribution['stages'], (
        'attribution lost the decode stage: {}'.format(
            sorted(attribution['stages'])))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Roofline benchmark: calibrated per-stage ceilings, '
                    'overlap-aware attribution and advisor checks on the '
                    'mnist decode line')
    parser.add_argument('--quick', action='store_true',
                        help='small store')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the binding-stage/'
                             'monotonicity assertions')
    parser.add_argument('--workers', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help="where calibration stages: 'cuda' (the "
                             "default; raises without CUDA) or 'cpu'")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(
        args.device, 'python -m petastorm_tpu_torch.benchmark.roofline')
    result = run_roofline_bench(quick=args.quick, check=not args.no_check,
                                workers_count=args.workers, device=device)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
