"""Device-decode benchmark (JAX ``benchmark/device_decode.py``):
bytes-through ingest with the codec decode run on the device against the
host batched-decode baseline.

On an ``NdarrayCodec`` token store, workers ship the raw column payload
(np.save header + cells, one ``(rows, stride)`` uint8 grid per planned
column, :mod:`petastorm_tpu_torch.ops.decode`) and the
:class:`~petastorm_tpu_torch.torch_utils.TorchDataLoader` decodes it on its
device (header strip, bit reinterpretation and reshape, fused with any
device-marked ``TransformSpec``). The host stops paying codec CPU per
epoch; what remains on the host side of the decode stage is a zero-copy
buffer slice.

The A/B is the kill switch (``PETASTORM_TPU_DEVICE_DECODE`` on vs off)
over the same store through the same reader + loader stack, median-of-N
full passes. Each pass proves which path ran via the decode-path split
counters (``rows_decoded_device`` vs ``rows_decoded_batched``, plus
``bytes_shipped_raw`` and the derived ``device_decode_fraction``), the
two modes are compared bit for bit over the whole epoch, and the
device-on line is judged against the calibrated probe ceilings: the fused
decode ceiling (``device_decode``) and the raw-bytes staging ceiling
(``ingest``). The loader and the probes run on ``device`` (the CUDA
device unless ``device='cpu'``).

Usage (output is always JSON)::

    python -m petastorm_tpu_torch.benchmark.device_decode [--quick] \
        [--no-check] [--prefetch-depth N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
import time
from typing import Optional

from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR

#: Full-run ceiling on host codec CPU in the device-decode pass. Workers
#: ship zero-copy raw views, so per-sample host decode time should be
#: interconnect-noise small — an order of magnitude under what the host
#: batched path pays on this store (~5-10us/sample with framing).
MAX_DEVICE_PASS_HOST_DECODE_US = 4.0

#: Wholesale-collapse guard on the device-on line vs the host baseline
#: (full mode). On the CPU the "device" decode pays a torch dispatch per
#: batch with no accelerator to win it back, so the device line
#: legitimately trails the host line there; drift beyond this is a broken
#: path.
MIN_DEVICE_VS_HOST_FRACTION = 0.05


def _run_pass(url: str, device: bool, batch_size: int,
              prefetch_depth: Optional[int] = None, target=None) -> dict:
    """One full epoch through ``make_columnar_reader`` + ``TorchDataLoader``
    for ``target`` (a resolved device) with the kill switch pinned
    (``device``: on or off); returns samples/s, the decode-path split
    counters, per-sample host decode CPU, and the epoch's tokens."""
    import numpy as np

    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.torch_utils import TorchDataLoader

    saved = os.environ.get(DEVICE_DECODE_ENV_VAR)
    os.environ[DEVICE_DECODE_ENV_VAR] = 'on' if device else 'off'
    try:
        with make_columnar_reader(url, num_epochs=1,
                                  reader_pool_type='thread',
                                  workers_count=1,
                                  shuffle_row_groups=False) as reader:
            loader = TorchDataLoader(reader, batch_size=batch_size,
                                     prefetch_depth=prefetch_depth,
                                     device=target)
            chunks = []
            start = time.perf_counter()
            rows = 0
            for batch in loader:
                # the copy back to the host waits for the batch's decode
                tokens = batch['tokens'].cpu().numpy()
                rows += len(tokens)
                chunks.append(tokens)
            wall = time.perf_counter() - start
            snapshot = reader._stats_snapshot()
            diag = reader.diagnostics
    finally:
        if saved is None:
            os.environ.pop(DEVICE_DECODE_ENV_VAR, None)
        else:
            os.environ[DEVICE_DECODE_ENV_VAR] = saved
    epoch = np.concatenate(chunks) if chunks else np.empty((0,))
    decode_s = diag.get('worker_decode_s', 0.0) or 0.0
    return {
        'rows': rows,
        'wall_s': round(wall, 4),
        'samples_per_sec': round(rows / wall, 1) if wall else 0.0,
        'rows_decoded_device': snapshot.get('rows_decoded_device', 0),
        'rows_decoded_batched': snapshot.get('rows_decoded_batched', 0),
        'rows_decoded_percell': snapshot.get('rows_decoded_percell', 0),
        'bytes_shipped_raw': snapshot.get('bytes_shipped_raw', 0),
        'device_decode_fraction': snapshot.get('device_decode_fraction'),
        'host_decode_us_per_sample':
            round(1e6 * decode_s / rows, 3) if rows else None,
        '_epoch': epoch,
    }


def _median_line(runs: list) -> dict:
    """Collapse repeated passes into one artifact line: median samples/s,
    the per-run rates, and the last run's counters (identical across runs
    by construction — every pass decodes the full store one way)."""
    line = {k: v for k, v in runs[-1].items() if k != '_epoch'}
    line['samples_per_sec'] = statistics.median(
        r['samples_per_sec'] for r in runs)
    line['runs'] = [r['samples_per_sec'] for r in runs]
    return line


def _calibration(url: str, samples_per_sec: float, target=None) -> dict:
    """Probe ceilings for the store on ``target`` (device_decode and ingest
    included) and the roofline verdict for the measured device-on line
    against the ingest ceiling."""
    from petastorm_tpu_torch import make_columnar_reader
    with make_columnar_reader(url, num_epochs=1, reader_pool_type='thread',
                              workers_count=1,
                              shuffle_row_groups=False) as reader:
        profile = reader.profile(calibrate='auto',
                                 samples_per_sec=samples_per_sec,
                                 device=target)
        for _ in reader:   # consume so the context exit joins cleanly
            pass
    ceilings = profile['ceilings']
    ingest = ceilings.get('ingest')
    device = ceilings.get('device_decode')
    return {
        'binding_stage': profile['binding_stage'],
        'binding_ceiling_samples_per_s':
            profile['binding_ceiling_samples_per_s'],
        'roofline_fraction': profile['roofline_fraction'],
        'ceilings': ceilings,
        'cpu_count': profile['cpu_count'],
        'ingest_ceiling_samples_per_s': ingest,
        'device_decode_ceiling_samples_per_s': device,
        'pct_of_ingest_ceiling':
            round(100.0 * samples_per_sec / ingest, 2) if ingest else None,
        'pct_of_device_decode_ceiling':
            round(100.0 * samples_per_sec / device, 2) if device else None,
    }


def run_device_decode_bench(quick: bool = False, check: bool = True,
                            prefetch_depth: Optional[int] = None,
                            device=None) -> dict:
    """Kill-switch A/B over an ``NdarrayCodec`` token store + probe-ceiling
    verdict on the device-on line, on ``device`` (CUDA unless ``'cpu'``;
    without CUDA it raises). ``quick`` shrinks the store (plumbing
    assertions only); the full run carries the headline."""
    import numpy as np

    from petastorm_tpu_torch.benchmark.northstar import generate_token_dataset
    from petastorm_tpu_torch.device import resolve_device

    target = resolve_device(device)

    rows = 2048 if quick else 16384
    passes = 3 if quick else 5
    batch_size = 256
    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_device_decode_')
    tokens_url = 'file://' + os.path.join(tmpdir, 'tokens')
    # the bench must not depend on (or pollute) the user's calibration
    # cache: point the artifact dir into the bench scratch
    from petastorm_tpu_torch import profiler
    saved_env = os.environ.get(profiler.CALIBRATION_DIR_ENV_VAR)
    os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = os.path.join(tmpdir, 'cal')
    try:
        generate_token_dataset(tokens_url, rows=rows, seq_len=256,
                               ndarray_codec=True)

        # one discarded priming pass: cold page cache and first-use costs
        # (CUDA context, allocator) must not bill either mode
        _run_pass(tokens_url, True, batch_size, prefetch_depth, target)
        device_runs, host_runs = [], []
        for i in range(passes):
            # alternate the within-pair order: host drift is monotone over
            # seconds and must bill both modes equally
            if i % 2 == 0:
                device_runs.append(_run_pass(tokens_url, True, batch_size,
                                             prefetch_depth, target))
                host_runs.append(_run_pass(tokens_url, False, batch_size,
                                           prefetch_depth, target))
            else:
                host_runs.append(_run_pass(tokens_url, False, batch_size,
                                           prefetch_depth, target))
                device_runs.append(_run_pass(tokens_url, True, batch_size,
                                             prefetch_depth, target))

        identical = bool(np.array_equal(device_runs[-1]['_epoch'],
                                        host_runs[-1]['_epoch']))
        lines = {'tokens_device': _median_line(device_runs),
                 'tokens_host': _median_line(host_runs)}
        headline = lines['tokens_device']
        roofline = _calibration(tokens_url, headline['samples_per_sec'],
                                target)

        result = {
            'quick': quick,
            'benchmark': 'device_decode_tokens',
            'rows': rows,
            'cpu_count': roofline['cpu_count'],
            # JAX's key: the device the decode ran on
            'jax_backend': _backend_name(target),
            'protocol': {'passes_per_mode': passes, 'pool': 'thread',
                         'workers': 1, 'batch_size': batch_size,
                         'prefetch_depth': prefetch_depth,
                         'kill_switch': DEVICE_DECODE_ENV_VAR},
            'lines': lines,
            'headline_line': 'tokens_device',
            'identical': identical,
            'roofline': roofline,
        }
        if check:
            _check(result, quick)
        return result
    finally:
        if saved_env is None:
            os.environ.pop(profiler.CALIBRATION_DIR_ENV_VAR, None)
        else:
            os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = saved_env
        shutil.rmtree(tmpdir, ignore_errors=True)


def _backend_name(device) -> str:
    """The CUDA device's name, or ``'cpu'``."""
    from petastorm_tpu_torch.profiler import device_name
    return device_name(device)


def _check(result: dict, quick: bool) -> None:
    device = result['lines']['tokens_device']
    host = result['lines']['tokens_host']
    rows = result['rows']
    assert result['identical'], (
        'device decode must be bit-identical to the host batched path '
        'over the whole epoch')
    assert device['rows_decoded_device'] >= rows, (
        'the device pass must decode every token cell on the device, got '
        '{}/{}'.format(device['rows_decoded_device'], rows))
    assert device['rows_decoded_batched'] == 0, (
        'a clean device pass must not decode on the host ({} rows did)'
        .format(device['rows_decoded_batched']))
    assert device['bytes_shipped_raw'] > 0, (
        'the device pass must ship raw column payload (bytes_shipped_raw)')
    assert device['device_decode_fraction'] == 1.0, (
        'device_decode_fraction must be 1.0 on the device pass, got {!r}'
        .format(device['device_decode_fraction']))
    assert host['rows_decoded_device'] == 0, (
        '{}=off must force the host batched path'.format(
            DEVICE_DECODE_ENV_VAR))
    assert host['rows_decoded_batched'] >= rows, (
        'the host A/B leg must batch-decode every cell, got {}/{}'.format(
            host['rows_decoded_batched'], rows))
    assert host['bytes_shipped_raw'] == 0, (
        'the host leg must not ship raw payload')
    # sub-second quick passes on a loaded host are noise-dominated; the
    # quick gate only proves the plumbing, the full run holds the bars
    if quick:
        return
    us = device['host_decode_us_per_sample']
    assert us is not None and us <= MAX_DEVICE_PASS_HOST_DECODE_US, (
        'host decode CPU must be near zero under bytes-through: measured '
        '{}us/sample (ceiling {})'.format(us, MAX_DEVICE_PASS_HOST_DECODE_US))
    roofline = result['roofline']
    ingest = roofline['ingest_ceiling_samples_per_s']
    assert ingest and roofline['pct_of_ingest_ceiling'], (
        'the ingest ceiling must be probed and the line judged against it')
    assert ingest >= device['samples_per_sec'], (
        'the measured line cannot exceed the raw-bytes staging ceiling: '
        '{} vs {} samples/s (probe is broken)'.format(
            device['samples_per_sec'], ingest))
    assert roofline['device_decode_ceiling_samples_per_s'], (
        'the device-decode ceiling must be probed')
    assert device['samples_per_sec'] >= \
        MIN_DEVICE_VS_HOST_FRACTION * host['samples_per_sec'], (
            'device decode collapsed vs the host baseline: {} vs {} '
            'samples/s'.format(device['samples_per_sec'],
                               host['samples_per_sec']))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Bytes-through device decode vs host batched decode on '
                    'an NdarrayCodec token store, probe-ceiling-judged')
    parser.add_argument('--quick', action='store_true',
                        help='small store, fewer passes')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the assertions')
    parser.add_argument('--prefetch-depth', type=int, default=None,
                        help='device-staging prefetch depth (default: '
                             'PETASTORM_TPU_PREFETCH_DEPTH or 2)')
    parser.add_argument('--device', default='cuda',
                        help="where the loader decodes: 'cuda' (the "
                             "default; raises without CUDA) or 'cpu'")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(
        args.device, 'python -m petastorm_tpu_torch.benchmark.device_decode')
    result = run_device_decode_bench(quick=args.quick,
                                     check=not args.no_check,
                                     prefetch_depth=args.prefetch_depth,
                                     device=device)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
