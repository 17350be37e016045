"""Batched-decode benchmark (JAX ``benchmark/decode_batch.py``): the mnist
decode line with row-group-vectorized codec decode against the per-cell
loop, judged against the calibrated ceilings.

It measures what the batched boundary
(``DataframeColumnCodec.make_column_decoder``) recovers over per-row
Python work, at two levels:

1. **Column decode** (the codec boundary in isolation): one row group's
   codec column pushed through
   :func:`~petastorm_tpu_torch.readers.columnar_worker.decode_column` with
   the vectorized path on and off, min-of-reps. ``NdarrayCodec`` decodes
   the whole chunk with one header compare and one contiguous copy;
   ``CompressedImageCodec`` keeps per-cell work to the image
   decompression itself.
2. **End-to-end** (the columnar read path): alternating batched/per-cell
   full passes (``PETASTORM_TPU_BATCHED_DECODE``), median-of-N, at 1 and
   2 workers. The 1-worker line is the headline, judged against the
   calibrated **single-stream** decode ceiling. The 2-worker line is
   context: thread workers hand the GIL back and forth around short
   ``cv2.imdecode`` calls, so 2 decode threads can be slower than one.

Each measured pass proves the split it claims to measure: batched passes
decode every codec cell through the vectorized path
(``rows_decoded_batched``), per-cell passes none, and one row group is
decoded both ways and compared bit for bit. The roofline verdicts
calibrate through :mod:`petastorm_tpu_torch.profiler`, whose staging probe
stages to ``device`` (the CUDA device unless ``device='cpu'``; without
CUDA it raises).

Usage (output is always JSON)::

    python -m petastorm_tpu_torch.benchmark.decode_batch [--quick] \
        [--no-check] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
import time

from petastorm_tpu_torch.codecs import BATCHED_DECODE_ENV_VAR

#: Bar for the headline line's %-of-ceiling (full mode); the quick run
#: only asserts the plumbing (split counters, bit-identity).
MIN_HEADLINE_ROOFLINE_PCT = 25.0

#: Column-decode speedup floor for the pure-vectorization codec
#: (``NdarrayCodec``: one memcpy per chunk against N Python calls); far
#: from host noise, yet it catches a rewrite that loses the vectorized
#: path.
MIN_NDARRAY_COLUMN_SPEEDUP = 5.0


def _column_decode_rates(url: str, field_name: str, reps: int) -> dict:
    """Min-of-reps decode rate of one row group's codec column through
    ``decode_column``, vectorized against per-cell, plus a bit-identity
    verdict over that row group."""
    import numpy as np
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl.dataset_metadata import (
        infer_or_load_unischema, load_row_groups)
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.readers.columnar_worker import decode_column

    fs, path, _ = get_filesystem_and_path_or_paths(url)
    pieces = load_row_groups(path, filesystem=fs)
    schema, _ = infer_or_load_unischema(path, fs)
    field = schema.fields[field_name]
    piece = pieces[len(pieces) // 2]
    with fs.open(piece.path, 'rb') as handle:
        table = pq.ParquetFile(handle).read_row_group(piece.row_group)
    column = table.column(field_name).combine_chunks()
    n = table.num_rows

    def timed(batched: bool):
        counts = {'batched': 0, 'percell': 0}
        out = decode_column(field, column, counts=counts,
                            batched=batched)                  # warm
        best = None
        for _ in range(reps):
            counts = {'batched': 0, 'percell': 0}
            start = time.perf_counter()
            out = decode_column(field, column, counts=counts,
                                batched=batched)
            took = time.perf_counter() - start
            best = took if best is None else min(best, took)
        return out, best, counts

    batched_out, batched_s, batched_counts = timed(True)
    percell_out, percell_s, _ = timed(False)
    identical = (batched_out.dtype == percell_out.dtype
                 and batched_out.shape == percell_out.shape
                 and bool(np.array_equal(batched_out, percell_out)))
    return {
        'rows': n,
        'codec': type(field.codec).__name__,
        'batched_rows_per_s': round(n / batched_s, 1) if batched_s else None,
        'percell_rows_per_s': round(n / percell_s, 1) if percell_s else None,
        'speedup_x': round(percell_s / batched_s, 2) if batched_s else None,
        'batched_cells': batched_counts['batched'],
        'identical': identical,
    }


def _run_pass(url: str, batched: bool, workers: int) -> dict:
    """One full columnar-reader consumption pass; returns samples/s plus the
    decode-path split counters proving which path ran."""
    from petastorm_tpu_torch import make_columnar_reader

    saved = os.environ.get(BATCHED_DECODE_ENV_VAR)
    os.environ[BATCHED_DECODE_ENV_VAR] = '1' if batched else '0'
    try:
        with make_columnar_reader(url, num_epochs=1,
                                  reader_pool_type='thread',
                                  workers_count=workers,
                                  shuffle_row_groups=False) as reader:
            start = time.perf_counter()
            rows = 0
            groups = 0
            for batch in reader:
                rows += len(batch.idx)
                groups += 1
            wall = time.perf_counter() - start
            snapshot = reader.diagnostics
    finally:
        if saved is None:
            os.environ.pop(BATCHED_DECODE_ENV_VAR, None)
        else:
            os.environ[BATCHED_DECODE_ENV_VAR] = saved
    return {
        'rows': rows,
        'row_groups': groups,
        'wall_s': round(wall, 4),
        'samples_per_sec': round(rows / wall, 1) if wall else 0.0,
        'rows_decoded_batched': snapshot.get('rows_decoded_batched', 0),
        'rows_decoded_percell': snapshot.get('rows_decoded_percell', 0),
    }


def _profile_line(url: str, workers: int, samples_per_sec: float,
                  target) -> dict:
    """The roofline verdict for one measured line: its samples/s against the
    calibrated decode ceiling effective at this worker count (probing on
    the first call, cached per host, dataset digest and device after)."""
    from petastorm_tpu_torch import make_columnar_reader
    with make_columnar_reader(url, num_epochs=1, reader_pool_type='thread',
                              workers_count=workers,
                              shuffle_row_groups=False) as reader:
        profile = reader.profile(calibrate='auto',
                                 samples_per_sec=samples_per_sec,
                                 device=target)
        # consume the epoch so the context exit joins a finished reader
        for _ in reader:
            pass
    return {
        'binding_stage': profile['binding_stage'],
        'binding_ceiling_samples_per_s':
            profile['binding_ceiling_samples_per_s'],
        'roofline_fraction': profile['roofline_fraction'],
        'roofline_pct': round(
            100.0 * (profile['roofline_fraction'] or 0.0), 2),
        'ceilings': profile['ceilings'],
        'cpu_count': profile['cpu_count'],
    }


def run_decode_batch_bench(quick: bool = False, check: bool = True,
                           device=None) -> dict:
    """Column-decode A/B, alternating end-to-end passes and the roofline
    verdict on the mnist decode line; calibration stages to ``device``
    (CUDA unless ``'cpu'``; without CUDA it raises). ``quick`` shrinks the
    store (plumbing assertions only); the full run carries the headline."""
    from petastorm_tpu_torch import profiler
    from petastorm_tpu_torch.benchmark.northstar import (
        generate_mnist_images_dataset, generate_token_dataset)
    from petastorm_tpu_torch.device import resolve_device

    target = resolve_device(device)
    rows = 2048 if quick else 16384
    token_rows = 512 if quick else 2048
    passes = 3 if quick else 5
    reps = 5 if quick else 9
    tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_decode_batch_')
    mnist_url = 'file://' + os.path.join(tmpdir, 'mnist')
    tokens_url = 'file://' + os.path.join(tmpdir, 'tokens')
    # the bench must not depend on (or pollute) the user's calibration
    # cache: point the artifact dir into the bench scratch
    saved_env = os.environ.get(profiler.CALIBRATION_DIR_ENV_VAR)
    os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = os.path.join(tmpdir, 'cal')
    try:
        generate_mnist_images_dataset(mnist_url, rows=rows)
        generate_token_dataset(tokens_url, rows=token_rows, seq_len=256,
                               ndarray_codec=True)

        column_decode = {
            'png_images': _column_decode_rates(mnist_url, 'image', reps),
            'ndarray_tokens': _column_decode_rates(tokens_url, 'tokens',
                                                   reps),
        }

        # one discarded priming pass per worker count: cold page cache and
        # pool spin-up must not bill either mode
        lines = {}
        for workers in (1, 2):
            _run_pass(mnist_url, True, workers)
            batched_runs, percell_runs = [], []
            for i in range(passes):
                # alternate the within-pair order: host drift is monotone
                # over seconds and must bill both modes equally
                if i % 2 == 0:
                    batched_runs.append(_run_pass(mnist_url, True, workers))
                    percell_runs.append(_run_pass(mnist_url, False, workers))
                else:
                    percell_runs.append(_run_pass(mnist_url, False, workers))
                    batched_runs.append(_run_pass(mnist_url, True, workers))
            for mode, runs in (('batched', batched_runs),
                               ('percell', percell_runs)):
                med = statistics.median(r['samples_per_sec'] for r in runs)
                lines['mnist_w{}_{}'.format(workers, mode)] = {
                    'workers': workers,
                    'samples_per_sec': med,
                    'runs': [r['samples_per_sec'] for r in runs],
                    'rows_decoded_batched': runs[-1]['rows_decoded_batched'],
                    'rows_decoded_percell': runs[-1]['rows_decoded_percell'],
                }

        # roofline verdicts for the batched lines (same calibration artifact
        # both times; the 1-worker line is the headline)
        for workers in (1, 2):
            key = 'mnist_w{}_batched'.format(workers)
            lines[key]['roofline'] = _profile_line(
                mnist_url, workers, lines[key]['samples_per_sec'], target)
            lines[key]['roofline_pct'] = \
                lines[key]['roofline']['roofline_pct']

        headline = lines['mnist_w1_batched']
        result = {
            'quick': quick,
            'benchmark': 'decode_batch_mnist',
            'rows': rows,
            'cpu_count': headline['roofline']['cpu_count'],
            'protocol': {'passes_per_mode': passes, 'pool': 'thread',
                         'token_rows': token_rows,
                         'column_decode_reps': reps},
            'column_decode': column_decode,
            'lines': lines,
            'headline_line': 'mnist_w1_batched',
            'roofline': {
                'binding_stage': headline['roofline']['binding_stage'],
                'binding_ceiling_samples_per_s':
                    headline['roofline']['binding_ceiling_samples_per_s'],
                'roofline_fraction':
                    headline['roofline']['roofline_fraction'],
                'roofline_pct': headline['roofline_pct'],
            },
        }
        if check:
            _check(result)
        return result
    finally:
        if saved_env is None:
            os.environ.pop(profiler.CALIBRATION_DIR_ENV_VAR, None)
        else:
            os.environ[profiler.CALIBRATION_DIR_ENV_VAR] = saved_env
        shutil.rmtree(tmpdir, ignore_errors=True)


def _check_exact(result: dict) -> None:
    """The conditions that hold whatever the host's speed: each column's
    decode bit-identical both ways with every cell through the vectorized
    path, every image cell of a batched pass decoded batched and none of a
    per-cell pass."""
    for name, entry in result['column_decode'].items():
        assert entry['identical'], (
            '{}: batched decode must be bit-identical to per-cell'
            .format(name))
        assert entry['batched_cells'] == entry['rows'], (
            '{}: the vectorized path must have decoded every cell of the '
            'batched A/B leg, got {}/{}'.format(name, entry['batched_cells'],
                                                entry['rows']))
    for key, line in result['lines'].items():
        if key.endswith('_batched'):
            assert line['rows_decoded_percell'] == 0, (
                '{}: a clean batched pass must not fall back per-cell '
                '({} cells did)'.format(key, line['rows_decoded_percell']))
            assert line['rows_decoded_batched'] >= result['rows'], (
                '{}: the batched pass must decode every image cell '
                'vectorized, got {}'.format(key,
                                            line['rows_decoded_batched']))
        else:
            assert line['rows_decoded_batched'] == 0, (
                '{}: {}=0 must force the per-cell loop'.format(
                    key, BATCHED_DECODE_ENV_VAR))


def _bars(result: dict) -> list:
    """The timing bars: the ``NdarrayCodec`` column must vectorize (one
    memcpy per chunk); batched decode must not regress either end-to-end
    line beyond noise (sub-second quick passes on a loaded host are
    noise-dominated, so quick only catches a wholesale regression); the
    headline line's share of its calibrated decode ceiling."""
    quick = result['quick']
    lines = result['lines']
    bars = [('ndarray column speedup x',
             result['column_decode']['ndarray_tokens']['speedup_x'], '>=',
             MIN_NDARRAY_COLUMN_SPEEDUP)]
    for workers in (1, 2):
        percell = lines['mnist_w{}_percell'.format(workers)]['samples_per_sec']
        bars.append(('{}-worker batched / per-cell'.format(workers),
                     lines['mnist_w{}_batched'.format(workers)][
                         'samples_per_sec'] / percell if percell else None,
                     '>=', 0.5 if quick else 0.75))
    bars.append(('headline roofline %', result['roofline']['roofline_pct'],
                 '>' if quick else '>=',
                 0.0 if quick else MIN_HEADLINE_ROOFLINE_PCT))
    return bars


def _check(result: dict) -> None:
    from petastorm_tpu_torch.benchmark import assert_bars
    _check_exact(result)
    assert result['roofline']['binding_stage'] == 'decode', (
        'the mnist line must stay decode-bound, got {!r}'.format(
            result['roofline']['binding_stage']))
    assert_bars(_bars(result))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Batched vs per-cell codec decode on the mnist line, '
                    'roofline-judged')
    parser.add_argument('--quick', action='store_true',
                        help='small store, plumbing assertions only')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the assertions')
    parser.add_argument('--device', default='cuda',
                        help="where calibration stages: 'cuda' (the "
                             "default; raises without CUDA) or 'cpu'")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(
        args.device, 'python -m petastorm_tpu_torch.benchmark.decode_batch')
    result = run_decode_batch_bench(quick=args.quick, check=not args.no_check,
                                    device=device)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
