"""Tracing overhead benchmark (JAX ``benchmark/trace_overhead.py``):
items/s with the span tracer on vs off.

The tracer's contract is "low-overhead, off-by-default": per-item spans must
be cheap enough to leave enabled on a production pipeline while diagnosing
it. This bench quantifies that on the row reader path (the chattiest
consumer: one published item per row group, spans for ventilate / parquet
read / decode / process / queue wait per item):

1. **Baseline passes** — ``make_reader`` over a small codec store,
   ``trace=False`` (forced off, immune to ``PETASTORM_TPU_TRACE``), full
   consumption, items/s recorded.
2. **Traced passes** — identical reader with ``trace=True``; every stage
   records spans and the consumer-side tracer buffers them.
3. Modes alternate (off, on, off, on, ...) so drift in host load hits both
   equally; the headline is the **median** of each mode and

   ``overhead_pct = 100 * (baseline_median - traced_median) / baseline_median``.

The traced run also exports a chrome trace to a temp file and validates it
(JSON loads, complete events carry ph/ts/dur/pid/tid) so the artifact
records that the exported timeline is well-formed, not just cheap.

The full run asserts **overhead < 5%**; ``--quick`` shrinks the store and
asserts a looser bar (sub-second passes are noise-dominated; the quick
gate exists to catch a rewrite that makes tracing accidentally hot, not to
re-prove the 5% claim). Nothing here touches a device.

Usage (output is always JSON)::

    python -m petastorm_tpu_torch.benchmark.trace_overhead [--quick] \
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


def _run_pass(url: str, trace, epochs: int, workers: int) -> dict:
    """One full consumption pass on the row reader; returns items/s (rows)
    and, when traced, the span count + export validity."""
    from petastorm_tpu_torch.reader import make_reader

    with make_reader(url, reader_pool_type='thread', workers_count=workers,
                     shuffle_row_groups=False, num_epochs=epochs,
                     trace=trace) as reader:
        start = time.perf_counter()
        rows = sum(1 for _ in reader)
        wall = time.perf_counter() - start
        out = {
            'rows': rows,
            'wall_s': round(wall, 4),
            'items_per_s': round(rows / wall, 1) if wall else 0.0,
        }
        if reader.tracer is not None:
            out['spans'] = len(reader.tracer)
            out['export'] = _validate_export(reader.tracer)
    return out


def _validate_export(tracer) -> dict:
    """Export the chrome trace to a temp file and check the schema the
    Perfetto loader depends on."""
    fd, path = tempfile.mkstemp(suffix='.json',
                                prefix='petastorm_tpu_torch_trace_')
    os.close(fd)
    try:
        written = tracer.export_chrome_trace(path)
        with open(path) as f:
            blob = json.load(f)
        events = blob['traceEvents']
        span_events = [e for e in events if e.get('ph') == 'X']
        required = all(
            isinstance(e.get('name'), str) and 'ts' in e and 'dur' in e
            and 'pid' in e and 'tid' in e for e in span_events)
        timestamps = [e['ts'] for e in span_events]
        return {
            'valid': bool(required and written == len(span_events)
                          and timestamps == sorted(timestamps)),
            'span_events': len(span_events),
        }
    finally:
        os.unlink(path)


def run_trace_overhead_bench(quick: bool = False, check: bool = True,
                             dataset_path: str = None) -> dict:
    """Alternating traced/untraced passes; returns one JSON-able dict.
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
        tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_trace_bench_')
        dataset_path = tmpdir
    url = 'file://' + dataset_path
    try:
        generate_readahead_dataset(url, rows=rows,
                                   rows_per_group=rows_per_group)
        # one discarded priming pass: first touch streams from cold page
        # cache and compiles codec paths — neither mode should pay it.
        # Baseline passes force trace=False (not None): None defers to
        # PETASTORM_TPU_TRACE, and an inherited env var would silently turn
        # the "off" arm into traced-vs-traced.
        _run_pass(url, False, 1, workers)

        # Quick passes are sub-second: take the best of two attempts so
        # transient host load cannot flip the gate (the readahead quick
        # bench uses the same discipline).
        baseline = traced = None
        overhead_pct = 0.0
        for _attempt in range(2 if quick else 1):
            baseline, traced = [], []
            for i in range(passes):
                # alternate the within-pair order: host drift (thermal,
                # page-cache, background load) is monotone over seconds, so a
                # fixed off-then-on order would bill the drift to tracing
                if i % 2 == 0:
                    baseline.append(_run_pass(url, False, epochs, workers))
                    traced.append(_run_pass(url, True, epochs, workers))
                else:
                    traced.append(_run_pass(url, True, epochs, workers))
                    baseline.append(_run_pass(url, False, epochs, workers))
            base_med = statistics.median(r['items_per_s'] for r in baseline)
            traced_med = statistics.median(r['items_per_s'] for r in traced)
            overhead_pct = (100.0 * (base_med - traced_med) / base_med
                            if base_med else 0.0)
            if overhead_pct < max_overhead_pct:
                break

        last_traced = traced[-1]
        result = {
            'quick': quick,
            'rows': rows,
            'epochs': epochs,
            'workers': workers,
            'passes_per_mode': passes,
            'baseline_items_per_s': base_med,
            'traced_items_per_s': traced_med,
            'overhead_pct': round(overhead_pct, 2),
            'spans_recorded': last_traced['spans'],
            'export_valid': last_traced['export']['valid'],
            'export_span_events': last_traced['export']['span_events'],
            'baseline_runs': [r['items_per_s'] for r in baseline],
            'traced_runs': [r['items_per_s'] for r in traced],
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
    """The plane ran: spans recorded and a valid Chrome trace export."""
    assert result['export_valid'], (
        'chrome trace export failed schema validation')
    assert result['spans_recorded'] > 0, 'traced run recorded no spans'


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='span-tracer overhead benchmark (items/s on vs off)')
    parser.add_argument('--quick', action='store_true',
                        help='small store/fewer passes')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the overhead assertion')
    args = parser.parse_args(argv)
    result = run_trace_overhead_bench(quick=args.quick,
                                      check=not args.no_check)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
