"""Readahead benchmark (JAX ``benchmark/readahead.py``): serial against
prefetched row-group reads on a synthetic slow-IO filesystem shim.

The readahead layer's claim is that storage I/O and decode CPU overlap
instead of serializing. Local disks are too fast to show that, so this
bench wraps the local filesystem in :class:`SlowFilesystem` (every
``read()`` call sleeps a fixed latency, modelling a remote object store)
and pins the io:decode ratio near 1:1 by construction:

1. **Calibration pass** (no delay): counts the shim's ``read()`` calls per
   row group, so a per-read delay can be derived that costs each row group
   a known synthetic I/O time.
2. The decode side gets the same budget through a ``TransformSpec`` that
   decompresses a zlib blob (transform time is decode-stage time), on top
   of the codec decode.
3. **Serial pass** (``io_readahead=0``, 1 worker): reads and decode
   serialize, so a group costs about io + decode.
4. **Readahead pass** (``io_readahead=2``, 1 worker): the background reader
   hides the next group's read behind the current decode, so a group
   costs about max(io, decode): about 2x at io = decode.

A single worker isolates the overlap: with many workers, one worker's
read overlaps another's decode, which is parallelism, not pipelining. The
full run asserts **>= 1.5x items/s** over serial and an **overlap fraction
> 0.5**; ``quick`` shrinks the store and asserts looser bars.

Usage::

    python -m petastorm_tpu_torch.benchmark.readahead [--quick] [--no-check]
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np

from petastorm_tpu_torch.faultfs import FaultInjector, FaultyFilesystem
from petastorm_tpu_torch.workers.stats import readahead_hit_rate

_MB = 1024.0 * 1024.0


class SlowFilesystem(FaultyFilesystem):
    """Filesystem wrapper whose opened files sleep ``seconds_per_read`` on
    every ``read()`` call (and ``seconds_per_mb`` a MB read): the
    ``fixed-latency`` scenario of the chaos injector
    (:mod:`petastorm_tpu_torch.faultfs`). Thread-safe: the worker thread
    and the readahead thread sleep independently, like two in-flight remote
    range requests."""

    def __init__(self, inner, seconds_per_read: float = 0.0,
                 seconds_per_mb: float = 0.0):
        super().__init__(inner, FaultInjector(
            'fixed-latency', seconds_per_read=seconds_per_read,
            seconds_per_mb=seconds_per_mb))
        self.seconds_per_read = seconds_per_read
        self.seconds_per_mb = seconds_per_mb


def columnar_reader(dataset_path: str, filesystem, workers: int = 1,
                    num_epochs=1, transform_spec=None, io_readahead=0,
                    retry=None, hedge=None, autotune=False):
    """A columnar reader of ``dataset_path`` over ``filesystem`` (any
    wrapped instance: a thread pool's workers share it) on ``workers``
    threads, no shuffle, no cache: what JAX's benches build with ``Reader``
    and a filesystem factory. ``retry``, ``hedge`` and ``autotune`` as the
    factories take them."""
    from petastorm_tpu_torch.autotune import resolve_autotune
    from petastorm_tpu_torch.reader import Reader
    from petastorm_tpu_torch.resilience import resolve_hedge, resolve_retry
    from petastorm_tpu_torch.workers.thread_pool import ThreadPool

    return Reader(dataset_path, None, mode='columnar',
                  pool=ThreadPool(workers, 50), num_epochs=num_epochs,
                  shuffle_row_groups=False, seed=None,
                  transform_spec=transform_spec, io_readahead=io_readahead,
                  autotune_options=resolve_autotune(autotune),
                  retry=resolve_retry(retry), hedge=resolve_hedge(hedge),
                  filesystem_factory=lambda: filesystem)


def _decode_work_transform(seconds_per_group: float):
    """A columnar TransformSpec whose func burns ~``seconds_per_group`` of
    real decompression CPU per row group, a stand-in for codec or
    augmentation work of a known cost. It uses ``zlib.decompress`` (not a
    Python busy spin) because real decode paths release the GIL; a
    GIL-holding spin would starve the background reader thread and
    understate the overlap any real pipeline gets."""
    import zlib

    from petastorm_tpu_torch.transform import TransformSpec

    blob = zlib.compress(
        np.random.default_rng(0).integers(0, 255, 1 << 20,
                                          dtype=np.uint8).tobytes(), 1)
    start = time.perf_counter()
    calib_rounds = 5
    for _ in range(calib_rounds):
        zlib.decompress(blob)
    per_call = max(1e-5, (time.perf_counter() - start) / calib_rounds)
    repeats = max(1, round(seconds_per_group / per_call))

    def decode_work(columns):
        for _ in range(repeats):
            zlib.decompress(blob)
        return columns

    return TransformSpec(func=decode_work)


def generate_readahead_dataset(url: str, rows: int, rows_per_group: int = 8):
    """Small petastorm store with one compressed-ndarray payload column."""
    from petastorm_tpu_torch.codecs import CompressedNdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('ReadaheadBench', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('payload', np.uint8, (32, 32, 3),
                       CompressedNdarrayCodec(), False),
    ])
    # incompressible payload: row-group byte size tracks row count, so the
    # row_group_size_mb knob maps to rows_per_group deterministically
    payload_bytes = 32 * 32 * 3
    row_group_size_mb = rows_per_group * payload_bytes / _MB
    row_dicts = []
    for i in range(rows):
        rng = np.random.default_rng(i)
        row_dicts.append({
            'id': np.int64(i),
            'payload': rng.integers(0, 255, (32, 32, 3), dtype=np.uint8),
        })
    with materialize_dataset(url, schema, row_group_size_mb=row_group_size_mb,
                             rows_per_file=max(rows_per_group * 4, rows // 2)
                             ) as writer:
        writer.write_rows(row_dicts)
    return schema


def _run_pass(dataset_path: str, slow_fs: SlowFilesystem, io_readahead,
              num_epochs: int, transform_spec) -> dict:
    """One measured read pass: 1 thread worker, no shuffle, columnar path."""
    reader = columnar_reader(dataset_path, slow_fs, num_epochs=num_epochs,
                             transform_spec=transform_spec,
                             io_readahead=io_readahead)
    reads_before = slow_fs.read_calls
    groups = 0
    rows = 0
    start = time.perf_counter()
    try:
        for batch in reader:
            groups += 1
            rows += len(batch.id)
    finally:
        wall = time.perf_counter() - start
        diag = reader.diagnostics
        reader.stop()
        reader.join()
    return {
        'wall_s': round(wall, 4),
        'row_groups': groups,
        'rows': rows,
        'items_per_s': round(groups / wall, 2) if wall else 0.0,
        'rows_per_s': round(rows / wall, 1) if wall else 0.0,
        'read_calls': slow_fs.read_calls - reads_before,
        'worker_io_s': round(diag['worker_io_s'], 4),
        'worker_decode_s': round(diag['worker_decode_s'], 4),
        'readahead_io_s': round(diag['readahead_io_s'], 4),
        'readahead_wait_s': round(diag['readahead_wait_s'], 4),
        'readahead_hits': diag['readahead_hits'],
        'readahead_misses': diag['readahead_misses'],
        'io_overlap_fraction': round(diag['io_overlap_fraction'], 4),
    }


def run_readahead_bench(quick: bool = False, check: bool = True,
                        dataset_path: str = None) -> dict:
    """Serial vs readahead comparison on the slow-IO shim; returns one
    JSON-able dict. ``quick`` shrinks the store/epochs (looser assertion
    bars); ``check=False`` reports without asserting."""
    from petastorm_tpu_torch.fs import LOCAL_FILESYSTEM

    rows = 64 if quick else 192
    rows_per_group = 8
    num_epochs = 2 if quick else 3
    stage_budget_s = 0.008 if quick else 0.02   # io AND decode per row group

    tmpdir = None
    if dataset_path is None:
        tmpdir = tempfile.mkdtemp(prefix='petastorm_tpu_torch_readahead_')
        dataset_path = tmpdir
    try:
        generate_readahead_dataset('file://' + dataset_path, rows=rows,
                                   rows_per_group=rows_per_group)
        base_fs = LOCAL_FILESYSTEM
        transform = _decode_work_transform(stage_budget_s)

        # 1. calibration: how many shim read() calls does one row group cost?
        cal_fs = SlowFilesystem(base_fs)
        calibration = _run_pass(dataset_path, cal_fs, 0, 1, transform)
        groups_per_epoch = calibration['row_groups']
        reads_per_group = max(1.0,
                              calibration['read_calls'] / groups_per_epoch)
        delay_per_read = stage_budget_s / reads_per_group

        # 2+3. serial (blocking read then decode, io:decode pinned ~1:1) vs
        # readahead (background reads overlap the decompression decode).
        # Quick passes are sub-second: take the best of two attempts so
        # transient host load cannot flip the gate.
        min_speedup = _min_speedup(quick)
        serial = readahead = None
        speedup = 0.0
        for _attempt in range(2 if quick else 1):
            serial_fs = SlowFilesystem(base_fs,
                                       seconds_per_read=delay_per_read)
            serial = _run_pass(dataset_path, serial_fs, 0, num_epochs,
                               transform)
            ra_fs = SlowFilesystem(base_fs, seconds_per_read=delay_per_read)
            readahead = _run_pass(dataset_path, ra_fs, 2, num_epochs,
                                  transform)
            speedup = (readahead['items_per_s'] / serial['items_per_s']
                       if serial['items_per_s'] else 0.0)
            if speedup >= min_speedup:
                break

        result = {
            'quick': quick,
            'rows': rows,
            'row_groups_per_epoch': groups_per_epoch,
            'epochs': num_epochs,
            'calibration': {
                'stage_budget_ms_per_group': stage_budget_s * 1000.0,
                'reads_per_group': round(reads_per_group, 1),
                'delay_per_read_ms': round(delay_per_read * 1000.0, 3),
                'natural_decode_s_per_epoch': calibration['worker_decode_s'],
            },
            'serial': serial,
            'readahead': readahead,
            'speedup_items_per_s': round(speedup, 2),
            'readahead_hit_rate': round(readahead_hit_rate(readahead), 3),
        }
        if not quick:
            # the stats-driven sizing story: same store, depth picked live
            auto_fs = SlowFilesystem(base_fs, seconds_per_read=delay_per_read)
            result['readahead_auto'] = _run_pass(dataset_path, auto_fs,
                                                 'auto', num_epochs, transform)
        if check:
            from petastorm_tpu_torch.benchmark import assert_bars
            assert_bars(_bars(result))
            _check_exact(result)
        return result
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


def _min_speedup(quick: bool) -> float:
    return 1.15 if quick else 1.5


def _bars(result: dict) -> list:
    """The timing bars: readahead's items/s over serial on the slow-IO
    shim with io:decode ~1:1, and the share of its read time hidden
    behind decode."""
    quick = result['quick']
    return [('readahead / serial items/s', result['speedup_items_per_s'],
             '>=', _min_speedup(quick)),
            ('io overlap fraction', result['readahead']['io_overlap_fraction'],
             '>', 0.25 if quick else 0.5)]


def _check_exact(result: dict) -> None:
    assert result['readahead']['readahead_hits'] > 0, \
        'no prefetched reads hit'


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='serial vs readahead row-group read benchmark')
    parser.add_argument('--quick', action='store_true',
                        help='small store/epochs')
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the speedup/overlap assertions')
    args = parser.parse_args(argv)
    result = run_readahead_bench(quick=args.quick, check=not args.no_check)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
