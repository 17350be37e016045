"""Transport microbenchmark (JAX ``benchmark/transport.py``): pickle-blob
against zero-copy worker-to-loader payloads.

Two measurements on decoded-image payloads (a dict of column arrays, the
columnar worker's publish unit):

1. **In-process serializer round trip**: ``serialize_multipart`` and
   ``deserialize_multipart`` back to back, the pure transport cost (MB/s
   and full-payload memcpys) without pool or process overhead.
2. **3-worker ProcessPool stream**: the same payloads shipped through a
   real ZMQ process pool, the copies on both sides of the boundary counted
   by the pool's ``payload_copies`` (the worker's ride back in each item's
   accounting frame, the consumer's are added where it deserializes).

The zero-copy path must move the stream with **strictly fewer payload
copies** than pickle, and (for payloads of 1 MB or more) at 1.5x the
in-process MB/s or better; :func:`run_transport_bench` asserts both unless
``check=False``. The workers run :func:`stream_image_payload`, a
module-level function that the pool's ``python -S`` worker interpreters
import.

Usage::

    python -m petastorm_tpu_torch.benchmark.transport [--quick] \
        [--payload-mb N] [--no-check]
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np

from petastorm_tpu_torch.workers.serializers import (PickleSerializer,
                                                     ZeroCopySerializer)

_MB = 1024.0 * 1024.0


def make_image_payload(rows: int, height: int, width: int) -> dict:
    """A decoded-image column batch: ``(rows, h, w, 3)`` uint8 plus labels,
    with deterministic content (benchmarks must not vary with RNG state)."""
    n = rows * height * width * 3
    image = (np.arange(n, dtype=np.uint32) % 251).astype(np.uint8)
    return {
        'image': image.reshape(rows, height, width, 3),
        'label': np.arange(rows, dtype=np.int64),
    }


def payload_nbytes(payload: dict) -> int:
    return sum(v.nbytes for v in payload.values())


def serializer_roundtrip_bench(serializer, payload: dict, rounds: int) -> dict:
    """Serialize+deserialize ``payload`` ``rounds`` times; report MB/s and the
    serializer's copy counter."""
    nbytes = payload_nbytes(payload)
    # warmup (allocator, pickle dispatch tables)
    frames = serializer.serialize_multipart(payload)
    serializer.deserialize_multipart(frames)
    copies_before = serializer.copies
    start = time.perf_counter()
    for _ in range(rounds):
        frames = serializer.serialize_multipart(payload)
        result = serializer.deserialize_multipart(frames)
    elapsed = time.perf_counter() - start
    np.testing.assert_array_equal(result['label'], payload['label'])
    return {
        'rounds': rounds,
        'payload_mb': round(nbytes / _MB, 3),
        'mb_per_s': round(rounds * nbytes / _MB / elapsed, 1) if elapsed else float('inf'),
        'copies': serializer.copies - copies_before,
        'copies_per_roundtrip': (serializer.copies - copies_before) / rounds,
    }


@functools.lru_cache(maxsize=1)
def _worker_payload(rows: int, height: int, width: int) -> dict:
    return make_image_payload(rows, height, width)


def stream_image_payload(rows: int, height: int, width: int, item) -> dict:
    """A pool worker's process function (JAX's ``ImageStreamWorker``): one
    decoded-image column batch per ventilated item, built once per worker
    interpreter."""
    return _worker_payload(rows, height, width)


def pool_stream_bench(serializer, workers: int, items: int,
                      rows: int, height: int, width: int) -> dict:
    """Ship ``items`` decoded-image batches through a real ``ProcessPool`` and
    report wall time, MB/s, and total payload copies (worker + consumer)."""
    from petastorm_tpu_torch.workers.process_pool import ProcessPool
    from petastorm_tpu_torch.workers.thread_pool import EmptyResultError

    # resolve the process function through its canonical module: under
    # ``python -m`` this file is ``__main__``, which a worker interpreter
    # cannot import
    from petastorm_tpu_torch.benchmark import transport as canonical
    process = functools.partial(canonical.stream_image_payload, rows, height,
                                width)

    pool = ProcessPool(workers, serializer=serializer)
    pool.start(process, list(range(items)), num_epochs=1, shuffle=False)
    received = 0
    start = time.perf_counter()
    try:
        while True:
            batch = pool.get_results()
            received += 1
            assert batch['image'].shape == (rows, height, width, 3)
    except EmptyResultError:
        pass
    elapsed = time.perf_counter() - start
    snapshot = pool.stats.snapshot()
    pool.stop()
    pool.join()
    # payload_copies covers both ends of the hop: the worker's copies
    # arrive in the items' accounting frames, the consumer's deserialize
    # copies are added by get_results
    total_copies = snapshot['payload_copies']
    return {
        'workers': workers,
        'items': received,
        'bytes_moved_mb': round(snapshot['bytes_moved'] / _MB, 1),
        'mb_per_s': round(snapshot['bytes_moved'] / _MB / elapsed, 1) if elapsed else 0.0,
        'payload_copies': total_copies,
        'copies_per_item': total_copies / received if received else None,
        'serialize_s': round(snapshot['serialize_s'], 4),
        'deserialize_s': round(snapshot['deserialize_s'], 4),
    }


def run_transport_bench(quick: bool = False, payload_mb: float = None,
                        check: bool = True) -> dict:
    """Full pickle-vs-zero-copy comparison; returns one JSON-able dict.

    ``quick`` shrinks rounds/items but keeps the payload at 1 MB or more so
    the speedup assertion stays meaningful.
    """
    if payload_mb is None:
        payload_mb = 1.5 if quick else 8.0
    # rows of 128x128 RGB ≈ 48 KiB each
    rows = max(1, int(payload_mb * _MB / (128 * 128 * 3)))
    payload = make_image_payload(rows, 128, 128)
    rounds = 5 if quick else 30
    items = 6 if quick else 24

    inproc = {
        'pickle': serializer_roundtrip_bench(PickleSerializer(), payload, rounds),
        'zero_copy': serializer_roundtrip_bench(ZeroCopySerializer(), payload, rounds),
    }
    pool = {
        'pickle': pool_stream_bench(PickleSerializer(), 3, items, rows, 128, 128),
        'zero_copy': pool_stream_bench(ZeroCopySerializer(), 3, items, rows, 128, 128),
    }
    speedup = (inproc['zero_copy']['mb_per_s'] / inproc['pickle']['mb_per_s']
               if inproc['pickle']['mb_per_s'] else float('inf'))
    result = {
        'payload_mb': inproc['pickle']['payload_mb'],
        'inprocess_roundtrip': inproc,
        'pool_stream': pool,
        'speedup_inprocess': round(speedup, 2),
        'quick': quick,
    }
    if check:
        from petastorm_tpu_torch.benchmark import assert_bars
        _check_exact(result)
        assert_bars(_bars(result))
    return result


def _bars(result: dict) -> list:
    """The timing bar: zero-copy at least 1.5x pickle's in-process MB/s,
    held on payloads of 1 MB or more."""
    if result['payload_mb'] < 1.0:
        return []
    inproc = result['inprocess_roundtrip']
    pickle_rate = inproc['pickle']['mb_per_s']
    return [('in-process zero-copy / pickle MB/s',
             inproc['zero_copy']['mb_per_s'] / pickle_rate
             if pickle_rate else float('inf'), '>=', 1.5)]


def _check_exact(result: dict) -> None:
    """The copy counts, which do not depend on the host's speed: zero-copy
    strictly fewer pool copies than pickle, no copy in its in-process
    round trip, and pickle's one copy a side."""
    pool = result['pool_stream']
    assert pool['zero_copy']['payload_copies'] < pool['pickle']['payload_copies'], (
        'zero-copy transport must make strictly fewer payload copies: '
        '{} vs {}'.format(pool['zero_copy']['payload_copies'],
                          pool['pickle']['payload_copies']))
    assert result['inprocess_roundtrip']['zero_copy']['copies'] == 0, (
        'the zero-copy in-process round trip copied: {}'.format(
            result['inprocess_roundtrip']['zero_copy']))
    assert pool['pickle']['copies_per_item'] == 2.0, (
        'pickle must copy each item once a side: {}'.format(pool['pickle']))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='pickle vs zero-copy transport microbenchmark')
    parser.add_argument('--quick', action='store_true',
                        help='small rounds/items')
    parser.add_argument('--payload-mb', type=float, default=None)
    parser.add_argument('--no-check', action='store_true',
                        help='report only; skip the copy/speedup assertions')
    args = parser.parse_args(argv)
    result = run_transport_bench(quick=args.quick, payload_mb=args.payload_mb,
                                 check=not args.no_check)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
