"""Pipeline health signals of the port.

A first piece of ``petastorm_tpu/health.py``: :func:`bottleneck_signals`
(:216), the pure classification of a ``ReaderStats`` snapshot that
:func:`~petastorm_tpu_torch.torch_utils.infeed_diagnosis` and
:meth:`~petastorm_tpu_torch.goodput.GoodputMonitor.explain_step` share, with
JAX's thresholds and wording. Heartbeats, the watchdog, flight records and
the debug endpoint come with the health slice. Torch-free: worker
interpreters may import it.
"""

from __future__ import annotations

from petastorm_tpu_torch.workers.stats import effective_io_s

#: Range-fetch p99 at or above which the object store is named the slow
#: side of the read plane.
SLOW_RANGE_FETCH_P99_S = 1.0

#: Peer-cache fetch p99 at or above which a peer cache host is named slow.
SLOW_PEER_FETCH_P99_S = 0.25


def bottleneck_signals(snapshot: dict) -> dict:
    """Classify the io / decode / consumer bottleneck of a ``ReaderStats``
    snapshot: ``{'bottleneck', 'hint', 'io_s', 'decode_s'}`` plus the
    queue-wait tail keys.

    The consumer wait's distribution separates two regimes the sums cannot:
    steady back-pressure (p50 near p99: the reader is slower than the
    consumer) and tail stalls (p50 near zero, p99 large: most batches are
    ready at once, yet every Nth delivery stalls the device), reported as
    ``tail_stall: True`` with its own hint."""
    io_s = effective_io_s(snapshot)
    decode_s = snapshot.get('worker_decode_s', 0.0)
    publish_wait_s = snapshot.get('worker_publish_wait_s', 0.0)
    qw_p50 = snapshot.get('queue_wait_p50_s', 0.0)
    qw_p99 = snapshot.get('queue_wait_p99_s', 0.0)
    # tail stall: the p99 consumer wait dwarfs the median and is large
    # enough to matter (>= 50 ms)
    tail_stall = bool(qw_p99 >= 0.05 and qw_p99 > 10.0 * max(qw_p50, 1e-4))
    busy = io_s + decode_s
    if tail_stall:
        bottleneck = 'tail-stall'
        hint = ('queue-wait p99 ({:.3f}s) dwarfs p50 ({:.4f}s): most '
                'batches arrive instantly but every Nth delivery stalls '
                'the consumer — look at the /slo burn, the flight-record '
                'p99 trend and per-stage histograms, not the means '
                '(docs/latency.md)'.format(qw_p99, qw_p50))
    elif publish_wait_s > busy:
        bottleneck = 'consumer'
        hint = ('workers outrun the consumer (publish_wait > io+decode): '
                'the training step / consumer loop is the ceiling')
    elif io_s > decode_s * 1.5:
        bottleneck = 'io'
        hint = ('storage stall dominates: raise io_readahead (or pass '
                "io_readahead='auto') before raising workers_count")
    elif decode_s > io_s * 1.5:
        bottleneck = 'decode'
        hint = ('decode dominates and reads are hidden: raise workers_count '
                'or cut decode work (decode_hints, lighter transforms)')
    else:
        bottleneck = 'balanced'
        hint = ('io and decode are comparable: io_readahead overlaps them '
                'for up to 2x; workers_count scales both')
    # the read plane's own latency stages name its slow side
    io_range_p99 = snapshot.get('io_range_p99_s') or 0.0
    peer_fetch_p99 = snapshot.get('peer_fetch_p99_s') or 0.0
    slow_object_store = bool(io_range_p99 >= SLOW_RANGE_FETCH_P99_S)
    slow_peer_cache = bool(peer_fetch_p99 >= SLOW_PEER_FETCH_P99_S)
    if slow_object_store and bottleneck in ('io', 'balanced'):
        hint = ('the OBJECT STORE is the slow side: range-fetch p99 is '
                '{:.3f}s (>= {:.2f}s) — check the store/network before '
                'touching pipeline knobs; hedging (hedge_ms) clips this '
                'tail (docs/object_store.md)'.format(
                    io_range_p99, SLOW_RANGE_FETCH_P99_S))
    if slow_peer_cache:
        hint += ('; a PEER CACHE host is slow: peer-fetch p99 is {:.3f}s '
                 '(>= {:.2f}s) — use /podmetrics to see which host, and '
                 'peer_hedge_s to route around it '
                 '(docs/pod_observability.md)'.format(
                     peer_fetch_p99, SLOW_PEER_FETCH_P99_S))
    return {'bottleneck': bottleneck, 'hint': hint, 'io_s': io_s,
            'decode_s': decode_s, 'queue_wait_p50_s': qw_p50,
            'queue_wait_p99_s': qw_p99, 'tail_stall': tail_stall,
            'io_range_p99_s': io_range_p99,
            'peer_fetch_p99_s': peer_fetch_p99,
            'slow_object_store': slow_object_store,
            'slow_peer_cache': slow_peer_cache}
