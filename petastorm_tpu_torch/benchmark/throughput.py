"""Reader throughput measurement (JAX ``benchmark/throughput.py``): warmup
then measure cycles, reporting samples/sec, RSS and CPU%. The ``torch``
read method measures the loader path: it counts the rows of
:class:`~petastorm_tpu_torch.torch_utils.TorchDataLoader` batches made for
``device``, where JAX's ``jax`` method counts ``JaxDataLoader`` rows.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from petastorm_tpu_torch.reader import make_batch_reader, make_reader


@dataclasses.dataclass
class ThroughputResult:
    samples_per_sec: float
    warmup_cycles: int
    measure_cycles: int
    rss_mb: float
    cpu_percent: float
    #: ``Reader.diagnostics`` snapshot taken right after the measured window.
    #: Stats are reset after warmup, so the per-stage wall times (worker
    #: io/decode, serialize/deserialize, queue wait), payload bytes/copies,
    #: gauges and derived ``items_per_s``/``mb_per_s`` cover the measured
    #: samples only.
    diagnostics: Optional[dict] = None
    #: ``infeed_diagnosis(diagnostics, heartbeats=...)`` over the measured
    #: window: the classification (bottleneck + pipeline_state) the CLI's
    #: ``-d`` prints, with the live heartbeats folded in so it agrees with
    #: the watchdog and ``/healthz``.
    diagnosis: Optional[dict] = None
    #: The lineage coverage audit (``reader.lineage.coverage_report()``)
    #: taken after the run when requested via ``audit=True``, what the
    #: CLI's ``--audit`` prints. ``None`` when not requested.
    audit: Optional[dict] = None
    #: The roofline profile (``reader.profile()``) of the measured window
    #: when requested via ``profile=True``: measured samples/s against the
    #: calibrated per-stage ceilings, binding stage, advisor
    #: recommendations; what the CLI's ``--profile`` prints.
    profile: Optional[dict] = None
    #: The SLO verdict (``reader.slo.evaluate()``) of the measured window
    #: when ``slo=dict(...)`` targets were passed; what the CLI's
    #: ``--slo-p99-ms`` prints.
    slo: Optional[dict] = None
    #: The autotune controller's report (``reader.autotune.report()``) when
    #: the run was launched with ``autotune=True``; what the CLI's
    #: ``--autotune`` prints.
    autotune: Optional[dict] = None


def _consume(iterator, count: int, batched: bool) -> int:
    """Pull ``count`` samples; returns the actual number consumed (the stream
    restarts via num_epochs=None, so StopIteration is unexpected)."""
    seen = 0
    while seen < count:
        item = next(iterator)
        if batched:
            first = item[0] if isinstance(item, tuple) else next(iter(item.values()))
            seen += len(first)
        else:
            seen += 1
    return seen


def reader_throughput(dataset_url: str,
                      field_regex=None,
                      warmup_cycles: int = 200,
                      measure_cycles: int = 1000,
                      pool_type: str = 'thread',
                      workers_count: int = 3,
                      shuffling_queue_size: int = 500,
                      read_method: str = 'python',
                      batch_reader: bool = False,
                      torch_batch_size: int = 0,
                      prefetch_depth: Optional[int] = None,
                      io_readahead=0,
                      trace=None,
                      trace_path: Optional[str] = None,
                      metrics_interval: float = 0,
                      metrics_out: Optional[str] = None,
                      debug_port=None,
                      stall_timeout: float = 0,
                      audit: bool = False,
                      profile: bool = False,
                      slo: Optional[dict] = None,
                      autotune=False,
                      on_decode_error: str = 'raise',
                      cache_type: str = 'null',
                      cache_location: Optional[str] = None,
                      cache_size_limit: Optional[int] = None,
                      remote_read: Optional[str] = None,
                      storage_options: Optional[dict] = None,
                      device=None) -> ThroughputResult:
    """Measure reader throughput on ``dataset_url``.

    ``read_method='python'`` iterates raw reader rows/batches;
    ``read_method='torch'`` wraps the reader in :class:`TorchDataLoader`
    with ``torch_batch_size`` for ``device`` and counts batch rows.
    ``device`` (CUDA unless ``'cpu'``; without CUDA it raises) is also
    where ``profile`` stages its probes.

    ``trace_path`` enables per-item span tracing and exports the chrome
    trace of the measured window (warmup spans are dropped) there;
    ``metrics_interval``/``metrics_out`` run the continuous metrics emitter
    alongside the measurement; ``debug_port``/``stall_timeout`` arm the live
    health endpoint/watchdog on the benchmarked reader.
    """
    import psutil

    from petastorm_tpu_torch.device import resolve_device
    device = resolve_device(device)
    factory = make_batch_reader if batch_reader else make_reader
    if trace_path is not None and trace is None:
        trace = True
    if autotune is True or isinstance(autotune, dict):
        # the controller's calibration stages to the bench's device
        autotune = dict(autotune) if isinstance(autotune, dict) else {}
        autotune.setdefault('device', str(device))
    kwargs = dict(reader_pool_type=pool_type, workers_count=workers_count,
                  num_epochs=None, io_readahead=io_readahead, trace=trace,
                  metrics_interval=metrics_interval, metrics_out=metrics_out,
                  debug_port=debug_port, stall_timeout=stall_timeout,
                  on_decode_error=on_decode_error, cache_type=cache_type,
                  cache_location=cache_location,
                  cache_size_limit=cache_size_limit, slo=slo,
                  autotune=autotune, remote_read=remote_read,
                  storage_options=storage_options)
    if field_regex is not None:
        kwargs['schema_fields'] = field_regex

    proc = psutil.Process()
    with factory(dataset_url, **kwargs) as reader:
        if read_method == 'torch':
            from petastorm_tpu_torch.torch_utils import TorchDataLoader
            loader = TorchDataLoader(
                reader, batch_size=torch_batch_size or 16,
                shuffling_queue_capacity=shuffling_queue_size,
                prefetch_depth=prefetch_depth, device=device)
            iterator = iter(loader)
            batched = True
        elif read_method == 'python':
            iterator = iter(reader)
            batched = reader.batched_output
        else:
            raise ValueError('Unknown read_method {!r}'.format(read_method))

        _consume(iterator, warmup_cycles, batched)
        # warmup decode/io must not pollute the measured window: the stage
        # times, counters and derived items_per_s/mb_per_s in `diagnostics`
        # cover exactly the measured samples (the trace window likewise)
        if reader.stats is not None:
            reader.stats.reset()
        if reader.tracer is not None:
            reader.tracer.reset()
        proc.cpu_percent()  # reset the cpu counter window
        start = time.perf_counter()
        actual = _consume(iterator, measure_cycles, batched)
        elapsed = time.perf_counter() - start
        cpu = proc.cpu_percent()
        rss = proc.memory_info().rss / (1024.0 * 1024.0)
        diagnostics = reader.diagnostics
        from petastorm_tpu_torch.torch_utils import infeed_diagnosis
        health = getattr(reader, 'health', None)
        watchdog = getattr(reader, 'watchdog', None)
        slo_verdict = None
        monitor = getattr(reader, 'slo', None)
        if monitor is not None:
            slo_verdict = monitor.evaluate()
        diagnosis = infeed_diagnosis(
            diagnostics,
            heartbeats=health.heartbeats() if health is not None else None,
            stall_after_s=watchdog.stall_after_s
            if watchdog is not None else None,
            slo=slo_verdict)
        if trace_path is not None and reader.tracer is not None:
            reader.tracer.export_chrome_trace(trace_path)
        audit_report = None
        if audit:
            lineage = getattr(reader, 'lineage', None)
            audit_report = (lineage.coverage_report()
                            if lineage is not None else {'enabled': False})
        autotune_report = None
        controller = getattr(reader, 'autotune', None)
        if controller is not None:
            autotune_report = controller.report()
        profile_report = None
        if profile:
            # the measured window's own samples/s is the numerator (torch
            # mode counts batch rows; row mode counts rows); the probes run
            # after the measurement so they cannot perturb it
            profile_report = reader.profile(
                samples_per_sec=actual / elapsed, device=device)
            diagnosis['roofline'] = {
                k: profile_report.get(k)
                for k in ('measured_samples_per_s', 'binding_stage',
                          'binding_ceiling_samples_per_s',
                          'roofline_fraction')}

    return ThroughputResult(samples_per_sec=actual / elapsed,
                            warmup_cycles=warmup_cycles,
                            measure_cycles=actual,
                            rss_mb=rss, cpu_percent=cpu,
                            diagnostics=diagnostics,
                            diagnosis=diagnosis,
                            audit=audit_report,
                            profile=profile_report,
                            slo=slo_verdict,
                            autotune=autotune_report)
