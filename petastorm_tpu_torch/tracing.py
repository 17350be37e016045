"""Per-item pipeline tracing and continuous metrics emission.

The port's copy of ``petastorm_tpu/tracing.py`` (``resolve_trace`` :93,
``Tracer`` :123, ``step_stall_marker`` :74, ``stitch_pod_trace`` :251,
``prometheus_text`` :313, ``MetricsEmitter`` :377), with its environment
variable, span names and metric names (prefix ``petastorm_tpu``), so one
scrape configuration and one trace viewer read both packages.

- :class:`Tracer`: a bounded ring of spans ``(name, cat, start_s, dur_s,
  pid, tid, args)`` that every component on the sample path records into
  (ventilate, readahead and parquet reads, decode, serialize, result-queue
  wait, deserialize, device staging, the consumer's train step, the
  goodput step). Off unless asked for (``trace=`` or
  ``PETASTORM_TPU_TRACE``). Timestamps are ``time.perf_counter()``
  readings, CLOCK_MONOTONIC on Linux, so spans recorded in worker
  interpreters land on the consumer's timeline; each keeps its worker's
  pid and thread id. :meth:`Tracer.export_chrome_trace` writes Chrome
  trace-event JSON, which https://ui.perfetto.dev opens.
- :func:`stitch_pod_trace`: the span tails of a pod's hosts as one Chrome
  trace on the aggregator's clock, a process track a host.
- :class:`MetricsEmitter`: a daemon thread writing a stats snapshot every
  N seconds as JSON lines, or as Prometheus text for a ``.prom`` path, and
  one final snapshot at :meth:`MetricsEmitter.stop`.

numpy-free and torch-free: worker interpreters import it.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

#: Environment variable controlling tracing when the ``trace=`` kwarg is left
#: at its default. ``''``/``'0'``/``'false'``/``'off'`` disable;
#: ``'1'``/``'true'``/``'on'`` enable; any other value enables tracing AND
#: names the chrome-trace file exported when the reader joins.
TRACE_ENV_VAR = 'PETASTORM_TPU_TRACE'

#: Default ring-buffer bound: ~7 tuple slots per span keeps 100k spans in the
#: low tens of MB while covering minutes of steady-state pipeline activity.
DEFAULT_CAPACITY = 100_000

#: A recorded span: (name, cat, start_s, dur_s, pid, tid, args-or-None).
#: ``start_s`` is a ``time.perf_counter()`` reading; ``dur_s`` seconds.
Span = Tuple[str, str, float, float, int, int, Optional[dict]]

#: Category of the per-step goodput spans
#: (:class:`~petastorm_tpu_torch.goodput.GoodputMonitor` records one complete
#: ``'step'`` span per training step, args carrying the verdict/stall ms).
GOODPUT_STEP_CAT = 'goodput'


def step_stall_marker(event: dict) -> Optional[dict]:
    """An instant step-boundary marker for a data-stalled goodput step.

    Given a chrome-trace ``'X'`` event, returns a process-scoped instant
    (``ph='i'``) event at the step boundary naming the stall — Perfetto
    renders these as flags, so stalled steps stand out on a busy pod
    timeline without opening each span's args. ``None`` for every other
    event."""
    args = event.get('args') or {}
    if (event.get('cat') != GOODPUT_STEP_CAT
            or args.get('verdict') != 'data-stall'):
        return None
    return {'name': 'data-stall {}ms'.format(args.get('stall_ms')),
            'cat': GOODPUT_STEP_CAT, 'ph': 'i', 's': 'p',
            'ts': event['ts'], 'pid': event['pid'],
            'tid': event.get('tid', 0), 'args': dict(args)}


def resolve_trace(trace) -> Tuple[bool, Optional[str]]:
    """Resolve a factory's ``trace=`` kwarg against :data:`TRACE_ENV_VAR`.

    Returns ``(enabled, export_path)``. ``trace=None`` defers to the env var;
    ``trace=True``/``False`` force; a string value enables tracing and names
    the chrome-trace file auto-exported at ``Reader.join()``.
    """
    if trace is None:
        value = os.environ.get(TRACE_ENV_VAR, '').strip()
        if not value or value.lower() in ('0', 'false', 'off'):
            return False, None
        if value.lower() in ('1', 'true', 'on'):
            return True, None
        return True, value
    if isinstance(trace, str):
        return True, trace
    return bool(trace), None


def make_span(name: str, cat: str, start_s: float, dur_s: float,
              pid: Optional[int] = None, tid: Optional[int] = None,
              args: Optional[dict] = None) -> Span:
    """Build one span tuple, stamping the calling thread/process when the
    caller does not supply a track."""
    return (name, cat, start_s, dur_s,
            os.getpid() if pid is None else pid,
            threading.get_ident() if tid is None else tid,
            args)


class Tracer:
    """Thread-safe bounded ring buffer of pipeline spans.

    One instance lives on the worker pool (``pool.tracer``, reachable as
    ``reader.tracer`` / ``loader.tracer``) when tracing is enabled; thread
    and dummy pools record into it directly, process workers accumulate spans
    locally (``PieceWorker.record_span``) and the pool :meth:`merge`\\ s the
    batches shipped back in the item's ``ITEM_DONE`` frame.
    """

    __slots__ = ('_lock', '_spans', '_added', '_origin_pid')

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError('capacity must be >= 1, got {}'.format(capacity))
        self._lock = threading.Lock()
        self._spans: 'deque[Span]' = deque(maxlen=capacity)
        self._added = 0
        # the constructing process is the consumer: its pid names the
        # consumer track in the export metadata
        self._origin_pid = os.getpid()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring bound since construction/reset."""
        with self._lock:
            return self._added - len(self._spans)

    def add_span(self, name: str, cat: str, start_s: float, dur_s: float,
                 pid: Optional[int] = None, tid: Optional[int] = None,
                 args: Optional[dict] = None) -> None:
        span = make_span(name, cat, start_s, dur_s, pid, tid, args)
        with self._lock:
            self._spans.append(span)
            self._added += 1

    @contextmanager
    def span(self, name: str, cat: str = '', args: Optional[dict] = None):
        """Record a complete span around the with-block."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, cat, start, time.perf_counter() - start,
                          args=args)

    def merge(self, spans) -> None:
        """Append a batch of span tuples (shipped back from a worker)."""
        if not spans:
            return
        with self._lock:
            self._spans.extend(spans)
            self._added += len(spans)

    def reset(self) -> None:
        """Drop every recorded span (benchmarks call this after warmup so the
        exported window covers only the measured passes)."""
        with self._lock:
            self._spans.clear()
            self._added = 0

    def spans(self) -> List[Span]:
        """A point-in-time copy of the buffered spans."""
        with self._lock:
            return list(self._spans)

    # -- chrome trace-event export ---------------------------------------------

    def chrome_trace_events(self) -> List[dict]:
        """The buffered spans as Chrome trace-event dicts: complete events
        (``ph='X'``, ``ts``/``dur`` in microseconds) sorted by timestamp,
        preceded by ``process_name`` metadata naming the consumer vs worker
        tracks."""
        spans = self.spans()
        spans.sort(key=lambda s: s[2])
        events: List[dict] = []
        for pid in sorted({s[4] for s in spans}):
            role = 'consumer' if pid == self._origin_pid else 'worker'
            events.append({'name': 'process_name', 'ph': 'M', 'pid': pid,
                           'tid': 0,
                           'args': {'name': 'petastorm_tpu {} (pid {})'
                                    .format(role, pid)}})
        for name, cat, start_s, dur_s, pid, tid, args in spans:
            event = {'name': name, 'cat': cat or 'pipeline', 'ph': 'X',
                     'ts': start_s * 1e6, 'dur': max(0.0, dur_s) * 1e6,
                     'pid': pid, 'tid': tid}
            if args:
                event['args'] = args
            events.append(event)
            marker = step_stall_marker(event)
            if marker is not None:
                events.append(marker)
        return events

    def export_chrome_trace(self, path: str) -> int:
        """Write the buffered spans as Chrome trace-event JSON (open the file
        in Perfetto / ``chrome://tracing``). Returns the number of span
        events written.

        The write is atomic (tmp file + ``os.replace``): a crash mid-dump —
        exactly when traces matter most — must never leave a truncated JSON
        that Perfetto rejects, and a previous good export at the same path
        survives a failed rewrite."""
        from petastorm_tpu_torch.utils import atomic_write
        events = self.chrome_trace_events()
        atomic_write(path, lambda f: json.dump(
            {'traceEvents': events, 'displayTimeUnit': 'ms'}, f))
        return sum(1 for e in events if e['ph'] == 'X')

    def tail(self, limit: int = 500) -> List[dict]:
        """The most recent ``limit`` spans as JSON-able dicts (same field
        names as the chrome events: ``ts``/``dur`` in microseconds). The
        flight recorder embeds this ring tail in its stall dump — the last
        thing the pipeline did before it stopped doing anything."""
        if limit < 1:
            return []
        with self._lock:
            spans = list(self._spans)[-limit:]
        return [{'name': name, 'cat': cat or 'pipeline',
                 'ts': start_s * 1e6, 'dur': max(0.0, dur_s) * 1e6,
                 'pid': pid, 'tid': tid, 'args': args}
                for name, cat, start_s, dur_s, pid, tid, args in spans]


def stitch_pod_trace(tracks: List[dict], path: str) -> str:
    """The span tails of a pod's hosts as ONE clock-aligned Chrome trace.

    ``tracks`` is a :class:`~petastorm_tpu_torch.podobs.PodObserver`
    report's ``trace_tracks``: a dict a host with ``host``, ``pid``,
    ``clock_offset_s`` (that host's monotonic clock less the aggregator's,
    estimated from the poll's round trip) and ``spans`` (tail dicts,
    ``ts``/``dur`` in µs on the HOST's clock). Each span's ``ts`` moves by
    ``-clock_offset_s`` onto the aggregator's timeline, and each distinct
    ``(host, pid)`` gets its own synthetic pid with a ``process_name`` row
    naming the host: two hosts' equal OS pids must not share a Perfetto
    track. Data-stalled goodput steps get :func:`step_stall_marker` flags.
    Written atomically; returns ``path``."""
    from petastorm_tpu_torch.utils import atomic_write
    events: List[dict] = []
    pid_map: Dict[Tuple[str, object], int] = {}
    for track in tracks:
        host = str(track.get('host'))
        offset_s = track.get('clock_offset_s') or 0.0
        offset_us = float(offset_s) * 1e6
        for span in track.get('spans') or []:
            key = (host, span.get('pid'))
            pid = pid_map.get(key)
            if pid is None:
                pid = pid_map[key] = len(pid_map) + 1
                events.append({
                    'name': 'process_name', 'ph': 'M', 'pid': pid, 'tid': 0,
                    'args': {'name': 'petastorm_tpu {} (pid {})'.format(
                        host, span.get('pid'))}})
            event = {'name': span.get('name'),
                     'cat': span.get('cat') or 'pipeline', 'ph': 'X',
                     'ts': float(span.get('ts', 0.0)) - offset_us,
                     'dur': max(0.0, float(span.get('dur', 0.0))),
                     'pid': pid, 'tid': span.get('tid', 0)}
            if span.get('args'):
                event['args'] = span['args']
            events.append(event)
            marker = step_stall_marker(event)
            if marker is not None:
                events.append(marker)
    events.sort(key=lambda e: (e['ph'] != 'M', e.get('ts', 0.0)))
    atomic_write(path, lambda f: json.dump(
        {'traceEvents': events, 'displayTimeUnit': 'ms'}, f))
    return path


def _prometheus_value(value: float) -> str:
    """One sample value per the text-exposition format: finite floats print
    normally, non-finite ones as the spec's ``NaN``/``+Inf``/``-Inf``
    literals (``float()`` would print ``nan``/``inf``, which scrape parsers
    reject — derived ratios can legitimately be non-finite)."""
    value = float(value)
    if math.isnan(value):
        return 'NaN'
    if math.isinf(value):
        return '+Inf' if value > 0 else '-Inf'
    return repr(value)


def prometheus_text(snapshot: dict, prefix: str = 'petastorm_tpu') -> str:
    """A stats snapshot in Prometheus text-exposition format — the one
    formatter shared by :class:`MetricsEmitter` (``.prom`` textfile
    collector output) and the debug endpoint's ``/metrics`` route.
    Non-numeric values are skipped; everything is exposed as a gauge (the
    snapshot is a point-in-time scrape, not a counter stream) with a
    ``# HELP`` line, and non-finite values use the spec's
    ``NaN``/``+Inf``/``-Inf`` literals.

    Two string keys are special-cased as info-style labeled gauges (the
    Prometheus idiom for categorical state): ``binding_stage`` (the
    roofline profiler's verdict — see ``docs/profiling.md``) exports as
    ``<prefix>_binding_stage{stage="decode"} 1``, and
    ``autotune_last_knob`` (the controller's most recent move — see
    ``docs/autotune.md``) as
    ``<prefix>_autotune_last_knob{knob="workers_count:up"} 1``.

    When the snapshot carries the latency plane's histogram states (the
    ``'_latency_histograms'`` key a ``ReaderStats`` snapshot includes unless
    kill-switched — see ``docs/latency.md``), each stage renders in the
    spec's **histogram** form: cumulative ``<prefix>_latency_<stage>_seconds_bucket``
    samples with ``le`` labels, the mandatory terminal ``le="+Inf"`` bucket,
    and ``_sum``/``_count`` — scrapeable by any Prometheus-conformant
    parser, quantile-queryable via ``histogram_quantile()``."""
    from petastorm_tpu_torch.latency import prometheus_histogram_lines
    from petastorm_tpu_torch.workers.stats import LATENCY_HISTOGRAMS_KEY
    lines = []
    histograms = snapshot.get(LATENCY_HISTOGRAMS_KEY)
    if isinstance(histograms, dict):
        for stage in sorted(histograms):
            metric = '{}_latency_{}_seconds'.format(prefix, stage)
            lines.extend(prometheus_histogram_lines(
                metric, histograms[stage],
                help_text='petastorm_tpu {} duration distribution '
                          '(see docs/latency.md)'.format(stage)))
    for key in sorted(snapshot):
        if key == LATENCY_HISTOGRAMS_KEY:
            continue
        value = snapshot[key]
        if key == 'binding_stage' and isinstance(value, str) and value:
            metric = '{}_{}'.format(prefix, key)
            lines.append('# HELP {} the roofline profiler\'s binding '
                         'pipeline stage (see docs/profiling.md)'
                         .format(metric))
            lines.append('# TYPE {} gauge'.format(metric))
            lines.append('{}{{stage="{}"}} 1'.format(metric, value))
            continue
        if key == 'autotune_last_knob' and isinstance(value, str) and value:
            metric = '{}_{}'.format(prefix, key)
            lines.append('# HELP {} the autotune controller\'s most recent '
                         'knob move (see docs/autotune.md)'.format(metric))
            lines.append('# TYPE {} gauge'.format(metric))
            lines.append('{}{{knob="{}"}} 1'.format(metric, value))
            continue
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        metric = '{}_{}'.format(prefix, key)
        lines.append('# HELP {} petastorm_tpu reader stat {!r} '
                     '(see docs/transport.md key table)'.format(metric, key))
        lines.append('# TYPE {} gauge'.format(metric))
        lines.append('{} {}'.format(metric, _prometheus_value(value)))
    return '\n'.join(lines) + '\n'


class MetricsEmitter:
    """Background thread snapshotting a stats source every ``interval_s``
    seconds to a file.

    Formats (picked from the path suffix unless ``fmt`` is given):

    - ``jsonl`` — one JSON object per snapshot appended per line, with
      ``ts`` (epoch seconds) added; tail it or ship it to a log pipeline.
    - ``prometheus`` (``.prom`` suffix) — Prometheus text-exposition format,
      atomically rewritten each snapshot; point a node-exporter textfile
      collector at it.

    A final snapshot is emitted at :meth:`stop` so short runs always record
    at least one sample. ``Reader.stop()/join()`` drive the lifecycle.
    """

    def __init__(self, snapshot_fn: Callable[[], dict], interval_s: float,
                 path: str, fmt: Optional[str] = None,
                 prefix: str = 'petastorm_tpu'):
        if interval_s <= 0:
            raise ValueError('interval_s must be positive, got '
                             '{!r}'.format(interval_s))
        if fmt is None:
            fmt = 'prometheus' if str(path).endswith('.prom') else 'jsonl'
        if fmt not in ('jsonl', 'prometheus'):
            raise ValueError("fmt must be 'jsonl' or 'prometheus', got "
                             '{!r}'.format(fmt))
        self._snapshot_fn = snapshot_fn
        self._interval = interval_s
        self._path = str(path)
        self._fmt = fmt
        self._prefix = prefix
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._emit_lock = threading.Lock()
        self._final_emitted = False
        self.emit_count = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='petastorm-tpu-metrics')
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_event.wait(self._interval):
            self.emit_once()

    def emit_once(self) -> None:
        snapshot = dict(self._snapshot_fn())
        if self._fmt == 'jsonl':
            # jsonl lines stay scalar: the raw histogram states (137-bucket
            # count pairs per stage per tick) belong to the .prom/scrape
            # path; the derived *_p50_s/*_p99_s keys carry the tail signal
            from petastorm_tpu_torch.workers.stats import LATENCY_HISTOGRAMS_KEY
            snapshot.pop(LATENCY_HISTOGRAMS_KEY, None)
            # deliberate wall clock: 'ts' is a log-pipeline timestamp for
            # humans and scrapers, never compared against monotonic readings
            ts = time.time()
            line = json.dumps({'ts': ts, **snapshot}, sort_keys=True)
        # _emit_lock exists precisely to serialize emissions (periodic tick
        # vs the final flush at stop()); holding it across the write IS the
        # point, and only those two threads ever contend on it
        with self._emit_lock:
            if self._fmt == 'jsonl':
                with open(self._path, 'a') as f:
                    f.write(line + '\n')
            else:
                self._write_prometheus(snapshot)
            self.emit_count += 1

    def _write_prometheus(self, snapshot: dict) -> None:
        from petastorm_tpu_torch.utils import atomic_write
        atomic_write(self._path,
                     lambda f: f.write(prometheus_text(snapshot,
                                                       self._prefix)))

    def stop(self, join: bool = True) -> None:
        """Signal the thread to stop; with ``join`` (the default) also wait
        for it and emit one final snapshot. Idempotent."""
        self._stop_event.set()
        if not join:
            return
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
            self._thread = None
        if not self._final_emitted:
            self._final_emitted = True
            self.emit_once()
