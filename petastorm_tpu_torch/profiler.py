"""The port's roofline profiler: calibrated per-stage ceilings,
overlap-aware attribution and a what-if advisor.

The port's copy of ``petastorm_tpu/profiler.py``, with its constants,
report keys, gauge names and warning wording:

- **Calibration micro-probes** (:func:`calibrate`) measure this host's
  per-stage ceilings on the dataset itself: the storage's sequential read
  and the Parquet row-group read rate under the plain and ``pre_buffer``
  opens (JAX :219; the coalesced ranged mode needs a range reader, which
  comes with the remote object stores, and reports ``None``), the decode
  rate of each codec through the port's own decode path
  (:func:`~petastorm_tpu_torch.readers.columnar_worker.decode_column`,
  with the batched/per-cell routing its workers use), the
  ``ZeroCopySerializer`` round trip, and the host-to-device staging of
  :func:`~petastorm_tpu_torch.torch_utils.stage_to_device`, the per-leaf
  staging :func:`~petastorm_tpu_torch.torch_utils.prefetch_to_device`
  runs (pinned allocation, copy, ``non_blocking`` copy on a side stream),
  timed up to an event on that stream. The artifact is cached as JSON per
  ``(host, dataset digest, device)``.
- **Overlap-aware attribution** (:func:`attribute`): per-stage busy time as
  the interval union of each stage's spans, so overlapped readahead,
  decode and staging are not counted twice.
- **Roofline verdict** (:func:`build_profile`): "measured X samples/s = Y%
  of the binding stage's ceiling Z", the binding stage being the
  calibrated stage with the lowest ceiling for this configuration.
- **What-if advisor** (:func:`advise`): ranked knob recommendations from
  the throughput model (:func:`predict_throughput`), checked for direction
  against the committed BENCH artifacts
  (:func:`replay_against_artifacts`).

The device is explicit: :func:`calibrate` and :func:`get_calibration`
stage to ``device`` (CUDA unless the caller passes ``'cpu'``; without
CUDA they raise), and the staging probe raises on a failing card where
JAX's returns ``None``. It waits only on its own stream's event, never on
the whole device: it may run on the autotune controller's thread while a
training step is in flight. An artifact carries its own ``kind`` and the
name of the device it staged to, under a file name JAX's
``roofline_{host}_{digest}.json`` cannot collide with, and
:func:`load_calibration` treats another kind or another device as a miss:
a JAX or CPU ceiling never judges a card's measurements.

Surfaces: ``reader.profile(device=)`` / ``reader.explain_throughput()``,
the ``GET /profile`` route, the ``roofline`` section of flight records
and of ``infeed_diagnosis``, and the ``stage_ceiling_*`` /
``roofline_fraction`` gauges of ``/metrics``. This module imports no torch
at module level: worker interpreters import it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: Environment variable gating the profiler surfaces (default on).
#: ``0``/``false``/``off`` removes the ``/profile`` route and makes
#: ``reader.profile()`` raise.
PROFILER_ENV_VAR = 'PETASTORM_TPU_PROFILER'

#: Where calibration artifacts live when ``cache_dir`` is not passed.
CALIBRATION_DIR_ENV_VAR = 'PETASTORM_TPU_CALIBRATION_DIR'

#: Probe-methodology version stamped into every calibration artifact and
#: required on load (JAX's version 4: the io ceiling is the max over the
#: open modes).
PROBE_SCHEMA_VERSION = 4

#: The port's artifact ``kind``: JAX's artifacts carry
#: ``'petastorm_tpu_roofline_calibration'`` and are a miss here.
CALIBRATION_KIND = 'petastorm_tpu_torch_roofline_calibration'

#: Pipeline stages a ceiling is calibrated for, in pipeline order.
#: ``device_decode`` and ``ingest`` are JAX's probe-only ceilings of the
#: device-decode benchmark gate; the port reports them ``None`` until that
#: gate is ported.
CEILING_STAGES = ('io', 'decode', 'serialize', 'device_stage')

#: Span name -> attribution stage. Spans whose name is not listed keep their
#: category as the stage.
SPAN_STAGE = {
    'parquet_read': 'io',
    'readahead_read': 'io',
    'decode_columns': 'decode',
    'decode_rows': 'decode',
    'transform': 'decode',
    'serialize': 'serialize',
    'deserialize': 'deserialize',
    'device_stage': 'device_stage',
    'train_step': 'train',
    'queue_wait': 'consumer_wait',
    'infeed_wait': 'consumer_wait',
    'process_item': 'worker',
    'ventilate': 'ventilate',
}

#: Stages that mean "waiting, not working": excluded from binding-stage
#: selection (a pipeline is never *bound* by its own idle time).
IDLE_ATTRIBUTION_STAGES = frozenset({'consumer_wait', 'ventilate', 'worker'})

#: A roofline fraction above this is not a fast pipeline, it is a broken
#: measurement: the measured window drained pre-decoded buffers (too short
#: to be steady-state) or the calibration is stale for this host.
SANE_FRACTION_LIMIT = 1.3

_MB = 1024.0 * 1024.0


def profiler_enabled() -> bool:
    """The :data:`PROFILER_ENV_VAR` gate (default on)."""
    value = os.environ.get(PROFILER_ENV_VAR, '').strip().lower()
    return value not in ('0', 'false', 'off')


# ---------------------------------------------------------------------------
# dataset digest + calibration cache
# ---------------------------------------------------------------------------

def dataset_digest(pieces, schema=None) -> str:
    """Content digest of a dataset's row-group composition — every
    ``(path, row_group, num_rows)`` triple — plus the column view when a
    ``schema`` is given (JAX :129). Regenerating a store in place changes
    the digest, so a stale calibration is never served for it; ceilings
    are per view, so differently pruned readers never share one."""
    h = hashlib.md5()
    for piece in sorted(pieces, key=lambda p: (str(p.path), p.row_group)):
        h.update('{}:{}:{}\n'.format(piece.path, piece.row_group,
                                     piece.num_rows).encode())
    if schema is not None:
        h.update('view:{}\n'.format(
            ','.join(sorted(schema.fields))).encode())
    return h.hexdigest()[:16]


def device_name(device) -> str:
    """The name a calibration is stamped with: the CUDA device's
    ``torch.cuda.get_device_name``, or ``'cpu'``. ``device`` is a resolved
    ``torch.device``."""
    if device.type == 'cpu':
        return 'cpu'
    import torch
    return torch.cuda.get_device_name(device)


def _resolve(device):
    """``device`` resolved (CUDA by default, raising without it) and its
    :func:`device_name`."""
    from petastorm_tpu_torch.device import resolve_device
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        import torch
        device = torch.device('cuda', torch.cuda.current_device())
    return device, device_name(device)


def calibration_dir(cache_dir: Optional[str] = None) -> str:
    if cache_dir:
        return str(cache_dir)
    env = os.environ.get(CALIBRATION_DIR_ENV_VAR, '').strip()
    if env:
        return env
    return os.path.join(os.path.expanduser('~'), '.cache', 'petastorm_tpu')


def calibration_path(digest: str, device: str,
                     cache_dir: Optional[str] = None) -> str:
    """The artifact path for ``(this host, digest, device name)``:
    ``torch_roofline_{host}_{digest}_{device digest}.json``, which no JAX
    artifact name (``roofline_{host}_{digest}.json``) can equal."""
    host = socket.gethostname().split('.')[0] or 'host'
    tag = hashlib.md5(device.encode()).hexdigest()[:8]
    return os.path.join(calibration_dir(cache_dir),
                        'torch_roofline_{}_{}_{}.json'.format(host, digest,
                                                              tag))


def load_calibration(digest: str, device: str,
                     cache_dir: Optional[str] = None) -> Optional[dict]:
    """The cached calibration for ``digest`` staged to the device named
    ``device`` on this host, or ``None`` on a miss: no artifact, an
    unreadable one, another ``kind`` (a JAX artifact), another digest or
    device, or another probe version."""
    path = calibration_path(digest, device, cache_dir)
    try:
        with open(path) as f:
            cal = json.load(f)
    except (OSError, ValueError):
        return None
    if cal.get('kind') != CALIBRATION_KIND:
        return None
    if cal.get('dataset_digest') != digest or cal.get('device') != device:
        return None
    if cal.get('probe_version') != PROBE_SCHEMA_VERSION:
        return None
    return cal


def save_calibration(calibration: dict,
                     cache_dir: Optional[str] = None) -> str:
    from petastorm_tpu_torch.utils import atomic_write
    out_dir = calibration_dir(cache_dir)
    os.makedirs(out_dir, exist_ok=True)
    path = calibration_path(calibration['dataset_digest'],
                            calibration['device'], cache_dir)
    return atomic_write(path, lambda f: json.dump(calibration, f, indent=2,
                                                  sort_keys=True))


# ---------------------------------------------------------------------------
# calibration micro-probes
# ---------------------------------------------------------------------------

def _sample_pieces(pieces, sample_row_groups: int):
    """Spread the sampled row groups across the dataset (first/last/middle)
    instead of taking a prefix — a store whose early groups differ from the
    rest (warm page cache, different files) must not skew the ceilings."""
    pieces = list(pieces)
    n = len(pieces)
    k = max(1, min(sample_row_groups, n))
    if k == n:
        return pieces
    step = (n - 1) / (k - 1) if k > 1 else 0
    return [pieces[int(round(i * step))] for i in range(k)]


#: Repetitions per timed probe section; the BEST (minimum-time) rep is the
#: ceiling. Scheduler interference only ever slows a measurement down, so
#: min-of-N is the honest estimator for "what this host can do".
PROBE_REPS = 5


def _read_table(piece):
    import pyarrow.parquet as pq
    with open(piece.path, 'rb') as handle:
        return pq.ParquetFile(handle).read_row_group(piece.row_group)


def _probe_storage(sampled) -> dict:
    """Sequential-read bandwidth of the dataset's own files, plus the
    Parquet row-group read rate under the plain and ``pre_buffer=True``
    opens (JAX :219). ``parquet_ranged_rows_per_s`` is ``None``: the
    ranged mode needs a range reader, which the port does not have yet.
    Page-cache state is whatever the host has (``page_cache: 'ambient'``):
    these are sustained re-read ceilings, the regime epochs 2+ run in."""
    import pyarrow.parquet as pq
    total_bytes = 0
    seq_s = 0.0
    paths = []
    for piece in sampled:
        if piece.path not in paths:
            paths.append(piece.path)
    for path in paths:
        start = time.perf_counter()
        with open(path, 'rb') as f:
            while True:
                chunk = f.read(4 * 1024 * 1024)
                if not chunk:
                    break
                total_bytes += len(chunk)
        seq_s += time.perf_counter() - start

    def timed_read(pre_buffer: bool) -> Tuple[float, int]:
        read_s, rows = 0.0, 0
        for piece in sampled:
            with open(piece.path, 'rb') as handle:
                pf = (pq.ParquetFile(handle, pre_buffer=True) if pre_buffer
                      else pq.ParquetFile(handle))
                start = time.perf_counter()
                table = pf.read_row_group(piece.row_group)
                read_s += time.perf_counter() - start
                rows += table.num_rows
        return read_s, rows

    plain_s, rows = min(timed_read(pre_buffer=False)
                        for _ in range(PROBE_REPS))
    pre_s, _ = min(timed_read(pre_buffer=True) for _ in range(PROBE_REPS))
    return {
        'page_cache': 'ambient',
        'bytes': total_bytes,
        'seq_read_mb_per_s': round(total_bytes / _MB / seq_s, 2)
        if seq_s else None,
        'parquet_rows_per_s': round(rows / plain_s, 1) if plain_s else None,
        'parquet_pre_buffer_rows_per_s': round(rows / pre_s, 1)
        if pre_s else None,
        'parquet_ranged_rows_per_s': None,
        'parquet_read_s': round(plain_s, 4),
        'rows': rows,
    }


def _probe_decode(sampled, schema) -> dict:
    """Per-codec decode throughput through the port's decode path
    (:func:`~petastorm_tpu_torch.readers.columnar_worker.decode_column`,
    honoring each field's codec and the batched/per-cell routing the
    workers use) over the sampled row groups (JAX :295). One untimed pass
    warms codec imports and the column buffers; the timed pass is the
    single-core decode ceiling. Each per-codec entry records the cells the
    whole-column path decoded (``batched_rows``)."""
    from petastorm_tpu_torch.readers.columnar_worker import decode_column
    names = [name for name, field in schema.fields.items()]
    per_codec: Dict[str, dict] = {}
    rows = 0
    total_s = 0.0
    decoded_bytes = 0
    for piece in sampled:
        table = _read_table(piece)
        present = [n for n in names if n in table.column_names]
        # warm pass: codec imports, lazy cv2 init, chunk materialization
        for name in present:
            decode_column(schema.fields[name],
                          table.column(name).combine_chunks(),
                          counts={'batched': 0, 'percell': 0})
        n = table.num_rows
        rows += n
        for name in present:
            field = schema.fields[name]
            elapsed, out = None, None
            path_counts = {'batched': 0, 'percell': 0}
            for _ in range(PROBE_REPS):
                path_counts = {'batched': 0, 'percell': 0}
                start = time.perf_counter()
                out = decode_column(field,
                                    table.column(name).combine_chunks(),
                                    counts=path_counts)
                took = time.perf_counter() - start
                elapsed = took if elapsed is None else min(elapsed, took)
            total_s += elapsed
            codec = field.codec
            label = type(codec).__name__ if codec is not None else 'none'
            image_format = getattr(codec, '_image_codec', None)
            if image_format:
                label = '{}({})'.format(label, str(image_format).lstrip('.'))
            entry = per_codec.setdefault(label, {'rows': 0, 'seconds': 0.0,
                                                 'decoded_bytes': 0,
                                                 'batched_rows': 0,
                                                 'percell_rows': 0})
            entry['rows'] += n
            entry['seconds'] += elapsed
            entry['batched_rows'] += path_counts['batched']
            entry['percell_rows'] += path_counts['percell']
            nbytes = getattr(out, 'nbytes', 0)
            entry['decoded_bytes'] += int(nbytes)
            decoded_bytes += int(nbytes)
    for entry in per_codec.values():
        entry['rows_per_s'] = (round(entry['rows'] / entry['seconds'], 1)
                               if entry['seconds'] else None)
        entry['mb_per_s'] = (round(entry['decoded_bytes'] / _MB
                                   / entry['seconds'], 1)
                             if entry['seconds'] else None)
        entry['seconds'] = round(entry['seconds'], 4)
        if entry['batched_rows'] >= entry['percell_rows'] \
                and entry['batched_rows']:
            entry['path'] = 'host-batched'
        elif entry['percell_rows']:
            entry['path'] = 'per-cell'
        else:
            entry['path'] = 'host-native'
    return {
        'rows': rows,
        'seconds': round(total_s, 4),
        'rows_per_s': round(rows / total_s, 1) if total_s else None,
        'decoded_mb_per_s': round(decoded_bytes / _MB / total_s, 1)
        if total_s else None,
        'per_codec': per_codec,
        'decoded_bytes': decoded_bytes,
    }


def _decode_sample_columns(sampled, schema) -> Tuple[dict, int]:
    """One decoded row group's columns (numpy dict) for the transport and
    staging probes — the actual payload shape the pipeline ships."""
    from petastorm_tpu_torch.readers.columnar_worker import decode_column
    table = _read_table(sampled[0])
    columns = {}
    for name, field in schema.fields.items():
        if name in table.column_names:
            columns[name] = decode_column(
                field, table.column(name).combine_chunks())
    return columns, table.num_rows


def _probe_serialize(columns: dict, rows: int) -> dict:
    """``ZeroCopySerializer`` roundtrip bandwidth on a real decoded payload —
    the worker→consumer transport ceiling for process pools (in-process pools
    skip this stage entirely; their ceiling is effectively infinite)."""
    from petastorm_tpu_torch.workers.serializers import ZeroCopySerializer
    serializer = ZeroCopySerializer()
    frames = serializer.serialize_multipart(columns)     # warm
    serializer.deserialize_multipart(frames)
    payload_bytes = sum(getattr(v, 'nbytes', 0) for v in columns.values())
    elapsed = None
    for _ in range(PROBE_REPS):
        start = time.perf_counter()
        frames = serializer.serialize_multipart(columns)
        serializer.deserialize_multipart(frames)
        took = time.perf_counter() - start
        elapsed = took if elapsed is None else min(elapsed, took)
    return {
        'rows': rows,
        'payload_bytes': int(payload_bytes),
        'seconds': round(elapsed, 6),
        'rows_per_s': round(rows / elapsed, 1) if elapsed else None,
        'mb_per_s': round(payload_bytes / _MB / elapsed, 1)
        if elapsed else None,
    }


def _probe_device_stage(columns: dict, rows: int, device) -> dict:
    """Host→device staging bandwidth through
    :func:`~petastorm_tpu_torch.torch_utils.stage_to_device`, the per-leaf
    staging of ``prefetch_to_device`` (JAX :429): a pinned allocation and a
    copy into it, then a ``non_blocking`` copy to ``device`` on a side
    stream of this probe's own; each rep is timed up to the
    ``synchronize()`` of that stream's event. It waits on nothing else: it
    may run while a training step is in flight. A failure on the card
    raises (JAX returns ``None`` on a host without an accelerator runtime;
    the port names its device instead). On the CPU the staging converts
    the leaves to tensors and waits on nothing."""
    import torch

    from petastorm_tpu_torch.torch_utils import stage_to_device
    stream = (torch.cuda.Stream(device=device) if device.type == 'cuda'
              else None)

    def stage_once():
        staged, event = stage_to_device(columns, device, stream)
        if event is not None:
            event.synchronize()
        return staged

    stage_once()                                        # warm
    payload_bytes = sum(getattr(v, 'nbytes', 0) for v in columns.values())
    elapsed = None
    for _ in range(PROBE_REPS):
        start = time.perf_counter()
        stage_once()
        took = time.perf_counter() - start
        elapsed = took if elapsed is None else min(elapsed, took)
    return {
        'rows': rows,
        'payload_bytes': int(payload_bytes),
        'seconds': round(elapsed, 6),
        'rows_per_s': round(rows / elapsed, 1) if elapsed else None,
        'mb_per_s': round(payload_bytes / _MB / elapsed, 1)
        if elapsed else None,
        'device': device_name(device),
    }


def calibrate(dataset_path, pieces, schema, sample_row_groups: int = 3,
              cache_dir: Optional[str] = None, save: bool = True,
              device=None) -> dict:
    """Run every micro-probe against ``sample_row_groups`` row groups of the
    actual dataset and return (and, with ``save``, cache) the calibration
    artifact (JAX :570). All ceilings are rows/sec for THIS dataset's rows
    on THIS host, per stage and single-stream (the advisor's model scales
    them); the staging ceiling is to ``device`` (CUDA unless ``'cpu'``)."""
    device, name = _resolve(device)
    digest = dataset_digest(pieces, schema)
    sampled = _sample_pieces(pieces, sample_row_groups)
    storage = _probe_storage(sampled)
    decode = _probe_decode(sampled, schema)
    columns, sample_rows = _decode_sample_columns(sampled, schema)
    serialize = _probe_serialize(columns, sample_rows)
    stage = _probe_device_stage(columns, sample_rows, device)
    total_rows = sum(max(0, p.num_rows) for p in pieces)
    # the fastest of the open modes is the storage ceiling: the roofline
    # must not punish a dataset for the mode it does not use
    io_rates = [r for r in (storage.get('parquet_rows_per_s'),
                            storage.get('parquet_pre_buffer_rows_per_s'),
                            storage.get('parquet_ranged_rows_per_s'))
                if r]
    ceilings = {
        'io': max(io_rates) if io_rates else None,
        'decode': decode.get('rows_per_s'),
        'serialize': serialize.get('rows_per_s'),
        'device_stage': stage.get('rows_per_s'),
        'device_decode': None,
        'ingest': None,
    }
    calibration = {
        'kind': CALIBRATION_KIND,
        'probe_version': PROBE_SCHEMA_VERSION,
        'host': socket.gethostname(),
        'cpu_count': os.cpu_count() or 1,
        'device': name,
        'dataset_path': str(dataset_path),
        'dataset_digest': digest,
        # deliberate wall clock: artifact timestamp for humans, never
        # compared against monotonic readings
        'written_at': time.time(),
        'sampled_row_groups': len(sampled),
        'sampled_rows': decode['rows'],
        'total_rows': total_rows,
        'rows_per_group': (decode['rows'] / len(sampled)) if sampled else 0,
        'probes': {
            'storage': storage,
            'decode': decode,
            'serialize': serialize,
            'device_stage': stage,
            'device_decode': None,
            'ingest': None,
        },
        'ceilings': ceilings,
    }
    if save:
        try:
            save_calibration(calibration, cache_dir)
        except OSError:
            logger.warning('could not cache calibration artifact',
                           exc_info=True)
    return calibration


def get_calibration(dataset_path, pieces, schema, mode: str = 'auto',
                    sample_row_groups: int = 3,
                    cache_dir: Optional[str] = None,
                    device=None) -> Optional[dict]:
    """Resolve a calibration per ``mode`` (JAX :643): ``'cached'`` loads the
    artifact of ``device`` or returns ``None`` (never probes — safe for hot
    paths and HTTP handlers that must stay cheap); ``'auto'`` loads it and
    probes on a miss; ``'force'`` always re-probes."""
    if mode not in ('cached', 'auto', 'force'):
        raise ValueError("calibration mode must be 'cached', 'auto' or "
                         "'force'; got {!r}".format(mode))
    device, name = _resolve(device)
    digest = dataset_digest(pieces, schema)
    if mode in ('cached', 'auto'):
        cal = load_calibration(digest, name, cache_dir)
        if cal is not None or mode == 'cached':
            return cal
    return calibrate(dataset_path, pieces, schema,
                     sample_row_groups=sample_row_groups,
                     cache_dir=cache_dir, device=device)


# ---------------------------------------------------------------------------
# overlap-aware attribution
# ---------------------------------------------------------------------------

def interval_union(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals. THE
    attribution primitive: two overlapped 1s decode spans are 1s of decode
    wall, not 2 — summing stage durations double-counts exactly the overlap
    the pipeline exists to create."""
    merged = 0.0
    current_start = current_end = None
    # normalize BEFORE sorting: a reversed (end, start) tuple sorted raw
    # breaks the merge invariant (its true start can precede tuples already
    # consumed)
    for start, end in sorted((e, s) if e < s else (s, e)
                             for s, e in intervals):
        if current_end is None:
            current_start, current_end = start, end
        elif start > current_end:
            merged += current_end - current_start
            current_start, current_end = start, end
        elif end > current_end:
            current_end = end
    if current_end is not None:
        merged += current_end - current_start
    return merged


def attribute(spans: Sequence, wall_s: Optional[float] = None,
              snapshot: Optional[dict] = None) -> dict:
    """Per-stage busy/idle attribution from recorded span tuples
    (``Tracer.spans()``: ``(name, cat, start_s, dur_s, pid, tid, args)``).

    Per stage, the busy time is the **interval union** of that stage's
    spans across every track; ``busy_fraction`` divides by the observed
    wall (max span end − min span start unless ``wall_s`` is given). The
    ``critical`` stage is the busiest non-idle stage — with overlap, stage
    fractions do not sum to 1, and the binding constraint is whichever
    stage the wall clock cannot escape. ``overlap_s`` quantifies the win:
    sum of stage busy times minus their global union (0 = fully serial).

    With no spans (tracing off) and a ``snapshot``, falls back to the
    aggregate ``ReaderStats`` stage times — flagged ``'source':
    'snapshot'``, since aggregate sums cannot see overlap across workers.
    """
    spans = list(spans or ())
    if not spans:
        out = {'source': 'snapshot', 'wall_s': None, 'stages': {},
               'critical_stage': None, 'overlap_s': None}
        if snapshot:
            wall = snapshot.get('window_s') or wall_s
            out['wall_s'] = wall
            from petastorm_tpu_torch.workers.stats import effective_io_s
            # same canonical stage names as the spans path, so consumers
            # can join stages[critical_stage] regardless of trace mode;
            # these sum ACROSS workers, so fractions can exceed 1 (flagged
            # by source='snapshot' — only spans see overlap)
            named = {
                'io': effective_io_s(snapshot),
                'decode': snapshot.get('worker_decode_s', 0.0),
                'serialize': snapshot.get('serialize_s', 0.0),
                'deserialize': snapshot.get('deserialize_s', 0.0),
                'device_stage': snapshot.get('device_stage_s', 0.0),
                'consumer_wait': (snapshot.get('queue_wait_s', 0.0)
                                  + snapshot.get('worker_publish_wait_s',
                                                 0.0)),
            }
            for stage, busy in named.items():
                if busy:
                    out['stages'][stage] = {
                        'busy_s': round(busy, 4),
                        'busy_fraction': round(busy / wall, 4)
                        if wall else None,
                    }
            active = {stage: busy for stage, busy in named.items()
                      if busy and stage not in IDLE_ATTRIBUTION_STAGES}
            if active:
                out['critical_stage'] = max(active, key=active.get)
        return out

    by_stage: Dict[str, List[Tuple[float, float]]] = {}
    starts, ends = [], []
    everything = []
    for name, cat, start_s, dur_s, _pid, _tid, _args in spans:
        stage = SPAN_STAGE.get(name, cat or 'other')
        end = start_s + max(0.0, dur_s)
        by_stage.setdefault(stage, []).append((start_s, end))
        everything.append((start_s, end))
        starts.append(start_s)
        ends.append(end)
    wall = wall_s if wall_s else (max(ends) - min(starts))
    stages = {}
    busy_sum = 0.0
    for stage, intervals in sorted(by_stage.items()):
        busy = interval_union(intervals)
        stages[stage] = {
            'spans': len(intervals),
            'busy_s': round(busy, 4),
            'busy_fraction': round(busy / wall, 4) if wall else None,
        }
        if stage not in IDLE_ATTRIBUTION_STAGES:
            busy_sum += busy
    active = {stage: info['busy_s'] for stage, info in stages.items()
              if stage not in IDLE_ATTRIBUTION_STAGES}
    critical = max(active, key=active.get) if active else None
    return {
        'source': 'spans',
        'wall_s': round(wall, 4),
        'stages': stages,
        'critical_stage': critical,
        # how much stage work ran concurrently: serial sum minus the union
        'overlap_s': round(max(0.0, busy_sum - interval_union(everything)), 4),
    }


# ---------------------------------------------------------------------------
# throughput model + roofline profile
# ---------------------------------------------------------------------------

def predict_throughput(ceilings: dict, workers: int = 1,
                       cpu_count: Optional[int] = None,
                       io_overlap: bool = False,
                       in_process: bool = True,
                       cached: bool = False,
                       worker_efficiency: float = 1.0) -> Optional[float]:
    """Predicted samples/s from calibrated single-stream ceilings.

    The model (docs/profiling.md "Attribution math"):

    - decode scales with effective parallel workers ``min(workers,
      cpu_count)`` (workers beyond cores time-slice, they do not add
      decode), damped by ``worker_efficiency`` — the *measured* marginal
      value of each extra worker. ``1.0`` is ideal scaling (the default);
      ``0.0`` means extra workers add nothing; **negative** values model
      a GIL convoy (sub-GIL-quantum decode calls make thread workers
      serialize on the lock instead of the codecs, so a second worker is
      slower than one). Effective parallelism is
      ``1 + worker_efficiency * (eff_workers - 1)``, floored at 0.05 so a
      pathological factor predicts "much slower", never zero;
    - storage is a shared resource (no worker scaling);
    - without readahead a worker serializes read→decode, so the combined
      rate is harmonic (``1/(1/io + 1/decode)``); with ``io_overlap``
      (readahead) it is ``min(io, decode)``;
    - process pools additionally cap at the serializer ceiling,
      in-process pools skip that stage;
    - device staging caps everything (it is downstream of any cache);
    - ``cached`` (warm shared/local tier) skips io+decode entirely.

    Monotone in ``workers`` by construction **for non-negative
    worker_efficiency** — every term is then nondecreasing in the
    effective worker count (the advisor's monotonicity contract, asserted
    in tests). A negative measured factor deliberately breaks monotonicity:
    that is the point (the model must be able to predict that removing a
    worker is the winning move).
    """
    io = ceilings.get('io')
    decode = ceilings.get('decode')
    caps = []
    if not cached:
        eff = max(1, min(workers, cpu_count or workers))
        parallel = max(0.05, 1.0 + worker_efficiency * (eff - 1))
        scaled_decode = decode * parallel if decode else None
        if io and scaled_decode:
            if io_overlap:
                caps.append(min(io, scaled_decode))
            else:
                caps.append(1.0 / (1.0 / io + 1.0 / scaled_decode))
        elif scaled_decode:
            caps.append(scaled_decode)
        elif io:
            caps.append(io)
    if not in_process and ceilings.get('serialize'):
        caps.append(ceilings['serialize'])
    if ceilings.get('device_stage'):
        caps.append(ceilings['device_stage'])
    if not caps and cached:
        # no post-cache stage was calibrated (in-process pool, no staging
        # probe): the measurable FLOOR is the best
        # uncached configuration — a warm cache can only beat it, so the
        # model must not predict nothing at all
        return predict_throughput(ceilings, workers=cpu_count or workers,
                                  cpu_count=cpu_count, io_overlap=True,
                                  in_process=in_process, cached=False)
    if not caps:
        return None
    return min(caps)


def measured_worker_efficiency(measured_samples_per_s,
                               decode_ceiling,
                               workers: int) -> Optional[float]:
    """The per-worker efficiency factor implied by a *measured* rate on a
    decode-bound pipeline: solve ``measured = ceiling * (1 + e*(w-1))`` for
    ``e``, clamped to ``[-1, 1]``. ``None`` when underdetermined (one
    worker, or no decode ceiling) — with one worker the marginal value of a
    second is unknowable until tried, which is exactly why the autotune
    controller pairs this model with revert-on-regression.

    This is how a GIL convoy (two workers measuring below one worker's
    share of the decode ceiling) becomes representable: the implied ``e``
    is strongly negative, and the model then predicts the *removal* of a
    worker as a gain (see :func:`replay_against_artifacts`)."""
    if workers is None or workers <= 1:
        return None
    if not decode_ceiling or not measured_samples_per_s:
        return None
    e = (measured_samples_per_s / decode_ceiling - 1.0) / (workers - 1)
    return max(-1.0, min(1.0, e))


def build_profile(snapshot: dict, calibration: Optional[dict] = None,
                  spans: Optional[Sequence] = None,
                  samples_per_sec: Optional[float] = None,
                  workers_count: Optional[int] = None,
                  io_readahead=0, pool_type: str = 'thread',
                  cache_type: str = 'null') -> dict:
    """Assemble the roofline profile: measured rate, calibrated ceilings,
    the binding stage, the %-of-ceiling verdict, overlap-aware attribution,
    and the advisor's ranked recommendations. Everything JSON-able."""
    measured = samples_per_sec
    estimated = False
    if measured is None:
        items_per_s = snapshot.get('items_per_s') or 0.0
        rows_per_group = (calibration or {}).get('rows_per_group') or 0
        if items_per_s and rows_per_group:
            # the stats layer counts published items (row groups for
            # columnar/batch readers); scale by the calibrated mean rows
            # per group to talk samples/s like the benchmarks do
            measured = items_per_s * rows_per_group
            estimated = True
        else:
            measured = items_per_s
    profile = {
        'kind': 'petastorm_tpu_roofline_profile',
        'measured_samples_per_s': round(measured, 2) if measured else 0.0,
        'measured_is_estimated_from_items': estimated,
        'attribution': attribute(spans, snapshot=snapshot),
        'config': {'workers_count': workers_count,
                   'io_readahead': io_readahead,
                   'pool_type': pool_type,
                   'cache_type': cache_type},
    }
    if calibration is None:
        profile['calibrated'] = False
        profile['ceilings'] = {}
        profile['binding_stage'] = None
        profile['roofline_fraction'] = None
        return profile
    ceilings = dict(calibration.get('ceilings') or {})
    in_process = pool_type != 'process'
    workers = max(1, workers_count or 1)
    cpu_count = calibration.get('cpu_count') or 1
    io_overlap = bool(io_readahead) \
        or snapshot.get('io_overlap_fraction', 0.0) > 0.5
    # A warm cache legitimately skips the io+decode the ceilings measure:
    # when the snapshot proves the reads were mostly cache hits, judge
    # against the post-cache stages instead.
    hits = snapshot.get('shared_hits', 0)
    misses = snapshot.get('shared_misses', 0)
    cache_warm = (cache_type == 'shared' and hits + misses > 0
                  and hits / (hits + misses) > 0.5)
    # effective per-stage ceilings for THIS configuration: decode scaled by
    # usable workers, serializer dropped for in-process pools, io+decode
    # dropped for a proven-warm cache
    effective = {}
    if not cache_warm:
        if ceilings.get('io'):
            effective['io'] = ceilings['io']
        if ceilings.get('decode'):
            effective['decode'] = \
                ceilings['decode'] * min(workers, cpu_count)
    if not in_process and ceilings.get('serialize'):
        effective['serialize'] = ceilings['serialize']
    if ceilings.get('device_stage'):
        effective['device_stage'] = ceilings['device_stage']
    if cache_warm and not effective:
        # no post-cache stage was calibrated (in-process pool, no staging
        # probe): fall back to the uncached ceilings so the verdict
        # stays defined — a warm cache legitimately exceeding them gets
        # the benign cache-replay warning below, not a None binding stage
        if ceilings.get('io'):
            effective['io'] = ceilings['io']
        if ceilings.get('decode'):
            effective['decode'] = \
                ceilings['decode'] * min(workers, cpu_count)
    binding = min(effective, key=effective.get) if effective else None
    fraction = None
    if binding and effective[binding]:
        fraction = measured / effective[binding] if measured else 0.0
    predicted = predict_throughput(
        ceilings, workers=workers, cpu_count=cpu_count,
        io_overlap=io_overlap, in_process=in_process, cached=cache_warm)
    profile.update({
        'calibrated': True,
        'cache_warm': cache_warm,
        'calibration_host': calibration.get('host'),
        'dataset_digest': calibration.get('dataset_digest'),
        'cpu_count': cpu_count,
        'ceilings': {k: round(v, 2) for k, v in ceilings.items()
                     if v is not None},
        'effective_ceilings': {k: round(v, 2)
                               for k, v in effective.items()},
        'binding_stage': binding,
        'binding_ceiling_samples_per_s': round(effective[binding], 2)
        if binding else None,
        'roofline_fraction': round(fraction, 4)
        if fraction is not None else None,
        'predicted_samples_per_s': round(predicted, 2)
        if predicted else None,
    })
    if fraction is not None and fraction > SANE_FRACTION_LIMIT:
        if cache_type != 'null':
            # a replaying cache (proven warm, or local-disk whose hits no
            # counter records) is the benign explanation — name it
            # instead of crying broken measurement
            profile['warning'] = (
                'measured rate is {:.1f}x the calibrated {} ceiling; with '
                "cache_type={!r} a cache-replay epoch legitimately beats "
                'the io+decode ceilings — judge cached epochs against the '
                'post-cache stages, not this one'.format(
                    fraction, binding, cache_type))
        else:
            profile['warning'] = (
                'measured rate is {:.1f}x the calibrated {} ceiling — a '
                'sustained pipeline cannot beat its binding stage, so '
                'either the measured window drained pre-decoded buffers '
                '(lengthen it past steady state) or the calibration is '
                "stale (profile(calibrate='force'))".format(
                    fraction, binding))
    profile['advisor'] = advise(profile)
    return profile


def explain(profile: dict) -> str:
    """One human sentence per roofline verdict — what ``reader
    .explain_throughput()`` and the CLI's ``--profile`` print."""
    measured = profile.get('measured_samples_per_s') or 0.0
    if not profile.get('calibrated'):
        return ('measured {:.1f} samples/s; no calibration for this '
                'dataset yet — run reader.profile() (or benchmark/'
                'roofline.py) to measure the per-stage ceilings'
                .format(measured))
    binding = profile.get('binding_stage')
    ceiling = profile.get('binding_ceiling_samples_per_s') or 0.0
    fraction = profile.get('roofline_fraction') or 0.0
    lines = ['measured {:.1f} samples/s = {:.1f}% of the binding stage '
             "({}) ceiling of {:.1f} samples/s".format(
                 measured, 100.0 * fraction, binding, ceiling)]
    if profile.get('warning'):
        lines.append('WARNING: ' + profile['warning'])
    for rec in (profile.get('advisor') or [])[:2]:
        lines.append('try {}: {}'.format(rec['knob'], rec['reason']))
    return '; '.join(lines)


def roofline_gauges(profile: dict) -> dict:
    """The profile as flat metric gauges merged into stats snapshots —
    ``stage_ceiling_<stage>``, ``roofline_fraction`` and the (string-
    valued, label-exported) ``binding_stage`` — so Prometheus scrapes show
    %-of-ceiling next to raw samples/s."""
    gauges = {}
    for stage, value in (profile.get('effective_ceilings') or {}).items():
        gauges['stage_ceiling_{}'.format(stage)] = value
    if profile.get('roofline_fraction') is not None:
        gauges['roofline_fraction'] = profile['roofline_fraction']
    if profile.get('binding_stage'):
        gauges['binding_stage'] = profile['binding_stage']
    if profile.get('measured_samples_per_s') is not None:
        gauges['roofline_samples_per_s'] = profile['measured_samples_per_s']
    return gauges


def roofline_summary(profile: dict) -> dict:
    """The compact roofline section embedded in flight records and
    ``infeed_diagnosis`` output."""
    return {
        'measured_samples_per_s': profile.get('measured_samples_per_s'),
        'binding_stage': profile.get('binding_stage'),
        'binding_ceiling_samples_per_s':
            profile.get('binding_ceiling_samples_per_s'),
        'roofline_fraction': profile.get('roofline_fraction'),
        'critical_stage': (profile.get('attribution') or {})
            .get('critical_stage'),
    }


# ---------------------------------------------------------------------------
# what-if advisor
# ---------------------------------------------------------------------------

def advise(profile: dict, max_workers: Optional[int] = None) -> List[dict]:
    """Ranked knob recommendations with predicted samples/s deltas.

    Each entry: ``{'knob', 'from', 'to', 'predicted_samples_per_s',
    'predicted_delta_pct', 'reason'}``, sorted by predicted delta
    descending; only positive-delta recommendations are emitted. The
    predictions replay :func:`predict_throughput` — the same model the
    roofline verdict uses — so a recommendation can never promise more than
    the calibrated ceilings admit."""
    if not profile.get('calibrated'):
        return []
    ceilings = {k: v for k, v in (profile.get('ceilings') or {}).items()}
    config = profile.get('config') or {}
    workers = max(1, config.get('workers_count') or 1)
    cpu_count = profile.get('cpu_count') or 1
    in_process = config.get('pool_type') != 'process'
    io_overlap = bool(config.get('io_readahead'))
    base = predict_throughput(ceilings, workers=workers, cpu_count=cpu_count,
                              io_overlap=io_overlap, in_process=in_process)
    if not base:
        return []
    recommendations = []

    def consider(knob, from_value, to_value, predicted, reason):
        if predicted is None:
            return
        delta = 100.0 * (predicted - base) / base
        if delta < 1.0:       # sub-percent predictions are noise, not advice
            return
        recommendations.append({
            'knob': knob, 'from': from_value, 'to': to_value,
            'predicted_samples_per_s': round(predicted, 1),
            'predicted_delta_pct': round(delta, 1),
            'reason': reason,
        })

    target_workers = max_workers or cpu_count
    if target_workers > workers:
        predicted = predict_throughput(
            ceilings, workers=target_workers, cpu_count=cpu_count,
            io_overlap=io_overlap, in_process=in_process)
        consider('workers_count', workers, target_workers, predicted,
                 'decode is parallel up to the {} host cores'
                 .format(cpu_count))
    if not io_overlap and ceilings.get('io') and ceilings.get('decode'):
        predicted = predict_throughput(
            ceilings, workers=workers, cpu_count=cpu_count,
            io_overlap=True, in_process=in_process)
        consider('io_readahead', 0, 'auto', predicted,
                 'overlap storage reads with decode instead of serializing '
                 'them per row group')
    if config.get('cache_type') in (None, 'null', 'local-disk'):
        cached = predict_throughput(ceilings, workers=workers,
                                    cpu_count=cpu_count, io_overlap=True,
                                    in_process=in_process, cached=True)
        consider("cache_type='shared'", config.get('cache_type') or 'null',
                 'shared', cached,
                 'epochs 2+ (and every concurrent reader on this host) '
                 'skip io+decode entirely via the host-wide decoded tier')
    if not in_process:
        # the inverse direction: a process pool whose serializer ceiling
        # binds should drop to threads when decode would not regress
        without = predict_throughput(ceilings, workers=workers,
                                     cpu_count=cpu_count,
                                     io_overlap=io_overlap, in_process=True)
        consider("reader_pool_type='thread'", 'process', 'thread', without,
                 'the zero-copy transport ceiling binds before decode does')
    recommendations.sort(key=lambda r: -r['predicted_delta_pct'])
    return recommendations


# ---------------------------------------------------------------------------
# model validation against the committed BENCH artifacts
# ---------------------------------------------------------------------------

def replay_against_artifacts(root: Optional[str] = None) -> List[dict]:
    """Directional validation of the advisor's model against committed BENCH
    artifacts: each check replays the model on a measured configuration pair
    and verifies the model predicts the direction the measurement showed.
    Returns ``[{'check', 'artifact', 'ok', 'detail'}, ...]`` (artifacts
    absent from ``root`` are skipped, not failed — the profiler must work
    outside the repo checkout)."""
    root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checks = []

    def load(name):
        try:
            with open(os.path.join(root, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # BENCH_r07: readahead overlapped a ~1:1 io:decode pipeline. Model:
    # min(io, dec) / harmonic(io, dec) = 2.0 at 1:1 — direction up,
    # bounded by 2 (the model must predict a gain, and not a fantasy one).
    r07 = load('BENCH_r07.json')
    if r07 is not None:
        parsed = r07.get('parsed') or r07
        speedup = (parsed.get('speedup_items_per_s')
                   if isinstance(parsed, dict) else None)
        ceilings = {'io': 100.0, 'decode': 100.0}
        serial = predict_throughput(ceilings, io_overlap=False, cpu_count=1)
        overlapped = predict_throughput(ceilings, io_overlap=True,
                                        cpu_count=1)
        model_gain = overlapped / serial
        ok = 1.0 < model_gain <= 2.0 and (speedup is None or speedup > 1.0)
        checks.append({'check': 'readahead_overlap_direction',
                       'artifact': 'BENCH_r07.json', 'ok': ok,
                       'detail': 'model {:.2f}x vs measured {}x'.format(
                           model_gain, speedup)})
    # BENCH_scaling: flat samples/s curve on a 1-core host. Model with
    # cpu_count=1 must predict zero gain from extra workers.
    scaling = load('BENCH_scaling.json')
    if scaling is not None:
        cpus = scaling.get('host_cpu_count') or 1
        ceilings = {'io': 1e6, 'decode': 100.0}
        one = predict_throughput(ceilings, workers=1, cpu_count=cpus,
                                 io_overlap=True)
        eight = predict_throughput(ceilings, workers=8, cpu_count=cpus,
                                   io_overlap=True)
        ok = (eight <= one * max(1, cpus) + 1e-9) and \
            (cpus != 1 or abs(eight - one) < 1e-9)
        checks.append({'check': 'worker_scaling_bounded_by_cores',
                       'artifact': 'BENCH_scaling.json', 'ok': ok,
                       'detail': 'model predicts {:.1f} -> {:.1f} on a '
                                 '{}-core host'.format(one, eight, cpus)})
    # BENCH_r11: a warm shared-cache pass beat the serial io+decode
    # roofline. Model: cached throughput must be >= the uncached ceiling.
    r11 = load('BENCH_r11.json')
    if r11 is not None:
        roof = (r11.get('roofline') or {}).get('samples_per_sec')
        warm = (r11.get('warm') or {}).get('samples_per_sec')
        ceilings = {'io': 1000.0, 'decode': 500.0, 'device_stage': 50000.0}
        uncached = predict_throughput(ceilings, io_overlap=True, cpu_count=1)
        cached = predict_throughput(ceilings, io_overlap=True, cpu_count=1,
                                    cached=True)
        ok = cached >= uncached and (not roof or not warm or warm >= roof)
        checks.append({'check': 'warm_cache_exceeds_io_decode_roofline',
                       'artifact': 'BENCH_r11.json', 'ok': ok,
                       'detail': 'model cached {:.0f} >= uncached {:.0f}; '
                                 'measured warm {} vs roofline {}'.format(
                                     cached, uncached, warm, roof)})
    # BENCH_r13: 2 thread workers measured slower than 1 on the
    # small-png mnist line (a GIL convoy on short decode calls). With the
    # measured per-worker efficiency factor the model must predict the w2
    # direction DOWN — the honest-measurement note the default ideal-scaling
    # model could not represent (and the regression the autotune
    # controller's revert path exists to undo when it walks into it blind).
    r13 = load('BENCH_r13.json')
    if r13 is not None:
        lines = r13.get('lines') or {}
        w1 = (lines.get('mnist_w1_batched') or {}).get('samples_per_sec')
        w2_line = lines.get('mnist_w2_batched') or {}
        w2 = w2_line.get('samples_per_sec')
        decode_ceiling = ((w2_line.get('roofline') or {})
                          .get('ceilings') or {}).get('decode')
        if w1 and w2 and decode_ceiling:
            efficiency = measured_worker_efficiency(w2, decode_ceiling, 2)
            ceilings = {'io': 10.0 * decode_ceiling,
                        'decode': decode_ceiling}
            base = predict_throughput(ceilings, workers=1, cpu_count=2,
                                      io_overlap=True)
            measured_model = predict_throughput(
                ceilings, workers=2, cpu_count=2, io_overlap=True,
                worker_efficiency=efficiency)
            ideal_model = predict_throughput(ceilings, workers=2,
                                             cpu_count=2, io_overlap=True)
            # the measured factor must flip the predicted direction to
            # match the measurement (down), while the ideal factor still
            # predicts up — proving the knob adds representational power
            # rather than just re-deriving the ideal curve
            ok = (w2 < w1 and measured_model < base
                  and ideal_model > base and efficiency is not None
                  and efficiency < 0)
            checks.append({
                'check': 'gil_convoy_negative_scaling_direction',
                'artifact': 'BENCH_r13.json', 'ok': ok,
                'detail': 'measured w1 {:.0f} -> w2 {:.0f}; implied '
                          'efficiency {:.2f}; model w2 {:.0f} vs w1 {:.0f} '
                          '(ideal-scaling model said {:.0f})'.format(
                              w1, w2, efficiency or 0.0,
                              measured_model or 0.0, base or 0.0,
                              ideal_model or 0.0)})
    return checks
