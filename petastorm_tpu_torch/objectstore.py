"""Object-store read plane: coalesced parallel range reads.

The port's copy of ``petastorm_tpu/objectstore.py`` (the whole module; it
imports no torch). A remote row-group read is a set of byte ranges, one a
column chunk, which the Parquet footer describes exactly:

- :class:`RangePlanner` turns ``(footer metadata, row group, columns)`` into
  the ``(offset, length)`` ranges of the needed column chunks (a chunk
  starts at its dictionary page when one precedes its data pages), merges
  ranges whose gap is at most ``gap_bytes`` (one round trip costs more than
  a small gap re-read) and splits ranges above ``max_range_bytes`` so that
  one large chunk still spreads over the fetch threads.
- :class:`ParallelRangeReader` fetches the planned ranges concurrently
  (bounded fetch threads, each range through its own store handle), each
  range under the retry and hedge of a
  :class:`~petastorm_tpu_torch.resilience.ResilientIO`, so a straggling
  range is hedged alone instead of the whole row group. The fetched
  segments form a random-access :class:`RangeBuffer` that
  ``pq.ParquetFile`` decodes from memory; bytes the plan did not cover are
  fetched inline and counted as ``io_range_fallbacks``, never an error.

A worker picks its plane with the factories' ``remote_read``
(``'ranged' | 'prebuffer' | 'serial'``; None or ``'auto'``: ``prebuffer``
for a remote protocol, ``serial`` for a local one).
"""

from __future__ import annotations

import io
import struct
import threading
import time
from bisect import bisect_right, insort
from typing import Callable, Dict, List, Optional, Tuple

from petastorm_tpu_torch.latency import bucket_index

#: Merge two planned ranges when the gap between them is at most this many
#: bytes: one round trip costs more than re-downloading a small gap.
DEFAULT_GAP_BYTES = 64 * 1024

#: Split a merged range above this size so one giant column chunk still
#: spreads across the in-flight fetch slots.
DEFAULT_MAX_RANGE_BYTES = 8 * 1024 * 1024

#: Bound on concurrently in-flight range fetches per read.
DEFAULT_MAX_IN_FLIGHT = 8

#: First footer fetch size: one tail read this long resolves the footer for
#: almost every real file (a longer footer costs exactly one more fetch).
DEFAULT_FOOTER_BYTES = 64 * 1024

#: Valid ``remote_read`` factory knob values (``None`` = auto).
REMOTE_READ_MODES = ('ranged', 'prebuffer', 'serial')

_PARQUET_MAGIC = b'PAR1'
_FOOTER_LEN = struct.Struct('<I')


def resolve_remote_read(remote_read) -> Optional[str]:
    """Normalize the factory ``remote_read=`` knob: ``None``/``'auto'`` →
    ``None`` (the worker picks per filesystem protocol), otherwise one of
    :data:`REMOTE_READ_MODES`. A typo fails the factory, not the worker."""
    if remote_read is None or remote_read == 'auto':
        return None
    if remote_read in REMOTE_READ_MODES:
        return remote_read
    raise ValueError("remote_read must be one of {} or None/'auto', got "
                     '{!r}'.format(list(REMOTE_READ_MODES), remote_read))


class RangePlanner:
    """Plan a row-group read as explicit byte ranges from footer metadata.

    Pure computation — no I/O: the planner sees only the
    ``pq.FileMetaData`` the reader already holds, so planning is free to
    run per read.
    """

    def __init__(self, gap_bytes: int = DEFAULT_GAP_BYTES,
                 max_range_bytes: int = DEFAULT_MAX_RANGE_BYTES):
        if gap_bytes < 0:
            raise ValueError('gap_bytes must be >= 0, got '
                             '{}'.format(gap_bytes))
        if max_range_bytes < 1:
            raise ValueError('max_range_bytes must be >= 1, got '
                             '{}'.format(max_range_bytes))
        self.gap_bytes = gap_bytes
        self.max_range_bytes = max_range_bytes

    @staticmethod
    def column_chunk_ranges(metadata, row_group: int,
                            columns: Optional[List[str]] = None
                            ) -> List[Tuple[int, int]]:
        """``(offset, length)`` of every needed column chunk of one row
        group. A chunk starts at its dictionary page when one precedes the
        data pages (the same rule pyarrow's own ``pre_buffer`` coalescing
        applies) and spans ``total_compressed_size``. ``columns`` selects by
        top-level name (nested paths like ``a.list.item`` belong to ``a``);
        ``None`` takes every chunk."""
        wanted = None if columns is None else {c.split('.')[0]
                                               for c in columns}
        rg = metadata.row_group(row_group)
        ranges = []
        for i in range(rg.num_columns):
            chunk = rg.column(i)
            if wanted is not None \
                    and chunk.path_in_schema.split('.')[0] not in wanted:
                continue
            start = chunk.data_page_offset
            dict_off = chunk.dictionary_page_offset
            if dict_off is not None and 0 < dict_off < start:
                start = dict_off
            length = chunk.total_compressed_size
            if length > 0:
                ranges.append((int(start), int(length)))
        return sorted(ranges)

    def merge(self, ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        """Coalesce sorted ``(offset, length)`` ranges whose gap is at most
        ``gap_bytes``, then split results above ``max_range_bytes``."""
        merged: List[List[int]] = []
        for offset, length in sorted(ranges):
            if merged and offset - (merged[-1][0] + merged[-1][1]) \
                    <= self.gap_bytes:
                end = max(merged[-1][0] + merged[-1][1], offset + length)
                merged[-1][1] = end - merged[-1][0]
            else:
                merged.append([offset, length])
        out: List[Tuple[int, int]] = []
        for offset, length in merged:
            while length > self.max_range_bytes:
                out.append((offset, self.max_range_bytes))
                offset += self.max_range_bytes
                length -= self.max_range_bytes
            out.append((offset, length))
        return out

    def plan(self, metadata, row_group: int,
             columns: Optional[List[str]] = None) -> List[Tuple[int, int]]:
        """The merged fetch plan for one row-group read."""
        return self.merge(self.column_chunk_ranges(metadata, row_group,
                                                   columns))

    @staticmethod
    def wasted_bytes(chunks: List[Tuple[int, int]],
                     plan: List[Tuple[int, int]]) -> int:
        """Gap bytes the merged ``plan`` fetches beyond the raw ``chunks``
        (the documented price of coalescing, reported per read)."""
        return (sum(n for _, n in plan) - sum(n for _, n in chunks))


class RangeBuffer:
    """Random-access read-only file over fetched ``(offset, bytes)``
    segments, with an inline fetch fallback for uncovered bytes.

    The fetch threads :meth:`insert` concurrently while pyarrow reads are
    not yet running; once :class:`ParallelRangeReader` hands the buffer to
    ``pq.ParquetFile`` only the reading thread touches it (the lock is kept
    because a fallback fetch mid-read also inserts). Uncovered reads call
    ``fetch_fn(offset, length)`` — the same resilient ranged read the
    planned segments used — and are tallied via ``on_fallback``.
    """

    def __init__(self, size: int,
                 fetch_fn: Callable[[int, int], bytes],
                 on_fallback: Optional[Callable[[int], None]] = None):
        self._size = int(size)
        self._fetch = fetch_fn
        self._on_fallback = on_fallback
        self._mutex = threading.Lock()
        self._starts: List[int] = []
        self._segments: Dict[int, bytes] = {}
        self._pos = 0
        self._closed = False

    # -- segment bookkeeping ---------------------------------------------------

    def insert(self, offset: int, data: bytes) -> None:
        with self._mutex:
            if offset in self._segments:
                if len(data) > len(self._segments[offset]):
                    self._segments[offset] = data
                return
            insort(self._starts, offset)
            self._segments[offset] = data

    def _covering_locked(self, offset: int) -> Optional[Tuple[int, bytes]]:
        """The segment containing ``offset``, or ``None``."""
        i = bisect_right(self._starts, offset) - 1
        if i < 0:
            return None
        start = self._starts[i]
        data = self._segments[start]
        if offset < start + len(data):
            return start, data
        return None

    def _next_start_locked(self, offset: int) -> int:
        i = bisect_right(self._starts, offset)
        return self._starts[i] if i < len(self._starts) else self._size

    # -- file protocol ---------------------------------------------------------

    def read(self, nbytes: int = -1) -> bytes:
        if nbytes is None or nbytes < 0:
            nbytes = self._size - self._pos
        nbytes = max(0, min(nbytes, self._size - self._pos))
        parts = []
        pos = self._pos
        remaining = nbytes
        while remaining > 0:
            with self._mutex:
                hit = self._covering_locked(pos)
                gap_end = (self._next_start_locked(pos) if hit is None
                           else None)
            if hit is not None:
                start, data = hit
                lo = pos - start
                take = min(remaining, len(data) - lo)
                parts.append(data[lo:lo + take])
            else:
                # uncovered bytes: fetch exactly the missing sub-range (to
                # the next known segment) through the resilient range read
                take = min(remaining, gap_end - pos)
                data = self._fetch(pos, take)
                if self._on_fallback is not None:
                    self._on_fallback(take)
                self.insert(pos, data)
                parts.append(data[:take])
            pos += take
            remaining -= take
        self._pos = pos
        return b''.join(parts)

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self._size + offset
        else:
            raise ValueError('invalid whence {!r}'.format(whence))
        self._pos = max(0, min(self._pos, self._size))
        return self._pos

    def tell(self) -> int:
        return self._pos

    def size(self) -> int:
        return self._size

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True


class ParallelRangeReader:
    """Coalesced parallel row-group reads over one (possibly fault-wrapped)
    filesystem.

    One instance per worker, shared by the worker thread and its readahead
    thread (all mutable state — the footer cache and the event tallies — is
    lock-protected; every read call builds its own :class:`RangeBuffer` and
    ``pq.ParquetFile``, and every range fetch opens its own store handle,
    so no file handle ever serves two concurrent reads).

    :param filesystem: fsspec-like filesystem (``open``/``size``); chaos and
        trace-replay wrappers apply per range because every range goes
        through ``filesystem.open``.
    :param resilience: optional
        :class:`petastorm_tpu_torch.resilience.ResilientIO`; when set, EVERY range
        fetch runs under its retry (outer) and hedge (inner) layers — the
        per-request discipline that makes hedging cheap (a straggler range
        is duplicated alone, not the whole row group).
    :param max_in_flight: concurrent range fetches per row-group read.
    :param observe_spans: record one ``range_fetch`` span tuple per
        :meth:`fetch_range` (retry count annotated; the hedge layer's
        per-attempt spans come from ``ResilientIO.take_spans``). Off by
        default; a worker opts in when its reader traces (unless
        ``PETASTORM_TPU_PODOBS=0``).
    :param observe_latency: feed each :meth:`fetch_range` duration into an
        internal ``io_range`` latency delta, drained by
        :meth:`take_latency` (the ``LatencyDeltas.drain`` shape).
    """

    #: Bound on undrained ``range_fetch`` spans (a construction that never
    #: drains must not grow without limit).
    MAX_PENDING_SPANS = 2048

    def __init__(self, filesystem, resilience=None,
                 gap_bytes: int = DEFAULT_GAP_BYTES,
                 max_range_bytes: int = DEFAULT_MAX_RANGE_BYTES,
                 max_in_flight: int = DEFAULT_MAX_IN_FLIGHT,
                 footer_bytes: int = DEFAULT_FOOTER_BYTES,
                 observe_spans: bool = False,
                 observe_latency: bool = False):
        if max_in_flight < 1:
            raise ValueError('max_in_flight must be >= 1, got '
                             '{}'.format(max_in_flight))
        self._fs = filesystem
        self._resilience = resilience
        self._planner = RangePlanner(gap_bytes=gap_bytes,
                                     max_range_bytes=max_range_bytes)
        self._max_in_flight = max_in_flight
        self._footer_bytes = max(16, footer_bytes)
        self._mutex = threading.Lock()
        # path -> (file size, FileMetaData, footer tail (offset, bytes))
        self._footers: Dict[str, Tuple[int, object, Tuple[int, bytes]]] = {}
        self._events: Dict[str, int] = {}
        self._observe_spans = bool(observe_spans)
        self._observe_latency = bool(observe_latency)
        # (name, cat, start_s, dur_s, args) tuples; accumulated under the
        # mutex because fetch_range runs on the worker thread, the
        # readahead thread AND the per-call pump threads
        self._spans: list = []
        # {'io_range': {'buckets': {index: n}, 'sum': s, 'count': n}} — the
        # LatencyDeltas entry shape, mergeable by bucket addition
        self._latency: Dict[str, dict] = {}

    # -- events ----------------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        with self._mutex:
            self._events[name] = self._events.get(name, 0) + n

    def take_events(self) -> Dict[str, int]:
        """Drain accumulated ``io_range_*`` counter deltas (worker thread
        only — the same discipline as ``ResilientIO.take_events``)."""
        with self._mutex:
            events, self._events = self._events, {}
        return events

    def _observe_fetch(self, offset: int, length: int, start_s: float,
                       retries: int, error: Optional[str]) -> None:
        """Record one finished :meth:`fetch_range` into the span/latency
        accumulators (mutex-guarded: callers include pump threads)."""
        dur_s = time.perf_counter() - start_s
        span = None
        if self._observe_spans:
            args: dict = {'offset': offset, 'length': length}
            if retries:
                args['retries'] = retries
            if error is not None:
                args['error'] = error
            span = ('range_fetch', 'io', start_s, dur_s, args)
        with self._mutex:
            if span is not None:
                self._spans.append(span)
                if len(self._spans) > self.MAX_PENDING_SPANS:
                    del self._spans[:len(self._spans)
                                    - self.MAX_PENDING_SPANS]
            if self._observe_latency:
                entry = self._latency.get('io_range')
                if entry is None:
                    entry = self._latency['io_range'] = {
                        'buckets': {}, 'sum': 0.0, 'count': 0}
                index = bucket_index(dur_s)
                entry['buckets'][index] = entry['buckets'].get(index, 0) + 1
                entry['sum'] += dur_s
                entry['count'] += 1

    def take_spans(self) -> list:
        """Drain accumulated ``range_fetch`` span tuples (worker thread
        only; empty unless ``observe_spans=True``)."""
        with self._mutex:
            spans, self._spans = self._spans, []
        return spans

    def take_latency(self) -> Optional[Dict[str, dict]]:
        """Drain the accumulated ``io_range`` latency deltas (worker thread
        only; ``None`` unless ``observe_latency=True`` and data exists).
        Shape matches ``LatencyDeltas.drain`` — absorb with
        ``LatencyDeltas.absorb`` or ``PipelineLatency.merge_deltas``."""
        with self._mutex:
            if not self._latency:
                return None
            latency, self._latency = self._latency, {}
        return latency

    # -- range fetch -----------------------------------------------------------

    def _fetch_once(self, path: str, offset: int, length: int) -> bytes:
        """One ranged GET through a fresh store handle (short reads are
        drained — fsspec files may return less than asked)."""
        with self._fs.open(path, 'rb') as f:
            f.seek(offset)
            parts = []
            remaining = length
            while remaining > 0:
                chunk = f.read(remaining)
                if not chunk:
                    break
                parts.append(chunk)
                remaining -= len(chunk)
        return b''.join(parts)

    def fetch_range(self, path: str, offset: int, length: int) -> bytes:
        """One resilient ranged read: retry + hedge apply to THIS range.
        With the observe flags set, the whole resilient call (hedges and
        retries included — the latency the pipeline actually saw) lands as
        one ``range_fetch`` span / ``io_range`` latency observation."""
        def fetch():
            return self._fetch_once(path, offset, length)
        self._count('io_range_requests')
        self._count('io_range_bytes', length)
        observing = self._observe_spans or self._observe_latency
        if not observing:
            if self._resilience is not None and self._resilience.enabled:
                return self._resilience.read(
                    fetch, description='range_read({}@{}+{})'.format(
                        path, offset, length))
            return fetch()
        retries = [0]
        start_s = time.perf_counter()
        try:
            if self._resilience is not None and self._resilience.enabled:
                def on_retry(exc, attempt):
                    retries[0] += 1
                result = self._resilience.read(
                    fetch, on_retry=on_retry,
                    description='range_read({}@{}+{})'.format(
                        path, offset, length))
            else:
                result = fetch()
        except Exception as e:
            self._observe_fetch(offset, length, start_s, retries[0],
                                type(e).__name__)
            raise
        self._observe_fetch(offset, length, start_s, retries[0], None)
        return result

    # -- footer / metadata -----------------------------------------------------

    def _file_size(self, path: str) -> int:
        size = getattr(self._fs, 'size', None)
        if callable(size):
            got = size(path)
            if got is not None:
                return int(got)
        return int(self._fs.info(path)['size'])

    def file_metadata(self, path: str):
        """``(size, pq.FileMetaData, (tail_offset, tail_bytes))`` for
        ``path``, resolved once per file from at most two tail fetches and
        cached (the object-store footer-cache idiom)."""
        with self._mutex:
            cached = self._footers.get(path)
        if cached is not None:
            return cached
        import pyarrow.parquet as pq
        size = self._file_size(path)
        tail_len = min(size, self._footer_bytes)
        tail = self.fetch_range(path, size - tail_len, tail_len)
        if len(tail) < 8 or tail[-4:] != _PARQUET_MAGIC:
            raise IOError('not a parquet file (bad trailing magic): '
                          '{}'.format(path))
        footer_len = _FOOTER_LEN.unpack(tail[-8:-4])[0] + 8
        if footer_len > tail_len:
            # rare long footer: one more exact fetch
            tail_len = min(size, footer_len)
            tail = self.fetch_range(path, size - tail_len, tail_len)
        metadata = pq.read_metadata(io.BytesIO(tail))
        entry = (size, metadata, (size - tail_len, tail))
        with self._mutex:
            self._footers.setdefault(path, entry)
        return entry

    # -- the read --------------------------------------------------------------

    def _fetch_into(self, path: str, plan: List[Tuple[int, int]],
                    buffer: RangeBuffer) -> None:
        """Fetch every planned range into ``buffer``, ``max_in_flight`` at a
        time. Fetch threads are per-call and joined before return — no
        persistent pool, nothing to leak at worker shutdown (the hedge
        layer's own race threads are drained by ``ResilientIO.drain``)."""
        if len(plan) == 1 or self._max_in_flight == 1:
            for offset, length in plan:
                buffer.insert(offset, self.fetch_range(path, offset, length))
            return
        work = list(plan)
        errors: List[BaseException] = []

        def pump():
            while True:
                with self._mutex:
                    if not work or errors:
                        return
                    offset, length = work.pop()
                try:
                    buffer.insert(offset,
                                  self.fetch_range(path, offset, length))
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    with self._mutex:
                        errors.append(e)
                    return

        threads = [threading.Thread(
            target=pump, daemon=True,
            name='petastorm-torch-rangeio-{}'.format(i))
            for i in range(min(self._max_in_flight, len(plan)))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        if errors:
            raise errors[0]

    def fetch_row_group_bytes(self, path: str, row_group: int,
                              columns: Optional[List[str]] = None) -> int:
        """Fetch (and discard) the planned ranges for one row group; returns
        the planned byte count. This is the raw-ingest probe the profiler
        and the object-store benchmark time: parallel range throughput with
        no parquet assembly — the ceiling ranged row-group reads run
        under."""
        size, metadata, _tail = self.file_metadata(path)
        plan = self._planner.plan(metadata, row_group, columns)
        buffer = RangeBuffer(size,
                             lambda off, n: self.fetch_range(path, off, n))
        self._fetch_into(path, plan, buffer)
        return sum(length for _, length in plan)

    def read_row_group(self, path: str, row_group: int,
                       columns: Optional[List[str]] = None):
        """Read one row group as a ``pa.Table`` via planned parallel range
        fetches. ``columns=None`` reads every column."""
        import pyarrow.parquet as pq
        size, metadata, (tail_offset, tail) = self.file_metadata(path)
        chunks = self._planner.column_chunk_ranges(metadata, row_group,
                                                  columns)
        plan = self._planner.merge(chunks)
        buffer = RangeBuffer(
            size, lambda off, n: self.fetch_range(path, off, n),
            on_fallback=lambda n: self._count('io_range_fallbacks'))
        # the cached footer tail serves pyarrow's own footer reads for free
        buffer.insert(tail_offset, tail)
        self._fetch_into(path, plan, buffer)
        self._count('io_ranged_reads')
        wasted = self._planner.wasted_bytes(chunks, plan)
        if wasted:
            self._count('io_range_wasted_bytes', wasted)
        try:
            pf = pq.ParquetFile(buffer, metadata=metadata)
        except TypeError:   # pyarrow predating the metadata kwarg
            pf = pq.ParquetFile(buffer)
        table = pf.read_row_group(row_group, columns=columns)
        return table
