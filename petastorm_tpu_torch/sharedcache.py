"""Host-wide tiered cache of decoded row groups.

The port's copy of ``petastorm_tpu/sharedcache.py``, tiers 0 and 1. Every
reader on a host (and each of its worker processes) that names one cache
root attaches to the same tiers, so a row group is read and decoded once
per host:

- **Tier 0, shared memory.** Decoded payloads are published as segment
  files in ``/dev/shm/petastorm-tpu-<md5(root)[:12]>`` (under the root
  when there is no ``/dev/shm``) and attached by ``mmap``. An arrow table
  is an Arrow IPC stream, anything else pickle protocol 5 whose large
  buffers are frames of their own: on a hit they come back as **read-only**
  numpy views over the mapping, with no read and no decode.
- **Tier 1, disk.** Segments that tier 0 evicts spill to ``<root>/disk`` in
  the same format; a tier-1 hit is promoted back to tier 0.

Readers never lock: a writer publishes a whole file with ``os.replace``.
The first process to miss a key takes a lock file (``os.link`` of a file
that already names its holder) and fills it; the others wait for its
segment. A lock whose holder is dead, or older than ``lock_timeout_s``, is
stolen. Attaching a segment drops a pin file naming the pid; eviction
skips pinned segments, and a dead pid's pins expire on sight. Each segment
has a sized header and a trailer magic, so a truncated one is dropped and
refilled, never served. The byte format, the directory names and the kill
switch are the JAX package's, so a root filled by either package serves
the other.

A publish that fails (``OSError``, a payload that does not serialize)
serves the filled value as it is and counts ``shared_put_failures``; the
``cache-enospc`` chaos scenario raises ``ENOSPC`` there (JAX
``sharedcache.py:1156-1180``).

Kill switch: ``PETASTORM_TPU_SHARED_CACHE=0`` makes ``cache_type='shared'``
a :class:`~petastorm_tpu_torch.cache.NullCache`: no attachment, no files.

The pod tier (JAX ``sharedcache.py:539-600, 952-1222, 1353-1460``): a
root that calls :meth:`SharedRowGroupCache.serve_peers` answers ``GET
/peercache/<digest>`` on ``127.0.0.1`` with the raw bytes of a resident
segment (:class:`PeerCacheServer`; 404 on a miss). A root made with
``peers=['host:port', ...]`` asks its peers on a local miss before it
fills: a fetched segment is validated (header, trailer, frame table),
republished in the local tiers and counted as ``peer_hits``, never
``fills``, so the sum of ``fills`` over a pod's roots counts each row group
decoded once per pod. A peer that errs or times out is skipped for
``peer_dead_cooldown_s`` (``peer_skipped_dead``); a pod that cannot serve
degrades to a local fill, never a failed read. ``peer_hedge_s`` races the
peer fetch against the local fill (a :class:`~petastorm_tpu_torch.
resilience.HedgedRead`; a once-gate keeps the fill single). Each peer
attempt is a ``peer_fetch`` span and latency observation, drained by
:meth:`~SharedRowGroupCache.take_spans` and :meth:`~SharedRowGroupCache.
take_latency` (off under ``PETASTORM_TPU_PODOBS=0``). A peer request
carries the cache's :attr:`~SharedRowGroupCache.trace_id` in
``X-Petastorm-Trace``; the serving side echoes it and stamps
``X-Petastorm-Clock-S`` (:mod:`petastorm_tpu_torch.podobs`).
"""

from __future__ import annotations

import errno
import hashlib
import json
import logging
import mmap
import os
import pickle
import struct
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from petastorm_tpu_torch.cache import CacheBase
from petastorm_tpu_torch.faultfs import maybe_inject_cache_fault
from petastorm_tpu_torch.latency import bucket_index
from petastorm_tpu_torch.podobs import (CLOCK_HEADER, TRACE_HEADER,
                                        new_trace_id, podobs_enabled)

logger = logging.getLogger(__name__)

#: ``0``/``false``/``off``/``no`` turns ``cache_type='shared'`` into a
#: NullCache.
SHARED_CACHE_ENV_VAR = 'PETASTORM_TPU_SHARED_CACHE'

_SEGMENT_MAGIC = b'PTSC'
_SEGMENT_TRAILER = b'CSTP'
_SEGMENT_VERSION = 1
#: Segment payload encodings.
KIND_PICKLE5 = 1     # frames: [pickle stream, out-of-band buffer 0..N]
KIND_ARROW_IPC = 2   # frames: [arrow IPC stream]

_HEADER = struct.Struct('<4sHHI')     # magic, version, kind, nframes
_FRAME_LEN = struct.Struct('<Q')
#: Frames start on 64-byte boundaries: attached arrays are cache-line
#: aligned.
_FRAME_ALIGN = 64

#: Buffers below this pickle in-band: a frame costs more than the copy.
_OOB_THRESHOLD_BYTES = 4096

#: Tier 0's budget when only the disk tier is sized.
_DEFAULT_MEM_LIMIT_BYTES = 1 << 30

#: Attached segments an instance keeps pinned; older ones are unpinned
#: (their mappings live as long as an array refers to them).
_DEFAULT_ATTACH_LIMIT = 16

#: A process rewrites its counter file every N events, and at close.
_COUNTER_FLUSH_EVERY = 32

#: Counter files of dead processes older than this are swept at attach
#: time. Within it, totals accumulate across runs on one root: compare
#: deltas, or use a fresh root.
_COUNTER_TTL_S = 3600.0


def shared_cache_enabled() -> bool:
    """The :data:`SHARED_CACHE_ENV_VAR` kill switch (default: enabled)."""
    return os.environ.get(SHARED_CACHE_ENV_VAR, '1').strip().lower() \
        not in ('0', 'false', 'off', 'no')


class CorruptSegmentError(Exception):
    """A segment file failed validation (truncated or torn); it is dropped
    and refilled, never served."""


def _fs_now(root: str) -> float:
    """The filesystem's "now": the mtime of a fresh probe file. Lock and
    counter ages compare it with mtimes, so both sides read one clock and a
    step of this host's wall clock cannot steal a live lock. Raises
    ``OSError`` when the directory is gone."""
    fd, tmp = tempfile.mkstemp(dir=root, suffix='.clk')
    try:
        os.close(fd)
        return os.stat(tmp).st_mtime
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True      # exists, owned by someone else
    except OSError:
        return False
    return True


# -- segment file format -------------------------------------------------------

def write_segment(path: str, kind: int, frames: List) -> int:
    """Publish ``frames`` (buffer-protocol objects) as a segment file at
    ``path``, atomically; returns the bytes written. Raises ``OSError``
    when the filesystem is full."""
    views = [memoryview(f) for f in frames]
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix='.tmp')
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(_HEADER.pack(_SEGMENT_MAGIC, _SEGMENT_VERSION, kind,
                                 len(views)))
            for view in views:
                f.write(_FRAME_LEN.pack(view.nbytes))
            offset = _HEADER.size + _FRAME_LEN.size * len(views)
            for view in views:
                pad = (-offset) % _FRAME_ALIGN
                if pad:
                    f.write(b'\0' * pad)
                    offset += pad
                f.write(view)
                offset += view.nbytes
            f.write(_SEGMENT_TRAILER)
            size = offset + len(_SEGMENT_TRAILER)
        os.replace(tmp, path)
        return size
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def read_segment(path: str) -> Tuple[int, List[memoryview], mmap.mmap]:
    """Map a segment file: ``(kind, frame views, mapping)``. The views are
    read-only slices of the mapping and keep it alive. Raises
    :class:`CorruptSegmentError` on any structural mismatch, before a
    payload byte is read."""
    with open(path, 'rb') as f:
        try:
            mapping = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:        # an empty file cannot be mapped
            raise CorruptSegmentError('empty segment file')
    try:
        total = len(mapping)
        if total < _HEADER.size + len(_SEGMENT_TRAILER):
            raise CorruptSegmentError('segment shorter than its header')
        magic, version, kind, nframes = _HEADER.unpack_from(mapping, 0)
        if magic != _SEGMENT_MAGIC or version != _SEGMENT_VERSION:
            raise CorruptSegmentError('bad segment magic/version')
        table_end = _HEADER.size + _FRAME_LEN.size * nframes
        if total < table_end + len(_SEGMENT_TRAILER):
            raise CorruptSegmentError('segment truncated inside frame table')
        lengths = [_FRAME_LEN.unpack_from(
            mapping, _HEADER.size + i * _FRAME_LEN.size)[0]
            for i in range(nframes)]
        offset = table_end
        spans = []
        for length in lengths:
            offset += (-offset) % _FRAME_ALIGN
            spans.append((offset, length))
            offset += length
        if (total != offset + len(_SEGMENT_TRAILER)
                or mapping[offset:offset + len(_SEGMENT_TRAILER)]
                != _SEGMENT_TRAILER):
            raise CorruptSegmentError('segment truncated (size/trailer '
                                      'mismatch)')
        view = memoryview(mapping)
        return kind, [view[lo:lo + n] for lo, n in spans], mapping
    except CorruptSegmentError:
        mapping.close()
        raise
    except (struct.error, ValueError, OverflowError) as e:
        mapping.close()
        raise CorruptSegmentError(str(e))


def _serialize_payload(value) -> Tuple[int, List]:
    """``value -> (kind, frames)``: an arrow table as one IPC stream,
    anything else as pickle protocol 5 with large buffers out of band."""
    import pyarrow as pa
    if isinstance(value, pa.Table):
        from petastorm_tpu_torch.workers.serializers import \
            ArrowTableSerializer
        return KIND_ARROW_IPC, [ArrowTableSerializer().serialize(value)]
    frames: List = [None]

    def keep_out_of_band(pickle_buffer):
        try:
            raw = pickle_buffer.raw()
        except BufferError:          # non-contiguous exporter: in-band
            return True
        if raw.nbytes < _OOB_THRESHOLD_BYTES:
            return True
        frames.append(raw)
        return False

    frames[0] = pickle.dumps(value, protocol=5,
                             buffer_callback=keep_out_of_band)
    return KIND_PICKLE5, frames


def _deserialize_payload(kind: int, frames: List[memoryview]):
    if kind == KIND_ARROW_IPC:
        import pyarrow as pa
        with pa.ipc.open_stream(pa.py_buffer(frames[0])) as reader:
            return reader.read_all()
    if kind == KIND_PICKLE5:
        return pickle.loads(frames[0], buffers=frames[1:])
    raise CorruptSegmentError('unknown segment kind {}'.format(kind))


# -- one tier ------------------------------------------------------------------

class _SegmentStore:
    """One directory of segment files, bounded in bytes with approximate-LRU
    eviction (a running per-process total, re-seeded by a scan when it
    crosses the limit or goes negative). Evictions spill into
    ``spill_store`` or unlink; pinned segments are skipped unless their
    pid is dead."""

    def __init__(self, root: str, size_limit_bytes: int, pins: '_PinRegistry',
                 spill_store: Optional['_SegmentStore'] = None):
        self.root = root
        self._size_limit = size_limit_bytes
        self._pins = pins
        self._spill = spill_store
        self._lock = threading.Lock()
        self._approx_total: Optional[int] = None
        self.evictions = 0
        self.spills = 0
        os.makedirs(root, exist_ok=True)

    def path_for(self, digest: str) -> str:
        return os.path.join(self.root, digest + '.seg')

    def contains(self, digest: str) -> bool:
        return os.path.exists(self.path_for(digest))

    def _entries(self):
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if not name.endswith('.seg'):
                continue
            full = os.path.join(self.root, name)
            try:
                st = os.stat(full)
            except OSError:
                continue
            yield full, st.st_size, st.st_mtime

    def size_bytes(self) -> int:
        return sum(size for _, size, _ in self._entries())

    def approx_size_bytes(self) -> int:
        with self._lock:
            if self._approx_total is None:
                self._approx_total = self.size_bytes()
            return max(0, self._approx_total)

    def put(self, digest: str, kind: int, frames: List) -> None:
        path = self.path_for(digest)
        incoming = sum(memoryview(f).nbytes for f in frames) + _HEADER.size
        try:
            replaced = os.stat(path).st_size
        except OSError:
            replaced = 0
        self._evict_if_needed(incoming - replaced)
        size = write_segment(path, kind, frames)
        with self._lock:
            if self._approx_total is not None:
                # the charge above estimated from the frames; correct it to
                # the file's size (padding, frame table)
                self._approx_total += size - incoming
        os.utime(path, None)

    def put_file(self, digest: str, src_path: str) -> None:
        """Copy a validated segment file in (promotion or spill: the tiers
        usually live on different filesystems)."""
        try:
            size = os.stat(src_path).st_size
        except OSError:
            return
        path = self.path_for(digest)
        try:
            replaced = os.stat(path).st_size
        except OSError:
            replaced = 0
        self._evict_if_needed(size - replaced)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix='.tmp')
        try:
            with os.fdopen(fd, 'wb') as out, open(src_path, 'rb') as src:
                while True:
                    chunk = src.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def touch(self, digest: str) -> None:
        try:
            os.utime(self.path_for(digest), None)
        except OSError:
            pass

    def drop(self, digest: str) -> None:
        path = self.path_for(digest)
        try:
            size = os.stat(path).st_size
            os.remove(path)
        except OSError:
            return
        with self._lock:
            if self._approx_total is not None:
                self._approx_total -= size

    def _evict_if_needed(self, incoming_bytes: int) -> None:
        with self._lock:
            if self._approx_total is None:
                self._approx_total = self.size_bytes()
            self._approx_total += incoming_bytes
            if self._approx_total < 0:
                # other processes' stores were missed: re-seed
                self._approx_total = self.size_bytes() + max(0, incoming_bytes)
            if self._approx_total <= self._size_limit:
                return
            entries = list(self._entries())
            total = sum(size for _, size, _ in entries) + max(0, incoming_bytes)
            self._approx_total = total
            if total <= self._size_limit:
                return
        for full, size, _mtime in sorted(entries, key=lambda e: e[2]):
            if total <= self._size_limit:
                break
            digest = os.path.basename(full)[:-len('.seg')]
            if self._pins.is_pinned(digest):
                continue
            if self._spill is not None:
                try:
                    self._spill.put_file(digest, full)
                    self.spills += 1
                except OSError as e:
                    logger.warning('shared cache spill failed: %s', e)
            try:
                os.remove(full)
            except OSError:
                continue
            self.evictions += 1
            total -= size
        with self._lock:
            self._approx_total = total


# -- pins ----------------------------------------------------------------------

class _PinRegistry:
    """Pins across processes: one ``<digest>.<pid>.<token>.pin`` file per
    attachment. A pin whose pid is dead is removed when seen."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def pin(self, digest: str, token: str) -> str:
        path = os.path.join(self.root, '{}.{}.{}.pin'.format(
            digest, os.getpid(), token))
        try:
            with open(path, 'w'):
                pass
        except OSError as e:
            logger.warning('failed to pin shared-cache segment: %s', e)
        return path

    @staticmethod
    def unpin(pin_path: str) -> None:
        try:
            os.remove(pin_path)
        except OSError:
            pass

    def is_pinned(self, digest: str) -> bool:
        prefix = digest + '.'
        try:
            names = os.listdir(self.root)
        except OSError:
            return False
        for name in names:
            if not (name.startswith(prefix) and name.endswith('.pin')):
                continue
            try:
                pid = int(name[len(prefix):].split('.', 1)[0])
            except ValueError:
                pid = -1
            if _pid_alive(pid):
                return True
            try:
                os.remove(os.path.join(self.root, name))
            except OSError:
                pass
        return False


# -- the cache -----------------------------------------------------------------

class _Attachment:
    __slots__ = ('mapping', 'pin_path')

    def __init__(self, mapping, pin_path):
        self.mapping = mapping
        self.pin_path = pin_path


class SharedRowGroupCache(CacheBase):
    """Tiered host-wide cache of decoded row-group payloads.

    :param path: the root every attaching reader names. Tier 1, pins,
        locks and counters live under it; tier 0 in ``/dev/shm`` keyed by
        its digest.
    :param size_limit_bytes: tier 1's byte budget.
    :param mem_size_limit_bytes: tier 0's byte budget; defaults to
        ``min(size_limit_bytes, 1 GiB)``. Size it under the free space of
        ``/dev/shm``: a full one fails the publish, and the read is then
        served uncached.
    :param mem_dir: tier 0's directory in place of the ``/dev/shm`` one.
    :param attach_limit: attached segments this instance keeps pinned.
    :param lock_timeout_s: how long a miss waits for another process's
        fill before filling itself.
    :param cleanup: :meth:`cleanup` removes both tiers.
    :param peers: the pod tier: ``['host:port', ...]``, the
        :meth:`serve_peers` endpoints of other hosts' roots, asked on a
        local miss before filling.
    :param peer_timeout_s: the HTTP timeout of one peer fetch.
    :param peer_hedge_s: None: peers, then the fill, in turn; a number: the
        peer fetch races the local fill, which starts after this many
        seconds.
    :param peer_dead_cooldown_s: how long a peer that erred is skipped.

    Instances pickle to worker interpreters: the copy re-attaches to the
    same tiers with fresh local state.
    """

    #: Bound on undrained ``peer_fetch`` spans.
    MAX_PENDING_SPANS = 2048

    def __init__(self, path: str, size_limit_bytes: int,
                 mem_size_limit_bytes: Optional[int] = None,
                 mem_dir: Optional[str] = None,
                 attach_limit: int = _DEFAULT_ATTACH_LIMIT,
                 lock_timeout_s: float = 30.0,
                 cleanup: bool = False,
                 peers: Optional[List[str]] = None,
                 peer_timeout_s: float = 2.0,
                 peer_hedge_s: Optional[float] = None,
                 peer_dead_cooldown_s: float = 30.0):
        if not path:
            raise ValueError("cache_type='shared' needs a cache_location "
                             'directory shared by every attaching reader')
        if size_limit_bytes <= 0:
            raise ValueError('size_limit_bytes must be positive, got '
                             '{!r}'.format(size_limit_bytes))
        self._path = os.path.abspath(path)
        self._size_limit = int(size_limit_bytes)
        self._mem_limit = int(mem_size_limit_bytes
                              or min(self._size_limit,
                                     _DEFAULT_MEM_LIMIT_BYTES))
        self._mem_dir_override = mem_dir
        self._attach_limit = max(1, attach_limit)
        self._lock_timeout_s = lock_timeout_s
        self._cleanup_on_exit = cleanup
        self._peers = list(peers or [])
        self._peer_timeout_s = peer_timeout_s
        self._peer_hedge_s = peer_hedge_s
        self._peer_dead_cooldown_s = float(peer_dead_cooldown_s)
        self._init_runtime()

    def _init_runtime(self) -> None:
        self._instance_token = uuid.uuid4().hex[:8]
        self._lock = threading.Lock()
        self._closed = False
        mem_dir = self._mem_dir_override or self._default_mem_dir(self._path)
        os.makedirs(self._path, exist_ok=True)
        self._pins = _PinRegistry(os.path.join(self._path, 'pins'))
        self._disk = _SegmentStore(os.path.join(self._path, 'disk'),
                                   self._size_limit, self._pins)
        self._mem = _SegmentStore(mem_dir, self._mem_limit, self._pins,
                                  spill_store=self._disk)
        self._locks_dir = os.path.join(self._path, 'locks')
        self._counters_dir = os.path.join(self._path, 'counters')
        os.makedirs(self._locks_dir, exist_ok=True)
        os.makedirs(self._counters_dir, exist_ok=True)
        self._attached: 'OrderedDict[str, _Attachment]' = OrderedDict()
        self._events = {'shared_hits': 0, 'shared_misses': 0,
                        'shared_evictions': 0, 'shared_put_failures': 0,
                        'shared_peer_hits': 0, 'shared_peer_misses': 0,
                        'shared_peer_errors': 0,
                        'shared_peer_skipped_dead': 0}
        self._totals = {'hits': 0, 'misses': 0, 'fills': 0, 'evictions': 0,
                        'spills': 0, 'corrupt_dropped': 0, 'lock_waits': 0,
                        'lock_steals': 0, 'put_failures': 0,
                        'peer_hits': 0, 'peer_misses': 0, 'peer_errors': 0,
                        'peer_bytes': 0, 'peer_skipped_dead': 0}
        # a peer that erred or timed out is skipped until its deadline
        self._peer_dead_until: Dict[str, float] = {}
        self._observe_pod = podobs_enabled()
        #: the id every peer request of this cache carries in
        #: ``X-Petastorm-Trace`` ('' with the pod plane off: no header)
        self.trace_id = new_trace_id() if self._observe_pod else ''
        self._pod_spans: list = []
        self._pod_latency: Dict[str, dict] = {}
        # the pod tier's hedge: "fetch from a peer" against "fill here"
        self._peer_hedge = None
        if self._peers and self._peer_hedge_s is not None:
            from petastorm_tpu_torch.resilience import HedgedRead
            self._peer_hedge = HedgedRead(
                dict(threshold_s=float(self._peer_hedge_s)),
                on_event=self._peer_hedge_event)
        self._peer_server: Optional['PeerCacheServer'] = None
        self._events_since_flush = 0
        self._counter_path = os.path.join(
            self._counters_dir,
            '{}-{}.json'.format(os.getpid(), self._instance_token))
        self._fs_clock_cache: Optional[Tuple[float, float]] = None
        self._sweep_stale_counters()

    def _sweep_stale_counters(self) -> None:
        """Remove the counter files of processes dead for over
        ``_COUNTER_TTL_S``."""
        try:
            now = _fs_now(self._counters_dir)
            names = os.listdir(self._counters_dir)
        except OSError:
            return
        for name in names:
            if not name.endswith('.json'):
                continue
            try:
                pid = int(name.split('-', 1)[0])
            except ValueError:
                pid = -1
            full = os.path.join(self._counters_dir, name)
            try:
                old = (now - os.stat(full).st_mtime) > _COUNTER_TTL_S
            except OSError:
                continue
            if old and not _pid_alive(pid):
                try:
                    os.remove(full)
                except OSError:
                    pass

    @staticmethod
    def _default_mem_dir(path: str) -> str:
        digest = hashlib.md5(path.encode('utf-8')).hexdigest()[:12]
        if os.path.isdir('/dev/shm'):
            return os.path.join('/dev/shm', 'petastorm-tpu-' + digest)
        return os.path.join(path, 'mem')

    # worker interpreters get the settings; mappings, pins and counters are
    # per process and rebuilt there
    def __getstate__(self):
        return {'path': self._path, 'size_limit': self._size_limit,
                'mem_limit': self._mem_limit,
                'mem_dir': self._mem_dir_override,
                'attach_limit': self._attach_limit,
                'lock_timeout_s': self._lock_timeout_s,
                'cleanup': self._cleanup_on_exit,
                'peers': self._peers,
                'peer_timeout_s': self._peer_timeout_s,
                'peer_hedge_s': self._peer_hedge_s,
                'peer_dead_cooldown_s': self._peer_dead_cooldown_s}

    def __setstate__(self, state):
        self._path = state['path']
        self._size_limit = state['size_limit']
        self._mem_limit = state['mem_limit']
        self._mem_dir_override = state['mem_dir']
        self._attach_limit = state['attach_limit']
        self._lock_timeout_s = state['lock_timeout_s']
        self._cleanup_on_exit = state['cleanup']
        self._peers = state.get('peers', [])
        self._peer_timeout_s = state.get('peer_timeout_s', 2.0)
        self._peer_hedge_s = state.get('peer_hedge_s')
        self._peer_dead_cooldown_s = state.get('peer_dead_cooldown_s', 30.0)
        self._init_runtime()

    # -- lookup ----------------------------------------------------------------

    @staticmethod
    def _digest(key: str) -> str:
        return hashlib.md5(key.encode('utf-8')).hexdigest()

    def contains(self, key: str) -> bool:
        """Whether tier 0 or tier 1 holds ``key`` (no attachment, no lock:
        the readahead planner's peek)."""
        digest = self._digest(key)
        return self._mem.contains(digest) or self._disk.contains(digest)

    def _try_attach(self, digest: str):
        """``(payload,)`` on a hit, None on a miss. A tier-1 hit is promoted
        to tier 0; a corrupt segment is dropped and counts as a miss."""
        for store, promote in ((self._mem, False), (self._disk, True)):
            path = store.path_for(digest)
            if not os.path.exists(path):
                continue
            try:
                kind, frames, mapping = read_segment(path)
            except OSError:
                continue
            except CorruptSegmentError:
                store.drop(digest)
                with self._lock:
                    self._totals['corrupt_dropped'] += 1
                continue
            try:
                payload = _deserialize_payload(kind, frames)
            except CorruptSegmentError:
                mapping.close()
                store.drop(digest)
                with self._lock:
                    self._totals['corrupt_dropped'] += 1
                continue
            if promote:
                try:
                    self._mem.put_file(digest, path)
                except OSError:
                    pass
                else:
                    # one copy, in tier 0: tier 0's eviction spills it again
                    store.drop(digest)
            else:
                store.touch(digest)
            self._register_attachment(digest, mapping)
            return (payload,)
        return None

    def _register_attachment(self, digest: str, mapping) -> None:
        pin_path = self._pins.pin(digest, self._instance_token)
        with self._lock:
            old = self._attached.pop(digest, None)
            self._attached[digest] = _Attachment(mapping, pin_path)
            dropped = []
            while len(self._attached) > self._attach_limit:
                dropped.append(self._attached.popitem(last=False)[1])
        if old is not None:
            dropped.append(old)
        for att in dropped:
            # unpin only: the mapping lives while a payload view refers to it
            self._pins.unpin(att.pin_path)

    # -- single-flight fill ----------------------------------------------------

    def _lock_path(self, digest: str) -> str:
        return os.path.join(self._locks_dir, digest + '.lock')

    @property
    def _lock_id(self) -> str:
        return '{}:{}'.format(os.getpid(), self._instance_token)

    def _try_lock(self, digest: str) -> bool:
        # link a complete file into place: the lock names its holder from
        # its first instant. The temporary name is unique per call, since
        # thread-pool workers share one instance.
        path = self._lock_path(digest)
        tmp = '{}.{}.{}'.format(path, self._lock_id, uuid.uuid4().hex[:8])
        try:
            with open(tmp, 'w') as f:
                f.write(self._lock_id)
            try:
                os.link(tmp, path)
            except OSError as e:
                if e.errno in (errno.EEXIST, errno.ENOENT):
                    return False
                raise
            return True
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def _unlock(self, digest: str) -> None:
        # remove only our own lock: one stolen from us is the thief's now
        path = self._lock_path(digest)
        try:
            with open(path) as f:
                if f.read().strip() != self._lock_id:
                    return
            os.remove(path)
        except OSError:
            pass

    @staticmethod
    def _parse_lock_holder(content: str) -> int:
        try:
            return int(content.strip().split(':', 1)[0] or -1)
        except ValueError:
            return -1

    def _read_lock_state(self, path: str):
        """``(holder pid, mtime)`` of a lock file, or None when it is gone
        or unreadable."""
        try:
            st = os.stat(path)
            with open(path) as f:
                holder = self._parse_lock_holder(f.read())
        except OSError:
            return None
        return holder, st.st_mtime

    def _lock_age(self, mtime: float) -> Optional[float]:
        """Age of ``mtime`` on the filesystem's clock, None when it cannot
        be probed; the probe is reused for 1 s, advanced by the monotonic
        clock."""
        mono = time.monotonic()
        cached = self._fs_clock_cache
        if cached is not None and mono - cached[1] < 1.0:
            return cached[0] + (mono - cached[1]) - mtime
        try:
            fs = _fs_now(self._locks_dir)
        except OSError:
            self._fs_clock_cache = None
            return None
        self._fs_clock_cache = (fs, mono)
        return fs - mtime

    def _lock_stale(self, digest: str) -> bool:
        state = self._read_lock_state(self._lock_path(digest))
        if state is None:
            return False
        holder, mtime = state
        if holder >= 0 and not _pid_alive(holder):
            return True
        age = self._lock_age(mtime)
        return age is not None and age > self._lock_timeout_s

    def _steal_lock(self, digest: str) -> bool:
        """Claim a stale lock by renaming it (one of many waiters wins),
        then check it again; a lock that turned out live is put back unless
        a new one took its place."""
        path = self._lock_path(digest)
        claim = '{}.claim.{}.{}'.format(path, self._lock_id,
                                        uuid.uuid4().hex[:8])
        try:
            os.rename(path, claim)
        except OSError:
            return False
        state = self._read_lock_state(claim)
        stale = True
        if state is not None:
            holder, mtime = state
            if holder >= 0 and _pid_alive(holder):
                age = self._lock_age(mtime)
                stale = age is not None and age > self._lock_timeout_s
        if not stale:
            try:
                os.link(claim, path)
            except OSError:
                pass
        try:
            os.remove(claim)
        except OSError:
            pass
        if stale:
            with self._lock:
                self._totals['lock_steals'] += 1
        return stale

    def _wait_for_fill(self, digest: str):
        """Another process holds the fill lock: wait for its segment, or
        for the lock to turn stale. ``(payload,)`` or None (fill here)."""
        deadline = time.monotonic() + self._lock_timeout_s
        delay = 0.002
        with self._lock:
            self._totals['lock_waits'] += 1
        while time.monotonic() < deadline:
            time.sleep(delay)
            delay = min(delay * 2, 0.02)
            attached = self._try_attach(digest)
            if attached is not None:
                return attached
            if not os.path.exists(self._lock_path(digest)):
                return self._try_attach(digest)
            if self._lock_stale(digest) and self._steal_lock(digest):
                return None
        return None

    # -- pod tier (peer caches) ----------------------------------------------

    def _bump(self, total_key: str, event_key: str, n: int = 1) -> None:
        with self._lock:
            self._totals[total_key] = self._totals.get(total_key, 0) + n
            self._events[event_key] = self._events.get(event_key, 0) + n

    def _peer_hedge_event(self, name: str, n: int = 1) -> None:
        # the pod hedge's io_hedges / io_hedge_wins / io_hedge_losses, in
        # the cache's own counter families
        short = name.replace('io_', 'peer_')
        self._bump(short, 'shared_' + short, n)

    def _observe_peer_fetch(self, peer: str, start_s: float, outcome: str,
                            nbytes: int) -> None:
        """One peer attempt as a ``peer_fetch`` span and latency
        observation; nothing under ``PETASTORM_TPU_PODOBS=0``."""
        if not self._observe_pod:
            return
        dur_s = time.perf_counter() - start_s
        span = ('peer_fetch', 'io', start_s, dur_s,
                {'peer': peer, 'outcome': outcome, 'bytes': nbytes})
        index = bucket_index(dur_s)
        with self._lock:
            if len(self._pod_spans) < self.MAX_PENDING_SPANS:
                self._pod_spans.append(span)
            entry = self._pod_latency.setdefault(
                'peer_fetch', {'buckets': {}, 'sum': 0.0, 'count': 0})
            entry['buckets'][index] = entry['buckets'].get(index, 0) + 1
            entry['sum'] += dur_s
            entry['count'] += 1

    def take_spans(self) -> list:
        """The ``peer_fetch`` spans (``(name, cat, start_s, dur_s, args)``)
        since the last call."""
        with self._lock:
            spans, self._pod_spans = self._pod_spans, []
        return spans

    def take_latency(self) -> Optional[Dict[str, dict]]:
        """The ``peer_fetch`` latency deltas since the last call, in the
        ``LatencyDeltas.drain()`` shape; None when there are none."""
        with self._lock:
            latency, self._pod_latency = self._pod_latency, {}
        return latency or None

    def segment_bytes(self, digest: str) -> Optional[bytes]:
        """The raw bytes of a resident segment, tier 0 first (the peer
        server's read; None on a miss). A publisher replaces whole files,
        so the bytes are a whole segment; the fetching peer validates them
        all the same."""
        for store in (self._mem, self._disk):
            try:
                with open(store.path_for(digest), 'rb') as f:
                    return f.read()
            except OSError:
                continue
        return None

    def _mark_peer_dead(self, peer: str) -> None:
        """Skip ``peer`` (counted ``peer_skipped_dead``) until
        ``peer_dead_cooldown_s`` from now."""
        if self._peer_dead_cooldown_s <= 0:
            return
        with self._lock:
            self._peer_dead_until[peer] = (time.perf_counter()
                                           + self._peer_dead_cooldown_s)

    def _peer_fetch(self, digest: str):
        """Ask each peer for ``digest`` in turn: download the segment,
        validate it, republish it in the local tiers and attach it. Returns
        the attached ``(payload,)`` or None. A 404 is an honest miss; any
        other failure counts ``peer_errors``, opens the peer's cooldown and
        moves on."""
        import urllib.error
        import urllib.request
        for peer in self._peers:
            with self._lock:
                dead_until = self._peer_dead_until.get(peer)
            if dead_until is not None:
                if time.perf_counter() < dead_until:
                    self._bump('peer_skipped_dead',
                               'shared_peer_skipped_dead')
                    continue
                with self._lock:
                    self._peer_dead_until.pop(peer, None)
            url = 'http://{}/peercache/{}'.format(peer, digest)
            tmp = None
            nbytes = 0
            attempt_start = time.perf_counter()
            request = urllib.request.Request(url)
            if self._observe_pod:
                # the serving peer echoes the id: both hosts' records of
                # this fetch join on it
                request.add_header(TRACE_HEADER, self.trace_id)
            try:
                with urllib.request.urlopen(
                        request, timeout=self._peer_timeout_s) as resp:
                    fd, tmp = tempfile.mkstemp(dir=self._path,
                                               suffix='.peer')
                    with os.fdopen(fd, 'wb') as out:
                        while True:
                            chunk = resp.read(1 << 20)
                            if not chunk:
                                break
                            out.write(chunk)
                            nbytes += len(chunk)
                # validate before publishing: a torn transfer is dropped,
                # never served
                _kind, frames, mapping = read_segment(tmp)
                for frame in frames:
                    frame.release()
                mapping.close()
                self._mem.put_file(digest, tmp)
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    self._bump('peer_errors', 'shared_peer_errors')
                    self._mark_peer_dead(peer)
                    self._observe_peer_fetch(peer, attempt_start, 'error',
                                             nbytes)
                else:
                    self._observe_peer_fetch(peer, attempt_start, 'miss',
                                             nbytes)
                continue
            except (OSError, CorruptSegmentError, ValueError) as e:
                logger.warning('peer-cache fetch %s failed (degrading to '
                               'next peer / local fill): %s', url, e)
                self._bump('peer_errors', 'shared_peer_errors')
                self._mark_peer_dead(peer)
                self._observe_peer_fetch(peer, attempt_start, 'error',
                                         nbytes)
                continue
            finally:
                if tmp is not None:
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
            attached = self._try_attach(digest)
            if attached is not None:
                self._bump('peer_hits', 'shared_peer_hits')
                with self._lock:
                    self._totals['peer_bytes'] += nbytes
                    self._peer_dead_until.pop(peer, None)
                self._observe_peer_fetch(peer, attempt_start, 'hit', nbytes)
                return attached
            self._observe_peer_fetch(peer, attempt_start, 'miss', nbytes)
        self._bump('peer_misses', 'shared_peer_misses')
        return None

    def serve_peers(self, port: int = 0) -> int:
        """Start this root's pod endpoint (``GET /peercache/<digest>`` on
        ``127.0.0.1``) and return its port, what other hosts list in their
        ``peers``. Idempotent; :meth:`close` stops it."""
        with self._lock:
            server = self._peer_server
        if server is not None:
            return server.port
        server = PeerCacheServer(self, port=port).start()
        with self._lock:
            if self._peer_server is None:
                self._peer_server = server
                server = None
        if server is not None:    # lost a start race: keep the first
            server.stop()
        return self._peer_server.port

    def _pod_fill(self, digest: str, fill_cache_func):
        """A local miss with peers: the pod before the store. In turn, the
        peers and then the fill; hedged, the peer fetch (primary) races the
        fill (the hedge, started after ``peer_hedge_s``) and a once-gate
        lets one fill through."""
        if self._peer_hedge is None:
            attached = self._peer_fetch(digest)
            if attached is not None:
                self._record(hit=False)   # a local miss the pod served
                return attached[0]
            return self._publish_fill(digest, fill_cache_func)
        gate = {'mutex': threading.Lock(), 'done': False, 'value': None}

        def gated_fill():
            # the second arrival waits for the first fill under the mutex,
            # and never fills (and counts) the row group again
            with gate['mutex']:
                if not gate['done']:
                    gate['value'] = self._publish_fill(digest,
                                                       fill_cache_func)
                    gate['done'] = True
                return gate['value']

        def peers_then_fill():
            attached = self._peer_fetch(digest)
            if attached is not None:
                self._record(hit=False)
                return attached[0]
            return gated_fill()
        return self._peer_hedge.call(
            peers_then_fill, hedge_fn=gated_fill,
            description='peer_fill({})'.format(digest[:8]))

    # -- CacheBase -------------------------------------------------------------

    def get(self, key: str, fill_cache_func):
        digest = self._digest(key)
        attached = self._try_attach(digest)
        if attached is not None:
            self._record(hit=True)
            return attached[0]
        got_lock = self._try_lock(digest)
        if not got_lock:
            if self._lock_stale(digest) and self._steal_lock(digest):
                got_lock = self._try_lock(digest)
            if not got_lock:
                attached = self._wait_for_fill(digest)
                if attached is not None:
                    self._record(hit=True)
                    return attached[0]
                got_lock = self._try_lock(digest)
        try:
            # the previous holder may have published before we got the lock
            attached = self._try_attach(digest)
            if attached is not None:
                self._record(hit=True)
                return attached[0]
            if self._peers:
                return self._pod_fill(digest, fill_cache_func)
            return self._publish_fill(digest, fill_cache_func)
        finally:
            if got_lock:
                self._unlock(digest)

    def _publish_fill(self, digest: str, fill_cache_func):
        """Fill and publish: every ``fills`` count comes from here, which
        makes the sum of ``fills`` over a pod's roots its decode count."""
        value = fill_cache_func()
        self._record(hit=False)
        try:
            # the cache-enospc chaos scenario raises here, taking the route
            # a full /dev/shm or spill disk takes
            maybe_inject_cache_fault(digest)
            kind, frames = _serialize_payload(value)
            self._mem.put(digest, kind, frames)
            with self._lock:
                self._totals['fills'] += 1
        except (OSError, pickle.PicklingError, TypeError, ValueError) as e:
            # a failed publish (a full /dev/shm) never fails the read: the
            # value is served as filled and the failure counted
            logger.warning('failed to publish shared-cache segment '
                           '(degrading to direct decode): %s', e)
            with self._lock:
                self._events['shared_put_failures'] += 1
                self._totals['put_failures'] += 1
        return value

    # -- telemetry -------------------------------------------------------------

    def _record(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self._events['shared_hits'] += 1
                self._totals['hits'] += 1
            else:
                self._events['shared_misses'] += 1
                self._totals['misses'] += 1
            evictions = self._mem.evictions + self._disk.evictions
            new_evictions = evictions - self._totals['evictions']
            if new_evictions:
                self._events['shared_evictions'] += new_evictions
                self._totals['evictions'] = evictions
            self._totals['spills'] = self._mem.spills
            self._events_since_flush += 1
            flush = self._events_since_flush >= _COUNTER_FLUSH_EVERY
            if flush:
                self._events_since_flush = 0
        if flush:
            self._flush_counters()

    def take_events(self) -> Dict[str, int]:
        """The ``shared_*`` counts since the last call."""
        with self._lock:
            events = dict(self._events)
            for name in self._events:
                self._events[name] = 0
        return events

    def occupancy_bytes(self) -> int:
        """Approximate bytes held by both tiers (running totals)."""
        return self._mem.approx_size_bytes() + self._disk.approx_size_bytes()

    def size_bytes(self) -> int:
        """Exact bytes held by both tiers (a directory scan)."""
        return self._mem.size_bytes() + self._disk.size_bytes()

    def tier_bytes(self) -> Tuple[int, int]:
        """``(tier 0, tier 1)`` bytes held (directory scans)."""
        return self._mem.size_bytes(), self._disk.size_bytes()

    def counters(self) -> Dict[str, int]:
        """This instance's lifetime totals."""
        with self._lock:
            return dict(self._totals)

    def host_counters(self) -> Dict[str, int]:
        """The totals of every process attached to this root, this
        instance's flushed first."""
        self._flush_counters()
        return self.global_counters(self._path)

    def _flush_counters(self) -> None:
        with self._lock:
            if self._closed:
                return
            payload = dict(self._totals, pid=os.getpid())
        try:
            fd, tmp = tempfile.mkstemp(dir=self._counters_dir, suffix='.tmp')
            with os.fdopen(fd, 'w') as f:
                json.dump(payload, f)
            os.replace(tmp, self._counter_path)
        except OSError:
            pass

    @staticmethod
    def global_counters(path: str) -> Dict[str, int]:
        """Totals summed over every attaching process's flushed counter
        file under the root ``path``."""
        totals: Dict[str, int] = {}
        counters_dir = os.path.join(os.path.abspath(path), 'counters')
        try:
            names = os.listdir(counters_dir)
        except OSError:
            return totals
        for name in names:
            if not name.endswith('.json'):
                continue
            try:
                with open(os.path.join(counters_dir, name)) as f:
                    blob = json.load(f)
            except (OSError, ValueError):
                continue
            for k, v in blob.items():
                if isinstance(v, int) and k != 'pid':
                    totals[k] = totals.get(k, 0) + v
        return totals

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Flush the counters, stop the pod endpoint, wait (bounded) for a
        pod hedge's loser, and release this instance's pins; idempotent.
        Mappings are not closed: payload views own them."""
        self._flush_counters()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            attached, self._attached = self._attached, OrderedDict()
            server, self._peer_server = self._peer_server, None
        if self._peer_hedge is not None:
            self._peer_hedge.drain()
        if server is not None:
            server.stop()
        for att in attached.values():
            self._pins.unpin(att.pin_path)

    def cleanup(self):
        self.close()
        if not self._cleanup_on_exit:
            return
        import shutil
        shutil.rmtree(self._mem.root, ignore_errors=True)
        shutil.rmtree(self._path, ignore_errors=True)


# -- the pod's peer protocol -------------------------------------------------

_HEX_DIGITS = frozenset('0123456789abcdef')


class PeerCacheServer:
    """One root's side of the pod protocol: ``GET /peercache/<digest>``
    answers the raw bytes of a resident segment (tier 0 first), 404 on a
    miss, 400 for a digest that is not hex (it becomes a file name), 500 on
    a failed read (the fetching peer counts it and moves on). A threading
    HTTP server on ``127.0.0.1`` with daemon request threads, stopped and
    joined by :meth:`stop`. The fetching side validates every segment
    before it republishes it. With the pod plane on, every reply echoes
    the request's ``X-Petastorm-Trace`` and stamps ``X-Petastorm-Clock-S``
    (:meth:`_pod_headers`), and :attr:`traces` counts the requests served
    under each trace id."""

    def __init__(self, cache: SharedRowGroupCache, port: int = 0):
        self._cache = cache
        self._requested_port = port
        self._server = None
        self._thread: Optional[threading.Thread] = None
        #: the bound port (not the requested one when that was 0)
        self.port: Optional[int] = None
        #: trace id -> requests answered under it: this side's record of
        #: the fetches a peer's ``peer_fetch`` spans time
        self.traces: Dict[str, int] = {}
        self._traces_lock = threading.Lock()

    def _pod_headers(self, handler) -> Dict[str, str]:
        """The pod plane's reply headers: the caller's trace id echoed and
        this host's monotonic clock at reply time; none with
        ``PETASTORM_TPU_PODOBS=0``."""
        if not podobs_enabled():
            return {}
        headers = {CLOCK_HEADER: repr(time.perf_counter())}
        trace = handler.headers.get(TRACE_HEADER)
        if trace:
            headers[TRACE_HEADER] = trace
            with self._traces_lock:
                self.traces[trace] = self.traces.get(trace, 0) + 1
        return headers

    def start(self) -> 'PeerCacheServer':
        if self._server is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug('peer-cache endpoint: ' + fmt, *args)

            def _reply(self, status: int, body: bytes,
                       content_type: str = 'text/plain'):
                self.send_response(status)
                self.send_header('Content-Type', content_type)
                self.send_header('Content-Length', str(len(body)))
                for name, value in outer._pod_headers(self).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                try:
                    route = self.path.split('?', 1)[0]
                    if not route.startswith('/peercache/'):
                        self._reply(404, b'unknown route; try '
                                         b'/peercache/<digest>\n')
                        return
                    digest = route[len('/peercache/'):]
                    if not digest or not set(digest) <= _HEX_DIGITS:
                        self._reply(400, b'bad digest\n')
                        return
                    data = outer._cache.segment_bytes(digest)
                    if data is None:
                        self._reply(404, b'miss\n')
                        return
                    self._reply(200, data, 'application/octet-stream')
                except Exception as e:   # a 500, never a dead serve loop
                    logger.exception('peer-cache request failed')
                    try:
                        self._reply(500, 'error: {}\n'.format(e).encode())
                    except OSError:
                        pass

        self._server = ThreadingHTTPServer(
            ('127.0.0.1', self._requested_port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={'poll_interval': 0.1}, daemon=True,
            name='petastorm-torch-peercache-http')
        self._thread.start()
        logger.info('peer-cache endpoint on http://127.0.0.1:%d/peercache/',
                    self.port)
        return self

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
