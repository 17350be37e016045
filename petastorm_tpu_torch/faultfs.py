"""Deterministic fault injection for the read path: a seeded,
scenario-driven filesystem wrapper plus the ``PETASTORM_TPU_CHAOS`` harness.

The port's copy of ``petastorm_tpu/faultfs.py`` (the whole module). Every
injection decision is a pure function of ``(seed, path, operation,
occurrence-index)``, hashed exactly as the JAX package hashes it, so one
scenario with one seed over one access sequence makes the same reads fail,
straggle, truncate or kill in both packages:

========================  ====================================================
scenario                  injected faults
========================  ====================================================
``transient-errors``      ``read()`` raises ``OSError(EIO)`` at ``error_rate``
                          (then a ``cooldown_reads`` clean window per file:
                          one row-group read spans many ``read()`` calls, so
                          a bounded retry provably recovers)
``tail-latency``          every read pays ``base_latency_s``; a ``tail_rate``
                          fraction pays ``tail_latency_s``
``read-hangs``            a ``hang_rate`` fraction of reads sleep ``hang_s``
                          (the straggler shape hedges and watchdogs see)
``truncated-reads``       a ``truncate_rate`` fraction of reads return short
                          data (corrupts the Arrow stream mid-parse; the
                          retry layer re-reads through a fresh handle)
``worker-kill``           after ``kill_after_reads`` reads, raise
                          :class:`SimulatedWorkerCrash` (at most ``max_kills``
                          per process): kills the worker thread or
                          interpreter from inside the read path
``cache-enospc``          shared-cache segment publication raises
                          ``OSError(ENOSPC)`` at ``enospc_rate`` (the cache
                          degrades to direct decode)
``fixed-latency``         every read pays ``seconds_per_read`` plus
                          ``seconds_per_mb`` a MiB, faultlessly
``trace-replay``          every read pays a first-byte latency and a
                          size/bandwidth delay drawn from a recorded
                          object-store trace (``trace=<file-or-name>``; the
                          builtin ``s3-us-east-1`` is this package's own copy
                          under ``traces/``)
``host-death``            the pod-elasticity plane: a simulated host dies
                          mid-epoch (:class:`~petastorm_tpu_torch.podelastic.
                          ElasticHost` asks :meth:`FaultInjector.
                          should_kill_host` before each delivery step)
``host-join``             a simulated host joins mid-epoch (:class:`~petastorm_
                          tpu_torch.podelastic.ElasticPodSim` asks
                          :meth:`FaultInjector.should_join_host` between
                          rounds); neither touches the filesystem
========================  ====================================================

Harness: ``PETASTORM_TPU_CHAOS='<scenario>:<seed>[:k=v,...]'`` (the JAX
package's variable) arms the scenario in every
:class:`~petastorm_tpu_torch.readers.piece_worker.PieceWorker`, whose
filesystem :func:`maybe_wrap` wraps, worker interpreters of the process
pool included (they inherit the environment). Reader construction
(metadata, footers) stays clean: chaos arms under the worker read path that
the resilience layer protects.

The module needs only the standard library.
"""

from __future__ import annotations

import errno
import hashlib
import logging
import os
import threading
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

#: Environment variable arming the chaos harness: ``'<scenario>:<seed>'``
#: (seed optional, default 0). Parsed once per process, cached.
CHAOS_ENV_VAR = 'PETASTORM_TPU_CHAOS'

#: Scenario registry: name -> default params. Every param can be overridden
#: by constructing a :class:`FaultInjector` directly (benchmarks do).
SCENARIOS: Dict[str, dict] = {
    'none': {},
    'transient-errors': dict(error_rate=0.25, cooldown_reads=64),
    'tail-latency': dict(base_latency_s=0.0, tail_rate=0.05,
                         tail_latency_s=0.25),
    'read-hangs': dict(hang_rate=0.03, hang_s=1.0, cooldown_reads=64),
    'truncated-reads': dict(truncate_rate=0.2, cooldown_reads=64),
    'worker-kill': dict(kill_after_reads=5, max_kills=1),
    'cache-enospc': dict(enospc_rate=1.0),
    # every read pays a fixed latency (plus an optional per-byte
    # bandwidth cost), faultlessly
    'fixed-latency': dict(seconds_per_read=0.0, seconds_per_mb=0.0),
    # replay a recorded object-store latency/bandwidth distribution:
    # trace = path to a trace JSON or a builtin name under traces/ (e.g.
    # 's3-us-east-1'); scales stretch/shrink the recorded samples without
    # re-recording
    'trace-replay': dict(trace='', latency_scale=1.0, bandwidth_scale=1.0),
    # pod-elasticity scenarios (for the elasticity plane, NOT the
    # filesystem wrapper): kill one simulated host mid-epoch / admit a
    # late joiner. die_host=-1 derives the victim from the seed.
    'host-death': dict(die_host=-1, die_after_batches=3, max_deaths=1),
    'host-join': dict(join_after_batches=3, max_joins=1),
}


def trace_path(name: str) -> str:
    """Resolve a trace spec to a file path: an existing path is itself; a
    bare name resolves to this package's ``traces/<name>.json``."""
    if os.path.exists(name):
        return name
    builtin = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'traces', name + '.json')
    if os.path.exists(builtin):
        return builtin
    raise ValueError('unknown trace {!r}: not a file, and no builtin trace '
                     '{}'.format(name, builtin))


def load_trace(name: str) -> dict:
    """Load + validate a recorded object-store trace (two non-empty lists
    of positive samples, ``first_byte_latency_s`` and
    ``bandwidth_bytes_per_s``). Fails fast on a missing or malformed trace — a chaos run silently replaying nothing would be the
    worst failure mode."""
    import json
    with open(trace_path(name), 'r') as f:
        trace = json.load(f)
    for field in ('first_byte_latency_s', 'bandwidth_bytes_per_s'):
        samples = trace.get(field)
        if not isinstance(samples, list) or not samples \
                or not all(isinstance(s, (int, float)) and s > 0
                           for s in samples):
            raise ValueError('trace {!r}: {} must be a non-empty list of '
                             'positive numbers'.format(name, field))
    return trace


class SimulatedWorkerCrash(SystemExit):
    """An injected worker death. ``SystemExit`` by design: no ``except
    Exception`` handler on the worker path may swallow it — a thread worker
    dies exactly like one hit by an async kill, and a process worker's
    interpreter exits nonzero so the parent's liveness check fires."""


class FaultInjector:
    """Seeded, replayable fault decisions keyed by (path, op, occurrence).

    Thread-safe: the worker thread and its background readahead thread share
    one instance (they share the wrapped filesystem). Per-(path, op)
    occurrence counters make decisions deterministic for a given access
    sequence; ``max_consecutive`` caps back-to-back failures per path so a
    bounded retry provably recovers.
    """

    def __init__(self, scenario: str = 'none', seed: int = 0, **overrides):
        if scenario not in SCENARIOS:
            raise ValueError('unknown chaos scenario {!r}; valid: {}'.format(
                scenario, sorted(SCENARIOS)))
        params = dict(SCENARIOS[scenario])
        unknown = set(overrides) - set(params)
        if unknown:
            raise ValueError('unknown {} param(s) {}; valid: {}'.format(
                scenario, sorted(unknown), sorted(params)))
        params.update(overrides)
        self.scenario = scenario
        self.seed = int(seed)
        self.params = params
        self._lock = threading.Lock()
        self._occurrences: Dict[tuple, int] = {}
        self._cooldown: Dict[str, int] = {}
        self._kills = 0
        self._joins = 0
        self._reads = 0
        #: Injection tally by fault kind (diagnostics + test assertions).
        self.injected: Dict[str, int] = {}
        #: Injected *time* tally by kind, seconds (e.g. the total replayed
        #: trace latency) — the float companion of :attr:`injected`.
        self.injected_s: Dict[str, float] = {}
        self._trace: Optional[dict] = None
        if scenario == 'trace-replay':
            if not params['trace']:
                raise ValueError("trace-replay needs trace=<file-or-name>, "
                                 "e.g. 'trace-replay:0:trace=s3-us-east-1'")
            self._trace = load_trace(str(params['trace']))

    # -- decisions -------------------------------------------------------------

    def _occurrence(self, path: str, op: str) -> int:
        key = (path, op)
        with self._lock:
            n = self._occurrences.get(key, 0)
            self._occurrences[key] = n + 1
        return n

    def _uniform(self, path: str, op: str, occurrence: int) -> float:
        """Deterministic uniform [0, 1) draw for one decision point."""
        token = '{}:{}:{}:{}'.format(self.seed, os.path.basename(path), op,
                                     occurrence)
        digest = hashlib.md5(token.encode()).digest()
        return int.from_bytes(digest[:8], 'big') / float(1 << 64)

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1

    def _count_s(self, kind: str, seconds: float) -> None:
        with self._lock:
            self.injected_s[kind] = self.injected_s.get(kind, 0.0) + seconds

    def _in_cooldown(self, path: str) -> bool:
        """True (and consume one cooldown tick) while ``path`` is inside
        the clean window an injected fault opened. One row-group read spans
        many ``read()`` calls, so the window is sized in reads
        (``cooldown_reads``) — a bounded retry of the whole operation lands
        inside it and provably recovers."""
        if 'cooldown_reads' not in self.params:
            return False
        with self._lock:
            remaining = self._cooldown.get(path, 0)
            if remaining > 0:
                self._cooldown[path] = remaining - 1
                return True
        return False

    def _mark_fault(self, path: str) -> None:
        with self._lock:
            self._cooldown[path] = int(self.params['cooldown_reads'])

    def spend_kills(self) -> None:
        """Count every ``worker-kill`` kill as spent: the injector of a
        replacement interpreter (:func:`mark_replacement`)."""
        with self._lock:
            self._kills = max(self._kills, int(self.params.get('max_kills',
                                                               0)))

    # -- fs-side hooks ---------------------------------------------------------

    def before_read(self, path: str) -> None:
        """Runs before every wrapped ``read()``: may sleep (latency/hang),
        raise ``OSError`` (transient error) or :class:`SimulatedWorkerCrash`
        (worker kill)."""
        p = self.params
        occurrence = self._occurrence(path, 'read')
        with self._lock:
            self._reads += 1
            reads = self._reads
        if self.scenario == 'worker-kill':
            with self._lock:
                kill = (reads >= p['kill_after_reads']
                        and self._kills < p['max_kills'])
                if kill:
                    self._kills += 1
            if kill:
                self._count('worker_kill')
                raise SimulatedWorkerCrash(
                    'chaos: injected worker kill after {} reads '
                    '(seed {})'.format(reads, self.seed))
            return
        draw = self._uniform(path, 'read', occurrence)
        if self.scenario == 'transient-errors':
            if draw < p['error_rate'] and not self._in_cooldown(path):
                self._mark_fault(path)
                self._count('transient_error')
                raise OSError(errno.EIO,
                              'chaos: injected transient read error '
                              '(seed {}, occurrence {})'.format(
                                  self.seed, occurrence), path)
        elif self.scenario == 'tail-latency':
            delay = p['base_latency_s']
            if draw < p['tail_rate']:
                delay = p['tail_latency_s']
                self._count('tail_read')
            if delay > 0:
                time.sleep(delay)
        elif self.scenario == 'read-hangs':
            if draw < p['hang_rate'] and not self._in_cooldown(path):
                self._mark_fault(path)
                self._count('hang')
                time.sleep(p['hang_s'])

    def after_read(self, path: str, data):
        """Runs on every wrapped ``read()``'s returned bytes: may truncate
        (``truncated-reads``) or sleep (``fixed-latency`` — after the inner
        read completes)."""
        if self.scenario == 'fixed-latency':
            p = self.params
            nbytes = len(data) if data is not None else 0
            delay = (p['seconds_per_read']
                     + nbytes / (1024.0 * 1024.0) * p['seconds_per_mb'])
            if delay > 0:
                time.sleep(delay)
            return data
        if self.scenario != 'truncated-reads' or not data:
            return data
        occurrence = self._occurrence(path, 'truncate')
        if self._uniform(path, 'truncate', occurrence) \
                < self.params['truncate_rate'] \
                and not self._in_cooldown(path):
            self._mark_fault(path)
            self._count('truncated_read')
            return data[:max(1, len(data) // 2)]
        return data

    def trace_delay(self, path: str, offset: int, nbytes: int) -> None:
        """Replay one recorded object-store read against ``(path, offset,
        nbytes)``: sleep a first-byte latency sample plus ``nbytes`` over a
        bandwidth sample, both drawn deterministically from the trace.

        The draw is keyed on the *range* (path + offset + nbytes) plus a
        per-range occurrence counter: two different in-flight ranges replay
        independent samples regardless of thread completion order (the
        parallel range reader stays deterministic), while a hedge or retry
        of the SAME range re-draws — exactly the behavior that makes
        hedging win against a recorded tail."""
        if self._trace is None:
            return
        p = self.params
        key = '{}@{}+{}'.format(os.path.basename(path), offset, nbytes)
        occurrence = self._occurrence(key, 'trace')
        fb_samples = self._trace['first_byte_latency_s']
        bw_samples = self._trace['bandwidth_bytes_per_s']
        fb_draw = self._uniform(key, 'trace-fb', occurrence)
        bw_draw = self._uniform(key, 'trace-bw', occurrence)
        fb = fb_samples[min(int(fb_draw * len(fb_samples)),
                            len(fb_samples) - 1)]
        bw = bw_samples[min(int(bw_draw * len(bw_samples)),
                            len(bw_samples) - 1)]
        delay = fb * p['latency_scale']
        if nbytes:
            delay += nbytes / (bw * p['bandwidth_scale'])
        self._count('trace_reads')
        self._count_s('trace_latency_s', delay)
        if delay > 0:
            time.sleep(delay)

    # -- pod-elasticity hooks --------------------------------------------------

    def should_kill_host(self, host_index: int, batches_delivered: int) -> bool:
        """For the pod-elasticity plane (``podelastic.ElasticHost`` asks
        before each delivery step): True when this simulated host must die
        *now* (raise ``SimulatedHostDeath``). ``die_host`` picks the victim by index;
        ``die_host=-1`` derives it from the seed (deterministically, without
        needing to know the pod size: the draw selects a small index, and the
        first host at-or-above it to cross ``die_after_batches`` dies —
        replayable under the elasticity plane's round-robin stepping)."""
        if self.scenario != 'host-death':
            return False
        p = self.params
        if batches_delivered < p['die_after_batches']:
            return False
        die_host = int(p['die_host'])
        if die_host < 0:
            # seed-derived victim in [0, 4): pods smaller than the draw fall
            # through to the >= test below, so some host always dies
            die_host = int(self._uniform('pod', 'host-death', 0) * 4)
        with self._lock:
            if self._kills >= p['max_deaths']:
                return False
            if host_index != die_host and not (
                    int(p['die_host']) < 0 and host_index >= die_host):
                return False
            self._kills += 1
        self._count('host_death')
        return True

    def should_join_host(self, batches_delivered: int) -> bool:
        """For the pod-elasticity plane (``podelastic.ElasticPodSim``
        asks between delivery rounds): True when a new simulated host must
        join the pod *now* (at most ``max_joins`` per process, after
        ``join_after_batches`` pod-wide delivered batches)."""
        if self.scenario != 'host-join':
            return False
        p = self.params
        if batches_delivered < p['join_after_batches']:
            return False
        with self._lock:
            if self._joins >= p['max_joins']:
                return False
            self._joins += 1
        self._count('host_join')
        return True

    # -- cache-side hook -------------------------------------------------------

    def cache_put_fault(self, key: str) -> None:
        """Consulted by the shared cache before publishing a segment: raises
        ``OSError(ENOSPC)`` under the ``cache-enospc`` scenario (the cache's
        degrade path serves the decoded value anyway)."""
        if self.scenario != 'cache-enospc':
            return
        occurrence = self._occurrence(key, 'cache_put')
        if self._uniform(key, 'cache_put', occurrence) \
                < self.params['enospc_rate']:
            self._count('cache_enospc')
            raise OSError(errno.ENOSPC,
                          'chaos: injected ENOSPC on cache segment publish '
                          '(seed {})'.format(self.seed), key)


class FaultyFile:
    """File wrapper routing every ``read()`` through the injector (and
    counting reads/bytes on the owning filesystem)."""

    def __init__(self, inner, owner: 'FaultyFilesystem', path: str):
        self._inner = inner
        self._owner = owner
        self._path = path

    def read(self, *args, **kwargs):
        injector = self._owner.injector
        # the replayed trace keys on the byte range, so capture the offset
        # BEFORE the inner read advances it (only when a trace is armed —
        # tell() on every read would tax the faultless scenarios)
        offset = (self._inner.tell()
                  if injector.scenario == 'trace-replay' else 0)
        injector.before_read(self._path)
        data = self._inner.read(*args, **kwargs)
        nbytes = len(data) if data is not None else 0
        self._owner.on_read(nbytes)
        data = injector.after_read(self._path, data)
        injector.trace_delay(self._path, offset, nbytes)
        return data

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._inner.close()


class FaultyFilesystem:
    """Filesystem wrapper (any object with ``open(path, mode)``, such as
    :data:`petastorm_tpu_torch.fs.LOCAL_FILESYSTEM`) whose opened files
    consult a :class:`FaultInjector` on every ``read()``. Thread-safe
    (the worker thread and the readahead thread fault independently,
    exactly like two in-flight remote range requests)."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self.injector = injector
        self._lock = threading.Lock()
        self.read_calls = 0
        self.bytes_read = 0

    def on_read(self, nbytes: int) -> None:
        with self._lock:
            self.read_calls += 1
            self.bytes_read += nbytes

    def open(self, path, mode='rb', **kwargs):
        return FaultyFile(self._inner.open(path, mode, **kwargs), self, path)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# -- the PETASTORM_TPU_CHAOS harness hook -------------------------------------

#: Scenarios injecting at the filesystem layer (everything except the
#: cache-publication fault, which arms inside the shared cache, and the
#: pod-elasticity scenarios, which arm inside the pod plane's delivery loop).
_FS_SCENARIOS = frozenset({'transient-errors', 'tail-latency', 'read-hangs',
                           'truncated-reads', 'worker-kill',
                           'fixed-latency', 'trace-replay'})

_env_cache_lock = threading.Lock()
_env_cache: Dict[str, Optional[FaultInjector]] = {}
#: This interpreter replaces a worker that died (:func:`mark_replacement`).
_replacement = False


def parse_chaos(value: str) -> Optional[FaultInjector]:
    """``'<scenario>[:<seed>[:k=v,k=v]]'`` -> injector (``None`` for
    empty/'none'); e.g. ``'tail-latency:7:tail_rate=0.1,tail_latency_s=0.05'``.
    Raises on an unknown scenario or param name — a typo'd chaos spec
    silently running a CLEAN pass would be the worst possible failure mode
    for a chaos harness."""
    value = (value or '').strip()
    if not value or value == 'none':
        return None
    parts = value.split(':', 2)
    scenario = parts[0]
    seed = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    overrides = {}
    if len(parts) > 2 and parts[2]:
        for pair in parts[2].split(','):
            key, _, raw = pair.partition('=')
            try:
                overrides[key.strip()] = int(raw)
            except ValueError:
                try:
                    overrides[key.strip()] = float(raw)
                except ValueError:
                    # string-valued params (trace-replay's trace=<name>)
                    overrides[key.strip()] = raw.strip()
    return FaultInjector(scenario, seed=seed, **overrides)


def reset_chaos_cache() -> None:
    """Drop the per-process injector cache so the NEXT armed run starts a
    fresh, replayable fault sequence (tests and benchmarks that run several
    chaos passes in one process call this between passes; production
    processes live one scenario for their lifetime)."""
    with _env_cache_lock:
        _env_cache.clear()


def chaos_from_env() -> Optional[FaultInjector]:
    """The process-wide injector configured by :data:`CHAOS_ENV_VAR`
    (``None`` when unset). One injector per (process, env value): the worker
    thread, readahead thread and shared cache of one interpreter share a
    fault sequence, keeping a run replayable."""
    value = os.environ.get(CHAOS_ENV_VAR, '').strip()
    if not value or value == 'none':
        return None
    with _env_cache_lock:
        injector = _env_cache.get(value)
        if injector is None:
            injector = parse_chaos(value)
            if _replacement:
                injector.spend_kills()
            _env_cache[value] = injector
    return injector


def mark_replacement() -> None:
    """Mark this worker interpreter as the process pool's replacement of
    one that died: its ``worker-kill`` kills count as spent, so the
    scenario kills each interpreter the pool started at most once per
    ``max_kills`` and a replacement serves on. (The JAX package arms every
    replacement afresh, so under ``worker-kill`` each new interpreter dies
    at its ``kill_after_reads``-th read: a crash loop that only the respawn
    budget ends.) Other scenarios stay armed as they were."""
    global _replacement
    with _env_cache_lock:
        _replacement = True
        for injector in _env_cache.values():
            injector.spend_kills()


def maybe_wrap(filesystem):
    """Wrap ``filesystem`` in the env-configured chaos scenario when one is
    armed and injects at the fs layer; pass through otherwise. Called by
    ``PieceWorker`` so chaos covers exactly the worker read path
    (spawned worker interpreters inherit the env var and wrap themselves)."""
    injector = chaos_from_env()
    if injector is None or injector.scenario not in _FS_SCENARIOS:
        return filesystem
    logger.warning('chaos armed: wrapping filesystem in scenario %r '
                   '(seed %d)', injector.scenario, injector.seed)
    return FaultyFilesystem(filesystem, injector)


def maybe_inject_cache_fault(key: str) -> None:
    """Shared-cache publication hook: raises ``OSError(ENOSPC)`` when the
    ``cache-enospc`` scenario is armed (no-op otherwise)."""
    injector = chaos_from_env()
    if injector is not None:
        injector.cache_put_fault(key)
