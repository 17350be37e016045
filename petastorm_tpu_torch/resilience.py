"""Resilient IO: one retry policy and one hedging primitive under every
row-group read of the port's workers.

The port's copy of ``petastorm_tpu/resilience.py`` (the whole module, the
same classification, knobs, defaults and error texts):

- :class:`RetryPolicy` — error classification (transient vs permanent),
  exponential backoff with **full jitter** (readers hitting one flaky store
  must not re-arrive in lockstep), and a **total wall budget** so a retried
  call never takes unbounded time.
- :class:`HedgedRead` — fire a duplicate read when the first exceeds the
  live p95 of recent read latencies (or a fixed threshold): the first
  result wins, the loser is abandoned (its result discarded, its daemon
  thread left to finish its blocking read).
- :class:`ResilientIO` — the bundle a worker reads through
  (:meth:`~petastorm_tpu_torch.readers.piece_worker.PieceWorker.read` and
  its readahead thread), accumulating the ``io_retries`` / ``io_hedges`` /
  ``io_hedge_wins`` / ``io_hedge_losses`` / ``io_permanent_failures``
  counters that flow into ``ReaderStats``.

Classification: an ``OSError`` with a *request-shaped* errno
(``ENOENT``/``EACCES``/``EISDIR``/...: the path is wrong, not the store) is
**permanent** and fails on the first attempt; every other ``OSError``
(EIO, connection resets, timeouts) is transient. :func:`classify_read_error`
also treats pyarrow parse errors as transient: a truncated read from a
flaky store corrupts the Arrow stream mid-parse, and a re-read fetches
clean bytes; a file corrupt on disk still fails after the bounded attempts.

The module needs only the standard library: the worker interpreters of the
process pool (``python -S``, no torch) import it.
"""

from __future__ import annotations

import errno
import logging
import random
import threading
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

TRANSIENT, PERMANENT = 'transient', 'permanent'

#: ``OSError`` errnos that describe the *request*, not the store: retrying
#: cannot help, and a bad path must fail in one attempt.
PERMANENT_ERRNOS = frozenset({
    errno.ENOENT, errno.EACCES, errno.EPERM, errno.EISDIR, errno.ENOTDIR,
    errno.EEXIST, errno.ENOSPC, errno.EROFS, errno.ENAMETOOLONG,
})

#: ``OSError`` subclasses that are permanent regardless of errno (they are
#: raised by pure-python filesystems that never set one).
PERMANENT_TYPES = (FileNotFoundError, PermissionError, IsADirectoryError,
                   NotADirectoryError, FileExistsError)

#: Default retry knobs (the ``retry=True`` shape readers resolve to).
DEFAULT_RETRY = dict(attempts=3, initial_backoff_s=0.05, max_backoff_s=2.0,
                     total_budget_s=30.0)

#: Default hedge knobs (the ``hedge=True`` shape). ``threshold_s=None``
#: means adaptive: hedge when a read exceeds the rolling p95 of recent
#: reads times ``threshold_scale`` (clamped to [min, max]).
DEFAULT_HEDGE = dict(threshold_s=None, threshold_scale=2.0,
                     min_threshold_s=0.005, max_threshold_s=5.0,
                     warmup_samples=8)


def classify_error(exc: BaseException) -> str:
    """``'transient'`` (worth retrying) or ``'permanent'`` for a filesystem
    error. Non-OSError exceptions are permanent by default — a codec bug
    must not burn the retry budget."""
    if isinstance(exc, PERMANENT_TYPES):
        return PERMANENT
    if isinstance(exc, (OSError, IOError)):
        if getattr(exc, 'errno', None) in PERMANENT_ERRNOS:
            return PERMANENT
        return TRANSIENT
    return PERMANENT


def classify_read_error(exc: BaseException) -> str:
    """:func:`classify_error` plus: pyarrow parse failures are transient.
    A short/truncated read from a flaky store corrupts the Arrow stream and
    surfaces as ``ArrowInvalid`` — re-reading fetches clean bytes. Bounded
    attempts keep a genuinely corrupt file failing fast."""
    verdict = classify_error(exc)
    if verdict == TRANSIENT:
        return verdict
    if type(exc).__module__.startswith('pyarrow'):
        return TRANSIENT
    return verdict


def resolve_retry(retry) -> Optional[dict]:
    """Normalize a factory ``retry=`` knob: ``True``/``None`` → the default
    policy, ``False``/``0`` → ``None`` (off), a dict → defaults overlaid
    (typo'd keys fail the factory)."""
    if retry is None or retry is True:
        return dict(DEFAULT_RETRY)
    if retry is False or retry == 0:
        return None
    if isinstance(retry, dict):
        unknown = set(retry) - set(DEFAULT_RETRY)
        if unknown:
            raise ValueError('unknown retry option(s) {}; valid: {}'.format(
                sorted(unknown), sorted(DEFAULT_RETRY)))
        return dict(DEFAULT_RETRY, **retry)
    raise ValueError('retry must be True/False or an options dict, got '
                     '{!r}'.format(retry))


#: Default worker auto-recovery knobs (the ``worker_recovery=True`` shape).
#: ``max_respawns=None`` resolves to ``max(3, workers_count)`` at pool
#: start; ``poison_threshold`` is how many worker deaths one item may be
#: implicated in before it is quarantined through the lineage channel;
#: ``settle_s`` is how long the process pool waits for surviving workers to
#: drain before declaring the remaining in-flight items lost.
DEFAULT_RECOVERY = dict(max_respawns=None, poison_threshold=3, settle_s=1.0)


def resolve_recovery(recovery) -> Optional[dict]:
    """Normalize a factory ``worker_recovery=`` knob: ``True``/``None`` →
    defaults (recovery is ON by default — a crashed worker becomes a
    respawn + redispatch, not a dead pipeline), ``False`` → ``None`` (a
    worker death stops the pool loudly, the pre-recovery behavior), a dict
    → defaults overlaid."""
    if recovery is None or recovery is True:
        return dict(DEFAULT_RECOVERY)
    if recovery is False or recovery == 0:
        return None
    if isinstance(recovery, dict):
        unknown = set(recovery) - set(DEFAULT_RECOVERY)
        if unknown:
            raise ValueError('unknown worker_recovery option(s) {}; valid: '
                             '{}'.format(sorted(unknown),
                                         sorted(DEFAULT_RECOVERY)))
        return dict(DEFAULT_RECOVERY, **recovery)
    raise ValueError('worker_recovery must be True/False or an options '
                     'dict, got {!r}'.format(recovery))


def resolve_hedge(hedge) -> Optional[dict]:
    """Normalize a factory ``hedge=`` knob: ``False``/``None``/``0`` → off,
    ``True`` → adaptive defaults, a number → fixed threshold seconds, a
    dict → defaults overlaid."""
    if hedge is None or hedge is False or hedge == 0:
        return None
    if hedge is True:
        return dict(DEFAULT_HEDGE)
    if isinstance(hedge, (int, float)):
        if hedge < 0:
            raise ValueError('hedge threshold must be >= 0, got '
                             '{!r}'.format(hedge))
        return dict(DEFAULT_HEDGE, threshold_s=float(hedge))
    if isinstance(hedge, dict):
        unknown = set(hedge) - set(DEFAULT_HEDGE)
        if unknown:
            raise ValueError('unknown hedge option(s) {}; valid: {}'.format(
                sorted(unknown), sorted(DEFAULT_HEDGE)))
        return dict(DEFAULT_HEDGE, **hedge)
    raise ValueError('hedge must be True/False, a threshold in seconds, or '
                     'an options dict, got {!r}'.format(hedge))


class RetryPolicy:
    """Bounded retry with full-jitter exponential backoff.

    :param attempts: total tries (1 = no retry).
    :param initial_backoff_s: backoff ceiling before the first retry; the
        ceiling doubles per attempt up to ``max_backoff_s``. The actual
        sleep is uniform in ``[0, ceiling]`` (**full jitter**) so
        simultaneous failures across readers decorrelate instead of
        re-arriving in lockstep.
    :param max_backoff_s: backoff ceiling cap.
    :param total_budget_s: total wall budget across all attempts + sleeps;
        when spent, the last error is raised even with attempts remaining
        (``None`` = unbounded — only the attempt count limits).
    :param classify: ``exc -> 'transient'|'permanent'``.
    :param seed: seed for the jitter RNG (tests pin it; production uses OS
        entropy).
    """

    def __init__(self, attempts: int = 3, initial_backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0,
                 total_budget_s: Optional[float] = 30.0,
                 classify: Callable[[BaseException], str] = classify_error,
                 seed: Optional[int] = None):
        if attempts < 1:
            raise ValueError('attempts must be >= 1, got {}'.format(attempts))
        self.attempts = attempts
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.total_budget_s = total_budget_s
        self.classify = classify
        self._rng = random.Random(seed)

    def backoff_s(self, attempt: int) -> float:
        """The jittered sleep before retry number ``attempt`` (0-based)."""
        ceiling = min(self.max_backoff_s,
                      self.initial_backoff_s * (2 ** attempt))
        return self._rng.uniform(0.0, ceiling)

    def call(self, fn, *args,
             on_retry: Optional[Callable[[BaseException, int], None]] = None,
             on_event: Optional[Callable[[str, int], None]] = None,
             description: str = '', **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying transient failures.

        ``on_retry(exc, attempt)`` runs before each backoff sleep (the
        row-group reader drops its possibly-poisoned file handle there). ``on_event(name, n)`` receives
        ``'io_retries'`` / ``'io_permanent_failures'`` counter increments.
        Raises the last underlying error (permanent errors immediately, on
        the first attempt)."""
        deadline = (time.monotonic() + self.total_budget_s
                    if self.total_budget_s is not None else None)
        for attempt in range(self.attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if self.classify(e) == PERMANENT:
                    if on_event is not None:
                        on_event('io_permanent_failures', 1)
                    raise
                last_attempt = attempt == self.attempts - 1
                out_of_budget = (deadline is not None
                                 and time.monotonic() >= deadline)
                if last_attempt or out_of_budget:
                    raise
                if on_event is not None:
                    on_event('io_retries', 1)
                if on_retry is not None:
                    on_retry(e, attempt)
                delay = self.backoff_s(attempt)
                if deadline is not None:
                    delay = min(delay, max(0.0, deadline - time.monotonic()))
                logger.warning('%s failed (%s: %s); retry %d/%d in %.3fs',
                               description or getattr(fn, '__name__', 'call'),
                               type(e).__name__, e, attempt + 1,
                               self.attempts - 1, delay)
                if delay > 0:
                    time.sleep(delay)
        raise AssertionError('unreachable')  # pragma: no cover


class _HedgeRace:
    """Shared state of one primary-vs-hedge race: first finisher publishes,
    the loser's result is discarded."""

    __slots__ = ('done', 'winner', 'value', 'error', '_lock')

    def __init__(self):
        self.done = threading.Event()
        self.winner: Optional[str] = None
        self.value = None
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def finish(self, who: str, value=None, error=None) -> bool:
        with self._lock:
            if self.winner is not None:
                return False
            self.winner = who
            self.value = value
            self.error = error
        self.done.set()
        return True


class AdaptiveThreshold:
    """Rolling p95 of recent durations — the live hedge trigger.

    A small ring of the last N observations; :meth:`current` is the p95
    scaled by ``threshold_scale``, clamped to ``[min, max]``, and ``None``
    until ``warmup_samples`` observations exist (hedging before the
    distribution is known would double every read)."""

    __slots__ = ('_lock', '_ring', '_size', '_pos', '_count', '_scale',
                 '_min_s', '_max_s', '_warmup')

    def __init__(self, scale: float = 2.0, min_s: float = 0.005,
                 max_s: float = 5.0, warmup: int = 8, size: int = 128):
        self._lock = threading.Lock()
        self._ring = [0.0] * size
        self._size = size
        self._pos = 0
        self._count = 0
        self._scale = scale
        self._min_s = min_s
        self._max_s = max_s
        self._warmup = max(1, warmup)

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._ring[self._pos] = seconds
            self._pos = (self._pos + 1) % self._size
            self._count += 1

    def current(self) -> Optional[float]:
        with self._lock:
            n = min(self._count, self._size)
            if self._count < self._warmup:
                return None
            values = sorted(self._ring[:n])
        p95 = values[min(n - 1, int(0.95 * n))]
        return min(self._max_s, max(self._min_s, p95 * self._scale))


class HedgedRead:
    """Tail-latency hedging: run the primary read on a helper thread; when
    it exceeds the live threshold, fire a *second* identical read (through
    an independent handle — parquet handles are not concurrency-safe) and
    take whichever finishes first.

    The loser is cancelled by discard: its thread (daemon, fire-and-forget)
    keeps running until its blocking read returns, then finds the race
    decided and drops the result. That is the only cancellation semantics a
    blocking filesystem read allows — and it bounds *latency*, which is the
    point; the wasted read is the documented cost of hedging.
    """

    def __init__(self, options: dict,
                 on_event: Optional[Callable[[str, int], None]] = None,
                 on_attempt: Optional[Callable[[dict], None]] = None):
        self._fixed_threshold = options.get('threshold_s')
        self._threshold = AdaptiveThreshold(
            scale=options.get('threshold_scale', 2.0),
            min_s=options.get('min_threshold_s', 0.005),
            max_s=options.get('max_threshold_s', 5.0),
            warmup=options.get('warmup_samples', 8))
        self._on_event = on_event
        #: Per-attempt observability hook: called once per finished attempt
        #: (winner AND abandoned loser) with ``{'tag', 'start_s', 'dur_s',
        #: 'won', 'cancelled_by_hedge', 'description'}`` — the loser of a
        #: decided race is the attempt hedging cancelled, which counters
        #: alone cannot show. May be called from a race thread; the
        #: callback must be thread-safe.
        self._on_attempt = on_attempt
        # live race threads (winners AND abandoned losers): drained at
        # shutdown so no thread is still inside a C read when the
        # interpreter finalizes
        self._live_lock = threading.Lock()
        self._live: set = set()

    def drain(self, timeout_s: float = 5.0) -> None:
        """Join every outstanding race thread (bounded): an abandoned loser
        blocked in a C-level read must finish (or be given up on) before
        its interpreter starts finalizing."""
        deadline = time.monotonic() + timeout_s
        with self._live_lock:
            threads = list(self._live)
        for thread in threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))

    def threshold_s(self) -> Optional[float]:
        if self._fixed_threshold is not None:
            return self._fixed_threshold
        return self._threshold.current()

    def _event(self, name: str, n: int = 1) -> None:
        if self._on_event is not None:
            self._on_event(name, n)

    def _report_attempt(self, tag: str, start_s: float, won: bool,
                        description: str) -> None:
        """Fire :attr:`_on_attempt` for one finished attempt. Losing an
        already-decided race is the cancelled-by-hedge annotation: the only
        way an attempt loses is that its twin won first."""
        if self._on_attempt is None:
            return
        try:
            self._on_attempt({'tag': tag, 'start_s': start_s,
                              'dur_s': time.perf_counter() - start_s,
                              'won': bool(won),
                              'cancelled_by_hedge': not won,
                              'description': description})
        except Exception:  # observability must never fail the read
            logger.debug('hedge on_attempt callback failed', exc_info=True)

    def call(self, primary_fn, hedge_fn=None, description: str = 'read'):
        """Run ``primary_fn()``; if it is still running after the live
        threshold, also run ``hedge_fn()`` (defaults to ``primary_fn``) on a
        second thread and return the first result. Exceptions from the
        winner propagate; a losing failure is discarded (the race was
        already decided by a success), but if the FIRST finisher failed, its
        error wins — hedging is a latency tool, not a retry layer (wrap
        with :class:`RetryPolicy` for that)."""
        threshold = self.threshold_s()
        if threshold is None:
            # warmup: run inline, observe, never hedge
            start = time.perf_counter()
            value = primary_fn()
            self._threshold.observe(time.perf_counter() - start)
            self._report_attempt('primary', start, True, description)
            return value
        race = _HedgeRace()
        start = time.perf_counter()

        def run(tag, fn):
            attempt_start = time.perf_counter()
            try:
                try:
                    value = fn()
                except BaseException as e:  # noqa: BLE001 - winner re-raises
                    won = race.finish(tag, error=e)
                else:
                    won = race.finish(tag, value=value)
                    if tag == 'hedge':
                        self._event('io_hedge_wins' if won
                                    else 'io_hedge_losses')
                self._report_attempt(tag, attempt_start, won, description)
            finally:
                with self._live_lock:
                    self._live.discard(threading.current_thread())

        def spawn(tag, fn):
            thread = threading.Thread(
                target=run, args=(tag, fn), daemon=True,
                name='petastorm-torch-hedge-{}'.format(tag))
            with self._live_lock:
                self._live.add(thread)
            thread.start()
            return thread

        spawn('primary', primary_fn)
        hedged = False
        if not race.done.wait(threshold):
            hedged = True
            self._event('io_hedges')
            spawn('hedge', hedge_fn or primary_fn)
            race.done.wait()
        elapsed = time.perf_counter() - start
        if not hedged:
            # only un-hedged reads feed the threshold: a hedged read's
            # duration is already capped by the race and would drag the
            # p95 toward the threshold itself
            self._threshold.observe(elapsed)
        if race.error is not None:
            raise race.error
        return race.value


class ResilientIO:
    """The worker-facing bundle: retry + hedge + thread-safe counters.

    One instance per worker; the worker thread and its background readahead
    thread both route reads through :meth:`read`, and the worker thread
    drains the accumulated counters via :meth:`take_events` (same
    discipline as the shared cache's event drain — ``record_count`` is not
    safe from the background thread)."""

    #: Bound on undrained attempt spans: a direct construction that never
    #: drains (benchmarks, tests) must not grow without limit.
    MAX_PENDING_SPANS = 2048

    def __init__(self, retry_options: Optional[dict] = None,
                 hedge_options: Optional[dict] = None,
                 classify: Callable[[BaseException], str] = classify_read_error,
                 seed: Optional[int] = None,
                 observe_spans: bool = False):
        self.retry = (RetryPolicy(classify=classify, seed=seed,
                                  **retry_options)
                      if retry_options else None)
        self._observe_spans = bool(observe_spans)
        self.hedge = (HedgedRead(hedge_options, on_event=self._count,
                                 on_attempt=(self._record_attempt
                                             if self._observe_spans
                                             else None))
                      if hedge_options else None)
        self._lock = threading.Lock()
        self._events: Dict[str, int] = {}
        # (name, cat, start_s, dur_s, args) tuples — the WorkerBase
        # record_span shape, drained by the worker thread
        self._spans: list = []

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._events[name] = self._events.get(name, 0) + n

    def _record_attempt(self, info: dict) -> None:
        """Accumulate one hedge-race attempt as a span tuple (called from
        race threads — lock-protected, bounded)."""
        args = {'attempt': info.get('tag'),
                'description': info.get('description'),
                'won': bool(info.get('won'))}
        if info.get('cancelled_by_hedge'):
            args['cancelled_by_hedge'] = True
        span = ('io_attempt', 'io', info.get('start_s'),
                info.get('dur_s'), args)
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.MAX_PENDING_SPANS:
                del self._spans[:len(self._spans) - self.MAX_PENDING_SPANS]

    def take_events(self) -> Dict[str, int]:
        """Drain the accumulated counter deltas (worker thread only)."""
        with self._lock:
            events, self._events = self._events, {}
        return events

    def take_spans(self) -> list:
        """Drain the accumulated per-attempt span tuples (worker thread
        only; empty unless constructed with ``observe_spans=True``)."""
        with self._lock:
            spans, self._spans = self._spans, []
        return spans

    def drain(self, timeout_s: float = 5.0) -> None:
        """Join outstanding hedge race threads (worker shutdown): an
        abandoned loser must not still be inside a C-level read when its
        interpreter finalizes."""
        if self.hedge is not None:
            self.hedge.drain(timeout_s)

    @property
    def enabled(self) -> bool:
        return self.retry is not None or self.hedge is not None

    def read(self, fn, hedge_fn=None, on_retry=None,
             description: str = 'read'):
        """Run one read under the configured hedge (inner) and retry
        (outer) layers: a hedged pair that *both* fail is one failed
        attempt, retried with backoff through fresh handles."""
        call = fn
        if self.hedge is not None:
            hedger = self.hedge

            def call():
                return hedger.call(fn, hedge_fn=hedge_fn,
                                   description=description)
        if self.retry is None:
            return call()
        return self.retry.call(call, on_retry=on_retry, on_event=self._count,
                               description=description)
