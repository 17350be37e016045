"""The port's resilient IO and fault injector against the JAX package's.

Every case feeds the same inputs through both packages: error
classification over an errno table; ``RetryPolicy`` backoff draws under one
seed, retried and permanent calls, the wall budget and the ``on_retry``
hook; the ``resolve_*`` knobs and their error texts; ``AdaptiveThreshold``;
``HedgedRead`` and ``ResilientIO`` with controlled events (the primary and
the hedge each winning once, a failing first finisher, the drain of an
abandoned loser under the replayed trace); ``FaultInjector`` decisions over
a grid of seeds, paths and occurrences for every filesystem scenario;
``parse_chaos`` and ``maybe_wrap`` gating; ``retry_filesystem_call``; and
``delivery_deficit`` and ``crash_quarantine_record`` on one
ventilate/deliver sequence against JAX's tracker.
"""

import errno
import random
import threading
import time

import pyarrow as pa
import pytest

from petastorm_tpu import faultfs as jfaultfs
from petastorm_tpu import fs as jfs
from petastorm_tpu import lineage as jlineage
from petastorm_tpu import resilience as jresilience

import petastorm_tpu_torch
from petastorm_tpu_torch import faultfs as tfaultfs
from petastorm_tpu_torch import fs as tfs
from petastorm_tpu_torch import lineage as tlineage
from petastorm_tpu_torch import resilience as tresilience

RESILIENCE = {'jax': jresilience, 'torch': tresilience}
FAULTFS = {'jax': jfaultfs, 'torch': tfaultfs}
BOTH = sorted(RESILIENCE)

#: Exceptions and the verdict both packages must give them.
ERRORS = [
    (FileNotFoundError('x'), 'permanent'),
    (PermissionError('x'), 'permanent'),
    (IsADirectoryError('x'), 'permanent'),
    (NotADirectoryError('x'), 'permanent'),
    (FileExistsError('x'), 'permanent'),
    (ConnectionResetError(), 'transient'),
    (TimeoutError(), 'transient'),
    (OSError('no errno at all'), 'transient'),
    (ValueError('bug'), 'permanent'),
    (KeyError('bug'), 'permanent'),
    (RuntimeError('bug'), 'permanent'),
] + [(OSError(code, 'e'), 'permanent') for code in sorted(
    jresilience.PERMANENT_ERRNOS)] + [
    (OSError(code, 'e'), 'transient') for code in (
        errno.EIO, errno.EAGAIN, errno.ECONNRESET, errno.ETIMEDOUT,
        errno.EPIPE, errno.ECONNREFUSED, errno.EINTR)]


def _outcome(fn, *args):
    """``('ok', value)`` or ``('raise', type name, message)``."""
    try:
        return ('ok', fn(*args))
    except Exception as e:      # noqa: BLE001 - compared across packages
        return ('raise', type(e).__name__, str(e))


# -- classification -----------------------------------------------------------

@pytest.mark.parametrize('exc,verdict', ERRORS,
                         ids=[repr(e)[:40] for e, _ in ERRORS])
def test_classification_table(exc, verdict):
    for mod in RESILIENCE.values():
        assert mod.classify_error(exc) == verdict
        assert mod.classify_read_error(exc) == verdict


def test_constants_equal():
    for name in ('PERMANENT_ERRNOS', 'DEFAULT_RETRY', 'DEFAULT_HEDGE',
                 'DEFAULT_RECOVERY', 'TRANSIENT', 'PERMANENT'):
        assert getattr(tresilience, name) == getattr(jresilience, name)
    assert tfaultfs.SCENARIOS == jfaultfs.SCENARIOS
    assert tfaultfs.CHAOS_ENV_VAR == jfaultfs.CHAOS_ENV_VAR


def test_pyarrow_parse_errors_are_transient_for_reads():
    exc = pa.lib.ArrowInvalid('truncated stream')
    for mod in RESILIENCE.values():
        assert mod.classify_error(exc) == 'permanent'
        assert mod.classify_read_error(exc) == 'transient'


# -- RetryPolicy --------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 7, 42])
def test_backoff_draws_equal_under_one_seed(seed):
    draws = {}
    for name, mod in RESILIENCE.items():
        policy = mod.RetryPolicy(attempts=10, initial_backoff_s=0.1,
                                 max_backoff_s=1.0, seed=seed)
        draws[name] = [policy.backoff_s(a) for a in range(8)
                       for _ in range(5)]
    assert draws['torch'] == draws['jax']
    # full jitter: uniform in [0, ceiling], spread below the ceiling
    assert max(draws['torch'][15:20]) <= 0.8
    assert len({round(d, 6) for d in draws['torch']}) > 10


@pytest.mark.parametrize('pkg', BOTH)
def test_transient_retried_until_success(pkg):
    calls = {'n': 0}

    def flaky():
        calls['n'] += 1
        if calls['n'] < 3:
            raise OSError(errno.EIO, 'transient')
        return 'ok'

    policy = RESILIENCE[pkg].RetryPolicy(attempts=3, initial_backoff_s=0.001,
                                         seed=0)
    events = {}
    assert policy.call(flaky, on_event=lambda k, n: events.update(
        {k: events.get(k, 0) + n})) == 'ok'
    assert calls['n'] == 3 and events == {'io_retries': 2}


@pytest.mark.parametrize('pkg', BOTH)
def test_permanent_fails_in_one_attempt(pkg):
    calls = {'n': 0}

    def missing():
        calls['n'] += 1
        raise FileNotFoundError('/no/such/path')

    policy = RESILIENCE[pkg].RetryPolicy(attempts=3, initial_backoff_s=0.001,
                                         seed=0)
    events = {}
    with pytest.raises(FileNotFoundError):
        policy.call(missing, on_event=lambda k, n: events.update(
            {k: events.get(k, 0) + n}))
    assert calls['n'] == 1 and events == {'io_permanent_failures': 1}


@pytest.mark.parametrize('pkg', BOTH)
def test_attempts_exhausted_and_wall_budget(pkg):
    mod = RESILIENCE[pkg]
    calls = {'n': 0}

    def always():
        calls['n'] += 1
        raise OSError(errno.EIO, 'still down')

    with pytest.raises(OSError, match='still down'):
        mod.RetryPolicy(attempts=3, initial_backoff_s=0.001,
                        seed=0).call(always)
    assert calls['n'] == 3

    def slow_fail():
        calls['n'] += 1
        time.sleep(0.05)
        raise OSError(errno.EIO, 'down')

    calls['n'] = 0
    policy = mod.RetryPolicy(attempts=100, initial_backoff_s=0.001,
                             total_budget_s=0.1, seed=0)
    start = time.monotonic()
    with pytest.raises(OSError):
        policy.call(slow_fail)
    assert time.monotonic() - start < 2.0 and calls['n'] < 100
    with pytest.raises(ValueError, match='attempts must be >= 1'):
        mod.RetryPolicy(attempts=0)


def test_on_retry_hook_sequences_equal():
    hooks = {}
    for name, mod in RESILIENCE.items():
        seen = []

        def flaky(_seen=seen):
            if len(_seen) < 2:
                raise OSError(errno.EIO, 'x')
            return 'ok'

        policy = mod.RetryPolicy(attempts=5, initial_backoff_s=0.001, seed=0)
        assert policy.call(flaky, on_retry=lambda e, a, _s=seen: _s.append(
            (type(e).__name__, a))) == 'ok'
        hooks[name] = seen
    assert hooks['torch'] == hooks['jax'] == [('OSError', 0), ('OSError', 1)]


# -- knobs --------------------------------------------------------------------

KNOBS = [
    ('resolve_retry', None), ('resolve_retry', True), ('resolve_retry', False),
    ('resolve_retry', 0), ('resolve_retry', {'attempts': 5}),
    ('resolve_retry', {'atempts': 5}), ('resolve_retry', 'yes'),
    ('resolve_hedge', None), ('resolve_hedge', False), ('resolve_hedge', 0),
    ('resolve_hedge', True), ('resolve_hedge', 0.05), ('resolve_hedge', 2),
    ('resolve_hedge', -1.0), ('resolve_hedge', {'threshold_s': 0.1}),
    ('resolve_hedge', {'treshold_s': 0.1}), ('resolve_hedge', 'fast'),
    ('resolve_recovery', None), ('resolve_recovery', True),
    ('resolve_recovery', False), ('resolve_recovery', {'settle_s': 0.2}),
    ('resolve_recovery', {'max_respawn': 1}), ('resolve_recovery', [1]),
]


@pytest.mark.parametrize('fn,knob', KNOBS, ids=[
    '{}-{!r}'.format(f, k) for f, k in KNOBS])
def test_knob_resolution_equal(fn, knob):
    out = {name: _outcome(getattr(mod, fn), knob)
           for name, mod in RESILIENCE.items()}
    assert out['torch'] == out['jax']


def test_factories_take_and_validate_the_knobs(tmp_path):
    """The three factories take ``retry``, ``hedge`` and
    ``worker_recovery``, and a typo fails the factory with JAX's text."""
    from petastorm_tpu.test_util.dataset_gen import create_test_dataset
    url = 'file://' + str(tmp_path / 'ds')
    create_test_dataset(url, range(8), num_files=1)
    for factory in (petastorm_tpu_torch.make_reader,
                    petastorm_tpu_torch.make_columnar_reader,
                    petastorm_tpu_torch.make_batch_reader):
        with pytest.raises(ValueError, match='unknown retry option'):
            factory(url, retry={'atempts': 2})
        with pytest.raises(ValueError, match='unknown hedge option'):
            factory(url, hedge={'treshold_s': 0.1})
        with pytest.raises(ValueError, match='unknown worker_recovery'):
            factory(url, worker_recovery={'max_respawn': 1})
        with factory(url, workers_count=1, retry={'attempts': 2}, hedge=0.5,
                     worker_recovery=False) as reader:
            assert reader._spec.retry['attempts'] == 2
            assert reader._spec.hedge['threshold_s'] == 0.5
            assert reader._pool._recovery is None
            list(reader)
        with factory(url, workers_count=1) as reader:
            assert reader._spec.retry == jresilience.DEFAULT_RETRY
            assert reader._spec.hedge is None
            assert reader._pool._recovery == jresilience.DEFAULT_RECOVERY


# -- AdaptiveThreshold --------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_adaptive_threshold_equal(seed):
    rng = random.Random(seed)
    samples = [rng.expovariate(50.0) for _ in range(300)]
    currents = {}
    for name, mod in RESILIENCE.items():
        t = mod.AdaptiveThreshold(scale=2.0, min_s=0.005, max_s=0.2,
                                  warmup=8, size=64)
        seen = []
        for s in samples:
            t.observe(s)
            seen.append(t.current())
        currents[name] = seen
    assert currents['torch'] == currents['jax']
    assert currents['torch'][6] is None and currents['torch'][7] is not None


# -- HedgedRead and ResilientIO -----------------------------------------------

def _race(mod, primary_fast: bool):
    """One hedged call with controlled events: the primary blocks until the
    hedge has run (the hedge wins), or the hedge blocks until the primary
    returned (the primary wins). Returns ``(result, events)``."""
    events = {}
    lock = threading.Lock()

    def count(k, n=1):
        with lock:
            events[k] = events.get(k, 0) + n

    hedge = mod.HedgedRead(dict(mod.DEFAULT_HEDGE, threshold_s=0.02),
                           on_event=count)
    release = threading.Event()
    if primary_fast:
        def primary():
            time.sleep(0.05)
            return 'primary'

        def second():
            release.wait(5.0)
            return 'hedge'
    else:
        def primary():
            release.wait(5.0)
            return 'primary'

        def second():
            return 'hedge'
    result = hedge.call(primary, hedge_fn=second)
    release.set()
    hedge.drain()
    return result, events


@pytest.mark.parametrize('primary_fast', [False, True],
                         ids=['hedge-wins', 'primary-wins'])
def test_hedged_read_winners_equal(primary_fast):
    out = {name: _race(mod, primary_fast)
           for name, mod in RESILIENCE.items()}
    assert out['torch'] == out['jax']
    result, events = out['torch']
    if primary_fast:
        assert result == 'primary'
        assert events == {'io_hedges': 1, 'io_hedge_losses': 1}
    else:
        assert result == 'hedge'
        assert events == {'io_hedges': 1, 'io_hedge_wins': 1}


@pytest.mark.parametrize('pkg', BOTH)
def test_hedged_read_fast_errors_and_warmup(pkg):
    mod = RESILIENCE[pkg]
    events = []
    hedge = mod.HedgedRead(dict(mod.DEFAULT_HEDGE, threshold_s=0.5),
                           on_event=lambda k, n=1: events.append(k))
    assert hedge.call(lambda: 'fast') == 'fast' and events == []

    def boom():
        raise OSError(errno.EIO, 'injected')

    with pytest.raises(OSError, match='injected'):
        mod.HedgedRead(dict(mod.DEFAULT_HEDGE, threshold_s=5.0)).call(boom)
    adaptive = mod.HedgedRead(dict(mod.DEFAULT_HEDGE))
    assert adaptive.threshold_s() is None
    assert adaptive.call(lambda: 42) == 42


@pytest.mark.parametrize('pkg', BOTH)
def test_loser_drained_under_trace_replay(pkg):
    """A hedge under the replayed object-store trace (each package's own
    copy of ``s3-us-east-1``) wins against a wedged primary; ``drain()``
    joins the abandoned loser."""
    mod, fault = RESILIENCE[pkg], FAULTFS[pkg]
    injector = fault.FaultInjector('trace-replay', seed=3,
                                   trace='s3-us-east-1', latency_scale=0.001,
                                   bandwidth_scale=1000.0)
    io = mod.ResilientIO(None, dict(mod.DEFAULT_HEDGE, threshold_s=0.01))
    release = threading.Event()

    def stuck_primary():
        release.wait(10.0)
        return 'primary'

    def traced_hedge():
        injector.trace_delay('/d/part-0.parquet', 4096, 65536)
        return 'hedge'

    assert io.read(stuck_primary, hedge_fn=traced_hedge) == 'hedge'
    assert injector.injected['trace_reads'] == 1
    assert io.take_events() == {'io_hedges': 1, 'io_hedge_wins': 1}
    prefix = 'petastorm-{}-hedge-'.format('tpu' if pkg == 'jax' else 'torch')

    def race_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith(prefix)]

    assert any(t.name == prefix + 'primary' for t in race_threads())
    release.set()
    io.drain()
    assert race_threads() == []


def test_trace_is_the_ports_own_copy():
    import json
    path = tfaultfs.trace_path('s3-us-east-1')
    assert '/petastorm_tpu_torch/' in path.replace('\\', '/')
    assert json.load(open(path)) == json.load(open(
        jfaultfs.trace_path('s3-us-east-1')))
    draws = {}
    for name, fault in FAULTFS.items():
        injector = fault.FaultInjector('trace-replay', seed=11,
                                       trace='s3-us-east-1',
                                       latency_scale=1e-6,
                                       bandwidth_scale=1e6)
        for off in range(0, 8 * 4096, 4096):
            injector.trace_delay('/d/p.parquet', off, 4096)
        draws[name] = dict(injector.injected_s)
    assert draws['torch'] == draws['jax']


@pytest.mark.parametrize('pkg', BOTH)
def test_resilient_io_retry_counts_and_passthrough(pkg):
    mod = RESILIENCE[pkg]
    io = mod.ResilientIO(dict(mod.DEFAULT_RETRY, initial_backoff_s=0.001))
    calls = {'n': 0}

    def flaky():
        calls['n'] += 1
        if calls['n'] < 2:
            raise pa.lib.ArrowInvalid('short read')
        return 'ok'

    assert io.read(flaky) == 'ok'
    assert io.take_events() == {'io_retries': 1}
    assert io.take_events() == {}
    assert io.take_spans() == []
    off = mod.ResilientIO(None, None)
    assert not off.enabled and off.read(lambda: 3) == 3


# -- the fault injector -------------------------------------------------------

def _fs_decisions(fault, scenario, seed, overrides, reads=120):
    """Every decision of one injector over a fixed access sequence: each
    read's outcome (``ok``, ``raise``, ``kill``), the truncated lengths,
    and the tallies."""
    injector = fault.FaultInjector(scenario, seed=seed, **overrides)
    out = []
    for i in range(reads):
        path = '/data/part-{}.parquet'.format(i % 3)
        try:
            injector.before_read(path)
            data = injector.after_read(path, b'x' * (64 + i))
            out.append(('ok', len(data)))
        except OSError as e:
            out.append(('raise', e.errno))
        except SystemExit as e:
            out.append(('kill', type(e).__name__))
    return out, dict(injector.injected)


SCENARIO_GRID = [
    ('transient-errors', dict(error_rate=0.3, cooldown_reads=2)),
    ('truncated-reads', dict(truncate_rate=0.3, cooldown_reads=2)),
    ('read-hangs', dict(hang_rate=0.2, hang_s=0.0, cooldown_reads=2)),
    ('tail-latency', dict(tail_rate=0.2, tail_latency_s=0.0)),
    ('worker-kill', dict(kill_after_reads=7, max_kills=3)),
    ('fixed-latency', dict()),
]


@pytest.mark.parametrize('seed', [0, 1, 1234])
@pytest.mark.parametrize('scenario,overrides', SCENARIO_GRID,
                         ids=[s for s, _ in SCENARIO_GRID])
def test_injector_decisions_equal(scenario, overrides, seed):
    out = {name: _fs_decisions(fault, scenario, seed, overrides)
           for name, fault in FAULTFS.items()}
    assert out['torch'] == out['jax']
    decisions, tallies = out['torch']
    if scenario != 'fixed-latency':
        assert tallies, 'the scenario must inject'
    assert len(decisions) == 120


def test_injector_units():
    for fault in FAULTFS.values():
        injector = fault.FaultInjector('transient-errors', seed=0,
                                       error_rate=1.0)
        with pytest.raises(OSError):
            injector.before_read('/data/x.parquet')
        injector.before_read('/data/x.parquet')   # the cooldown window
        kill = fault.FaultInjector('worker-kill', seed=0, kill_after_reads=3)
        for _ in range(2):
            kill.before_read('/d/a.parquet')
        with pytest.raises(fault.SimulatedWorkerCrash):
            kill.before_read('/d/a.parquet')
        for _ in range(10):
            kill.before_read('/d/a.parquet')      # max_kills=1
        assert issubclass(fault.SimulatedWorkerCrash, SystemExit)
        with pytest.raises(ValueError, match='unknown chaos scenario'):
            fault.FaultInjector('tail-latencies')
        with pytest.raises(ValueError, match='param'):
            fault.FaultInjector('tail-latency', tail_rte=0.1)
        enospc = fault.FaultInjector('cache-enospc', seed=0)
        with pytest.raises(OSError) as info:
            enospc.cache_put_fault('digest0')
        assert info.value.errno == errno.ENOSPC
        fault.FaultInjector('tail-latency', seed=0).cache_put_fault('d')


@pytest.mark.parametrize('seed', [0, 5, 9])
def test_host_scenarios_parse_and_decide_as_jax(seed):
    """``host-death`` and ``host-join`` parse in the port (their consumers
    come with the pod plane) and decide as JAX's."""
    out = {}
    for name, fault in FAULTFS.items():
        death = fault.FaultInjector('host-death', seed=seed)
        join = fault.FaultInjector('host-join', seed=seed)
        out[name] = ([death.should_kill_host(h, b) for b in (2, 3, 4)
                      for h in range(4)],
                     [join.should_join_host(b) for b in range(6)])
    assert out['torch'] == out['jax']


def test_replacement_spends_worker_kills(monkeypatch):
    """A process pool's replacement interpreter is not killed again by
    ``worker-kill``; other scenarios stay armed."""
    monkeypatch.setattr(tfaultfs, '_replacement', False)
    tfaultfs.reset_chaos_cache()
    monkeypatch.setenv(tfaultfs.CHAOS_ENV_VAR,
                       'worker-kill:1:kill_after_reads=1')
    tfaultfs.mark_replacement()
    injector = tfaultfs.chaos_from_env()
    for _ in range(5):
        injector.before_read('/d/a.parquet')
    tfaultfs.reset_chaos_cache()
    monkeypatch.setenv(tfaultfs.CHAOS_ENV_VAR,
                       'transient-errors:0:error_rate=1.0')
    with pytest.raises(OSError):
        tfaultfs.chaos_from_env().before_read('/d/a.parquet')
    tfaultfs.reset_chaos_cache()


SPECS = ['', 'none', 'tail-latency:7:tail_rate=0.1,tail_latency_s=0.05',
         'transient-errors:3',
         'worker-kill:505:kill_after_reads=6,max_kills=2',
         'read-hangs:404:hang_rate=0.1,hang_s=0.3', 'cache-enospc',
         'trace-replay:0:trace=s3-us-east-1', 'tail-latncy:3',
         'transient-errors:1:eror_rate=0.1', 'host-death:2', 'host-join:1']


@pytest.mark.parametrize('spec', SPECS)
def test_parse_chaos_equal(spec):
    def parse(fault):
        injector = fault.parse_chaos(spec)
        if injector is None:
            return None
        params = {k: v for k, v in injector.params.items() if k != 'trace'}
        return injector.scenario, injector.seed, params
    out = {name: _outcome(parse, fault) for name, fault in FAULTFS.items()}
    assert out['torch'] == out['jax']


@pytest.mark.parametrize('pkg', BOTH)
def test_maybe_wrap_gates_on_env(pkg, monkeypatch):
    fault = FAULTFS[pkg]
    fault.reset_chaos_cache()
    monkeypatch.delenv(fault.CHAOS_ENV_VAR, raising=False)
    sentinel = object()
    assert fault.maybe_wrap(sentinel) is sentinel
    monkeypatch.setenv(fault.CHAOS_ENV_VAR, 'transient-errors:3')
    assert isinstance(fault.maybe_wrap(sentinel), fault.FaultyFilesystem)
    assert fault.chaos_from_env() is fault.chaos_from_env()   # cached
    fault.reset_chaos_cache()
    monkeypatch.setenv(fault.CHAOS_ENV_VAR, 'cache-enospc:3')
    assert fault.maybe_wrap(sentinel) is sentinel
    with pytest.raises(OSError):
        fault.maybe_inject_cache_fault('k')
    fault.reset_chaos_cache()


def test_faulty_file_reads_through_pyarrow(tmp_path):
    """pyarrow reads a wrapped file through ``read()``: the injector sees
    the reads of a row group, and a truncated read corrupts the parse."""
    import pyarrow.parquet as pq
    path = str(tmp_path / 'x.parquet')
    pq.write_table(pa.table({'a': list(range(1000))}), path,
                   row_group_size=100)
    wrapped = tfaultfs.FaultyFilesystem(
        tfs.LOCAL_FILESYSTEM,
        tfaultfs.FaultInjector('truncated-reads', seed=1, truncate_rate=1.0))
    with pytest.raises((pa.lib.ArrowInvalid, OSError)):
        pq.ParquetFile(wrapped.open(path)).read_row_group(2)
    assert wrapped.injector.injected == {'truncated_read': 1}
    clean = tfaultfs.FaultyFilesystem(tfs.LOCAL_FILESYSTEM,
                                      tfaultfs.FaultInjector('none'))
    table = pq.ParquetFile(clean.open(path)).read_row_group(3)
    assert table.column('a').to_pylist() == list(range(300, 400))
    assert clean.read_calls > 0 and clean.bytes_read > 0


# -- retry_filesystem_call ----------------------------------------------------

@pytest.mark.parametrize('pkg', BOTH)
def test_retry_filesystem_call(pkg):
    retry_filesystem_call = {'jax': jfs, 'torch': tfs}[pkg] \
        .retry_filesystem_call
    calls = {'n': 0}

    @retry_filesystem_call(attempts=3, initial_delay_s=0.001)
    def missing():
        calls['n'] += 1
        raise FileNotFoundError('/typo/path')

    start = time.monotonic()
    with pytest.raises(FileNotFoundError):
        missing()
    assert calls['n'] == 1 and time.monotonic() - start < 0.5

    @retry_filesystem_call
    def flaky():
        calls['n'] += 1
        if calls['n'] < 3:
            raise OSError(errno.EIO, 'x')
        return 'ok'

    calls['n'] = 0
    assert flaky() == 'ok' and calls['n'] == 3
    assert flaky.__name__ == 'flaky'


# -- lineage: delivery deficit and crash quarantine ---------------------------

LINEAGE = {'jax': jlineage, 'torch': tlineage}
PIECES = [('/p0.parquet', 0, 10), ('/p1.parquet', 3, 7), ('/p1.parquet', 4, 0)]


def _ledger_script(lineage):
    """One ventilate/deliver/quarantine sequence; the deficits along it and
    the crash records (``ts`` dropped)."""
    tracker = lineage.LineageTracker(
        enabled=True, dataset_digest='d', shard=1, pieces=PIECES,
        items=[(0, (0, 1)), (1, (0, 3)), (1, (1, 3)), (1, (2, 3)),
               (2, (0, 1))])
    out = [tracker.delivery_deficit(0, 0, (0, 1))]        # unknown epoch
    for key in [(0, (0, 1)), (1, (0, 3)), (1, (1, 3)), (1, (2, 3))]:
        tracker.record_ventilated(0, key[0], key[1])
    out.append([tracker.delivery_deficit(0, k, p) for k, p in
                [(0, (0, 1)), (1, (0, 3)), (1, (1, 3)), (1, (2, 3))]])
    tracker.register(lineage.Provenance('d', 0, '/p0.parquet', 0, 10,
                                        ('all', 10), 0, 1, 0, (0, 1), 0))
    record = lineage.crash_quarantine_record(tracker, 1, 0, (1, 3), 3)
    tracker.add_quarantines([record])
    out.append([tracker.delivery_deficit(0, k, p) for k, p in
                [(0, (0, 1)), (1, (0, 3)), (1, (1, 3)), (1, (2, 3))]])
    out.append(tracker.delivery_deficit(0, None, (0, 1)))
    records = [lineage.crash_quarantine_record(tracker, *args) for args in
               [(1, 0, (0, 3), 2), (1, 0, (2, 3), 2), (0, 4, None, 5),
                (2, 0, (0, 1), 3), (None, 1, (0, 1), 3)]]
    out.append([{k: v for k, v in r.items() if k != 'ts'}
                for r in [record] + records])
    out.append(lineage.LineageTracker(enabled=False).delivery_deficit(
        0, 0, (0, 1)))
    return out


def test_delivery_deficit_and_crash_records_equal():
    out = {name: _ledger_script(mod) for name, mod in LINEAGE.items()}
    assert out['torch'] == out['jax']
    script = out['torch']
    assert script[0] is None and script[1] == [1, 1, 1, 1]
    assert script[2] == [0, 1, 0, 1]
    assert script[-1] is None
    rows = [r['rows'] for r in script[4]]
    assert rows == [2, 3, 2, 10, 1, 1]        # np.array_split of 7 rows in 3
    assert {r['stage'] for r in script[4]} == {'worker-crash'}


def test_public_names():
    assert petastorm_tpu_torch.RetryPolicy is tresilience.RetryPolicy
    assert petastorm_tpu_torch.HedgedRead is tresilience.HedgedRead
    assert petastorm_tpu_torch.FaultInjector is tfaultfs.FaultInjector
    assert {'RetryPolicy', 'HedgedRead', 'FaultInjector'} <= set(
        petastorm_tpu_torch.__all__)
