"""Pod observability: one surface for the metrics, read-plane latency and
decode-once certificate of several hosts.

The port's copy of ``petastorm_tpu/podobs.py``, with its environment
variables, routes, headers, JSON kinds and keys, merge rules and verdict
wording, so a port host and a JAX host poll and merge each other. Host
code that imports no torch: worker interpreters import it.

- **The per-host surface.** :func:`make_observe_fn` builds what a
  :class:`~petastorm_tpu_torch.health.DebugServer` serves on
  ``GET /observe/snapshot``: the stats counters, the raw latency-histogram
  bucket states, the health verdict with its degraded causes, the SLO
  burn, the lineage coverage digest, the shared cache's ``fills`` and
  ``peer_hits``, a span tail, the goodput summary, an elastic section, and
  the host's ``time.perf_counter()`` reading (the clock-offset anchor).
- **The aggregator.** :class:`PodObserver` polls a ``host:port`` list (the
  shared cache's ``peers`` convention) and merges: counters by addition,
  histograms by bucket-count addition (a pod p99 equals the p99 of one
  histogram that recorded every observation, since integer counts have no
  merge order), health by worst-of with each host's causes named, and the
  pod decode-once certificate ``sum(fills) == distinct row groups``. A host
  that does not answer turns the verdict into :data:`PARTIAL_POD`, named,
  never a silently smaller denominator.
- **Clock alignment.** Peer-cache requests and ``/observe`` replies carry
  :data:`TRACE_HEADER` (a request id) and :data:`CLOCK_HEADER` (the
  server's monotonic reading); the observer estimates each host's offset as
  ``remote_clock - (t0 + t1) / 2``, and
  :func:`petastorm_tpu_torch.tracing.stitch_pod_trace` writes one aligned
  timeline of every host.

On by default; ``PETASTORM_TPU_PODOBS=0`` makes no thread, route or file:
both routes answer 404, no ``range_fetch`` / ``peer_fetch`` /
``io_attempt`` span or latency is recorded, and no trace header is sent.
The observer never starts a thread: it polls on its caller's thread (a
call, the ``petastorm-tpu-torch-podstat`` command, or a request to the
``/podmetrics`` route of the host that embeds it).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
import time
import urllib.request
import uuid
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from petastorm_tpu_torch.latency import (LatencyHistogram, NUM_BUCKETS,
                                         QUANTILE_REL_ERROR_BOUND)

logger = logging.getLogger(__name__)

#: Environment variable gating the whole plane (default on).
#: ``0``/``false``/``off``: no ``/observe/snapshot`` or ``/podmetrics``
#: routes, no ``range_fetch`` / ``peer_fetch`` / ``io_attempt`` span or
#: latency recording, no trace headers on peer-cache requests.
PODOBS_ENV_VAR = 'PETASTORM_TPU_PODOBS'

#: Comma-separated ``host:port`` list of the pod's debug endpoints; when set
#: (and the plane is on), a reader embeds a :class:`PodObserver` and serves
#: its report on ``/podmetrics``.
PODOBS_PEERS_ENV_VAR = 'PETASTORM_TPU_PODOBS_PEERS'

#: Request and response header carrying the trace id: one id stamped by
#: the client rides through a peer-cache fetch or an observe poll.
TRACE_HEADER = 'X-Petastorm-Trace'

#: Response header carrying the server's ``time.perf_counter()`` at reply
#: time: the clock-offset anchor (monotonic clocks of two hosts are not
#: comparable; the offset estimate makes them so).
CLOCK_HEADER = 'X-Petastorm-Clock-S'

#: Route of the per-host snapshot.
SNAPSHOT_ROUTE = '/observe/snapshot'

#: Route of the merged pod report on an aggregating host.
PODMETRICS_ROUTE = '/podmetrics'

#: The named verdict when a polled host is unreachable: the report merges
#: every host that answered, and the certificate refuses an incomplete
#: denominator.
PARTIAL_POD = 'partial_pod'

#: Pipeline states from best to worst, as ``health`` names them (kept
#: literal so the pod plane does not import the HTTP and watchdog module).
VERDICT_ORDER = ('healthy', 'degraded', 'starving', 'stalled')

#: Snapshot keys that do not merge by addition: spans and fractions would
#: double-count, percentiles come from the merged histograms instead.
_NON_ADDITIVE_KEYS = frozenset({'window_s', 'io_overlap_fraction', 'pid',
                                'epoch',
                                # pod-wide constants every elastic host
                                # reports alike: summing K copies would
                                # inflate the certificate's denominator
                                'expected_batches'})
_NON_ADDITIVE_SUFFIXES = ('_p50_s', '_p90_s', '_p99_s', '_p999_s',
                          '_fraction')

#: Poll timeout a peer, the shared cache's ``peer_timeout_s`` default.
DEFAULT_TIMEOUT_S = 2.0


def podobs_enabled() -> bool:
    """The :data:`PODOBS_ENV_VAR` gate (default on): the one switch of the
    port's pod plane."""
    value = os.environ.get(PODOBS_ENV_VAR, '').strip().lower()
    return value not in ('0', 'false', 'off')


def pod_peers_from_env() -> Tuple[str, ...]:
    """The :data:`PODOBS_PEERS_ENV_VAR` peer list (empty when unset)."""
    return parse_peers(os.environ.get(PODOBS_PEERS_ENV_VAR, ''))


def parse_peers(peers) -> Tuple[str, ...]:
    """A comma-separated string or an iterable of ``host:port`` strings as
    a tuple. An entry without a port raises: it would poll the wrong
    surface."""
    if peers is None:
        return ()
    if isinstance(peers, str):
        parts: Iterable[str] = peers.split(',')
    else:
        parts = peers
    out = []
    for part in parts:
        part = str(part).strip()
        if not part:
            continue
        if ':' not in part:
            raise ValueError('peer {!r} is not host:port (the shared-cache '
                             'peers= convention)'.format(part))
        out.append(part)
    return tuple(out)


def new_trace_id() -> str:
    """A fresh trace id for :data:`TRACE_HEADER`."""
    return uuid.uuid4().hex


# -- the per-host surface -----------------------------------------------------

def make_observe_fn(snapshot_fn: Optional[Callable[[], dict]] = None,
                    health_fn: Optional[Callable[[], dict]] = None,
                    slo_fn: Optional[Callable[[], dict]] = None,
                    coverage_fn: Optional[Callable[[], dict]] = None,
                    cache_counters_fn: Optional[Callable[[], dict]] = None,
                    span_tail_fn: Optional[Callable[[], list]] = None,
                    elastic_fn: Optional[Callable[[], dict]] = None,
                    goodput_fn: Optional[Callable[[], dict]] = None,
                    host: Optional[str] = None) -> Callable[[], dict]:
    """The ``observe_fn`` a ``DebugServer`` serves on
    :data:`SNAPSHOT_ROUTE`: one JSON-able dict of every per-host surface
    the pod merge reads. Each section is fenced: a broken sensor reports
    ``{'error': ...}`` in its own section, and the other sections of a
    sick host still reach the aggregator."""
    host = host or socket.gethostname()

    def _section(fn):
        if fn is None:
            return None
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - fence per sensor
            logger.debug('observe snapshot section failed', exc_info=True)
            return {'error': '{}: {}'.format(type(e).__name__, e)}

    def observe() -> dict:
        from petastorm_tpu_torch.workers.stats import LATENCY_HISTOGRAMS_KEY
        stats = _section(snapshot_fn) or {}
        histograms = {}
        if isinstance(stats, dict):
            stats = dict(stats)
            histograms = stats.pop(LATENCY_HISTOGRAMS_KEY, None) or {}
        return {
            'kind': 'petastorm_tpu.observe_snapshot',
            'version': 1,
            'host': host,
            'pid': os.getpid(),
            'clock_s': time.perf_counter(),
            'stats': stats,
            'latency_histograms': histograms,
            'health': _section(health_fn),
            'slo': _section(slo_fn),
            'coverage': _section(coverage_fn),
            'cache': _section(cache_counters_fn),
            'span_tail': _section(span_tail_fn),
            'elastic': _section(elastic_fn),
            'goodput': _section(goodput_fn),
        }

    return observe


# -- merge rules --------------------------------------------------------------

def merge_counters(snapshots: Sequence[Optional[dict]]) -> dict:
    """Per-host scalar counters merged **by addition**, skipping the keys
    that do not add (spans, fractions, percentiles: the pod tail comes from
    :func:`merge_histogram_states`, never from averaged percentiles)."""
    totals: Dict[str, float] = {}
    for snap in snapshots:
        for key, value in (snap or {}).items():
            if key.startswith('_') or isinstance(value, bool):
                continue
            if not isinstance(value, (int, float)):
                continue
            if key in _NON_ADDITIVE_KEYS or key.endswith(
                    _NON_ADDITIVE_SUFFIXES):
                continue
            totals[key] = totals.get(key, 0) + value
    return totals


def merge_histogram_states(
        state_maps: Sequence[Optional[Dict[str, dict]]]) -> Dict[str, dict]:
    """Per-host ``{stage: state}`` exports (``LatencyHistogram.state()``)
    merged by bucket-count addition. The counts are integers over fixed
    bounds, so the merge has no order: the pod histogram's buckets equal
    those of one histogram that recorded every observation (the float
    ``sum`` depends on the order of addition, so it equals it only
    approximately)."""
    merged: Dict[str, dict] = {}
    for states in state_maps:
        for stage, state in (states or {}).items():
            agg = merged.setdefault(stage, {'buckets': {}, 'sum': 0.0,
                                            'count': 0})
            for index, n in (state.get('buckets') or ()):
                index = min(int(index), NUM_BUCKETS)
                agg['buckets'][index] = agg['buckets'].get(index, 0) + int(n)
            agg['sum'] += float(state.get('sum', 0.0))
            agg['count'] += int(state.get('count', 0))
    return {stage: {'buckets': [[i, n]
                                for i, n in sorted(agg['buckets'].items())
                                if n],
                    'sum': agg['sum'], 'count': agg['count']}
            for stage, agg in merged.items()}


def state_percentiles(state: dict) -> Dict[str, Optional[float]]:
    """p50, p90, p99 and p999 of one histogram ``state``, by loading its
    counts into a :class:`~petastorm_tpu_torch.latency.LatencyHistogram`:
    the estimator and its error bound are the per-host plane's own."""
    histogram = LatencyHistogram()
    histogram.merge_delta({
        'buckets': {int(i): int(n) for i, n in (state.get('buckets') or ())},
        'sum': float(state.get('sum', 0.0)),
        'count': int(state.get('count', 0))})
    return histogram.percentiles()


def merge_health(verdicts_by_host: Dict[str, Optional[dict]]) -> dict:
    """Worst-of health with each host's causes named: the pod state is the
    worst host state (:data:`VERDICT_ORDER`), and each host's state, hint
    and ``degraded_causes`` ride under ``by_host``, so "the pod is
    degraded" always says which host and why."""
    worst, worst_rank = VERDICT_ORDER[0], 0
    by_host = {}
    causes: List[str] = []
    for host, verdict in sorted(verdicts_by_host.items()):
        verdict = verdict or {}
        state = verdict.get('state') or VERDICT_ORDER[0]
        try:
            rank = VERDICT_ORDER.index(state)
        except ValueError:
            rank = 1    # an unknown state is degraded, never healthy
        host_causes = list(verdict.get('degraded_causes') or [])
        by_host[host] = {'state': state, 'hint': verdict.get('hint'),
                         'causes': host_causes}
        causes.extend('{}: {}'.format(host, c) for c in host_causes)
        if rank > worst_rank:
            worst, worst_rank = state, rank
    return {'state': worst, 'by_host': by_host, 'causes': causes}


class PodCertificateError(AssertionError):
    """The pod certificate failed, or could not be checked against a full
    denominator. An ``AssertionError``, like the coverage auditor's."""


def check_pod_certificate(cache_totals: Optional[dict],
                          expected_row_groups: Optional[int] = None,
                          unreachable: Sequence[str] = (),
                          elastic_totals: Optional[dict] = None,
                          expected_batches: Optional[int] = None) -> dict:
    """The pod decode-once certificate from summed shared-cache counters:
    ``sum(fills) == distinct row groups`` (each row group decoded exactly
    once in the pod), ``peer_hits`` tallied as the evidence of sharing. An
    unreachable host makes it uncheckable (its fills are missing from the
    sum), a named problem, never a pass.

    With the elastic plane, ``elastic_totals`` (summed
    ``ElasticHost.elastic_snapshot()`` counters) and ``expected_batches``
    (the lease grid's total) extend it to **exactly-once delivery across
    membership changes**: ``sum(batches_delivered)`` must equal the grid
    (more: a batch delivered twice across a rebalance; fewer: one
    dropped), ``batches_skipped_claimed`` tallied as the fence's evidence.
    :class:`~petastorm_tpu_torch.podelastic.ElasticCoverageAuditor` names
    each duplicate or drop by host, path and row group."""
    cache_totals = cache_totals or {}
    fills = int(cache_totals.get('fills', 0) or 0)
    peer_hits = int(cache_totals.get('peer_hits', 0) or 0)
    problems: List[str] = []
    unreachable = list(unreachable)
    if unreachable:
        problems.append(
            '{}: {} host(s) unreachable ({}) — their fills are missing '
            'from the sum, so the certificate denominator is incomplete; '
            'refusing to certify'.format(PARTIAL_POD, len(unreachable),
                                         ', '.join(map(str, unreachable))))
    checked = expected_row_groups is not None and not unreachable
    if checked:
        expected = int(expected_row_groups)  # type: ignore[arg-type]
        if fills > expected:
            problems.append(
                'duplicate fills: {} fills recorded for {} distinct row '
                'groups — some row group was decoded more than once '
                '(a forged or double-published fill)'.format(fills,
                                                             expected))
        elif fills < expected:
            problems.append(
                'missing fills: {} fills recorded for {} distinct row '
                'groups — either the run is incomplete or a fill counter '
                'was lost'.format(fills, expected))
    elastic_totals = elastic_totals or {}
    delivered = int(elastic_totals.get('batches_delivered', 0) or 0)
    elastic_checked = expected_batches is not None and not unreachable
    if elastic_checked:
        expected_b = int(expected_batches)  # type: ignore[arg-type]
        if delivered > expected_b:
            problems.append(
                'duplicate delivery: {} batches delivered for a {}-batch '
                'lease grid — some batch was delivered more than once '
                'across a rebalance (the delivery claim fence was '
                'bypassed)'.format(delivered, expected_b))
        elif delivered < expected_b:
            problems.append(
                'dropped delivery: {} batches delivered for a {}-batch '
                'lease grid — a batch was lost across a membership '
                'change'.format(delivered, expected_b))
    ok: Optional[bool]
    if unreachable:
        ok = False
    elif checked or elastic_checked:
        ok = not problems
    else:
        ok = None   # nothing to certify against; never a silent pass
    certificate = {'fills': fills, 'peer_hits': peer_hits,
                   'peer_misses': int(cache_totals.get('peer_misses', 0) or 0),
                   'peer_errors': int(cache_totals.get('peer_errors', 0) or 0),
                   'expected_row_groups': expected_row_groups,
                   'unreachable': unreachable,
                   'checked': checked, 'ok': ok, 'problems': problems}
    if expected_batches is not None or elastic_totals:
        certificate['elastic'] = {
            'batches_delivered': delivered,
            'batches_skipped_claimed': int(
                elastic_totals.get('batches_skipped_claimed', 0) or 0),
            'leases_rebalanced': int(
                elastic_totals.get('leases_rebalanced', 0) or 0),
            'rows_resumed': int(elastic_totals.get('rows_resumed', 0) or 0),
            'expected_batches': expected_batches,
            'checked': elastic_checked,
        }
    return certificate


def check_pod_goodput(goodput_by_host: Optional[Dict[str, Optional[dict]]],
                      min_goodput: Optional[float] = None,
                      unreachable: Sequence[str] = ()) -> dict:
    """The pod goodput verdict from per-host ``/goodput`` summaries
    (``GoodputMonitor.summary()``): the pod fractions come from the SUMMED
    seconds, never averaged, so a straggler cannot hide behind the other
    hosts' means, and the host that stalls most is named the straggler.
    ``min_goodput`` arms the check; an unreachable host makes it
    uncheckable, a named :data:`PARTIAL_POD` refusal."""
    totals = {'steps': 0, 'fenced_steps': 0, 'total_s': 0.0, 'stall_s': 0.0,
              'h2d_s': 0.0, 'device_s': 0.0, 'host_s': 0.0}
    by_host: Dict[str, dict] = {}
    for host, section in sorted((goodput_by_host or {}).items()):
        state = (section or {}).get('state') or {}
        total = float(state.get('total_s', 0.0) or 0.0)
        if total <= 0.0:
            continue
        stall = float(state.get('stall_s', 0.0) or 0.0)
        h2d = float(state.get('h2d_s', 0.0) or 0.0)
        device = float(state.get('device_s', 0.0) or 0.0)
        totals['steps'] += int(state.get('steps', 0) or 0)
        totals['fenced_steps'] += int(state.get('fenced_steps', 0) or 0)
        totals['total_s'] += total
        totals['stall_s'] += stall
        totals['h2d_s'] += h2d
        totals['device_s'] += device
        totals['host_s'] += float(state.get('host_s', 0.0) or 0.0)
        by_host[host] = {
            'steps': int(state.get('steps', 0) or 0),
            'goodput_fraction': round(device / total, 4),
            'data_stall_fraction': round((stall + h2d) / total, 4),
        }
    pod_total = totals['total_s']
    goodput_fraction = (round(totals['device_s'] / pod_total, 4)
                        if pod_total > 0 else None)
    data_stall_fraction = (
        round((totals['stall_s'] + totals['h2d_s']) / pod_total, 4)
        if pod_total > 0 else None)
    straggler = None
    if by_host:
        worst = max(by_host, key=lambda h: by_host[h]['data_stall_fraction'])
        straggler = dict(by_host[worst], host=worst)
    problems: List[str] = []
    unreachable = list(unreachable)
    if unreachable:
        problems.append(
            '{}: {} host(s) unreachable ({}) — their step seconds are '
            'missing from the sum; refusing to certify pod goodput'.format(
                PARTIAL_POD, len(unreachable),
                ', '.join(map(str, unreachable))))
    checked = (min_goodput is not None and goodput_fraction is not None
               and not unreachable)
    if checked and goodput_fraction < float(min_goodput):  # type: ignore[arg-type]
        detail = ''
        if straggler is not None:
            detail = (' — straggler {}: data_stall_fraction {}, '
                      'goodput_fraction {}'.format(
                          straggler['host'],
                          straggler['data_stall_fraction'],
                          straggler['goodput_fraction']))
        problems.append('pod goodput {} below min_goodput {}{}'.format(
            goodput_fraction, float(min_goodput), detail))
    ok: Optional[bool]
    if unreachable:
        ok = False
    elif checked:
        ok = not problems
    else:
        ok = None   # no target or no data; never a silent pass
    return {'goodput_fraction': goodput_fraction,
            'data_stall_fraction': data_stall_fraction,
            'totals': totals, 'by_host': by_host, 'straggler': straggler,
            'min_goodput': min_goodput, 'unreachable': unreachable,
            'checked': checked, 'ok': ok, 'problems': problems}


# -- the aggregator -----------------------------------------------------------

class PodObserver:
    """Polls a pod's ``/observe/snapshot`` surfaces and merges them into one
    report.

    A reader serves :meth:`report` on ``/podmetrics`` when
    :data:`PODOBS_PEERS_ENV_VAR` names the pod; ``petastorm-tpu-torch-
    podstat`` (:func:`main`) and scripts call it directly. It never starts
    a thread: every poll runs on its caller's thread.

    ``expected_row_groups`` arms the decode-once certificate,
    ``expected_batches`` the exactly-once delivery certificate and
    ``min_goodput`` the pod goodput verdict; :meth:`assert_certificate`
    raises :class:`PodCertificateError`."""

    def __init__(self, peers, timeout_s: float = DEFAULT_TIMEOUT_S,
                 expected_row_groups: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 expected_batches: Optional[int] = None,
                 min_goodput: Optional[float] = None):
        self.peers = parse_peers(peers)
        if not self.peers:
            raise ValueError('PodObserver needs at least one host:port peer')
        self.timeout_s = float(timeout_s)
        self.expected_row_groups = expected_row_groups
        self.expected_batches = expected_batches
        #: the floor of the pod goodput fraction (from summed seconds),
        #: the straggler named on a breach
        self.min_goodput = min_goodput
        self.trace_id = trace_id or new_trace_id()
        self.last_report: Optional[dict] = None

    # -- polling --------------------------------------------------------------

    def fetch_snapshot(self, peer: str) -> dict:
        """One peer's snapshot with the poll's annotations: ``_peer``,
        ``_rtt_s`` and ``_clock_offset_s``, the estimate
        ``remote_clock - (t0 + t1) / 2`` (what to add to a local
        ``perf_counter`` reading to land on that host's clock, good to
        about half the round trip)."""
        url = 'http://{}{}'.format(peer, SNAPSHOT_ROUTE)
        request = urllib.request.Request(
            url, headers={TRACE_HEADER: self.trace_id})
        t0 = time.perf_counter()
        with urllib.request.urlopen(request,
                                    timeout=self.timeout_s) as response:
            body = response.read()
            t1 = time.perf_counter()
            clock_header = response.headers.get(CLOCK_HEADER)
        snapshot = json.loads(body.decode('utf-8'))
        remote_clock = None
        if clock_header:
            try:
                remote_clock = float(clock_header)
            except ValueError:
                remote_clock = None
        if remote_clock is None:
            remote_clock = snapshot.get('clock_s')
        snapshot['_peer'] = peer
        snapshot['_rtt_s'] = t1 - t0
        snapshot['_clock_offset_s'] = (
            remote_clock - (t0 + t1) / 2.0
            if isinstance(remote_clock, (int, float)) else None)
        return snapshot

    def poll(self) -> Tuple[List[dict], List[dict]]:
        """``(snapshots, unreachable)``: each peer that answered, and a
        ``{'peer', 'error'}`` record for each one that did not."""
        snapshots, unreachable = [], []
        for peer in self.peers:
            try:
                snapshots.append(self.fetch_snapshot(peer))
            except Exception as e:  # noqa: BLE001 - a dead peer is a verdict
                unreachable.append({'peer': peer,
                                    'error': '{}: {}'.format(
                                        type(e).__name__, e)})
        return snapshots, unreachable

    # -- merging --------------------------------------------------------------

    def merge(self, snapshots: List[dict],
              unreachable: Optional[List[dict]] = None) -> dict:
        """The pod report of polled snapshots: a function of its inputs
        alone (tests drive it with simulated hosts, no HTTP)."""
        unreachable = list(unreachable or [])
        hosts = []
        health_by_host: Dict[str, Optional[dict]] = {}
        stats_list, histogram_maps, cache_list = [], [], []
        elastic_list: List[Optional[dict]] = []
        goodput_by_host: Dict[str, Optional[dict]] = {}
        slo_burns: Dict[str, float] = {}
        hard_breach_hosts: List[str] = []
        coverage_by_host = {}
        trace_tracks = []
        for snapshot in snapshots:
            label = str(snapshot.get('_peer') or snapshot.get('host'))
            health = snapshot.get('health')
            hosts.append({
                'peer': snapshot.get('_peer'),
                'host': snapshot.get('host'),
                'pid': snapshot.get('pid'),
                'rtt_s': snapshot.get('_rtt_s'),
                'clock_offset_s': snapshot.get('_clock_offset_s'),
                'state': (health or {}).get('state'),
            })
            health_by_host[label] = health
            stats_list.append(snapshot.get('stats'))
            histogram_maps.append(snapshot.get('latency_histograms'))
            cache_list.append(snapshot.get('cache'))
            elastic_list.append(snapshot.get('elastic'))
            goodput = snapshot.get('goodput')
            if goodput is not None:
                goodput_by_host[label] = goodput
            slo = snapshot.get('slo') or {}
            burn = slo.get('burn_rate')
            if isinstance(burn, (int, float)):
                slo_burns[label] = float(burn)
            if slo.get('hard_breach'):
                hard_breach_hosts.append(label)
            coverage = snapshot.get('coverage')
            if coverage is not None:
                coverage_by_host[label] = coverage
            span_tail = snapshot.get('span_tail')
            if span_tail:
                trace_tracks.append({
                    'host': label,
                    'pid': snapshot.get('pid'),
                    'clock_offset_s': snapshot.get('_clock_offset_s'),
                    'spans': span_tail,
                })
        merged_histograms = merge_histogram_states(histogram_maps)
        latency = {}
        for stage, state in sorted(merged_histograms.items()):
            entry = {'count': state['count'],
                     'sum_s': round(state['sum'], 6)}
            for name, value in state_percentiles(state).items():
                entry[name + '_s'] = (round(value, 9)
                                      if value is not None else None)
            latency[stage] = entry
        health = merge_health(health_by_host)
        cache_totals = merge_counters(cache_list)
        elastic_totals = merge_counters(elastic_list)
        certificate = check_pod_certificate(
            cache_totals, self.expected_row_groups,
            unreachable=[u['peer'] for u in unreachable],
            elastic_totals=elastic_totals,
            expected_batches=self.expected_batches)
        goodput = check_pod_goodput(
            goodput_by_host, min_goodput=self.min_goodput,
            unreachable=[u['peer'] for u in unreachable])
        verdict = PARTIAL_POD if unreachable else health['state']
        report = {
            'kind': 'petastorm_tpu.podmetrics',
            'version': 1,
            'trace_id': self.trace_id,
            'peers': list(self.peers),
            'hosts': hosts,
            'hosts_reporting': len(snapshots),
            'unreachable': unreachable,
            'verdict': verdict,
            'health': health,
            'counters': merge_counters(stats_list),
            'latency': latency,
            'latency_histograms': merged_histograms,
            'quantile_rel_error_bound': QUANTILE_REL_ERROR_BOUND,
            'slo': {'burn_rate_by_host': slo_burns,
                    'worst_burn_rate': (max(slo_burns.values())
                                        if slo_burns else None),
                    'hard_breach_hosts': hard_breach_hosts},
            'coverage': coverage_by_host,
            'cache': {'totals': cache_totals,
                      'by_host': {str(h.get('peer') or h.get('host')):
                                  c for h, c in zip(hosts, cache_list)
                                  if c is not None}},
            'elastic': {'totals': elastic_totals,
                        'by_host': {str(h.get('peer') or h.get('host')):
                                    e for h, e in zip(hosts, elastic_list)
                                    if e is not None}},
            'certificate': certificate,
            'goodput': goodput,
            'trace_tracks': trace_tracks,
        }
        self.last_report = report
        return report

    def report(self) -> dict:
        """One poll and merge: THE pod report (what an aggregating host
        serves on :data:`PODMETRICS_ROUTE`)."""
        snapshots, unreachable = self.poll()
        return self.merge(snapshots, unreachable)

    def assert_certificate(self, report: Optional[dict] = None) -> dict:
        """The certificate of ``report`` (or of a fresh :meth:`report`);
        raises :class:`PodCertificateError` naming every problem: duplicate
        or missing fills, duplicate or dropped deliveries, an unreachable
        host."""
        if report is None:
            report = self.report()
        certificate = report.get('certificate') or {}
        if certificate.get('ok') is True:
            return certificate
        problems = list(certificate.get('problems') or [])
        if certificate.get('ok') is None:
            problems.append('certificate unchecked: pass '
                            'expected_row_groups to arm it')
        raise PodCertificateError(
            'pod decode-once certificate failed: ' + '; '.join(problems))

    def export_pod_chrome_trace(self, path: str,
                                report: Optional[dict] = None) -> str:
        """The polled hosts' span tails as one clock-aligned Chrome trace
        at ``path`` (https://ui.perfetto.dev opens it)."""
        if report is None:
            report = self.last_report or self.report()
        from petastorm_tpu_torch.tracing import stitch_pod_trace
        return stitch_pod_trace(report.get('trace_tracks') or [], path)


# -- the command --------------------------------------------------------------

def main(argv=None) -> int:
    """``petastorm-tpu-torch-podstat``: poll a pod's debug endpoints and
    print the merged report. Exits 1 on a :data:`PARTIAL_POD` verdict, a
    failed certificate (``--expect-row-groups``) or a pod goodput below
    ``--min-goodput``, as ``/healthz`` status codes do."""
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-torch-podstat',
        description='Aggregate pod-wide petastorm-tpu observability: poll '
                    'each host\'s /observe/snapshot and merge counters, '
                    'latency histograms, health, and the decode-once '
                    'certificate onto one surface.')
    parser.add_argument('peers', nargs='?', default=None,
                        help='comma-separated host:port list of debug '
                             'endpoints (default: ${})'.format(
                                 PODOBS_PEERS_ENV_VAR))
    parser.add_argument('--timeout', type=float, default=DEFAULT_TIMEOUT_S,
                        help='per-peer poll timeout in seconds '
                             '(default %(default)s)')
    parser.add_argument('--expect-row-groups', type=int, default=None,
                        help='arm the decode-once certificate: the number '
                             'of distinct row groups the pod must have '
                             'decoded exactly once')
    parser.add_argument('--min-goodput', type=float, default=None,
                        help='arm the pod goodput verdict: the pod-wide '
                             'goodput fraction (summed seconds, straggler '
                             'named) must meet this [0, 1] floor')
    parser.add_argument('--trace-out', default=None,
                        help='also write the stitched pod chrome trace '
                             'to this path')
    parser.add_argument('--compact', action='store_true',
                        help='single-line JSON output')
    args = parser.parse_args(argv)
    peers = args.peers or os.environ.get(PODOBS_PEERS_ENV_VAR, '')
    if not parse_peers(peers):
        parser.error('no peers: pass host:port[,host:port...] or set '
                     '{}'.format(PODOBS_PEERS_ENV_VAR))
    observer = PodObserver(peers, timeout_s=args.timeout,
                           expected_row_groups=args.expect_row_groups,
                           min_goodput=args.min_goodput)
    report = observer.report()
    print(json.dumps(report, indent=None if args.compact else 2,
                     sort_keys=True, default=str))
    if args.trace_out:
        observer.export_pod_chrome_trace(args.trace_out, report)
        print('pod trace written to {}'.format(args.trace_out),
              file=sys.stderr)
    if report['verdict'] == PARTIAL_POD:
        return 1
    if args.expect_row_groups is not None:
        try:
            observer.assert_certificate(report)
        except PodCertificateError as e:
            print(str(e), file=sys.stderr)
            return 1
    if args.min_goodput is not None:
        goodput = report.get('goodput') or {}
        if goodput.get('ok') is not True:
            for problem in goodput.get('problems') or (
                    'pod goodput unchecked: no host reported step data',):
                print(problem, file=sys.stderr)
            return 1
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
