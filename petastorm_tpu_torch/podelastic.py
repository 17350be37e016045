"""Elastic pod membership: shard leases that move when a host dies or joins
mid-epoch, with a machine-checked exactly-once certificate.

The port's copy of ``petastorm_tpu/podelastic.py``. Its coordination
records (``members/``, ``leases/``, ``delivered/``) are the same JSON as
JAX's, field for field, and its rendezvous hash, lease partition and batch
grid are the same functions, so a pod may mix the two packages and either
package's auditor certifies the other's ledger. Host code that imports no
torch: batches reach the consumer as the
:class:`~petastorm_tpu_torch.indexed.IndexedDatasetReader`'s numpy
columns, and the consumer stages them to the card.

Substrate
---------
The pod coordinates through a **shared coordination directory**
(``coord_root``), the one filesystem every host mounts, as the shared
row-group cache already asks of a pod. The HTTP plane of
:mod:`~petastorm_tpu_torch.podobs` is not a fallback: elasticity without a
``coord_root`` raises :class:`ElasticConfigError`.

Every publication is atomic (``utils.atomic_write``: a temporary file and
``os.replace``), and the one fencing write, a batch's delivery record, is
an ``os.link`` claim: the record goes to a temporary file, which is linked
to its final name, and ``FileExistsError`` means another host delivered
the batch. The link exists with its whole content or not at all. The
temporary file and the final name must be on one filesystem: keep
``coord_root`` on one mount.

Liveness in beats
-----------------
Member records carry a ``beats`` counter that only grows, never a
timestamp (the wall clocks of two hosts do not compare). An observer keeps,
for each peer, the last counter it saw and how many of its *own* beats have
passed since it last grew: a host is dead when its counter did not grow
within ``ttl_beats`` of the observer's beats. A simulated pod stepping K
hosts round-robin in one process is therefore as deterministic as a real
pod beating on a cadence.

Leases and rebalancing
----------------------
The row groups split into ``num_leases`` contiguous ranges
(:class:`LeasePlan`). Lease *i* belongs to the live host with the highest
``md5('{i}:{host}')`` (:func:`rendezvous_assign`): when a host dies only
its leases move, and when one joins only the leases it wins move. No
coordinator, no election: every host computes the same assignment from the
same sorted live set.

Exactly once across a rebalance
-------------------------------
A lease's batches are a (seed, epoch, lease)-keyed permutation of its rows
cut into fixed batches: any holder computes the same batch. Delivering
batch *b* is the creation of its claim record; the lease's cursor is
published after the claim. A takeover resumes at
``max(checkpointed cursor, max(claimed batch) + 1)``: the claim scan covers
a host that died between a claim and its cursor (never delivered twice),
and an unclaimed batch in flight is produced again by the new holder
(never lost). :class:`ElasticCoverageAuditor` checks the epoch, names each
duplicate or dropped batch by host, parquet path and row group, and refuses
to certify a partial pod.

Kill switch
-----------
Off unless asked for: without ``elastic=`` nothing here makes a file or a
thread, and ``PETASTORM_TPU_ELASTIC=0`` refuses even an explicit config.
Nothing in this module starts a thread: hosts are driven by their callers
(a training loop, :class:`ElasticPodSim`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: Environment knob of the elastic plane. Off by default: elasticity arms
#: only when a reader or simulator is given an explicit ``elastic=`` config
#: AND this variable is not ``0``/``false``/``off`` (the switch wins over
#: code).
ELASTIC_ENV_VAR = 'PETASTORM_TPU_ELASTIC'

#: Subdirectories of the coordination root.
MEMBERS_DIR = 'members'
LEASES_DIR = 'leases'
DELIVERED_DIR = 'delivered'

#: Schema version of every coordination record.
RECORD_VERSION = 1

#: Default liveness window, in observer beats.
DEFAULT_TTL_BEATS = 3

#: ``ReaderStats`` counters the elastic plane feeds (merged pod-wide by
#: ``podobs.PodObserver``).
ELASTIC_COUNTERS = ('hosts_joined', 'hosts_died', 'leases_rebalanced',
                    'rows_resumed')


class ElasticConfigError(ValueError):
    """A misconfiguration of pod elasticity, raised at construction (above
    all: elasticity without a shared coordination directory)."""


class SimulatedHostDeath(SystemExit):
    """An injected death of a whole host (chaos scenario ``host-death``). A
    ``SystemExit``, like :class:`~petastorm_tpu_torch.faultfs.
    SimulatedWorkerCrash`: no ``except Exception`` on the delivery path may
    swallow it."""


def elastic_killed() -> bool:
    """True when :data:`ELASTIC_ENV_VAR` turns the plane off."""
    return os.environ.get(ELASTIC_ENV_VAR, '').strip().lower() in (
        '0', 'false', 'off')


def default_host_id() -> str:
    """``hostname-pid``: unique a participating process (a simulated pod
    in one process passes explicit ids)."""
    return '{}-{}'.format(socket.gethostname(), os.getpid())


def _read_json(path: str) -> Optional[dict]:
    """One coordination record; None when missing. Publications are
    atomic, so a readable file is a whole record and a torn one raises."""
    try:
        with open(path, 'r') as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except ValueError as e:
        raise ElasticConfigError(
            'corrupt coordination record {}: {} (records are published '
            'atomically; a torn file means the coord_root filesystem does '
            'not honor rename atomicity)'.format(path, e))


def rendezvous_assign(num_leases: int,
                      hosts: Sequence[str]) -> Dict[int, str]:
    """Highest-random-weight assignment: lease ``i`` goes to
    ``argmax_h md5('{i}:{h}')`` over the live hosts. A function of
    ``(num_leases, set(hosts))`` alone, and minimally disruptive: adding or
    removing a host moves only that host's leases."""
    if not hosts:
        return {}
    assignment = {}
    for lease in range(num_leases):
        best_host, best_score = None, b''
        for host in sorted(set(hosts)):
            score = hashlib.md5('{}:{}'.format(lease, host).encode()).digest()
            if best_host is None or score > best_score:
                best_host, best_score = host, score
        assignment[lease] = best_host
    return assignment


class PodMembership:
    """Registration and beat-counted liveness over the coordination
    directory.

    Each member publishes ``members/<host_id>.json`` with a growing
    ``beats`` counter (:meth:`beat`); :meth:`observe` judges liveness from
    the counters' progress against the observer's own beats."""

    def __init__(self, coord_root: str, host_id: Optional[str] = None,
                 ttl_beats: int = DEFAULT_TTL_BEATS):
        if not coord_root:
            raise ElasticConfigError(
                'pod elasticity needs coord_root: a directory shared by '
                'every host (the same substrate the shared cache uses). '
                'The podobs/peer HTTP plane is an observability surface, '
                'NOT a membership substrate — configuring peers without a '
                'coord_root is an error, never a fallback')
        if ttl_beats < 1:
            raise ElasticConfigError('ttl_beats must be >= 1, got '
                                     '{!r}'.format(ttl_beats))
        self.coord_root = os.path.abspath(coord_root)
        self.host_id = host_id or default_host_id()
        self.ttl_beats = int(ttl_beats)
        self._members_dir = os.path.join(self.coord_root, MEMBERS_DIR)
        os.makedirs(self._members_dir, exist_ok=True)
        self.beats = 0
        #: host -> [last counter seen, own beats when it last grew]
        #: (this observer's alone, never published)
        self._progress: Dict[str, List[int]] = {}
        #: hosts judged live at the last :meth:`observe`
        self._live: Tuple[str, ...] = ()
        #: this observer's tallies of membership transitions
        self.counters = {'hosts_joined': 0, 'hosts_died': 0}
        self.beat()

    def _member_path(self, host_id: str) -> str:
        return os.path.join(self._members_dir, host_id + '.json')

    def beat(self) -> int:
        """Publish one heartbeat (an atomic replace of the member record);
        returns the new counter."""
        from petastorm_tpu_torch.utils import atomic_write
        self.beats += 1
        record = {'host': self.host_id, 'beats': self.beats,
                  'pid': os.getpid(), 'version': RECORD_VERSION}
        atomic_write(self._member_path(self.host_id),
                     lambda f: json.dump(record, f))
        return self.beats

    def leave(self) -> None:
        """Leave gracefully: remove the member record (the survivors see
        the host go at once instead of after ``ttl_beats``)."""
        try:
            os.remove(self._member_path(self.host_id))
        except FileNotFoundError:
            pass

    def observe(self) -> Tuple[str, ...]:
        """Read every member record, advance the progress clocks and return
        the sorted live set. Counts a join for each host that goes live
        (first seen, or a dead host whose counter grew again) and a death
        for each live host whose counter stalled past ``ttl_beats`` of this
        observer's beats or whose record vanished."""
        records = {}
        try:
            names = os.listdir(self._members_dir)
        except FileNotFoundError:
            names = []
        for name in sorted(names):
            if not name.endswith('.json'):
                continue
            record = _read_json(os.path.join(self._members_dir, name))
            if record is not None:
                records[record.get('host', name[:-5])] = record
        previously_live = set(self._live)
        known = set(self._progress)
        live = []
        for host, record in sorted(records.items()):
            counter = int(record.get('beats', 0))
            clock = self._progress.get(host)
            if clock is None:
                self._progress[host] = [counter, self.beats]
                live.append(host)
                continue
            if counter > clock[0]:
                clock[0], clock[1] = counter, self.beats
            if self.beats - clock[1] <= self.ttl_beats:
                live.append(host)
        for host in live:
            # a join is a dead-to-live (or unseen-to-live) transition
            if host not in previously_live and (host not in known
                                                or host in records):
                self.counters['hosts_joined'] += 1
        for host in sorted(previously_live.difference(live)):
            self.counters['hosts_died'] += 1
            logger.warning('pod member %s is dead (no heartbeat progress '
                           'within %d observer beats)', host, self.ttl_beats)
        self._live = tuple(live)
        return self._live

    @property
    def live_hosts(self) -> Tuple[str, ...]:
        """The live set of the last :meth:`observe`."""
        return self._live


class LeasePlan:
    """The row groups in ``num_leases`` contiguous ranges, each with its own
    (seed, epoch, lease)-keyed batch grid: any holder, first or takeover,
    computes the same batches. ``drop_last`` a lease: a fixed grid needs
    fixed batches, and the tail rows rotate in through the next epoch's
    permutation, as in ``IndexedBatchLoader``."""

    def __init__(self, row_offsets: np.ndarray, batch_size: int,
                 num_leases: int, seed: int = 0, shuffle: bool = True):
        n_pieces = len(row_offsets) - 1
        if num_leases < 1:
            raise ElasticConfigError('num_leases must be >= 1, got '
                                     '{!r}'.format(num_leases))
        if num_leases > n_pieces:
            raise ElasticConfigError(
                'num_leases {} exceeds the {} row groups of the dataset — '
                'a lease needs at least one row group'.format(num_leases,
                                                              n_pieces))
        if batch_size < 1:
            raise ElasticConfigError('batch_size must be >= 1, got '
                                     '{!r}'.format(batch_size))
        self.row_offsets = np.asarray(row_offsets, np.int64)
        self.batch_size = int(batch_size)
        self.num_leases = int(num_leases)
        self.seed = seed
        self.shuffle = shuffle
        # contiguous ranges, the remainder spread over the first leases
        base, extra = divmod(n_pieces, num_leases)
        bounds = [0]
        for i in range(num_leases):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))
        #: lease i covers pieces [piece_bounds[i], piece_bounds[i+1])
        self.piece_bounds = bounds

    def lease_pieces(self, lease: int) -> range:
        return range(self.piece_bounds[lease], self.piece_bounds[lease + 1])

    def lease_rows(self, lease: int) -> Tuple[int, int]:
        """Global row span [start, stop) of ``lease``."""
        lo, hi = self.piece_bounds[lease], self.piece_bounds[lease + 1]
        return int(self.row_offsets[lo]), int(self.row_offsets[hi])

    def batches_per_lease(self, lease: int) -> int:
        start, stop = self.lease_rows(lease)
        return (stop - start) // self.batch_size

    def total_batches(self) -> int:
        return sum(self.batches_per_lease(lease)
                   for lease in range(self.num_leases))

    def batch_rows(self, lease: int, epoch: int, batch: int) -> np.ndarray:
        """Global row indices of batch ``batch`` of ``lease`` in ``epoch``:
        the addressing function every holder shares."""
        start, stop = self.lease_rows(lease)
        n = stop - start
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch, lease))
            perm = rng.permutation(n)
        else:
            perm = np.arange(n, dtype=np.int64)
        window = perm[batch * self.batch_size:(batch + 1) * self.batch_size]
        return (np.asarray(window, np.int64) + start)

    def describe(self) -> dict:
        return {'num_leases': self.num_leases,
                'batch_size': self.batch_size,
                'total_batches': self.total_batches(),
                'piece_bounds': list(self.piece_bounds),
                'seed': self.seed, 'shuffle': self.shuffle}


class LeaseLedger:
    """Lease cursors and fenced delivery records in the coordination
    directory.

    - ``leases/lease_<i>.json``: the holder and its next-batch cursor,
      replaced atomically after deliveries.
    - ``delivered/l<i>_e<e>_b<b>.json``: THE delivery fence, created by
      writing a temporary file and ``os.link``-ing it, so it appears with
      its content; ``FileExistsError`` means another host (usually the
      dead former holder) delivered the batch, and the caller skips it.
    """

    def __init__(self, coord_root: str):
        self.coord_root = os.path.abspath(coord_root)
        self._leases_dir = os.path.join(self.coord_root, LEASES_DIR)
        self._delivered_dir = os.path.join(self.coord_root, DELIVERED_DIR)
        os.makedirs(self._leases_dir, exist_ok=True)
        os.makedirs(self._delivered_dir, exist_ok=True)

    # -- lease cursors --------------------------------------------------------

    def _lease_path(self, lease: int) -> str:
        return os.path.join(self._leases_dir, 'lease_{}.json'.format(lease))

    def read_lease(self, lease: int) -> Optional[dict]:
        return _read_json(self._lease_path(lease))

    def checkpoint_lease(self, lease: int, holder: str, epoch: int,
                         next_batch: int) -> None:
        """Publish the lease's cursor (atomic replace), after the delivery
        claim: the claim is the fence, the cursor a hint the takeover's
        claim scan can always repair."""
        from petastorm_tpu_torch.utils import atomic_write
        record = {'lease': lease, 'holder': holder,
                  'cursor': {'epoch': epoch, 'batch': next_batch},
                  'version': RECORD_VERSION}
        atomic_write(self._lease_path(lease),
                     lambda f: json.dump(record, f))

    # -- the delivery fence ---------------------------------------------------

    def _delivery_path(self, lease: int, epoch: int, batch: int) -> str:
        return os.path.join(
            self._delivered_dir,
            'l{}_e{}_b{}.json'.format(lease, epoch, batch))

    def claim_delivery(self, lease: int, epoch: int, batch: int,
                       host: str, rows: int,
                       row_groups: Sequence[dict]) -> bool:
        """Claim the delivery of one (lease, epoch, batch) atomically. True:
        this caller owns it (it may hand the batch to the consumer); False:
        another host delivered it (skip: the never-twice half of exactly
        once)."""
        final = self._delivery_path(lease, epoch, batch)
        tmp = '{}.tmp.{}.{}'.format(final, os.getpid(), host)
        record = {'lease': lease, 'epoch': epoch, 'batch': batch,
                  'host': host, 'rows': int(rows),
                  'row_groups': list(row_groups),
                  'version': RECORD_VERSION}
        try:
            with open(tmp, 'w') as f:
                json.dump(record, f)
            try:
                os.link(tmp, final)
            except FileExistsError:
                return False
            return True
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass

    def read_delivery(self, lease: int, epoch: int,
                      batch: int) -> Optional[dict]:
        return _read_json(self._delivery_path(lease, epoch, batch))

    def delivered_batches(self, lease: int, epoch: int) -> List[int]:
        """Batch indices of every claimed delivery of (lease, epoch)."""
        prefix = 'l{}_e{}_b'.format(lease, epoch)
        out = []
        try:
            names = os.listdir(self._delivered_dir)
        except FileNotFoundError:
            return out
        for name in names:
            if name.startswith(prefix) and name.endswith('.json'):
                try:
                    out.append(int(name[len(prefix):-5]))
                except ValueError:
                    continue
        return sorted(out)

    def resume_batch(self, lease: int, epoch: int) -> int:
        """Where a takeover resumes ``lease``:
        ``max(checkpointed cursor, max(claimed batch) + 1)``. Claimed means
        delivered, so never again; unclaimed means in flight, so produced
        again."""
        cursor = 0
        record = self.read_lease(lease)
        if record is not None:
            stored = record.get('cursor') or {}
            if int(stored.get('epoch', -1)) == epoch:
                cursor = int(stored.get('batch', 0))
        claimed = self.delivered_batches(lease, epoch)
        if claimed:
            cursor = max(cursor, max(claimed) + 1)
        return cursor


class ElasticCoverageAuditor:
    """The exactly-once check of one epoch from the ledger's claim records:
    every (lease, batch) of the plan's grid claimed once, every problem
    named by host, parquet path and row group, and a **partial pod refuses
    to certify** (``require_hosts`` without a member record leave the
    denominator unknown)."""

    def __init__(self, plan: LeasePlan, ledger: LeaseLedger,
                 pieces: Optional[Sequence] = None):
        self.plan = plan
        self.ledger = ledger
        #: the dataset's pieces (``IndexedDatasetReader.pieces``): names a
        #: dropped batch by path and row group where no record exists
        self.pieces = pieces

    def _name_lease(self, lease: int) -> str:
        if not self.pieces:
            return 'lease {} (pieces {}..{})'.format(
                lease, self.plan.piece_bounds[lease],
                self.plan.piece_bounds[lease + 1] - 1)
        briefs = []
        for piece_index in self.plan.lease_pieces(lease):
            piece = self.pieces[piece_index]
            briefs.append('{}#rg{}'.format(
                os.path.basename(getattr(piece, 'path', '?')),
                getattr(piece, 'row_group', '?')))
        return 'lease {} [{}]'.format(lease, ', '.join(briefs))

    def audit_epoch(self, epoch: int,
                    require_hosts: Sequence[str] = ()) -> dict:
        """``{'expected_batches', 'delivered_batches', 'duplicates',
        'missing', 'by_host', 'unreachable', 'ok', 'problems'}`` of one
        epoch. ``require_hosts`` arms the partial-pod refusal: a named
        host without a member record is reported and fails the audit."""
        problems: List[str] = []
        unreachable: List[str] = []
        members_dir = os.path.join(self.ledger.coord_root, MEMBERS_DIR)
        for host in require_hosts:
            path = os.path.join(members_dir, str(host) + '.json')
            if _read_json(path) is None:
                unreachable.append(str(host))
        if unreachable:
            problems.append(
                'partial_pod: required host(s) {} have no member record — '
                'their deliveries cannot be attributed, so the certificate '
                'denominator is incomplete; refusing to certify'.format(
                    ', '.join(unreachable)))
        expected = 0
        delivered = 0
        duplicates: List[str] = []
        missing: List[str] = []
        by_host: Dict[str, int] = {}
        for lease in range(self.plan.num_leases):
            grid = self.plan.batches_per_lease(lease)
            expected += grid
            claimed = self.ledger.delivered_batches(lease, epoch)
            claimed_set = set(claimed)
            for batch in claimed:
                record = self.ledger.read_delivery(lease, epoch, batch) or {}
                host = str(record.get('host', '?'))
                by_host[host] = by_host.get(host, 0) + 1
                if batch >= grid:
                    duplicates.append(
                        'host {} delivered out-of-grid batch {} of {} '
                        '(grid has {} batches): {}'.format(
                            host, batch, self._name_lease(lease), grid,
                            self._describe_record(record)))
            delivered += len(claimed_set.intersection(range(grid)))
            for batch in range(grid):
                if batch not in claimed_set:
                    missing.append(
                        'batch {} of {} was never delivered (dropped '
                        'rows)'.format(batch, self._name_lease(lease)))
        # one claim file a grid point makes a same-batch duplicate
        # impossible: what can go wrong is an out-of-grid claim or a drop
        if duplicates:
            problems.append('{} duplicate/forged delivery record(s): {}'
                            .format(len(duplicates), '; '.join(duplicates)))
        if missing:
            problems.append('{} dropped batch(es): {}'.format(
                len(missing), '; '.join(missing)))
        ok = not problems and not unreachable
        return {'epoch': epoch, 'expected_batches': expected,
                'delivered_batches': delivered,
                'duplicates': duplicates, 'missing': missing,
                'by_host': by_host, 'unreachable': unreachable,
                'checked': True, 'ok': ok, 'problems': problems}

    @staticmethod
    def _describe_record(record: dict) -> str:
        groups = record.get('row_groups') or []
        return ', '.join('{}#rg{}'.format(os.path.basename(
            str(g.get('path', '?'))), g.get('row_group', '?'))
            for g in groups) or '<no row groups recorded>'

    def assert_complete(self, epoch: int,
                        require_hosts: Sequence[str] = ()) -> dict:
        """Raise :class:`~petastorm_tpu_torch.podobs.PodCertificateError`
        naming every problem unless the epoch was delivered exactly
        once."""
        audit = self.audit_epoch(epoch, require_hosts=require_hosts)
        if not audit['ok']:
            from petastorm_tpu_torch.podobs import PodCertificateError
            raise PodCertificateError(
                'pod exactly-once certificate failed for epoch {}: {}'
                .format(epoch, '; '.join(audit['problems'])))
        return audit


class ElasticHost:
    """One pod member's delivery loop over the leases it holds.

    Driven by its caller (:meth:`step`), never by a thread of its own.
    Batches come from the shared :class:`LeasePlan` grid through an
    ``IndexedDatasetReader``'s ``gather``, are fenced by the
    :class:`LeaseLedger`, and reach ``on_batch`` (the consumer) only when
    the claim won, as the reader's numpy columns.
    """

    def __init__(self, dataset, plan: LeasePlan,
                 membership: PodMembership, ledger: LeaseLedger,
                 stats=None, host_index: int = 0,
                 checkpoint_every: int = 8):
        if checkpoint_every < 1:
            raise ElasticConfigError(
                'checkpoint_every must be >= 1, got {}'.format(
                    checkpoint_every))
        #: the cursor's checkpoint cadence. The claim is what recovery
        #: trusts (``resume_batch`` takes max(cursor, claims + 1)); the
        #: cursor only bounds a takeover's claim scan, so writing it every
        #: batch would buy nothing but a write on the hot loop
        self.checkpoint_every = checkpoint_every
        self.dataset = dataset
        self.plan = plan
        self.membership = membership
        self.ledger = ledger
        self.host_id = membership.host_id
        #: stable index for deterministic chaos targeting (the simulator's
        #: order of creation)
        self.host_index = host_index
        self.stats = stats
        self.counters = {name: 0 for name in ELASTIC_COUNTERS}
        self.counters['batches_delivered'] = 0
        self.counters['batches_skipped_claimed'] = 0
        self._held: Tuple[int, ...] = ()
        self._cursors: Dict[int, int] = {}
        self._epoch = 0
        self.dead = False

    # -- accounting -----------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if self.stats is not None:
            self.stats.add(name, n)

    def elastic_snapshot(self) -> dict:
        """The host's ``elastic`` section of ``podobs.make_observe_fn``:
        the transition counters and the current lease view."""
        snap = dict(self.counters)
        snap.update(self.membership.counters)
        snap['held_leases'] = len(self._held)
        snap['expected_batches'] = self.plan.total_batches()
        snap['epoch'] = self._epoch
        return snap

    # -- membership and rebalance ---------------------------------------------

    def rebalance(self, epoch: int) -> Tuple[int, ...]:
        """Observe the live set, recompute the assignment and adopt the
        leases won, each from its checkpointed or claimed resume point.
        Returns the held leases."""
        joined_before = self.membership.counters['hosts_joined']
        died_before = self.membership.counters['hosts_died']
        live = self.membership.observe()
        if self.stats is not None:
            self.stats.add('hosts_joined',
                           self.membership.counters['hosts_joined']
                           - joined_before)
            self.stats.add('hosts_died',
                           self.membership.counters['hosts_died']
                           - died_before)
        assignment = rendezvous_assign(self.plan.num_leases, live)
        held = tuple(sorted(lease for lease, host in assignment.items()
                            if host == self.host_id))
        initial = not self._held and not self._cursors
        for lease in held:
            if lease in self._cursors:
                continue
            resume = self.ledger.resume_batch(lease, epoch)
            self._cursors[lease] = resume
            if not initial or resume > 0:
                # a takeover: an established host won a lease it did not
                # hold, or a joiner adopts a lease with progress; count
                # the rebalance and the rows it took over
                self._count('leases_rebalanced')
                remaining = self.plan.batches_per_lease(lease) - resume
                self._count('rows_resumed',
                            max(0, remaining) * self.plan.batch_size)
                logger.warning(
                    'host %s took over lease %d at batch %d of epoch %d '
                    '(%d batches remain)', self.host_id, lease, resume,
                    epoch, max(0, remaining))
        for lease in set(self._cursors).difference(held):
            # lost to a joiner: the new holder resumes from the ledger
            del self._cursors[lease]
        self._held = held
        self._epoch = epoch
        return held

    # -- delivery -------------------------------------------------------------

    def _chaos_step(self) -> None:
        from petastorm_tpu_torch.faultfs import chaos_from_env
        injector = chaos_from_env()
        if injector is not None and injector.should_kill_host(
                self.host_index, self.counters['batches_delivered']):
            self.dead = True
            raise SimulatedHostDeath(
                'chaos: injected death of host {} (index {}) after {} '
                'delivered batches (seed {})'.format(
                    self.host_id, self.host_index,
                    self.counters['batches_delivered'], injector.seed))

    def step(self, epoch: int, on_batch=None) -> Optional[Tuple[int, int]]:
        """Deliver at most one batch: take the held lease with the most
        work left, produce its next grid batch, claim it and, when the
        claim won, gather the rows and hand them to ``on_batch(columns,
        lease, batch)``. Returns the (lease, batch) stepped, or None when
        this host's leases are drained."""
        if self.dead:
            raise SimulatedHostDeath('host {} is dead'.format(self.host_id))
        self._chaos_step()
        self.membership.beat()
        candidates = [
            (self.plan.batches_per_lease(lease) - self._cursors[lease],
             -lease)
            for lease in self._held
            if self._cursors[lease] < self.plan.batches_per_lease(lease)]
        if not candidates:
            return None
        remaining, neg_lease = max(candidates)
        lease = -neg_lease
        batch = self._cursors[lease]
        rows = self.plan.batch_rows(lease, epoch, batch)
        groups = self._row_groups_of(rows)
        claimed = self.ledger.claim_delivery(
            lease, epoch, batch, self.host_id, len(rows), groups)
        if claimed:
            if on_batch is not None:
                on_batch(self.dataset.gather(rows), lease, batch)
            self._count('batches_delivered')
        else:
            # the former holder delivered it before it died: skip
            self._count('batches_skipped_claimed')
        cursor = self._cursors[lease] = batch + 1
        drained = cursor >= self.plan.batches_per_lease(lease)
        if drained or cursor % self.checkpoint_every == 0:
            self.ledger.checkpoint_lease(lease, self.host_id, epoch, cursor)
        return lease, batch

    def _row_groups_of(self, rows: np.ndarray) -> List[dict]:
        piece_ids = np.unique(np.searchsorted(
            self.dataset.row_offsets, rows, side='right') - 1)
        out = []
        for piece_index in piece_ids:
            piece = self.dataset.pieces[int(piece_index)]
            out.append({'path': getattr(piece, 'path', '?'),
                        'row_group': getattr(piece, 'row_group', -1)})
        return out

    def remaining(self) -> int:
        return sum(self.plan.batches_per_lease(lease) - self._cursors[lease]
                   for lease in self._held)


class ElasticPodSim:
    """K simulated hosts over one coordination directory: pod elasticity
    on one machine.

    Hosts step round-robin, so one seed and chaos spec replay the same
    rebalances and the same injected tallies. ``host-death`` and
    ``host-join`` (``PETASTORM_TPU_CHAOS``) change the membership
    mid-epoch; the epoch ends when every lease's grid is claimed, and
    :meth:`certificate` checks exactly-once delivery across whatever
    rebalances happened."""

    def __init__(self, dataset, coord_root: str, k_hosts: int,
                 batch_size: int, num_leases: Optional[int] = None,
                 seed: int = 0, shuffle: bool = True,
                 ttl_beats: int = DEFAULT_TTL_BEATS, stats=None):
        if elastic_killed():
            raise ElasticConfigError(
                'pod elasticity is disabled ({}=0): the kill switch wins '
                'over code; unset it to run an elastic pod'.format(
                    ELASTIC_ENV_VAR))
        if k_hosts < 1:
            raise ElasticConfigError('k_hosts must be >= 1, got '
                                     '{!r}'.format(k_hosts))
        self.dataset = dataset
        self.coord_root = os.path.abspath(coord_root)
        self.k_hosts = int(k_hosts)
        if num_leases is None:
            num_leases = min(len(dataset.pieces), 2 * k_hosts)
        self.plan = LeasePlan(dataset.row_offsets, batch_size, num_leases,
                              seed=seed, shuffle=shuffle)
        self.ledger = LeaseLedger(coord_root)
        self.ttl_beats = ttl_beats
        self.stats = stats
        self.hosts: List[ElasticHost] = []
        self.deaths: List[str] = []
        self.joins: List[str] = []
        for index in range(k_hosts):
            self._spawn_host(index)

    def _spawn_host(self, index: int) -> ElasticHost:
        membership = PodMembership(
            self.coord_root, host_id='host-{}'.format(index),
            ttl_beats=self.ttl_beats)
        host = ElasticHost(self.dataset, self.plan, membership, self.ledger,
                           stats=self.stats, host_index=index)
        self.hosts.append(host)
        return host

    def auditor(self) -> ElasticCoverageAuditor:
        return ElasticCoverageAuditor(self.plan, self.ledger,
                                      pieces=self.dataset.pieces)

    def _maybe_join(self, total_delivered: int) -> Optional[ElasticHost]:
        from petastorm_tpu_torch.faultfs import chaos_from_env
        injector = chaos_from_env()
        if injector is None or not injector.should_join_host(
                total_delivered):
            return None
        host = self._spawn_host(len(self.hosts))
        self.joins.append(host.host_id)
        logger.warning('chaos: host %s joined the pod after %d delivered '
                       'batches', host.host_id, total_delivered)
        return host

    def run_epoch(self, epoch: int = 0, on_batch=None) -> dict:
        """Drive the pod through one epoch (round-robin steps, a rebalance
        at every membership change) and return :meth:`report`. Raises
        ``RuntimeError`` when the survivors cannot finish the grid (every
        host died, or no survivor can progress)."""
        for host in self.hosts:
            host.rebalance(epoch)
        total = self.plan.total_batches()
        delivered = 0
        stall_rounds = 0
        while delivered < total:
            survivors = [h for h in self.hosts if not h.dead]
            if not survivors:
                raise RuntimeError(
                    'every pod host died; {}/{} batches delivered'.format(
                        delivered, total))
            progressed = False
            membership_changed = False
            for host in list(survivors):
                try:
                    result = host.step(epoch, on_batch=on_batch)
                except SimulatedHostDeath:
                    self.deaths.append(host.host_id)
                    membership_changed = True
                    continue
                if result is not None:
                    progressed = True
            # a claim IS a delivery, so the pod's count is the sum of the
            # hosts' claim counters, the dead hosts' included (scanning
            # delivered/ here would be quadratic over the epoch)
            delivered = sum(h.counters['batches_delivered']
                            for h in self.hosts)
            if self._maybe_join(delivered) is not None:
                membership_changed = True
            if membership_changed or not progressed:
                # survivors re-observe: the dead age out after ttl_beats
                # of silence, joiners appear, leases move
                for host in self.hosts:
                    if not host.dead:
                        host.rebalance(epoch)
            if not progressed:
                stall_rounds += 1
                if stall_rounds > self.ttl_beats + 2:
                    raise RuntimeError(
                        'elastic pod wedged: {}/{} batches delivered and '
                        'no survivor can make progress'.format(delivered,
                                                               total))
            else:
                stall_rounds = 0
        return self.report(epoch)

    def report(self, epoch: int = 0) -> dict:
        counters: Dict[str, int] = {}
        for host in self.hosts:
            for name, value in host.elastic_snapshot().items():
                if name in ('expected_batches', 'epoch', 'held_leases'):
                    continue
                counters[name] = counters.get(name, 0) + value
        return {'kind': 'petastorm_tpu.elastic_pod_report',
                'version': RECORD_VERSION,
                'epoch': epoch,
                'plan': self.plan.describe(),
                'hosts': [h.host_id for h in self.hosts],
                'deaths': list(self.deaths),
                'joins': list(self.joins),
                'counters': counters,
                'audit': self.auditor().audit_epoch(epoch)}

    def certificate(self, epoch: int = 0,
                    require_hosts: Sequence[str] = ()) -> dict:
        """Check exactly-once delivery across the epoch's rebalances
        (raises ``PodCertificateError`` on any problem)."""
        return self.auditor().assert_complete(epoch,
                                              require_hosts=require_hosts)

    def close(self) -> None:
        for host in self.hosts:
            host.membership.leave()


def resolve_elastic_shard(elastic, cur_shard, shard_count,
                          shard_by_jax_process=False):
    """The factories' ``elastic=``: with a config (and the kill switch
    off), the factory joins the pod's membership and derives
    ``(cur_shard, shard_count)`` from this host's place in the live set.

    ``elastic`` is a dict: ``coord_root`` (required), optional ``host_id``
    and ``ttl_beats``. It excludes explicit ``cur_shard``/``shard_count``
    and ``shard_by_jax_process`` (one source of shard truth). Returns
    ``(cur_shard, shard_count, membership or None)``.

    A snapshot taken at construction for the streaming readers (their
    ventilation is fixed then); the mid-epoch rebalance is the lease grid
    of :class:`ElasticHost` / :class:`ElasticPodSim`. A reader restarted on
    a resized pod still gets the new shard map with no coordinator."""
    if elastic is None:
        return cur_shard, shard_count, None
    if elastic_killed():
        logger.warning('elastic= requested but %s=0: the kill switch wins; '
                       'no membership files or shard override created',
                       ELASTIC_ENV_VAR)
        return cur_shard, shard_count, None
    if cur_shard is not None or shard_count is not None:
        raise ElasticConfigError(
            'elastic= is mutually exclusive with explicit '
            'cur_shard/shard_count (lease-driven sharding IS the shard '
            'assignment)')
    if shard_by_jax_process:
        raise ElasticConfigError(
            'elastic= is mutually exclusive with shard_by_jax_process '
            '(pick one source of shard truth)')
    if not isinstance(elastic, dict):
        # JAX's words; its unescaped braces make JAX raise KeyError here
        raise ElasticConfigError(
            "elastic= must be a dict like {{'coord_root': ...}}, got "
            '{!r}'.format(elastic))
    unknown = set(elastic) - {'coord_root', 'host_id', 'ttl_beats'}
    if unknown:
        raise ElasticConfigError(
            'unknown elastic= option(s) {}; valid: coord_root, host_id, '
            'ttl_beats'.format(sorted(unknown)))
    membership = PodMembership(elastic.get('coord_root'),
                               host_id=elastic.get('host_id'),
                               ttl_beats=elastic.get('ttl_beats',
                                                     DEFAULT_TTL_BEATS))
    live = membership.observe()
    if membership.host_id not in live:
        raise ElasticConfigError(
            'host {} did not appear in its own membership observation — '
            'the coord_root {} is not behaving like a shared directory'
            .format(membership.host_id, membership.coord_root))
    index = live.index(membership.host_id)
    logger.info('elastic shard assignment: host %s is shard %d of %d '
                '(coord_root %s)', membership.host_id, index, len(live),
                membership.coord_root)
    return index, len(live), membership
