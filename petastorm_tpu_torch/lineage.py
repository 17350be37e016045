"""Sample lineage of the port: provenance on every item and batch, the
coverage audit, replay, and bad-sample quarantine.

The port's copy of ``petastorm_tpu/lineage.py`` (the constants :58-97,
``lineage_enabled`` … ``selection_offsets`` :99-201, ``LineageTracker``
:204-416, ``CoverageAuditor`` :419-627, ``BatchProvenance`` :630-711,
``make_quarantine_record`` :715-740, ``crash_quarantine_record``
:743-768, ``replay_records`` and ``replay`` :773-918). It imports numpy and the standard library only: the process
pool's worker interpreters import it.

- **Provenance.** Every published item carries a :class:`Provenance`
  (dataset digest, file index and path, row group, row-offset selection,
  epoch, shard, worker) made by the worker: the thread and dummy pools pass
  a :class:`LineageEnvelope` around the payload, the process pool moves the
  record in its ``DATA`` control frame so the payload frames stay
  zero-copy. The reader's :class:`LineageTracker` registers each delivered
  record (its ``seq``) and keeps per-epoch ledgers of what was ventilated
  and what was delivered.
- **Coverage audit.** :class:`CoverageAuditor` asserts exactly-once
  delivery per epoch from those ledgers, naming duplicated and dropped row
  groups, and checks row-exact coverage against the footers' row counts
  when every selection names its rows.
- **Replay.** :func:`replay` re-fetches the rows of recorded provenance
  through the reader's own worker (same predicate, partition, decode and
  transform): a bad batch again, bit for bit.
- **Quarantine.** ``on_decode_error='raise'|'skip'|'quarantine'``: under
  the last two a decode or transform failure drops its rows instead of
  killing the worker, and ``'quarantine'`` also records them.

On by default: one record an item on the worker side, one ring insert an
item on the consumer side, and one int64 column through the loader's
shuffling buffer. ``PETASTORM_TPU_LINEAGE=0`` (the JAX package's variable)
turns all of it off.

The ventilation timestamps (``record_vent_ts``, ``ventilated_ts``) feed
the latency plane's ``e2e_batch``, and :meth:`LineageTracker.
flight_summary` the health plane's flight records. Worker recovery
reads :meth:`LineageTracker.delivery_deficit` (was an item that died with
its worker delivered?) and quarantines a poison item through
:func:`crash_quarantine_record`.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

#: Environment variable gating lineage (default on): ``0`` / ``false`` /
#: ``off`` turn off envelopes, ledgers and batch columns.
LINEAGE_ENV_VAR = 'PETASTORM_TPU_LINEAGE'

#: The int64 column the loader threads through its shuffling buffer: each
#: row's packed ``(seq << PACK_SHIFT) | payload_offset``.
LINEAGE_COLUMN = '_lineage_src'

#: Key under which a finished loader batch holds its
#: :class:`BatchProvenance`.
PROVENANCE_KEY = '_provenance'

#: Bits of a packed source id kept for the payload-row offset (row groups
#: stay far below 16M rows; ``seq`` keeps 39 bits).
PACK_SHIFT = 24
_OFFSET_MASK = (1 << PACK_SHIFT) - 1

#: Provenance records kept in the tracker's ring.
DEFAULT_RECORD_CAPACITY = 65536

#: Per-epoch ledgers kept before the oldest epoch is evicted (bounds
#: ``num_epochs=None`` streams).
DEFAULT_EPOCH_CAPACITY = 16

#: Quarantine records kept in the ring (the totals count on past it).
DEFAULT_QUARANTINE_CAPACITY = 1024

#: Valid ``on_decode_error`` policies.
DECODE_ERROR_POLICIES = ('raise', 'skip', 'quarantine')

#: Exceptions that stay loud under every ``on_decode_error`` policy: they
#: are failures of the infrastructure (storage, memory, shutdown), not a
#: bad sample.
NEVER_QUARANTINE = (OSError, MemoryError, KeyboardInterrupt, SystemExit)


def lineage_enabled() -> bool:
    """The :data:`LINEAGE_ENV_VAR` gate (default on)."""
    value = os.environ.get(LINEAGE_ENV_VAR, '').strip().lower()
    return value not in ('0', 'false', 'off')


def validate_decode_error_policy(policy: str) -> str:
    if policy not in DECODE_ERROR_POLICIES:
        raise ValueError('on_decode_error must be one of {}, got {!r}'.format(
            DECODE_ERROR_POLICIES, policy))
    return policy


class Provenance(NamedTuple):
    """Where the rows of one published item came from. Plain data: it
    pickles across the process pool's control frame and JSON-ifies by
    :meth:`_asdict`.

    ``selection`` names the source rows (file-order offsets within the row
    group) the payload carries:

    - ``('all', n)``: all ``n`` rows, in file order;
    - ``('slice', lo, hi)``: rows ``[lo, hi)`` (a row-drop partition);
    - ``('index', (o0, o1, ...))``: explicit offsets (predicate matches, or
      a range with quarantined rows dropped);
    - ``('windows', n)``: ``n`` NGram windows (not row-granular);
    - ``('opaque', n)``: ``n`` rows whose offsets are unknown (a cache
      hit, or a transform that changed the row count).
    """
    dataset: str        # digest of the dataset path (12 hex chars)
    file_index: int     # ordinal of `path` among the reader's files
    path: str           # absolute path of the file
    row_group: int      # row group within the file
    rows: int           # rows (or windows) this payload delivers
    selection: tuple
    epoch: int          # ventilation epoch of the item
    shard: int          # reader shard (cur_shard), -1 when unsharded
    piece_index: int    # ordinal of the piece among the reader's pieces
    partition: tuple    # row-drop partition (k, n)
    worker_id: int      # worker that made the payload


class LineageEnvelope:
    """A published payload with its provenance (thread and dummy pools; the
    process pool moves the record in its control frame instead)."""

    __slots__ = ('payload', 'provenance')

    def __init__(self, payload, provenance: Provenance):
        self.payload = payload
        self.provenance = provenance


def batch_provenance_of(batch) -> Optional['BatchProvenance']:
    """The :class:`BatchProvenance` of a loader batch dict; None when it
    has none."""
    if not isinstance(batch, dict):
        return None
    value = batch.get(PROVENANCE_KEY)
    return value if isinstance(value, BatchProvenance) else None


def unwrap_envelope(item, tracker: Optional['LineageTracker']):
    """``(payload, seq or None)`` of a pool result: an envelope is unwrapped
    and registered with ``tracker`` (when given), anything else passes."""
    if isinstance(item, LineageEnvelope):
        seq = tracker.register(item.provenance) if tracker is not None else None
        return item.payload, seq
    return item, None


def pack_source(seq: int, offset: int) -> int:
    """The packed int64 source id of row ``offset`` of item ``seq``."""
    return (seq << PACK_SHIFT) | (offset & _OFFSET_MASK)


def pack_rows(seq: int, n: int) -> np.ndarray:
    """The packed source ids of all ``n`` rows of item ``seq``, in one
    numpy op."""
    return (seq << PACK_SHIFT) + np.arange(n, dtype=np.int64)


def unpack_source(packed: int) -> Tuple[int, int]:
    return int(packed) >> PACK_SHIFT, int(packed) & _OFFSET_MASK


def selection_offsets(selection: tuple) -> Optional[np.ndarray]:
    """The source row offsets a selection covers (None when it does not
    name its rows)."""
    kind = selection[0]
    if kind == 'all':
        return np.arange(selection[1], dtype=np.int64)
    if kind == 'slice':
        return np.arange(selection[1], selection[2], dtype=np.int64)
    if kind == 'index':
        return np.asarray(selection[1], dtype=np.int64)
    return None


class LineageTracker:
    """The consumer's lineage ledger of one reader, every part bounded:

    - the record ring: ``seq -> Provenance`` of every delivered item, what
      ``batch['_provenance']`` and :func:`replay` resolve against;
    - per-epoch ledgers of ventilation and delivery, keyed by
      ``(piece_index, partition)``, what :class:`CoverageAuditor` compares;
    - the quarantine ring and its totals.

    Thread-safe: the ventilator records ventilations, the consumer
    registers deliveries, the pools add quarantines and empty deliveries.
    """

    def __init__(self, enabled: bool = True, dataset_digest: str = '',
                 shard: int = -1,
                 pieces: Optional[List[Tuple[str, int, int]]] = None,
                 items: Optional[List[Tuple[int, tuple]]] = None,
                 row_filtered: bool = False,
                 record_capacity: int = DEFAULT_RECORD_CAPACITY,
                 epoch_capacity: int = DEFAULT_EPOCH_CAPACITY,
                 quarantine_capacity: int = DEFAULT_QUARANTINE_CAPACITY,
                 record_vent_ts: bool = False):
        self.enabled = enabled
        self.dataset_digest = dataset_digest
        self.shard = shard
        #: True when a predicate or filters drop rows on purpose: rows are
        #: then audited for duplicates only, never for misses
        self.row_filtered = row_filtered
        #: ``piece_index -> (path, row_group, num_rows)``, the footers' row
        #: counts row-exact coverage is held against
        self.pieces = {i: tuple(p) for i, p in enumerate(pieces or [])}
        #: every item of an epoch, ``[(piece_index, partition)]``
        self.items = [(int(i), tuple(p)) for i, p in (items or [])]
        self._record_capacity = record_capacity
        self._epoch_capacity = epoch_capacity
        #: stamp each ventilation with a ``time.perf_counter()`` reading
        #: that :meth:`register` ties to the delivered item's seq: the start
        #: of the ``e2e_batch`` latency (JAX ``lineage.py:241-246``). The
        #: reader sets it only when its stats carry a latency plane.
        self._record_vent_ts = bool(enabled and record_vent_ts)
        self._lock = threading.Lock()
        self._records: 'collections.OrderedDict[int, Provenance]' = \
            collections.OrderedDict()
        self._vent_ts: 'collections.OrderedDict[int, float]' = \
            collections.OrderedDict()
        self._next_seq = 0
        # epoch -> {'ventilated': Counter, 'vent_order': [key],
        #           'delivered': {key: [Provenance]}, 'order': [key],
        #           'rows': int, 'quarantined': Counter}
        self._epochs: 'collections.OrderedDict[int, dict]' = \
            collections.OrderedDict()
        self._quarantines: 'collections.deque' = collections.deque(
            maxlen=quarantine_capacity)
        self.quarantined_rows_total = 0
        self.quarantined_items_total = 0
        self.records_registered = 0
        self.passes = 0

    # -- ledgers -------------------------------------------------------------

    def _epoch_entry(self, epoch: int) -> dict:
        entry = self._epochs.get(epoch)
        if entry is None:
            entry = {'ventilated': collections.Counter(), 'vent_order': [],
                     'delivered': {}, 'order': [], 'rows': 0,
                     'quarantined': collections.Counter(), 'vent_ts': {}}
            self._epochs[epoch] = entry
            while len(self._epochs) > self._epoch_capacity:
                self._epochs.popitem(last=False)
        return entry

    def record_ventilated(self, epoch: int, piece_index: int,
                          partition: tuple) -> None:
        """One work item was handed to the pool for ``epoch``."""
        if not self.enabled or piece_index is None:
            return
        key = (piece_index, tuple(partition or (0, 1)))
        with self._lock:
            entry = self._epoch_entry(epoch)
            entry['ventilated'][key] += 1
            entry['vent_order'].append(key)
            if self._record_vent_ts:
                # a FIFO of dispatch times a key: deliveries of the key take
                # them in dispatch order
                entry['vent_ts'].setdefault(key, []).append(
                    time.perf_counter())

    def register(self, record: Provenance) -> int:
        """Register one delivered item's provenance; returns its ``seq``,
        the handle packed into a batch's source ids."""
        key = (record.piece_index, tuple(record.partition))
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._records[seq] = record
            while len(self._records) > self._record_capacity:
                self._records.popitem(last=False)
            entry = self._epoch_entry(record.epoch)
            if self._record_vent_ts:
                ts_fifo = entry['vent_ts'].get(key)
                if ts_fifo:
                    self._vent_ts[seq] = ts_fifo.pop(0)
                    while len(self._vent_ts) > self._record_capacity:
                        self._vent_ts.popitem(last=False)
            entry['delivered'].setdefault(key, []).append(record)
            entry['order'].append(key)
            entry['rows'] += record.rows
            self.records_registered += 1
        return seq

    def resolve(self, seq) -> Optional[Provenance]:
        """The provenance registered as ``seq`` (None once evicted)."""
        if seq is None:
            return None
        with self._lock:
            return self._records.get(int(seq))

    def ventilated_ts(self, seq) -> Optional[float]:
        """The ``time.perf_counter()`` reading at which the item registered
        as ``seq`` was ventilated (None when not stamped, or evicted)."""
        if seq is None:
            return None
        with self._lock:
            return self._vent_ts.get(int(seq))

    def add_quarantines(self, records) -> None:
        """Take in the quarantine records a pool drained from a worker."""
        if not records:
            return
        with self._lock:
            for record in records:
                self._quarantines.append(record)
                rows = int(record.get('rows', 1))
                self.quarantined_rows_total += rows
                self.quarantined_items_total += 1
                epoch = record.get('epoch')
                if epoch is not None:
                    key = (record.get('piece_index', -1),
                           tuple(record.get('partition') or (0, 1)))
                    self._epoch_entry(int(epoch))['quarantined'][key] += rows

    def quarantines(self, limit: Optional[int] = None) -> List[dict]:
        """The most recent quarantine records."""
        with self._lock:
            records = list(self._quarantines)
        return records[-limit:] if limit else records

    def delivery_deficit(self, epoch: int, piece_index: int,
                         partition: tuple) -> Optional[int]:
        """Ventilated minus accounted (delivered, or quarantined) for one
        item key in one epoch: the pools' exactly-once guard after a worker
        died. An outstanding item whose deficit is already ``<= 0`` was
        delivered before its ``ITEM_DONE`` died with the worker, and must
        not go out again. None when lineage is off or the epoch unknown:
        the caller then redispatches (at least once)."""
        if not self.enabled or piece_index is None:
            return None
        key = (int(piece_index), tuple(partition or (0, 1)))
        with self._lock:
            entry = self._epochs.get(int(epoch))
            if entry is None:
                return None
            accounted = len(entry['delivered'].get(key, ()))
            if entry['quarantined'].get(key):
                accounted += 1
            return entry['ventilated'].get(key, 0) - accounted

    def start_pass(self) -> None:
        """Mark a ``Reader.reset()``. Epoch numbers count on across passes
        (the pools never rewind them), so a new pass audits against fresh
        per-epoch ledgers; this only counts the pass."""
        with self._lock:
            self.passes += 1

    # -- views ---------------------------------------------------------------

    def epochs(self) -> List[int]:
        with self._lock:
            return sorted(self._epochs)

    def epoch_ledger(self, epoch: int) -> Optional[dict]:
        """A copy of one epoch's ledgers."""
        with self._lock:
            entry = self._epochs.get(epoch)
            if entry is None:
                return None
            return {'ventilated': dict(entry['ventilated']),
                    'vent_order': list(entry['vent_order']),
                    'delivered': {k: list(v)
                                  for k, v in entry['delivered'].items()},
                    'order': list(entry['order']),
                    'rows': entry['rows'],
                    'quarantined': dict(entry['quarantined'])}

    def coverage_report(self) -> dict:
        """The full :class:`CoverageAuditor` report."""
        return CoverageAuditor(self).report()

    def flight_summary(self, quarantine_limit: int = 20) -> dict:
        """The lineage section of a flight record: the coverage report and
        the latest ``quarantine_limit`` quarantine records."""
        report = self.coverage_report()
        report['recent_quarantines'] = self.quarantines(quarantine_limit)
        return report


class CoverageAuditor:
    """Audits a :class:`LineageTracker`'s ledgers: exactly-once delivery per
    epoch, duplicates and drops named by row group, and shuffle-quality and
    inter-shard skew metrics."""

    def __init__(self, tracker: LineageTracker):
        self._tracker = tracker

    def _piece_brief(self, piece_index: int, partition: tuple) -> dict:
        info = self._tracker.pieces.get(piece_index)
        brief = {'piece_index': piece_index, 'partition': list(partition)}
        if info is not None:
            brief.update({'path': info[0], 'row_group': info[1],
                          'num_rows': info[2]})
        return brief

    def audit_epoch(self, epoch: int) -> Optional[dict]:
        """One epoch's verdict: items (delivered == ventilated, duplicates
        and drops named), rows (the delivered selections and the
        quarantined rows cover each row group exactly once; checked only
        when every selection names its rows), and the shuffle lags."""
        ledger = self._tracker.epoch_ledger(epoch)
        if ledger is None:
            return None
        ventilated = ledger['ventilated']
        delivered = ledger['delivered']
        quarantined = ledger['quarantined']
        dup_items, dropped_items, quarantined_items = [], [], []
        for key, count in sorted(ventilated.items()):
            got = len(delivered.get(key, ()))
            if got > count:
                dup_items.append(dict(self._piece_brief(*key),
                                      ventilated=count, delivered=got))
            elif got < count:
                if quarantined.get(key):
                    # every row of the item was quarantined or skipped: it
                    # is accounted for, not silently dropped
                    quarantined_items.append(dict(
                        self._piece_brief(*key), ventilated=count,
                        delivered=got,
                        rows_quarantined=int(quarantined[key])))
                else:
                    dropped_items.append(dict(self._piece_brief(*key),
                                              ventilated=count, delivered=got))
        for key in sorted(set(delivered) - set(ventilated)):
            dup_items.append(dict(self._piece_brief(*key), ventilated=0,
                                  delivered=len(delivered[key])))

        # rows: per piece, the delivered selections and the quarantined
        # rows must cover [0, num_rows) exactly once
        row_exact = True
        row_dups = row_missing = 0
        check_missing = not self._tracker.row_filtered
        by_piece: Dict[int, List] = {}
        for (piece_index, _partition), records in delivered.items():
            by_piece.setdefault(piece_index, []).extend(records)
        for piece_index, records in by_piece.items():
            info = self._tracker.pieces.get(piece_index)
            num_rows = info[2] if info else -1
            sels = [selection_offsets(r.selection) for r in records]
            if any(s is None for s in sels):
                row_exact = False
                continue
            covered = (np.concatenate(sels) if sels
                       else np.empty(0, np.int64))
            unique = np.unique(covered)
            row_dups += int(len(covered) - len(unique))
            if check_missing and num_rows is not None and num_rows >= 0:
                q_rows = sum(n for (pi, _p), n in quarantined.items()
                             if pi == piece_index)
                row_missing += max(0, int(num_rows - len(unique) - q_rows))
            elif check_missing:
                row_exact = False
        if not check_missing:
            row_exact = False

        return {
            'epoch': epoch,
            'items_expected': len(self._tracker.items) or None,
            'items_ventilated': sum(ventilated.values()),
            'items_delivered': sum(len(v) for v in delivered.values()),
            'rows_delivered': ledger['rows'],
            'rows_quarantined': int(sum(quarantined.values())),
            'dup_items': dup_items,
            'dropped_items': dropped_items,
            'quarantined_items': quarantined_items,
            'row_exact': row_exact,
            'row_dups': row_dups,
            'row_missing': row_missing,
            'complete': (not dup_items and not dropped_items
                         and row_dups == 0
                         and (not row_exact or row_missing == 0)),
            'shuffle': self._shuffle_lags(ledger),
        }

    @staticmethod
    def _shuffle_lags(ledger: dict) -> dict:
        """Item shuffle quality: |arrival position - ventilation position|
        per item (the lag), and the runs of consecutive arrivals from one
        piece."""
        vent_pos = {}
        for pos, key in enumerate(ledger['vent_order']):
            vent_pos.setdefault(key, []).append(pos)
        lags = []
        taken: Dict[tuple, int] = {}
        for pos, key in enumerate(ledger['order']):
            positions = vent_pos.get(key)
            if not positions:
                continue
            i = min(taken.get(key, 0), len(positions) - 1)
            taken[key] = i + 1
            lags.append(abs(pos - positions[i]))
        runs, current = [], 0
        last_piece = None
        for key in ledger['order']:
            if key[0] == last_piece:
                current += 1
            else:
                if current:
                    runs.append(current)
                current = 1
                last_piece = key[0]
        if current:
            runs.append(current)
        if not lags:
            return {'items': 0}
        lags_arr = np.asarray(lags)
        runs_arr = np.asarray(runs) if runs else np.asarray([0])
        return {
            'items': len(lags),
            'lag_mean': round(float(lags_arr.mean()), 3),
            'lag_p50': int(np.median(lags_arr)),
            'lag_max': int(lags_arr.max()),
            'adjacent_source_runs': len(runs),
            'run_length_mean': round(float(runs_arr.mean()), 3),
            'run_length_max': int(runs_arr.max()),
        }

    def report(self) -> dict:
        """Every epoch's verdict and the totals. ``complete`` is the AND over
        the audited epochs (an epoch still in flight reads incomplete until
        its last item is delivered: audit after consumption)."""
        tracker = self._tracker
        epochs = {}
        for epoch in tracker.epochs():
            verdict = self.audit_epoch(epoch)
            if verdict is not None:
                epochs[epoch] = verdict
        return {
            'enabled': tracker.enabled,
            'dataset': tracker.dataset_digest,
            'shard': tracker.shard,
            'passes': tracker.passes,
            'records_registered': tracker.records_registered,
            'rows_quarantined_total': tracker.quarantined_rows_total,
            'items_quarantined_total': tracker.quarantined_items_total,
            'epochs': epochs,
            'complete': all(v['complete'] for v in epochs.values())
            if epochs else None,
        }

    def assert_complete(self) -> dict:
        """``AssertionError`` naming the row groups at fault unless every
        audited epoch delivered exactly once; returns the report."""
        report = self.report()
        problems = []
        for epoch, verdict in report['epochs'].items():
            if verdict['dropped_items']:
                problems.append('epoch {}: dropped {}'.format(
                    epoch, verdict['dropped_items']))
            if verdict['dup_items']:
                problems.append('epoch {}: duplicated {}'.format(
                    epoch, verdict['dup_items']))
            if verdict['row_exact'] and (verdict['row_dups']
                                         or verdict['row_missing']):
                problems.append('epoch {}: {} duplicate / {} missing rows'
                                .format(epoch, verdict['row_dups'],
                                        verdict['row_missing']))
        if problems:
            raise AssertionError('coverage audit failed: ' +
                                 '; '.join(problems))
        return report

    @staticmethod
    def shard_skew(reports: List[dict]) -> dict:
        """Skew across the coverage reports of one reader a shard: rows
        delivered per shard per epoch and the max / min ratio."""
        per_shard = {}
        epochs = set()
        for report in reports:
            shard = report.get('shard', -1)
            rows = {int(e): v['rows_delivered']
                    for e, v in report.get('epochs', {}).items()}
            per_shard[shard] = rows
            epochs.update(rows)
        skew = {}
        for epoch in sorted(epochs):
            rows = [per_shard[s].get(epoch, 0) for s in sorted(per_shard)]
            low = min(rows)
            skew[epoch] = {
                'rows_per_shard': {s: per_shard[s].get(epoch, 0)
                                   for s in sorted(per_shard)},
                'skew_ratio': round(max(rows) / low, 4) if low else None,
            }
        return {'shards': sorted(per_shard), 'epochs': skew}


class BatchProvenance:
    """Row provenance of one loader batch: the packed int64 source column
    that rode through the shuffling buffer. Row ``i`` came from payload
    offset ``sources[i] & OFFSET_MASK`` of registered item ``sources[i] >>
    PACK_SHIFT``; records resolve lazily."""

    __slots__ = ('sources', '_tracker')

    def __init__(self, sources: np.ndarray, tracker: Optional[LineageTracker]):
        self.sources = np.asarray(sources, dtype=np.int64)
        self._tracker = tracker

    def __len__(self) -> int:
        return len(self.sources)

    def seqs(self) -> np.ndarray:
        return self.sources >> PACK_SHIFT

    def offsets(self) -> np.ndarray:
        return self.sources & _OFFSET_MASK

    def record_for_row(self, i: int) -> Optional[Provenance]:
        if self._tracker is None:
            return None
        return self._tracker.resolve(int(self.sources[i]) >> PACK_SHIFT)

    def records(self) -> Dict[int, Optional[Provenance]]:
        """``seq -> Provenance`` of every source item of the batch (None
        where evicted)."""
        out = {}
        if self._tracker is None:
            return out
        for seq in np.unique(self.seqs()):
            out[int(seq)] = self._tracker.resolve(int(seq))
        return out

    def shuffle_quality(self) -> dict:
        """Row shuffle quality of the batch: runs of consecutive rows from
        one source item (long runs: the buffer is too small to decorrelate
        the row-group order) and the count of sources."""
        seqs = self.seqs()
        if not len(seqs):
            return {'rows': 0}
        boundaries = np.flatnonzero(np.diff(seqs) != 0)
        run_lengths = np.diff(np.concatenate(
            ([0], boundaries + 1, [len(seqs)])))
        return {
            'rows': int(len(seqs)),
            'sources': int(len(np.unique(seqs))),
            'adjacent_source_runs': int(len(run_lengths)),
            'run_length_mean': round(float(run_lengths.mean()), 3),
            'run_length_max': int(run_lengths.max()),
        }

    def summary(self) -> dict:
        """Rows per source item with each item's provenance: where the
        batch's rows came from, JSON-able."""
        seqs = self.seqs()
        sources = []
        for seq, count in zip(*np.unique(seqs, return_counts=True)):
            record = (self._tracker.resolve(int(seq))
                      if self._tracker is not None else None)
            entry = {'seq': int(seq), 'rows': int(count)}
            if record is not None:
                entry.update({'path': record.path,
                              'row_group': record.row_group,
                              'epoch': record.epoch,
                              'shard': record.shard,
                              'selection': list(record.selection[:1]) +
                              [int(x) if isinstance(x, (int, np.integer))
                               else list(x) for x in record.selection[1:]]})
            else:
                entry['evicted'] = True
            sources.append(entry)
        return {'rows': int(len(seqs)), 'sources': sources,
                'shuffle': self.shuffle_quality()}


# -- quarantine records -------------------------------------------------------

def make_quarantine_record(piece, piece_index: int, epoch: int,
                           partition: tuple, shard: int, stage: str,
                           error: BaseException, field: Optional[str] = None,
                           rows: int = 1,
                           row_offsets=None) -> dict:
    """One JSON-able quarantine record, what the pools hand the tracker."""
    record = {
        'stage': stage,
        'error': '{}: {}'.format(type(error).__name__, error)[:500],
        'path': piece.path,
        'row_group': piece.row_group,
        'piece_index': piece_index,
        'epoch': epoch,
        'partition': list(partition),
        'shard': shard,
        'rows': int(rows),
        # wall clock on purpose: when the bad sample appeared, for people
        'ts': time.time(),
    }
    if field is not None:
        record['field'] = field
    if row_offsets is not None:
        record['row_offsets'] = [int(o) for o in row_offsets]
    return record


def crash_quarantine_record(tracker: LineageTracker, piece_index: int,
                            epoch: int, partition: tuple,
                            crash_count: int) -> dict:
    """The quarantine record of a poison item, one that killed its worker
    ``crash_count`` times: stage ``'worker-crash'``, so the audit reads the
    item as quarantined, never as a silent drop. Its rows are the
    partition's share of the row group by the ``np.array_split`` rule (the
    first ``num_rows % n`` partitions carry one extra row)."""
    import types
    info = (tracker.pieces.get(int(piece_index)) if piece_index is not None
            else None)
    path, row_group, num_rows = info if info else ('<unknown>', -1, -1)
    partition = tuple(partition or (0, 1))
    k, n = int(partition[0]), max(1, int(partition[1]))
    rows = num_rows if num_rows and num_rows > 0 else 1
    if n > 1 and num_rows and num_rows > 0:
        rows = num_rows // n + (1 if k < num_rows % n else 0)
    piece = types.SimpleNamespace(path=path, row_group=row_group)
    return make_quarantine_record(
        piece, int(piece_index if piece_index is not None else -1),
        int(epoch or 0), partition, tracker.shard, 'worker-crash',
        RuntimeError('item killed {} worker(s); quarantined instead of '
                     'crash-looping'.format(crash_count)), rows=rows)


# -- replay -------------------------------------------------------------------

def _payload_to_columns(payload, schema) -> Dict[str, np.ndarray]:
    """Numpy columns, in payload-row order, of any worker payload: an arrow
    table, a dict of columns or a list of row dicts."""
    import pyarrow as pa
    if isinstance(payload, pa.Table):
        from petastorm_tpu_torch.readers.batch_worker import BatchResultsReader
        out = {}
        for name in payload.column_names:
            field = schema.fields.get(name) if schema is not None else None
            column = payload.column(name)
            if field is not None:
                out[name] = BatchResultsReader._column_to_numpy(column, field)
            else:
                out[name] = column.to_numpy(zero_copy_only=False)
        return out
    if isinstance(payload, dict):
        return {k: np.asarray(v) if not isinstance(v, np.ndarray) else v
                for k, v in payload.items()}
    if isinstance(payload, list):   # row dicts
        from petastorm_tpu_torch.torch_utils import _collate
        return _collate(payload) if payload else {}
    raise TypeError('cannot replay payload of type {}'.format(type(payload)))


def replay_records(reader, records: List[Provenance],
                   offsets_per_record: Optional[List[np.ndarray]] = None
                   ) -> Dict[str, np.ndarray]:
    """Fetch the rows of ``records`` again through the reader's own worker
    (same predicate, partition, decode and transform, no readahead, no
    cache) and return them as numpy columns, concatenated in record order.
    Columns the reader ships raw for device decode come back decoded on
    the host, its device ``TransformSpec`` run over them, as delivered.
    ``offsets_per_record`` picks payload rows per record (how
    :func:`replay` puts a batch together again)."""
    make_worker = getattr(reader, '_replay_worker', None)
    replay_items = getattr(reader, '_replay_items', None)
    if make_worker is None or replay_items is None:
        raise RuntimeError('reader does not expose replay machinery')
    worker = make_worker()
    pieces_out = []
    try:
        for i, record in enumerate(records):
            if record is None:
                raise ValueError('cannot replay an evicted provenance record '
                                 '(raise the tracker record capacity)')
            if record.selection[0] == 'windows':
                raise NotImplementedError(
                    'replay of NGram window provenance is not supported')
            item = replay_items[(record.piece_index,
                                 tuple(record.partition))]
            payload = worker(item._replace(epoch=record.epoch))
            if payload is None:
                raise RuntimeError(
                    'replay of {}:{} published 0 payloads (expected 1)'
                    .format(record.path, record.row_group))
            # planned columns come raw: decode them (and run a device
            # transform) as the delivery did
            columns = reader._host_decode_raw(_payload_to_columns(
                payload, getattr(reader, 'schema', None)))
            if offsets_per_record is not None:
                offsets = np.asarray(offsets_per_record[i], dtype=np.int64)
                columns = {k: v[offsets] for k, v in columns.items()}
            pieces_out.append(columns)
    finally:
        worker.shutdown()
    if not pieces_out:
        return {}
    if len(pieces_out) == 1:
        return pieces_out[0]
    out = {}
    for k in pieces_out[0]:
        parts = [p[k] for p in pieces_out]
        if any(p.dtype == object for p in parts):
            # dense and object parts (a nullable field whose nulls all fell
            # in one row group): row by row, never broadcast
            col = np.empty(sum(len(p) for p in parts), dtype=object)
            pos = 0
            for p in parts:
                for j in range(len(p)):
                    col[pos + j] = p[j]
                pos += len(p)
            out[k] = col
        else:
            out[k] = np.concatenate(parts)
    return out


def replay(reader, provenance) -> Dict[str, np.ndarray]:
    """The rows of recorded provenance, fetched again through the reader's
    row-group machinery, bit for bit.

    ``provenance``: a :class:`Provenance` (all of the item's rows), a
    registered ``seq``, a list of either, a :class:`BatchProvenance`, or a
    loader batch dict holding one under ``'_provenance'``; the last two
    give the batch's rows in the batch's order."""
    tracker = getattr(reader, 'lineage', None)
    if isinstance(provenance, dict):
        provenance = batch_provenance_of(provenance) or provenance
    if isinstance(provenance, BatchProvenance):
        seqs = provenance.seqs()
        offsets = provenance.offsets()
        order = np.arange(len(seqs))
        records, offset_lists, positions = [], [], []
        for seq in np.unique(seqs):
            mask = seqs == seq
            record = tracker.resolve(int(seq)) if tracker is not None else None
            records.append(record)
            offset_lists.append(offsets[mask])
            positions.append(order[mask])
        columns = replay_records(reader, records, offset_lists)
        # rows came back grouped by seq: put them in batch order
        perm = np.concatenate(positions) if positions else np.empty(0, np.int64)
        inverse = np.empty(len(perm), dtype=np.int64)
        inverse[perm] = np.arange(len(perm))
        return {k: v[inverse] for k, v in columns.items()}
    if isinstance(provenance, Provenance):
        return replay_records(reader, [provenance])
    if isinstance(provenance, (int, np.integer)):
        record = tracker.resolve(int(provenance)) if tracker is not None \
            else None
        return replay_records(reader, [record])
    if isinstance(provenance, (list, tuple)):
        records = [tracker.resolve(int(p)) if isinstance(p, (int, np.integer))
                   else p for p in provenance]
        return replay_records(reader, records)
    raise TypeError('cannot replay {!r}'.format(type(provenance)))
