"""pyarrow-style DNF ``filters`` for the reader: partition-value pruning,
row-group statistics pruning, and exact residual row filtering.

A copy of ``petastorm_tpu/filters.py`` (footers are read through the
store's filesystem, by path on a local one):

1. **Planning time**: every conjunction is tested against each piece. Terms
   on hive partition columns evaluate *exactly* (a partition value is
   constant for the piece); terms on regular columns evaluate
   *conservatively* against the row-group min/max statistics of the file
   footer (a column with no statistics keeps the piece). A piece is pruned
   only when every conjunction is provably unsatisfiable for it.
2. **Worker time**: when any filter term names a non-partition column, the
   full DNF is pushed down as a row predicate (:class:`FiltersPredicate`,
   specialised per piece), so the output is row-exact.

``filters`` grammar: ``[(col, op, val), ...]`` is a single AND conjunction; a
list of such lists is an OR of conjunctions. Ops: ``= == != < <= > >= in
not in``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from petastorm_tpu_torch.predicates import PredicateBase
from petastorm_tpu_torch.utils import cast_partition_value, cast_string_to_type

FILTER_OPS = {
    '=': lambda a, b: a == b,
    '==': lambda a, b: a == b,
    '!=': lambda a, b: a != b,
    '<': lambda a, b: a < b,
    '<=': lambda a, b: a <= b,
    '>': lambda a, b: a > b,
    '>=': lambda a, b: a >= b,
    'in': lambda a, b: a in b,
    'not in': lambda a, b: a not in b,
}

Conjunction = List[Tuple[str, str, object]]


def normalize_filters(filters) -> Optional[List[Conjunction]]:
    """Validate ``filters`` and normalize to a list of conjunctions (DNF)."""
    if not filters:
        return None
    if isinstance(filters[0], tuple):
        raw_conjunctions = [list(filters)]
    else:
        raw_conjunctions = [list(c) for c in filters]
    conjunctions = []
    for raw in raw_conjunctions:
        if not raw:
            raise ValueError('filters contains an empty conjunction')
        conjunction: Conjunction = []
        for term in raw:
            if not (isinstance(term, tuple) and len(term) == 3):
                raise ValueError(
                    'filter terms must be (column, op, value) tuples; got '
                    '{!r}'.format(term))
            col, op, val = term
            if op not in FILTER_OPS:
                raise ValueError('Unsupported filter op {!r} on column {!r}; '
                                 'supported: {}'.format(op, col,
                                                        sorted(FILTER_OPS)))
            if op in ('in', 'not in'):
                if isinstance(val, (str, bytes)) \
                        or not hasattr(val, '__iter__'):
                    # a bare string is iterable but would evaluate with
                    # substring semantics at row time; any real collection
                    # (list, set, numpy array, range, ...) is fine
                    raise ValueError(
                        "filter ({!r}, {!r}, ...) needs a collection value; "
                        'got {!r}'.format(col, op, val))
                # materialize: the value is evaluated many times (per row in
                # workers, per row group at planning) — a one-shot iterator
                # would silently exhaust after the first evaluation. Prefer a
                # frozenset (O(1) membership per row; pickles cleanly);
                # unhashable elements fall back to a list.
                materialized = list(val)
                try:
                    val = frozenset(materialized)
                except TypeError:
                    val = materialized
            conjunction.append((col, op, val))
        conjunctions.append(conjunction)
    return conjunctions


def filter_column_names(conjunctions: Sequence[Conjunction]) -> List[str]:
    return sorted({col for conjunction in conjunctions
                   for col, _, _ in conjunction})


def _scalar_type_ok(dtype_kind: str, val) -> bool:
    if isinstance(val, bool):
        return dtype_kind == 'b'
    if isinstance(val, (int, float)):
        return dtype_kind in 'biuf'
    if isinstance(val, str):
        # a str value against a bytes ('S') column would compare str-vs-bytes
        # per row — always False, i.e. a silent zero-row result; surface the
        # mismatch here like the other type checks (pass bytes instead)
        return dtype_kind == 'U'
    if isinstance(val, bytes):
        return dtype_kind == 'S'
    return True                     # date/decimal/...: let the workers decide


def validate_filter_types(conjunctions: Sequence[Conjunction], schema,
                          partition_keys=()) -> None:
    """Reject obviously type-mismatched filter values at construction time.

    Without this, ``('id', '>', '5')`` on an int column would crash workers
    mid-iteration with a per-row ``TypeError`` (the reference's pyarrow path
    rejects it at dataset-open time). Partition columns are exempt — their
    string values coerce to the filter value's type."""
    for conjunction in conjunctions:
        for col, op, val in conjunction:
            if col in partition_keys:
                continue
            field = schema.fields.get(col)
            if field is None or field.numpy_dtype is None:
                continue
            try:
                kind = np.dtype(field.numpy_dtype).kind
            except TypeError:
                continue
            values = val if op in ('in', 'not in') else [val]
            try:
                iter(values)
            except TypeError:
                raise ValueError(
                    "filter ({!r}, {!r}, ...) needs an iterable value".format(
                        col, op))
            for v in values:
                if not _scalar_type_ok(kind, v):
                    raise ValueError(
                        'filter value {!r} is incompatible with column {!r} '
                        '(dtype kind {!r})'.format(v, col, kind))


def _eval_term(actual, op: str, val) -> bool:
    """Exact evaluation of one term on a concrete cell value. ``None`` /
    missing values fail every comparison (pyarrow null semantics)."""
    if actual is None:
        return False
    # hive partition values arrive as strings; coerce to the filter value's
    # type so ('id', '>', 5) works on an unregistered partition column. For
    # in/not-in the element type drives the coercion.
    if isinstance(actual, str):
        if op in ('in', 'not in'):
            ref = next(iter(val), None)
            if ref is not None and not isinstance(ref, str):
                actual = cast_string_to_type(type(ref), actual)
        elif not isinstance(val, str):
            actual = cast_string_to_type(type(val), actual)
    return bool(FILTER_OPS[op](actual, val))


class FiltersPredicate(PredicateBase):
    """Row-level DNF filter evaluation, pushed down to reader workers exactly
    like a user predicate. Rows failing every conjunction never leave the
    worker, making ``filters`` row-exact regardless of row-group layout."""

    def __init__(self, conjunctions: Sequence[Conjunction]):
        self._conjunctions = [list(c) for c in conjunctions]
        self._fields = filter_column_names(conjunctions)

    def get_fields(self) -> List[str]:
        return list(self._fields)

    def do_include(self, values: dict) -> bool:
        for conjunction in self._conjunctions:
            if all(_eval_term(values.get(col), op, val)
                   for col, op, val in conjunction):
                return True
        return False

    def specialize(self, piece, schema) -> Optional['FiltersPredicate']:
        """Resolve partition terms against the piece's constant partition
        values, so workers only ever evaluate real stored columns (partition
        columns may not even exist in the stored schema).

        Returns ``None`` when every row of the piece trivially passes (some
        conjunction is fully satisfied by partition values alone), else a
        predicate over the remaining non-partition terms. A piece where no
        conjunction survives yields a reject-all predicate — planning prunes
        such pieces, this is the defensive backstop."""
        partition_values = piece.partition_dict
        reduced: List[Conjunction] = []
        for conjunction in self._conjunctions:
            residual: Conjunction = []
            satisfiable = True
            for col, op, val in conjunction:
                if col in partition_values:
                    field = schema.fields.get(col)
                    actual = cast_partition_value(
                        field.numpy_dtype if field is not None else None,
                        partition_values[col])
                    if not _eval_term(actual, op, val):
                        satisfiable = False
                        break
                else:
                    residual.append((col, op, val))
            if not satisfiable:
                continue
            if not residual:
                return None     # conjunction holds for every row of the piece
            reduced.append(residual)
        return FiltersPredicate(reduced)


class RowGroupStatsEvaluator:
    """Conservative planning-time evaluation of DNF filters per row-group
    piece: partition terms exactly, regular-column terms against footer
    min/max statistics. Footer metadata is read lazily, once per file, and
    only when a filter actually names a non-partition column."""

    def __init__(self, schema, preloaded_footers=None, filesystem=None):
        self._schema = schema
        self._filesystem = filesystem
        # path -> (FileMetaData | None, {column path_in_schema: index})
        self._footers: Dict[str, Tuple[object, Dict[str, int]]] = {}
        # footers already parsed during row-group discovery (metadata-less
        # stores) — reuse instead of a second round-trip per file
        for path, md in (preloaded_footers or {}).items():
            columns = {md.schema.column(j).path: j
                       for j in range(md.num_columns)}
            self._footers[path] = (md, columns)

    # -- footer access ---------------------------------------------------------

    def prefetch_footers(self, paths, num_workers: int = 8) -> None:
        """Read the footers of ``paths`` concurrently, as
        ``load_row_groups`` reads them."""
        from concurrent.futures import ThreadPoolExecutor
        missing = sorted(set(paths) - set(self._footers))
        if not missing:
            return
        with ThreadPoolExecutor(max_workers=num_workers) as executor:
            for path, entry in zip(missing, executor.map(self._read_footer,
                                                         missing)):
                self._footers[path] = entry

    def _read_footer(self, path: str):
        from petastorm_tpu_torch.etl.dataset_metadata import read_footer
        try:
            md = read_footer(path, self._filesystem)
            columns = {md.schema.column(j).path: j
                       for j in range(md.num_columns)}
            return md, columns
        except Exception:  # unreadable footer: never prune on its account
            return None, {}

    def _footer(self, path: str):
        if path not in self._footers:
            self._footers[path] = self._read_footer(path)
        return self._footers[path]

    def _column_stats(self, piece, col: str):
        """``(min, max, all_null)`` for the column chunk, or None when the
        statistics cannot support pruning."""
        md, columns = self._footer(piece.path)
        if md is None or col not in columns:
            return None
        if not 0 <= piece.row_group < md.num_row_groups:
            return None
        rg = md.row_group(piece.row_group)
        chunk = rg.column(columns[col])
        stats = chunk.statistics
        if stats is None:
            return None
        all_null = (stats.has_null_count and stats.null_count == rg.num_rows
                    and rg.num_rows > 0)
        if not stats.has_min_max:
            return (None, None, all_null) if all_null else None
        return stats.min, stats.max, all_null

    # -- term evaluation -------------------------------------------------------

    @staticmethod
    def _term_maybe_true(op: str, val, mn, mx, all_null: bool) -> bool:
        """Could *any* row of the chunk satisfy the term? False only when the
        statistics prove it cannot."""
        if all_null:
            return False            # null fails every supported op
        if mn is None or mx is None:
            return True
        try:
            if op in ('=', '=='):
                return mn <= val <= mx
            if op == '!=':
                return not (mn == mx == val)
            if op == '<':
                return mn < val
            if op == '<=':
                return mn <= val
            if op == '>':
                return mx > val
            if op == '>=':
                return mx >= val
            if op == 'in':
                return any(mn <= v <= mx for v in val)
            if op == 'not in':
                return not (mn == mx and mn in val)
        except TypeError:
            return True             # incomparable stats: keep the piece
        return True

    # -- piece evaluation ------------------------------------------------------

    def piece_maybe_matches(self, piece, conjunctions: Sequence[Conjunction],
                            partition_only: bool = False) -> bool:
        """True unless every conjunction is provably unsatisfiable for the
        piece. With ``partition_only`` no footer is touched: regular-column
        terms count as maybe-true — the cheap first pass that prunes on exact
        partition terms before any footer round-trips are paid."""
        partition_values = piece.partition_dict
        for conjunction in conjunctions:
            satisfiable = True
            for col, op, val in conjunction:
                if col in partition_values:
                    field = self._schema.fields.get(col)
                    actual = cast_partition_value(
                        field.numpy_dtype if field is not None else None,
                        partition_values[col])
                    # an uncastable partition value raises here: partition
                    # terms never reach the workers, so swallowing the error
                    # would silently disable the filter
                    if not _eval_term(actual, op, val):
                        satisfiable = False
                        break
                else:
                    if partition_only:
                        continue
                    stats = self._column_stats(piece, col)
                    if stats is None:
                        continue            # no statistics: cannot prune
                    mn, mx, all_null = stats
                    if not self._term_maybe_true(op, val, mn, mx, all_null):
                        satisfiable = False
                        break
            if satisfiable:
                return True
        return False
