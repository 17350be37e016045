"""Readers of the port over local stores.

Counterparts of ``petastorm_tpu/reader.py`` ``make_reader`` (:210),
``make_columnar_reader`` (:352-427), ``make_batch_reader`` (:430-486) and
``Reader`` (:489): its selection of row groups (``_filter_row_groups``
:952-1026) and its ventilation (:646-663). A reader lists the store's
row-group pieces, prunes them (a predicate on partition keys only, then
``filters`` on partition values and on footer statistics, then a
``rowgroup_selector``, then ``cur_shard``/``shard_count`` over what is
left), and ventilates one work item per piece and row-drop partition
(seeded shuffle, epochs) into a thread pool whose workers read and decode
each row group column-wise. A row predicate (the user's that needs stored
columns, and the residual of ``filters`` specialised to the piece) runs on
the workers. A reader yields one of four kinds of item:

- ``make_reader(url, schema_fields=NGram(...))``: NGram window chunks,
  through :meth:`Reader.iter_ngram_chunks`;
- ``make_reader(url, schema_fields=[...] or None)``: one schema namedtuple
  per row, after an optional per-row
  :class:`~petastorm_tpu_torch.transform.TransformSpec`;
- ``make_columnar_reader(url, ...)``: one namedtuple of decoded column
  arrays per row group (``batched_output``), after an optional columnar
  transform;
- ``make_batch_reader(url or [file urls], ...)``: one namedtuple of column
  arrays per row group of any Parquet store, as arrow stores them
  (``batched_output``), after an optional pandas transform.

Not ported yet (each raises ``NotImplementedError``): NGram with a
predicate, residual filters, a transform or row-drop partitions; decode
hints; caches; the process pool; lineage, health, tracing and autotune;
resilience; remote object stores; JAX-process and elastic sharding.
"""

from __future__ import annotations

import collections
import copy
import functools

from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import (infer_or_load_unischema,
                                                      load_row_groups)
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
from petastorm_tpu_torch.filters import (FiltersPredicate,
                                         RowGroupStatsEvaluator,
                                         filter_column_names,
                                         normalize_filters,
                                         validate_filter_types)
from petastorm_tpu_torch.fs import urls_to_path_or_paths
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.predicates import in_reduce
from petastorm_tpu_torch.readers.batch_worker import (BatchResultsReader,
                                                      load_batch_item)
from petastorm_tpu_torch.readers.columnar_worker import (load_columnar,
                                                         load_window_chunk)
from petastorm_tpu_torch.readers.row_worker import load_row_item
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.unischema import match_unischema_fields
from petastorm_tpu_torch.utils import cast_partition_value
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     ThreadPool, WorkItem)

_LATER = 'is not ported to petastorm_tpu_torch yet; it comes with a later slice'

#: Parameters of the JAX package's factories that the port does not take
#: yet, with the later slice that brings them.
_UNPORTED = {name: later for later, names in (
    ('the process pool', ('reader_pool_type', 'results_queue_size',
                          'zmq_copy_buffers', 'profiling_enabled')),
    ('decode hints', ('decode_hints',)),
    ('caches', ('cache_type', 'cache_location', 'cache_size_limit',
                'cache_row_size_estimate', 'cache_extra_settings')),
    ('readahead', ('io_readahead',)),
    ('lineage and quarantine', ('on_decode_error',)),
    ('tracing and health', ('trace', 'metrics_interval', 'metrics_out',
                            'debug_port', 'stall_timeout',
                            'flight_record_dir', 'slo')),
    ('autotune', ('autotune',)),
    ('resilience', ('retry', 'hedge', 'worker_recovery')),
    ('remote object stores', ('remote_read', 'storage_options')),
    ('multi-GPU sharding', ('shard_by_jax_process', 'elastic')))
    for name in names}


def _refuse_unported(factory, options):
    """``NotImplementedError`` for a parameter of the JAX package's factory
    that the port does not take yet, ``TypeError`` for an unknown one."""
    for name in options:
        if name not in _UNPORTED:
            raise TypeError('{}() got an unexpected keyword argument {!r}'
                            .format(factory, name))
        raise NotImplementedError(
            '{}({}=...) is not ported to petastorm_tpu_torch yet; it comes '
            'with the {} slice'.format(factory, name, _UNPORTED[name]))


def _validate_shard_range(cur_shard, shard_count):
    if cur_shard is None and shard_count is None:
        return
    if (cur_shard is None) != (shard_count is None):
        raise ValueError('cur_shard and shard_count must be specified '
                         'together (got cur_shard={!r}, shard_count={!r})'
                         .format(cur_shard, shard_count))
    if shard_count < 1:
        raise ValueError('shard_count must be a positive integer, got '
                         'shard_count={!r}'.format(shard_count))
    if not 0 <= cur_shard < shard_count:
        raise ValueError('cur_shard must be in [0, shard_count), got '
                         'cur_shard={!r} for shard_count={!r}'.format(
                             cur_shard, shard_count))


def _single_path(factory, dataset_url):
    """The path of one store; a URL list is refused with a pointer to
    ``make_batch_reader``."""
    path = urls_to_path_or_paths(dataset_url)
    if isinstance(path, list):
        raise ValueError('{} supports a single dataset url; a list of file '
                         'urls is only supported by make_batch_reader'
                         .format(factory))
    return path


def make_reader(dataset_url, schema_fields=None, num_epochs=1,
                shuffle_row_groups=True, workers_count=10, seed=None,
                transform_spec=None, predicate=None, filters=None,
                rowgroup_selector=None, cur_shard=None, shard_count=None,
                shuffle_row_drop_partitions=1, **unported):
    """Row-granular reader over the petastorm store at ``dataset_url``
    (``file://`` or a path). ``schema_fields``: an :class:`NGram` (window
    chunks), a list of field names, regexes or fields, or None for every
    field (one namedtuple per row). ``num_epochs=None`` loops forever;
    ``seed`` fixes the per-epoch row-group order.

    Selection: ``predicate`` (a :mod:`~petastorm_tpu_torch.predicates`
    object; on partition keys only it prunes row groups, else it runs on
    the workers), ``filters`` (pyarrow-style DNF, see
    :mod:`~petastorm_tpu_torch.filters`), ``rowgroup_selector`` (a
    :mod:`~petastorm_tpu_torch.selectors` object over the store's
    row-group indexes), ``cur_shard``/``shard_count`` (every
    ``shard_count``-th row group left, from ``cur_shard``), and
    ``shuffle_row_drop_partitions`` (each row group is ventilated that many
    times, each time with one slice of its rows). ``transform_spec.func``
    receives one row dict and returns it transformed."""
    _refuse_unported('make_reader', unported)
    path = _single_path('make_reader', dataset_url)
    mode = 'ngram' if isinstance(schema_fields, NGram) else 'rows'
    return Reader(path, copy.deepcopy(schema_fields), mode=mode,
                  num_epochs=num_epochs,
                  shuffle_row_groups=shuffle_row_groups,
                  workers_count=workers_count, seed=seed,
                  transform_spec=transform_spec, predicate=predicate,
                  filters=filters, rowgroup_selector=rowgroup_selector,
                  cur_shard=cur_shard, shard_count=shard_count,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions)


def make_columnar_reader(dataset_url, schema_fields=None, num_epochs=1,
                         shuffle_row_groups=True, workers_count=10, seed=None,
                         transform_spec=None, predicate=None, filters=None,
                         rowgroup_selector=None, cur_shard=None,
                         shard_count=None, shuffle_row_drop_partitions=1,
                         **unported):
    """Vectorized reader: one namedtuple of decoded numpy column arrays per
    row group (``batched_output``), over the transformed schema.
    ``transform_spec.func`` receives a dict of column arrays and runs on the
    workers. Selection as in :func:`make_reader`; NGram is not supported."""
    _refuse_unported('make_columnar_reader', unported)
    if isinstance(schema_fields, NGram):
        raise ValueError('NGram is not supported by make_columnar_reader; use '
                         'make_reader for windowed sequence assembly')
    path = _single_path('make_columnar_reader', dataset_url)
    return Reader(path, schema_fields, mode='columnar',
                  num_epochs=num_epochs, shuffle_row_groups=shuffle_row_groups,
                  workers_count=workers_count, seed=seed,
                  transform_spec=transform_spec, predicate=predicate,
                  filters=filters, rowgroup_selector=rowgroup_selector,
                  cur_shard=cur_shard, shard_count=shard_count,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions)


def make_batch_reader(dataset_url_or_urls, schema_fields=None, seed=None,
                      shuffle_row_groups=True, predicate=None, num_epochs=1,
                      cur_shard=None, shard_count=None, transform_spec=None,
                      filters=None, workers_count=10, **unported):
    """Vectorized reader of any Parquet store, with or without petastorm
    metadata (a schema is inferred from the files and their hive partition
    directories), or of an explicit list of ``file://`` parquet file URLs
    (read in the caller's order). Yields one namedtuple of numpy column
    arrays per row group (``batched_output``), as arrow stores the columns:
    codecs are not decoded, a null-bearing integer column is float64 with
    NaN, a fixed-shape list column is ``(n, *shape)``.
    ``schema_fields``: a list of regexes or None. ``transform_spec.func``
    receives a pandas DataFrame. Selection by ``predicate``, ``filters``
    and ``cur_shard``/``shard_count`` as in :func:`make_reader`."""
    _refuse_unported('make_batch_reader', unported)
    if schema_fields is not None and not (
            isinstance(schema_fields, list)
            and all(isinstance(f, str) for f in schema_fields)):
        raise ValueError('make_batch_reader schema_fields must be a list of '
                         'regex strings (UnischemaField selection and NGram '
                         'are row-reader features)')
    return Reader(urls_to_path_or_paths(dataset_url_or_urls), schema_fields,
                  mode='batch', num_epochs=num_epochs,
                  shuffle_row_groups=shuffle_row_groups,
                  workers_count=workers_count, seed=seed,
                  transform_spec=transform_spec, predicate=predicate,
                  filters=filters, cur_shard=cur_shard,
                  shard_count=shard_count)


def _view(stored, schema_fields):
    if schema_fields is None:
        return stored
    if all(isinstance(f, str) for f in schema_fields):
        matched = match_unischema_fields(stored, schema_fields)
        if not matched:
            raise ValueError('schema_fields {} matched no fields'
                             .format(schema_fields))
        return stored.create_schema_view(matched)
    return stored.create_schema_view(schema_fields)


def _cast_partition(schema, field_name, value):
    field = schema.fields.get(field_name)
    return cast_partition_value(field.numpy_dtype if field is not None
                                else None, value)


class Reader:
    """Context manager and iterator over a store; see :func:`make_reader`,
    :func:`make_columnar_reader` and :func:`make_batch_reader`.

    ``schema`` is the schema of what the reader yields (the selected fields,
    after the transform), ``stored_schema`` the store's full schema (stored
    or inferred), ``ngram`` the resolved NGram of a window reader (else
    None), ``pieces`` the row-group pieces this reader reads, after
    pruning and sharding."""

    def __init__(self, dataset_path, schema_fields, *, mode, num_epochs,
                 shuffle_row_groups, workers_count, seed,
                 transform_spec=None, predicate=None, filters=None,
                 rowgroup_selector=None, cur_shard=None, shard_count=None,
                 shuffle_row_drop_partitions=1):
        if num_epochs is not None and num_epochs < 1:
            raise ValueError('num_epochs must be >= 1 or None')
        if shuffle_row_drop_partitions < 1:
            raise ValueError('shuffle_row_drop_partitions must be >= 1')
        _validate_shard_range(cur_shard, shard_count)
        self.dataset_path = dataset_path
        self.stored_schema, was_stored = infer_or_load_unischema(dataset_path)
        if mode != 'batch' and not was_stored:
            raise RuntimeError(
                'Dataset at {} is missing petastorm_tpu metadata. If this is '
                'a plain parquet store, use make_batch_reader instead.'.format(
                    dataset_path))
        stored = self.stored_schema
        self.ngram = schema_fields if mode == 'ngram' else None
        #: every published item is a columnar NGram window chunk
        self.ngram_chunked = mode == 'ngram'
        #: every item is a namedtuple of column arrays (one row group)
        self.batched_output = mode in ('columnar', 'batch')
        self._rows = collections.deque()
        self._batches = None

        # footers read while listing a metadata-less store, kept for the
        # statistics pass of ``filters``
        self._footers = {}
        pieces = load_row_groups(dataset_path, footer_cache=self._footers)
        if not pieces:
            raise NoDataAvailableError('No row groups found at {}'.format(
                dataset_path))
        pieces, predicate, filters_predicate = self._filter_row_groups(
            pieces, predicate, rowgroup_selector, filters, cur_shard,
            shard_count)
        if not pieces:
            raise NoDataAvailableError(
                'No row groups left after predicate/selector/shard filtering '
                'at {}'.format(dataset_path))
        #: the row-group pieces this reader reads
        self.pieces = pieces

        if mode == 'ngram':
            ngram = self.ngram
            if (predicate is not None or filters_predicate is not None
                    or transform_spec is not None
                    or shuffle_row_drop_partitions > 1):
                raise NotImplementedError(
                    'an NGram reader with a row predicate, residual filters, '
                    'a transform or row-drop partitions ' + _LATER)
            ngram.resolve_regex_field_names(stored)
            missing = [n for n in ngram.get_all_field_names()
                       if n not in stored.fields]
            if missing:
                raise ValueError('NGram fields {} are not in the store schema'
                                 .format(missing))
            self.schema = stored.create_schema_view(
                [stored.fields[n] for n in ngram.get_all_field_names()])
            process = functools.partial(load_window_chunk, schema=stored,
                                        ngram=ngram)
        else:
            view = _view(stored, schema_fields)
            self.schema = (transform_schema(view, transform_spec)
                           if transform_spec is not None else view)
            names = list(view.fields)
            if mode == 'batch':
                self._batches = BatchResultsReader(self.schema)
                process = functools.partial(
                    load_batch_item, schema=view, full_schema=stored,
                    transform_spec=transform_spec,
                    transformed_schema=self.schema)
            else:
                load = load_columnar if mode == 'columnar' else load_row_item
                process = functools.partial(
                    load, schema=stored, names=names,
                    transform_spec=transform_spec,
                    transformed_schema=self.schema)

        items = []
        for piece in pieces:
            piece_predicate = predicate
            if filters_predicate is not None:
                specialized = filters_predicate.specialize(piece, stored)
                if specialized is not None:
                    piece_predicate = (
                        specialized if piece_predicate is None
                        else in_reduce([piece_predicate, specialized], all))
            items.extend(WorkItem(piece, piece_predicate,
                                  (p, shuffle_row_drop_partitions))
                         for p in range(shuffle_row_drop_partitions))
        self._pool = ThreadPool(workers_count)
        self._pool.start(process, items, num_epochs=num_epochs,
                         shuffle=shuffle_row_groups, seed=seed)

    def _filter_row_groups(self, pieces, predicate, rowgroup_selector,
                           filters, cur_shard, shard_count):
        """``(pieces, worker predicate, filters predicate)``: the pieces left
        after pruning and sharding, the user's predicate where it needs the
        workers, and the row-exact residual of ``filters`` (None when the
        filters name partition keys only)."""
        stored = self.stored_schema
        # the selector's indexes number the pieces of the whole store
        indexed = list(enumerate(pieces))
        worker_predicate = filters_predicate = None
        partition_keys = set(pieces[0].partition_dict)
        if predicate is not None:
            fields = set(predicate.get_fields())
            unknown = fields - set(stored.fields)
            if unknown:
                raise ValueError('Predicate uses unknown fields: {}'.format(
                    sorted(unknown)))
            if fields and fields <= partition_keys:
                indexed = [(i, p) for i, p in indexed if predicate.do_include(
                    {f: _cast_partition(stored, f, p.partition_dict[f])
                     for f in fields})]
            else:
                worker_predicate = predicate

        conjunctions = normalize_filters(filters) if filters is not None \
            else None
        if conjunctions:
            filter_cols = set(filter_column_names(conjunctions))
            unknown = filter_cols - set(stored.fields) - partition_keys
            if unknown:
                raise ValueError('filters use unknown columns: {}'.format(
                    sorted(unknown)))
            validate_filter_types(conjunctions, stored, partition_keys)
            # exact on partition values first, so footers are read only
            # for the pieces that pass; then conservative on statistics,
            # with the row-exact residual run on the workers
            stats = RowGroupStatsEvaluator(stored,
                                           preloaded_footers=self._footers)
            indexed = [(i, p) for i, p in indexed
                       if stats.piece_maybe_matches(p, conjunctions,
                                                    partition_only=True)]
            if filter_cols - partition_keys:
                stats.prefetch_footers({p.path for _, p in indexed})
                indexed = [(i, p) for i, p in indexed
                           if stats.piece_maybe_matches(p, conjunctions)]
                filters_predicate = FiltersPredicate(conjunctions)

        if rowgroup_selector is not None:
            indexes = get_row_group_indexes(self.dataset_path)
            missing = (set(rowgroup_selector.get_index_names())
                       - set(indexes))
            if missing:
                raise ValueError('Selector references unknown indexes: {}'
                                 .format(sorted(missing)))
            selected = rowgroup_selector.select_row_groups(indexes)
            indexed = [(i, p) for i, p in indexed if i in selected]

        pieces = [p for _, p in indexed]
        if cur_shard is not None:
            if len(pieces) < shard_count:
                raise NoDataAvailableError(
                    'Dataset has only {} row groups after pruning but {} '
                    'shards were requested; some shards would receive no '
                    'data'.format(len(pieces), shard_count))
            pieces = [p for i, p in enumerate(pieces)
                      if i % shard_count == cur_shard]
        return pieces, worker_predicate, filters_predicate

    def _next_item(self):
        """The next non-empty published item; StopIteration at the end."""
        while True:
            try:
                item = self._pool.get_results()
            except EmptyResultError:
                raise StopIteration from None
            if item is not None and len(item):
                return item

    def iter_ngram_chunks(self):
        """Window chunks, one per row group that has a valid window."""
        if not self.ngram_chunked:
            raise TypeError('iter_ngram_chunks needs an NGram reader')
        while True:
            try:
                yield self._next_item()
            except StopIteration:
                return

    def __iter__(self):
        return self

    def __next__(self):
        if self.ngram_chunked:
            raise TypeError('an NGram reader yields window chunks: iterate '
                            'iter_ngram_chunks() or batch it with '
                            'TorchDataLoader')
        if self._batches is not None:
            return self._batches.to_batch(self._next_item())
        if self.batched_output:
            return self.schema.make_batch_namedtuple(**self._next_item())
        while not self._rows:
            self._rows.extend(self._next_item())
        return self.schema.make_namedtuple(**self._rows.popleft())

    def stop(self):
        self._pool.stop()

    def join(self, timeout=None):
        self._pool.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()
