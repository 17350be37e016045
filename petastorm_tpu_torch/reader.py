"""Readers of the port over a local petastorm_tpu store.

Counterparts of ``petastorm_tpu/reader.py`` ``make_reader`` (:210),
``make_columnar_reader`` (:352-427) and ``Reader`` (:489). Row-group pieces
are ventilated (seeded shuffle, epochs) into a thread pool whose workers read
and decode each row group column-wise
(:mod:`petastorm_tpu_torch.readers.columnar_worker`). A reader yields one of
three kinds of item:

- ``make_reader(url, schema_fields=NGram(...))``: NGram window chunks,
  through :meth:`Reader.iter_ngram_chunks`;
- ``make_reader(url, schema_fields=[...] or None)``: one schema namedtuple
  per row;
- ``make_columnar_reader(url, ...)``: one namedtuple of column arrays per
  row group (``batched_output``), after an optional columnar
  :class:`~petastorm_tpu_torch.transform.TransformSpec`.

Not ported yet: ``make_batch_reader``, transforms and predicates on the row
reader, decode hints, sharding, caches, lineage, health, autotune, the
process pool and object stores.
"""

from __future__ import annotations

import collections
import copy
import functools

from petastorm_tpu_torch.etl.dataset_metadata import (get_schema,
                                                      load_row_groups)
from petastorm_tpu_torch.fs import url_to_path
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.readers.columnar_worker import (load_columnar,
                                                         load_rows,
                                                         load_window_chunk)
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.unischema import match_unischema_fields
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     ThreadPool)

_LATER = 'is not ported to petastorm_tpu_torch yet; it comes with a later slice'


def make_reader(dataset_url, schema_fields=None, num_epochs=1,
                shuffle_row_groups=True, workers_count=10, seed=None,
                transform_spec=None, predicate=None):
    """Row-granular reader over the store at ``dataset_url`` (``file://`` or
    a path). ``schema_fields``: an :class:`NGram` (window chunks), a list of
    field names, regexes or fields, or None for every field (one namedtuple
    per row). ``num_epochs=None`` loops forever; ``seed`` fixes the
    per-epoch row-group order."""
    if transform_spec is not None:
        raise NotImplementedError('make_reader(transform_spec=...) ' + _LATER)
    if predicate is not None:
        raise NotImplementedError('make_reader(predicate=...) ' + _LATER)
    mode = 'ngram' if isinstance(schema_fields, NGram) else 'rows'
    return Reader(url_to_path(dataset_url), copy.deepcopy(schema_fields),
                  mode=mode, num_epochs=num_epochs,
                  shuffle_row_groups=shuffle_row_groups,
                  workers_count=workers_count, seed=seed)


def make_columnar_reader(dataset_url, schema_fields=None, num_epochs=1,
                         shuffle_row_groups=True, workers_count=10, seed=None,
                         transform_spec=None):
    """Vectorized reader: one namedtuple of decoded numpy column arrays per
    row group (``batched_output``), over the transformed schema.
    ``transform_spec.func`` receives a dict of column arrays and runs on the
    workers. NGram is not supported."""
    if isinstance(schema_fields, NGram):
        raise ValueError('NGram is not supported by make_columnar_reader; use '
                         'make_reader for windowed sequence assembly')
    return Reader(url_to_path(dataset_url), schema_fields, mode='columnar',
                  num_epochs=num_epochs, shuffle_row_groups=shuffle_row_groups,
                  workers_count=workers_count, seed=seed,
                  transform_spec=transform_spec)


def make_batch_reader(*args, **kwargs):
    """Reads plain Parquet stores as arrow-typed batches in the JAX package;
    not ported yet."""
    raise NotImplementedError('make_batch_reader ' + _LATER)


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


class Reader:
    """Context manager and iterator over a store; see :func:`make_reader`
    and :func:`make_columnar_reader`.

    ``schema`` is the schema of what the reader yields (the selected fields,
    after the transform), ``stored_schema`` the store's full schema,
    ``ngram`` the resolved NGram of a window reader (else None)."""

    def __init__(self, dataset_path, schema_fields, *, mode, num_epochs,
                 shuffle_row_groups, workers_count, seed,
                 transform_spec=None):
        if num_epochs is not None and num_epochs < 1:
            raise ValueError('num_epochs must be >= 1 or None')
        self.dataset_path = dataset_path
        self.stored_schema = stored = get_schema(dataset_path)
        self.ngram = schema_fields if mode == 'ngram' else None
        #: every published item is a columnar NGram window chunk
        self.ngram_chunked = mode == 'ngram'
        #: every item is a namedtuple of column arrays (one row group)
        self.batched_output = mode == 'columnar'
        self._rows = collections.deque()
        if mode == 'ngram':
            ngram = self.ngram
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
            names = list(view.fields)
            if mode == 'columnar':
                self.schema = (transform_schema(view, transform_spec)
                               if transform_spec is not None else view)
                process = functools.partial(
                    load_columnar, schema=stored, names=names,
                    transform_spec=transform_spec,
                    transformed_schema=self.schema)
            else:
                self.schema = view
                process = functools.partial(load_rows, schema=stored,
                                            names=names)
        pieces = load_row_groups(dataset_path)
        if not pieces:
            raise ValueError('no row groups found at {}'.format(dataset_path))
        self._pool = ThreadPool(workers_count)
        self._pool.start(process, pieces, num_epochs=num_epochs,
                         shuffle=shuffle_row_groups, seed=seed)

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
