"""``make_reader`` of the port: an NGram window reader over a local
petastorm_tpu store.

Counterpart of ``petastorm_tpu/reader.py`` ``make_reader`` (:210) and
``Reader`` (:489) for the chunked NGram path: row-group pieces are
ventilated (seeded shuffle, epochs) into a thread pool whose workers read and
decode each row group column-wise and form its windows
(:mod:`petastorm_tpu_torch.readers.columnar_worker`); the consumer takes them
as :class:`~petastorm_tpu_torch.ngram.NGramWindowChunk`s through
:meth:`Reader.iter_ngram_chunks`. Plain row reads, predicates, transforms,
sharding, caches, lineage, health, autotune, the process pool and object
stores are not ported yet.
"""

from __future__ import annotations

import copy

from petastorm_tpu_torch.etl.dataset_metadata import (get_schema,
                                                      load_row_groups)
from petastorm_tpu_torch.fs import url_to_path
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.readers.columnar_worker import load_window_chunk
from petastorm_tpu_torch.workers.thread_pool import (EmptyResultError,
                                                     ThreadPool)


def make_reader(dataset_url, schema_fields=None, num_epochs=1,
                shuffle_row_groups=True, workers_count=10, seed=None):
    """NGram reader over the store at ``dataset_url`` (``file://`` or a
    path). ``schema_fields`` must be an :class:`NGram`; ``num_epochs=None``
    loops forever; ``seed`` fixes the per-epoch row-group order."""
    if not isinstance(schema_fields, NGram):
        raise NotImplementedError(
            'petastorm_tpu_torch.make_reader reads NGram windows in this '
            'slice; plain field-list reads come with a later slice')
    if num_epochs is not None and num_epochs < 1:
        raise ValueError('num_epochs must be >= 1 or None')
    return Reader(url_to_path(dataset_url), copy.deepcopy(schema_fields),
                  num_epochs=num_epochs, shuffle_row_groups=shuffle_row_groups,
                  workers_count=workers_count, seed=seed)


class Reader:
    """Context manager yielding NGram window chunks; see :func:`make_reader`.

    ``ngram`` is the reader's resolved NGram, ``schema`` the view of the
    fields it reads, ``stored_schema`` the store's full schema."""

    #: Every published item is a columnar window chunk (the loader's
    #: vectorized collation keys off this, as in the JAX package).
    ngram_chunked = True

    def __init__(self, dataset_path, ngram: NGram, num_epochs,
                 shuffle_row_groups, workers_count, seed):
        self.dataset_path = dataset_path
        self.stored_schema = get_schema(dataset_path)
        ngram.resolve_regex_field_names(self.stored_schema)
        missing = [n for n in ngram.get_all_field_names()
                   if n not in self.stored_schema.fields]
        if missing:
            raise ValueError('NGram fields {} are not in the store schema'
                             .format(missing))
        self.ngram = ngram
        self.schema = self.stored_schema.create_schema_view(
            [self.stored_schema.fields[n]
             for n in ngram.get_all_field_names()])
        pieces = load_row_groups(dataset_path)
        if not pieces:
            raise ValueError('no row groups found at {}'.format(dataset_path))
        self._pool = ThreadPool(workers_count)
        self._pool.start(
            lambda piece: load_window_chunk(piece, self.stored_schema,
                                            self.ngram),
            pieces, num_epochs=num_epochs, shuffle=shuffle_row_groups,
            seed=seed)

    def iter_ngram_chunks(self):
        """Window chunks, one per row group that has a valid window."""
        while True:
            try:
                chunk = self._pool.get_results()
            except EmptyResultError:
                return
            if chunk is not None:
                yield chunk

    def stop(self):
        self._pool.stop()

    def join(self, timeout=None):
        self._pool.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()
