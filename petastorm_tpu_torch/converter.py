"""Dataset converter of the port: materialise in-memory data (a pyarrow
Table, a pandas DataFrame, or a Spark DataFrame collected through
``toPandas``) to Parquet once, and hand out a picklable handle whose
loaders read it.

A copy of ``petastorm_tpu/converter.py``: the parent cache directory
(``set_parent_cache_dir_url``, ``PETASTORM_TPU_CACHE_DIR``), the
content fingerprint with its per-table memo (the same digest as JAX's for
the same table and parameters), the precision casts, the picklable
:class:`SavedDataset`, ``_wait_file_available``,
:func:`make_dataset_converter` (:308) and the atexit delete. The package
keeps its own registry of materialisations, so a handle of one package is
never handed out by the other.

:meth:`SavedDataset.make_torch_dataloader` is the port's
:class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader`,
:meth:`SavedDataset.make_torch_loader` the counterpart of JAX's
``make_jax_loader`` (:210; :func:`~petastorm_tpu_torch.torch_utils.
make_torch_loader`, with ``mesh=``), and :meth:`SavedDataset.
make_tf_dataset` :mod:`petastorm_tpu_torch.tf_utils`' dataset. Their
batches go to the CUDA device unless ``device='cpu'`` is given (the TF
dataset stays with TensorFlow). The rank check asks ``torch.distributed``
first, when a process group of more than one rank is up, then the
Horovod, OpenMPI and PMI variables.
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import sys
import threading
import time
import uuid
import warnings
import weakref
from typing import Dict, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.fs import (get_filesystem_and_path_or_paths,
                                    normalize_dir_url)

logger = logging.getLogger(__name__)

_parent_cache_dir_url = None
_cache_lock = threading.Lock()
#: cache key -> SavedDataset, this package's materialisations
_materialized: Dict[str, 'SavedDataset'] = {}


def set_parent_cache_dir_url(url: Optional[str]) -> None:
    """The directory under which converters materialise datasets (None
    clears it)."""
    global _parent_cache_dir_url
    _parent_cache_dir_url = normalize_dir_url(url) if url else None


def _get_parent_cache_dir_url(explicit: Optional[str]) -> str:
    if explicit:
        return normalize_dir_url(explicit)
    if _parent_cache_dir_url:
        return _parent_cache_dir_url
    env = os.environ.get('PETASTORM_TPU_CACHE_DIR')
    if env:
        return normalize_dir_url(env)
    raise ValueError(
        'No cache directory configured. Pass parent_cache_dir_url=, call '
        'set_parent_cache_dir_url(), or set PETASTORM_TPU_CACHE_DIR')


def _get_rank_and_size():
    """``(rank, size)`` of this training process: the ``torch.distributed``
    process group when one of more than one rank is up (torch is not
    imported for the question), else the Horovod, OpenMPI or PMI
    variables, else ``(None, None)``."""
    torch = sys.modules.get('torch')
    dist = getattr(torch, 'distributed', None)
    try:
        if (dist is not None and dist.is_available()
                and dist.is_initialized() and dist.get_world_size() > 1):
            return dist.get_rank(), dist.get_world_size()
    except Exception:  # noqa: BLE001 - a half-initialised group: the env
        pass
    for rank_env, size_env in [('HOROVOD_RANK', 'HOROVOD_SIZE'),
                               ('OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_SIZE'),
                               ('PMI_RANK', 'PMI_SIZE')]:
        rank, size = os.environ.get(rank_env), os.environ.get(size_env)
        if rank is not None and size is not None:
            return int(rank), int(size)
    return None, None


def _check_rank_mismatch(cur_shard, shard_count):
    rank, size = _get_rank_and_size()
    if rank is not None and (cur_shard != rank or shard_count != size):
        warnings.warn('This process is rank {} of {} but cur_shard={} '
                      'shard_count={} were requested; double-check your '
                      'sharding arguments'.format(rank, size, cur_shard,
                                                  shard_count))


def _to_arrow_table(data) -> pa.Table:
    if isinstance(data, pa.Table):
        return data
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            return pa.Table.from_pandas(data, preserve_index=False)
    except ImportError:
        pass
    # a Spark DataFrame is collected to this machine: bounded by its memory
    # (about twice the decoded dataset while converting)
    if hasattr(data, 'toPandas') and hasattr(data, 'schema'):
        logger.warning(
            'Collecting the Spark DataFrame to this machine for '
            'materialization (driver-RAM-bound; see README "Migrating '
            'Spark pipelines" for the cluster-write pattern)')
        return pa.Table.from_pandas(data.toPandas(), preserve_index=False)
    raise TypeError('Unsupported input type {}; expected pyarrow.Table, '
                    'pandas.DataFrame or pyspark DataFrame'.format(type(data)))


def _normalize_precision(table: pa.Table, precision: Optional[str]) -> pa.Table:
    """float64 → float32 columns (``'float32'``) or float32 → float64
    (``'float64'``)."""
    if precision is None:
        return table
    if precision not in ('float32', 'float64'):
        raise ValueError("precision must be 'float32', 'float64' or None")
    src = pa.float64() if precision == 'float32' else pa.float32()
    dst = pa.float32() if precision == 'float32' else pa.float64()
    fields = []
    changed = False
    for f in table.schema:
        if f.type == src:
            fields.append(pa.field(f.name, dst, f.nullable))
            changed = True
        else:
            fields.append(f)
    return table.cast(pa.schema(fields)) if changed else table


#: id(table) -> {params_repr: digest}. Arrow tables are immutable, so a
#: live table always hashes to the same digest; a finalizer drops the entry
#: when the table dies, so an id is never reused stale.
_fingerprint_memo: Dict[int, Dict[str, str]] = {}


def _fingerprint_memo_for(table: pa.Table) -> Dict[str, str]:
    key = id(table)
    entry = _fingerprint_memo.get(key)
    if entry is None:
        entry = _fingerprint_memo[key] = {}
        weakref.finalize(table, _fingerprint_memo.pop, key, None)
    return entry


def _params_repr(params: Dict) -> str:
    """The one serialisation of the materialisation parameters: inside the
    digest and as the memo key."""
    return repr(sorted(params.items()))


def _fingerprint(table: pa.Table, params: Dict) -> str:
    """The cache key: sha256 of the schema, the row count, every byte of
    the table's Arrow IPC stream (the logical rows, so two slices of one
    buffer differ) and the parameters; 32 hex digits."""
    params_repr = _params_repr(params)
    h = hashlib.sha256()
    h.update(table.schema.to_string().encode())
    h.update(str(table.num_rows).encode())

    class _HashSink:
        closed = False

        @staticmethod
        def write(data):
            h.update(data)
            return len(data)

    with pa.ipc.new_stream(_HashSink(), table.schema) as writer:
        writer.write_table(table)
    h.update(params_repr.encode())
    return h.hexdigest()[:32]


class SavedDataset:
    """Picklable handle of a materialised dataset: another process can
    unpickle it and open readers without materialising again."""

    def __init__(self, cache_dir_url: str, file_urls, dataset_size: int,
                 parent_cache_dir_url: str):
        self.cache_dir_url = cache_dir_url
        self.file_urls = list(file_urls)
        self.dataset_size = dataset_size
        self._parent_cache_dir_url = parent_cache_dir_url

    def __len__(self):
        return self.dataset_size

    def _batch_reader(self, num_epochs, reader_pool_type, workers_count,
                      cur_shard, shard_count, reader_kwargs):
        from petastorm_tpu_torch.reader import make_batch_reader
        if cur_shard is not None:
            _check_rank_mismatch(cur_shard, shard_count)
        return make_batch_reader(
            self.file_urls, num_epochs=num_epochs,
            reader_pool_type=reader_pool_type, workers_count=workers_count,
            cur_shard=cur_shard, shard_count=shard_count, **reader_kwargs)

    def make_torch_loader(self, batch_size=32, mesh=None, num_epochs=None,
                          shuffling_queue_capacity=0,
                          reader_pool_type='thread', workers_count=4,
                          cur_shard=None, shard_count=None, device=None,
                          **reader_kwargs):
        """A :class:`~petastorm_tpu_torch.torch_utils.TorchDataLoader` (or
        with ``mesh`` a ``ShardedTorchLoader``) over the data; a context
        manager."""
        from petastorm_tpu_torch.torch_utils import make_torch_loader
        reader = self._batch_reader(num_epochs, reader_pool_type,
                                    workers_count, cur_shard, shard_count,
                                    reader_kwargs)
        return make_torch_loader(
            reader, batch_size=batch_size, mesh=mesh,
            shuffling_queue_capacity=shuffling_queue_capacity, device=device)

    def make_torch_dataloader(self, batch_size=32, num_epochs=None,
                              shuffling_queue_capacity=0,
                              reader_pool_type='thread', workers_count=4,
                              cur_shard=None, shard_count=None,
                              inmemory_cache_all=False, device=None,
                              **reader_kwargs):
        """A :class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader` over
        the data; a context manager."""
        from petastorm_tpu_torch.pytorch import BatchedDataLoader
        reader = self._batch_reader(num_epochs, reader_pool_type,
                                    workers_count, cur_shard, shard_count,
                                    reader_kwargs)
        return BatchedDataLoader(
            reader, batch_size=batch_size,
            shuffling_queue_capacity=shuffling_queue_capacity,
            inmemory_cache_all=inmemory_cache_all, device=device)

    def make_tf_dataset(self, batch_size=None, num_epochs=None,
                        reader_pool_type='thread', workers_count=4,
                        cur_shard=None, shard_count=None, **reader_kwargs):
        """A context manager giving a ``tf.data.Dataset`` over the data,
        rebatched to ``batch_size`` when one is given."""
        from petastorm_tpu_torch.tf_utils import make_petastorm_dataset
        reader = self._batch_reader(num_epochs, reader_pool_type,
                                    workers_count, cur_shard, shard_count,
                                    reader_kwargs)
        dataset = make_petastorm_dataset(reader)
        if batch_size:
            dataset = dataset.unbatch().batch(batch_size)
        return _TfDatasetContextManager(reader, dataset)

    def delete(self):
        """Remove the materialised files and forget the handle."""
        fs, path, _ = get_filesystem_and_path_or_paths(self.cache_dir_url)
        try:
            if fs.exists(path):
                fs.rm(path, recursive=True)
        except OSError as e:
            logger.warning('Failed to delete %s: %s', self.cache_dir_url, e)
        with _cache_lock:
            for key, saved in list(_materialized.items()):
                if saved is self or saved.cache_dir_url == self.cache_dir_url:
                    del _materialized[key]


class _TfDatasetContextManager:
    def __init__(self, reader, dataset):
        self._reader = reader
        self.dataset = dataset

    def __enter__(self):
        return self.dataset

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._reader.stop()
        self._reader.join()


def _wait_file_available(fs, paths, timeout_s: float = 30.0):
    """Poll until every path exists (eventually consistent object stores);
    raises ``RuntimeError`` after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    pending = list(paths)
    while pending:
        pending = [p for p in pending if not fs.exists(p)]
        if not pending:
            return
        if time.monotonic() > deadline:
            raise RuntimeError('Timed out waiting for files: {}'.format(
                pending[:3]))
        time.sleep(0.1)


def make_dataset_converter(data, parent_cache_dir_url: Optional[str] = None,
                           precision: Optional[str] = None,
                           compression: Optional[str] = None,
                           row_group_size_mb: float = 32.0,
                           delete_at_exit: bool = True) -> SavedDataset:
    """Materialise ``data`` to Parquet under the cache directory, or reuse
    this package's materialisation of the same content and parameters, and
    return its picklable :class:`SavedDataset`."""
    parent = _get_parent_cache_dir_url(parent_cache_dir_url)
    params = {'compression': compression or 'none',
              'row_group_size_mb': row_group_size_mb,
              'precision': precision or 'none'}
    # the digest is memoised by the identity of an arrow table only: pandas
    # and Spark inputs can change in place, so they are hashed every call
    memo = _fingerprint_memo_for(data) if isinstance(data, pa.Table) else None
    params_repr = _params_repr(params)
    key = memo.get(params_repr) if memo is not None else None
    table = None
    if key is None:
        table = _normalize_precision(_to_arrow_table(data), precision)
        key = _fingerprint(table, params)
        if memo is not None:
            memo[params_repr] = key

    with _cache_lock:
        cached = _materialized.get(key)
        if cached is not None:
            fs, path, _ = get_filesystem_and_path_or_paths(cached.cache_dir_url)
            if fs.exists(path):
                logger.info('Cache hit: reusing %s', cached.cache_dir_url)
                return cached
            del _materialized[key]

    if table is None:  # a memo hit whose files are gone: convert again
        table = _normalize_precision(_to_arrow_table(data), precision)

    dir_name = '{}-{}'.format(int(time.time()), uuid.uuid4().hex[:12])
    cache_dir_url = '{}/{}'.format(parent.rstrip('/'), dir_name)
    fs, path, _ = get_filesystem_and_path_or_paths(cache_dir_url)
    fs.makedirs(path, exist_ok=True)

    file_path = '{}/part_00000.parquet'.format(path)
    row_group_rows = max(
        1, int(row_group_size_mb * 1024 * 1024 /
               max(1, table.nbytes // max(1, table.num_rows))))
    with fs.open(file_path, 'wb') as f:
        pq.write_table(table, f, row_group_size=row_group_rows,
                       compression=compression or 'NONE')
    _wait_file_available(fs, [file_path])

    sizes = [fs.info(file_path)['size']]
    if (np.median(sizes) > 0 and np.median(sizes) < 1024
            and table.num_rows > 100000):
        warnings.warn('Materialized parquet files are very small; performance '
                      'may suffer (reference recommends >=50MB median)')

    # a cache directory without a scheme gives bare file paths
    if '://' in cache_dir_url:
        scheme = cache_dir_url.split('://', 1)[0]
        file_url = '{}://{}'.format(scheme, file_path)
    else:
        file_url = file_path
    saved = SavedDataset(cache_dir_url, [file_url], table.num_rows, parent)
    with _cache_lock:
        _materialized[key] = saved
    if delete_at_exit:
        atexit.register(_best_effort_delete, saved)
    return saved


def _best_effort_delete(saved: SavedDataset):
    try:
        saved.delete()
    except Exception:  # noqa: BLE001 - atexit must never raise
        pass
