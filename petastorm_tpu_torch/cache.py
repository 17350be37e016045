"""Row-group caches: none, or a pickle-on-disk cache of one reader.

A copy of ``petastorm_tpu/cache.py`` (``CacheBase`` :30, ``NullCache`` :40,
``LocalDiskCache`` :47-165): a key maps to a file by its md5 digest under
one of ``shards`` directories, the value is pickled there (written to a
temporary file, then renamed into place), and stores past
``size_limit_bytes`` evict the least recently used files by mtime. The
host-wide cache of decoded segments is
:class:`petastorm_tpu_torch.sharedcache.SharedRowGroupCache`.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
from abc import ABC, abstractmethod

logger = logging.getLogger(__name__)

#: Re-seed the :class:`LocalDiskCache` running byte total from a directory
#: scan every N stores: the total is per process, so with several worker
#: processes writing to one directory each sees only its own stores.
RESEED_SCAN_EVERY = 256


class CacheBase(ABC):
    @abstractmethod
    def get(self, key: str, fill_cache_func):
        """The cached value for ``key``; on a miss ``fill_cache_func()``,
        stored and returned."""

    def cleanup(self):
        """Remove on-disk state, if any."""


class NullCache(CacheBase):
    """No cache: every get calls the fill function."""

    def get(self, key, fill_cache_func):
        return fill_cache_func()


class LocalDiskCache(CacheBase):
    """Pickle-on-disk cache with a size limit and mtime-LRU eviction.

    :param path: cache directory (created if missing).
    :param size_limit_bytes: approximate cap on the bytes cached.
    :param expected_row_size_bytes: advisory, kept for the reference API.
    :param shards: subdirectories that keep directory listings short.
    :param cleanup: :meth:`cleanup` removes the directory.
    """

    def __init__(self, path: str, size_limit_bytes: int,
                 expected_row_size_bytes: int = 0, shards: int = 6,
                 cleanup: bool = False):
        self._path = path
        self._size_limit = size_limit_bytes
        self._shards = shards
        self._cleanup_on_exit = cleanup
        self._approx_total = None     # running byte total, re-seeded by scans
        self._stores_since_scan = 0
        for shard in range(shards):
            os.makedirs(os.path.join(path, 'shard_{:02d}'.format(shard)),
                        exist_ok=True)

    def _key_path(self, key: str) -> str:
        digest = hashlib.md5(key.encode('utf-8')).hexdigest()
        shard = int(digest[:4], 16) % self._shards
        return os.path.join(self._path, 'shard_{:02d}'.format(shard),
                            digest + '.pkl')

    def get(self, key, fill_cache_func):
        path = self._key_path(key)
        try:
            with open(path, 'rb') as f:
                value = pickle.load(f)
            os.utime(path, None)          # LRU order
            return value
        except (OSError, pickle.UnpicklingError, EOFError):
            pass
        value = fill_cache_func()
        try:
            self._store(path, value)
        except OSError as e:   # a cache failure never fails the read
            logger.warning('Failed to store cache entry: %s', e)
        return value

    def _store(self, path: str, value) -> None:
        payload = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        # an overwrite releases the old entry's bytes from the running total
        # up front; a rescan that still lists the old file overcounts for a
        # moment, which evicts conservatively and corrects itself
        try:
            old_size = os.stat(path).st_size
        except OSError:
            old_size = 0
        if old_size and self._approx_total is not None:
            self._approx_total -= old_size
        self._evict_if_needed(len(payload))
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, 'wb') as f:
                f.write(payload)
            os.replace(tmp, path)        # atomic on POSIX
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def _entries(self):
        for shard in range(self._shards):
            shard_dir = os.path.join(self._path, 'shard_{:02d}'.format(shard))
            try:
                names = os.listdir(shard_dir)
            except OSError:
                continue
            for name in names:
                full = os.path.join(shard_dir, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                yield full, st.st_size, st.st_mtime

    def _evict_if_needed(self, incoming_bytes: int) -> None:
        # a running total, re-seeded by a scan when it goes negative (proof
        # that other processes' stores were missed) and every
        # RESEED_SCAN_EVERY stores; a full scan only past the limit
        self._stores_since_scan += 1
        if (self._approx_total is None or self._approx_total < 0
                or self._stores_since_scan >= RESEED_SCAN_EVERY):
            self._approx_total = sum(size for _, size, _ in self._entries())
            self._stores_since_scan = 0
        self._approx_total += incoming_bytes
        if self._approx_total <= self._size_limit:
            return
        entries = list(self._entries())
        total = sum(size for _, size, _ in entries) + incoming_bytes
        for full, size, _ in sorted(entries, key=lambda e: e[2]):
            if total <= self._size_limit:
                break
            try:
                os.remove(full)
                total -= size
            except OSError:
                pass
        self._approx_total = total

    def size_bytes(self) -> int:
        return sum(size for _, size, _ in self._entries())

    def cleanup(self):
        if not self._cleanup_on_exit:
            return
        import shutil
        # rename each shard away before removing it: a concurrent reader
        # sees the whole shard or none of it
        for shard in range(self._shards):
            shard_dir = os.path.join(self._path, 'shard_{:02d}'.format(shard))
            doomed = '{}.removing.{}'.format(shard_dir, os.getpid())
            try:
                os.rename(shard_dir, doomed)
            except OSError:
                continue
            shutil.rmtree(doomed, ignore_errors=True)
        shutil.rmtree(self._path, ignore_errors=True)
