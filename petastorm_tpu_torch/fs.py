"""Dataset URL resolution: URL -> (filesystem, path), picklable factories.

The port's copy of ``petastorm_tpu/fs.py`` (:24-146): ``_SCHEME_ALIASES``,
``_parse_url``, ``get_filesystem_and_path_or_paths`` (one filesystem for a
URL list), ``get_dataset_path``, the picklable :class:`FilesystemFactory`
and the HDFS name-service lookup (:mod:`petastorm_tpu_torch.hdfs`).

A path without a scheme stays the string it was given, as in JAX: the
store's path enters cache keys, piece paths and provenance records, so a
relative path must give the JAX package's keys (a worker makes it absolute
for the open only, :meth:`LocalFilesystem.absolute`).

The local filesystem needs no filesystem package: :data:`LOCAL_FILESYSTEM`
is the host's ``os`` and ``open`` behind the handful of fsspec methods the
readers and the converter call (``open``, ``size``, ``exists``,
``find``, ``makedirs``, ``rm``, ``info``), with ``protocol = 'file'`` so
that a worker's automatic read mode is ``serial``, as JAX's is for
fsspec's local filesystem. Every other scheme (``s3``, ``gcs``, ``hdfs``, ``memory``)
resolves through fsspec, imported only then; without fsspec such a URL
raises an ``ImportError`` naming the scheme.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

#: Schemes normalized onto a canonical fsspec protocol (JAX :24-32).
_SCHEME_ALIASES = {
    '': 'file',
    'file': 'file',
    'hdfs': 'hdfs',
    's3': 's3', 's3a': 's3', 's3n': 's3',
    'gs': 'gcs', 'gcs': 'gcs',
    'memory': 'memory',
}


class LocalFilesystem:
    """The host's filesystem behind the fsspec methods the readers call.
    Paths are used as given (a relative one against the working
    directory); :meth:`find` returns absolute paths, as fsspec's local
    filesystem does."""

    protocol = 'file'

    def open(self, path, mode='rb', **kwargs):
        return open(path, mode, **kwargs)

    def size(self, path) -> int:
        return os.path.getsize(path)

    def exists(self, path) -> bool:
        return os.path.exists(path)

    def find(self, path) -> List[str]:
        """Every file under ``path`` (absolute, sorted)."""
        root = os.path.abspath(path)
        if os.path.isfile(root):
            return [root]
        out = []
        for dirpath, _dirs, files in os.walk(root):
            out.extend(os.path.join(dirpath, f) for f in files)
        return sorted(out)

    def makedirs(self, path, exist_ok=False) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def rm(self, path, recursive=False) -> None:
        if recursive and os.path.isdir(path):
            import shutil
            shutil.rmtree(path)
        else:
            os.remove(path)

    def info(self, path) -> Dict:
        return {'name': path, 'size': os.path.getsize(path),
                'type': 'directory' if os.path.isdir(path) else 'file'}

    @staticmethod
    def absolute(path: str, cwd: Optional[str] = None) -> str:
        """``path`` against ``cwd`` (the reader's working directory; None:
        this process's) when it is relative: what a worker opens."""
        if os.path.isabs(path):
            return path
        return os.path.join(cwd or os.getcwd(), path)

    def __repr__(self):
        return 'LocalFilesystem()'


#: The one local filesystem object; a worker whose filesystem is this one
#: lets pyarrow open its files by path.
LOCAL_FILESYSTEM = LocalFilesystem()


def _fsspec(protocol: str):
    """fsspec, imported for a non-local scheme only."""
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            'the {!r} url scheme needs fsspec (and its {} implementation), '
            'which is not installed: {}'.format(protocol, protocol, e)) from e
    return fsspec


class FilesystemFactory:
    """Picklable callable producing a fresh filesystem, for worker
    interpreters (JAX :54-80): :data:`LOCAL_FILESYSTEM` for ``file``, an
    :class:`~petastorm_tpu_torch.hdfs.namenode.HAHdfsClient` over the
    namenodes of an HA name service, else ``fsspec.filesystem(protocol,
    **storage_options)``."""

    def __init__(self, protocol: str, storage_options: Optional[Dict] = None,
                 hdfs_namenodes: Optional[list] = None):
        self._protocol = protocol
        self._storage_options = dict(storage_options or {})
        self._hdfs_namenodes = hdfs_namenodes

    @property
    def protocol(self) -> str:
        return self._protocol

    @property
    def storage_options(self) -> Dict:
        return dict(self._storage_options)

    def __call__(self):
        if self._hdfs_namenodes:
            from petastorm_tpu_torch.hdfs.namenode import HdfsConnector
            return HdfsConnector.connect_to_either_namenode(
                self._hdfs_namenodes)
        if self._protocol == 'file':
            return LOCAL_FILESYSTEM
        return _fsspec(self._protocol).filesystem(self._protocol,
                                                  **self._storage_options)

    def __repr__(self):
        return 'FilesystemFactory({!r})'.format(self._protocol)


def _resolve_hdfs_namenodes(url: str) -> Optional[list]:
    """The namenodes when the url's authority is a configured HA name
    service (Hadoop XML under ``HADOOP_HOME`` and friends); None otherwise
    (JAX :83-95)."""
    netloc = urlparse(url).netloc
    if not netloc or ':' in netloc:
        return None   # an explicit host:port, not a name service
    try:
        from petastorm_tpu_torch.hdfs.namenode import HdfsNamenodeResolver
        return HdfsNamenodeResolver().resolve_hdfs_name_service(netloc)
    except Exception:   # a broken config resolves as no name service
        logger.debug('HDFS name service resolution failed for %s', url,
                     exc_info=True)
        return None


def _parse_url(url: str) -> Tuple[str, str]:
    """URL -> (fsspec protocol, path), JAX's rules (:98-121): a scheme-less
    URL is a local path kept as given; ``file://host/...`` is refused as
    the typo of ``file:///...``; ``memory`` paths are rooted; ``s3`` and
    ``gcs`` keep the bucket in the path; ``hdfs`` leaves the authority to
    the filesystem."""
    parsed = urlparse(url)
    scheme = parsed.scheme.lower()
    if scheme not in _SCHEME_ALIASES:
        raise ValueError('Unsupported url scheme {!r} in {!r}. Supported: {}'
                         .format(scheme, url,
                                 sorted(s for s in _SCHEME_ALIASES if s)))
    protocol = _SCHEME_ALIASES[scheme]
    if protocol == 'file':
        if parsed.netloc and parsed.netloc != 'localhost':
            raise ValueError(
                'file:// URLs must use three slashes (file:///abs/path); got '
                '{!r} whose authority component {!r} would be dropped'.format(
                    url, parsed.netloc))
        path = parsed.path if scheme else url
    elif protocol in ('s3', 'gcs'):
        path = parsed.netloc + parsed.path
    elif protocol == 'memory':
        path = '/' + parsed.netloc + parsed.path if parsed.netloc \
            else parsed.path
    else:
        path = parsed.path
    return protocol, path


def get_filesystem_and_path_or_paths(url_or_urls,
                                     storage_options: Optional[Dict] = None):
    """``(filesystem, path_or_paths, filesystem_factory)`` of one URL or a
    list of URLs, which must all live on one filesystem (JAX :124-143)."""
    urls = url_or_urls if isinstance(url_or_urls, list) else [url_or_urls]
    parsed = [_parse_url(u) for u in urls]
    protocols = {p for p, _ in parsed}
    if len(protocols) > 1:
        raise ValueError('All urls must be on the same filesystem, got {}'
                         .format(protocols))
    protocol = parsed[0][0]
    paths = [path for _, path in parsed]
    hdfs_namenodes = (_resolve_hdfs_namenodes(urls[0]) if protocol == 'hdfs'
                      else None)
    factory = FilesystemFactory(protocol, storage_options,
                                hdfs_namenodes=hdfs_namenodes)
    path_or_paths = paths if isinstance(url_or_urls, list) else paths[0]
    return factory(), path_or_paths, factory


def get_dataset_path(url: str) -> str:
    """URL -> the bare path on its filesystem."""
    return _parse_url(url)[1]


def retry_filesystem_call(func=None, *, attempts: int = 3,
                          initial_delay_s: float = 0.1,
                          total_budget_s: Optional[float] = 30.0):
    """Retry transient filesystem errors through the shared
    :class:`~petastorm_tpu_torch.resilience.RetryPolicy` (a decorator, with
    or without arguments): full-jitter backoff under a total wall budget,
    and a permanent error (``FileNotFoundError``, ``PermissionError``, a
    request-shaped errno) fails on its first attempt."""
    from petastorm_tpu_torch.resilience import RetryPolicy
    policy = RetryPolicy(attempts=attempts, initial_backoff_s=initial_delay_s,
                         total_budget_s=total_budget_s)

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            return policy.call(f, *args, description=f.__name__, **kwargs)
        return wrapper
    return decorate(func) if func is not None else decorate


def normalize_dir_url(dataset_url: str) -> str:
    """Strip trailing slashes from a dataset directory URL."""
    if not isinstance(dataset_url, str):
        raise ValueError('dataset_url must be a string, got {!r}'.format(
            dataset_url))
    return dataset_url.rstrip('/') or '/'


def normalize_dataset_url_or_urls(dataset_url_or_urls):
    """One URL, or a non-empty list of URLs (``make_batch_reader``'s list of
    parquet files), with trailing slashes stripped."""
    if isinstance(dataset_url_or_urls, (list, tuple)):
        if not dataset_url_or_urls:
            raise ValueError('dataset url list must be non-empty')
        return [normalize_dir_url(u) for u in dataset_url_or_urls]
    return normalize_dir_url(dataset_url_or_urls)
