"""Dataset URL resolution of the port: ``file://`` URLs and plain paths.

The counterpart of ``petastorm_tpu/fs.py`` (``normalize_dir_url`` :35,
``normalize_dataset_url_or_urls`` :43, ``retry_filesystem_call`` :149-176)
for local stores only; remote object stores and HDFS come with a later
slice. The filesystem is the host's own (``os`` and ``open``), so no
filesystem package is needed: :data:`LOCAL_FILESYSTEM` is the object with
``open(path, mode)`` that a worker reads through and that the chaos
harness (:func:`petastorm_tpu_torch.faultfs.maybe_wrap`) wraps.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional
from urllib.parse import urlparse


class LocalFilesystem:
    """The host's filesystem behind the one method a worker's reads need
    (JAX opens files through an fsspec filesystem, which the port does not
    need)."""

    def open(self, path, mode='rb', **kwargs):
        return open(path, mode, **kwargs)


#: The one local filesystem object; a worker whose filesystem is this one
#: lets pyarrow open its files by path.
LOCAL_FILESYSTEM = LocalFilesystem()


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


def url_to_path(url: str) -> str:
    """``file:///abs/path`` or a plain path → an absolute local path."""
    url = normalize_dir_url(url)
    parsed = urlparse(url)
    scheme = parsed.scheme.lower()
    if scheme == '':
        return os.path.abspath(url)
    if scheme != 'file':
        raise NotImplementedError(
            'url scheme {!r} is not ported to petastorm_tpu_torch yet (this '
            'slice reads file:// URLs and plain paths)'.format(scheme))
    if parsed.netloc and parsed.netloc != 'localhost':
        raise ValueError(
            'file:// URLs must use three slashes (file:///abs/path); got {!r}'
            .format(url))
    return parsed.path


def urls_to_path_or_paths(dataset_url_or_urls):
    """:func:`url_to_path` of one URL, or the list of paths of a URL list
    (in the caller's order)."""
    urls = normalize_dataset_url_or_urls(dataset_url_or_urls)
    if isinstance(urls, list):
        return [url_to_path(u) for u in urls]
    return url_to_path(urls)


def list_files(root: str) -> List[str]:
    """Every file under ``root``, sorted."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        out.extend(os.path.join(dirpath, f) for f in files)
    return sorted(out)
