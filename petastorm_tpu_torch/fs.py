"""Dataset URL resolution of the port: ``file://`` URLs and plain paths.

The counterpart of ``petastorm_tpu/fs.py`` for local stores only; remote
object stores and HDFS come with a later slice. The filesystem is the host's
own (``os`` and ``open``), so no filesystem package is needed.
"""

from __future__ import annotations

import os
from typing import List
from urllib.parse import urlparse


def normalize_dir_url(dataset_url: str) -> str:
    """Strip trailing slashes from a dataset directory URL."""
    if not isinstance(dataset_url, str):
        raise ValueError('dataset_url must be a string, got {!r}'.format(
            dataset_url))
    return dataset_url.rstrip('/') or '/'


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


def list_files(root: str) -> List[str]:
    """Every file under ``root``, sorted."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        out.extend(os.path.join(dirpath, f) for f in files)
    return sorted(out)
