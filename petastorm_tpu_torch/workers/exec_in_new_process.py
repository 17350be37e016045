"""Run a Python function in a new interpreter, never a fork.

The port's copy of ``petastorm_tpu/workers/exec_in_new_process.py``
(:17-82). The parent holds a CUDA context, which a forked child would
inherit and must not touch, so a worker is a fresh interpreter that cannot
see a GPU (``CUDA_VISIBLE_DEVICES=''``). It imports neither torch nor jax:
the worker modules of the port import neither.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

#: ``1`` starts workers with normal ``site`` initialization (for a
#: dependency that an editable install or a ``.pth`` hook provides); the
#: JAX package's variable.
WORKER_SITE_ENV_VAR = 'PETASTORM_TPU_WORKER_SITE'


def exec_in_new_process(func, args=(), kwargs=None) -> subprocess.Popen:
    """Serialize ``(func, args, kwargs)`` with dill to a temporary file and
    start ``python -S -m petastorm_tpu_torch.workers.exec_in_new_process
    <file>``, which loads, deletes and calls it.

    ``-S`` skips ``site`` and ``sitecustomize``: an environment that loads
    accelerator plugins at start-up would cost each worker seconds, and a
    worker needs none. The parent's resolved ``sys.path`` goes into
    ``PYTHONPATH`` instead, so what the parent imports the worker imports.
    ``PETASTORM_TPU_WORKER_SITE=1`` restores normal start-up."""
    import dill
    fd, path = tempfile.mkstemp(prefix='petastorm_torch_bootstrap_',
                                suffix='.dill')
    with os.fdopen(fd, 'wb') as f:
        dill.dump((func, tuple(args), dict(kwargs or {})), f)
    env = dict(os.environ)
    env['CUDA_VISIBLE_DEVICES'] = ''    # the GPU belongs to the parent
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    use_site = env.get(WORKER_SITE_ENV_VAR) == '1'
    interpreter = [sys.executable] if use_site else [sys.executable, '-S']
    if use_site:
        paths = [repo_root] + env.get('PYTHONPATH', '').split(os.pathsep)
    else:
        paths = [repo_root] + [p for p in sys.path if p]
    env['PYTHONPATH'] = os.pathsep.join(dict.fromkeys(p for p in paths if p))
    return subprocess.Popen(
        interpreter + ['-m', 'petastorm_tpu_torch.workers.exec_in_new_process',
                       path], env=env)


def _main():
    import dill
    path = sys.argv[1]
    try:
        try:
            with open(path, 'rb') as f:
                func, args, kwargs = dill.load(f)
        finally:
            try:
                os.remove(path)
            except OSError:
                pass
        func(*args, **kwargs)
    except ImportError as e:
        if not sys.flags.no_site:
            raise
        # -S skips .pth files, which editable installs rely on
        raise ImportError(
            '{} (worker started with -S to skip site initialization; if the '
            'missing module comes from an editable install or a .pth hook, '
            'set {}=1 to restore normal site startup)'.format(
                e, WORKER_SITE_ENV_VAR)) from e


if __name__ == '__main__':
    _main()
