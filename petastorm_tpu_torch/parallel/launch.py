"""Start the ranks of one multi-process program on this host.

:func:`launch_ranks` spawns ``world_size`` fresh interpreters, each
joining one ``torch.distributed`` process group through a ``FileStore``
under a given directory (no TCP port) and running an importable function;
it returns their results by rank. A rank that raises, dies or outlives the
time limit fails the whole launch in the parent with a ``RuntimeError``
naming the rank, and every rank still running is stopped. A rank that
fails inside the rendezvous itself (``init_process_group``: no rank has
run the function yet) is different: the ranks are stopped and started
again over a fresh store, up to :data:`RENDEZVOUS_ATTEMPTS` launches
within the one time limit, since gloo's TCP handshake over the loopback
can fail now and then on a host that many processes share. The CPU tests
run their gloo ranks through it, and ``chip_smoke.py`` its ranks on the
card.

Nothing here imports torch when the module is imported.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import pickle
import time
import traceback

_POLL_S = 0.05

#: Launches tried, each over a fresh store, while a rank fails inside the
#: rendezvous (``retry-1``, ``retry-2`` under the store directory).
RENDEZVOUS_ATTEMPTS = 3


class _RendezvousFailed(RuntimeError):
    """A rank failed inside ``init_process_group``."""


def init_rank(store_dir: str, rank: int, world_size: int,
              backend: str = 'gloo') -> None:
    """Join the process group of ``world_size`` ranks that rendezvous
    through the ``FileStore`` at ``store_dir/store``; on a CUDA host the
    rank's device is card ``rank % device_count``. The ranks share the
    host's cores: each takes its share for its intra-op threads."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    os.makedirs(store_dir, exist_ok=True)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(store_dir, 'store'), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def _resolve(fn):
    if callable(fn):
        return fn
    module, _, name = fn.partition(':')
    return getattr(importlib.import_module(module), name)


def _rank_main(fn, rank, world_size, store_dir, backend, args, kwargs):
    """A rank's body: join, run, write the result (or the traceback)."""
    import torch.distributed as dist
    out = os.path.join(store_dir, 'rank-%d' % rank)
    try:
        try:
            init_rank(store_dir, rank, world_size, backend)
        except BaseException:
            open(out + '.rendezvous', 'w').close()
            raise
        try:
            result = _resolve(fn)(*args, **kwargs)
        finally:
            dist.destroy_process_group()
        with open(out + '.tmp', 'wb') as f:
            pickle.dump(result, f)
        os.replace(out + '.tmp', out + '.pkl')
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        raise


def launch_ranks(fn, world_size: int, store_dir: str, *, args=(),
                 kwargs=None, backend: str = 'gloo',
                 timeout_s: float = 300.0):
    """Run ``fn(*args, **kwargs)`` on ``world_size`` ranks and return the
    list of their results by rank.

    :param fn: a module-level function, or its ``'module:name'``; each rank
        imports it in a fresh interpreter, so it must be importable there
        (the parent's ``sys.path`` is passed on).
    :param store_dir: an empty directory for the ``FileStore`` and the
        ranks' results.
    :param backend: the process group's backend (``'gloo'``; ``'nccl'``
        needs a card a rank).
    :param timeout_s: the wall limit of the whole launch, retries
        included; a rank still running then fails it.
    """
    deadline = time.monotonic() + timeout_s
    for attempt in range(RENDEZVOUS_ATTEMPTS):
        run_dir = (store_dir if attempt == 0
                   else os.path.join(store_dir, 'retry-%d' % attempt))
        try:
            return _launch(fn, world_size, run_dir, args, kwargs, backend,
                           timeout_s, deadline)
        except _RendezvousFailed as exc:
            if attempt == RENDEZVOUS_ATTEMPTS - 1:
                raise RuntimeError(str(exc)) from None


def _launch(fn, world_size, store_dir, args, kwargs, backend, timeout_s,
            deadline):
    """One launch of the ranks over the store at ``store_dir``."""
    os.makedirs(store_dir, exist_ok=True)
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_rank_main, name='rank-%d' % rank,
                         args=(fn, rank, world_size, store_dir, backend,
                               tuple(args), dict(kwargs or {})))
             for rank in range(world_size)]
    try:
        for p in procs:
            p.start()
        while True:
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                rank = failed[0]
                in_rendezvous = os.path.exists(os.path.join(
                    store_dir, 'rank-%d.rendezvous' % rank))
                raise (_RendezvousFailed if in_rendezvous else RuntimeError)(
                    'rank %d of %d failed (exit code %s):\n%s'
                    % (rank, world_size, procs[rank].exitcode,
                       _error_text(store_dir, rank)))
            if all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                late = [r for r, p in enumerate(procs) if p.exitcode is None]
                raise RuntimeError('rank %d of %d overran the time limit of '
                                   '%.0f s (still running: ranks %s)'
                                   % (late[0], world_size, timeout_s, late))
            time.sleep(_POLL_S)
        results = []
        for rank in range(world_size):
            with open(os.path.join(store_dir, 'rank-%d.pkl' % rank),
                      'rb') as f:
                results.append(pickle.load(f))
        return results
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join()


def _error_text(store_dir, rank):
    path = os.path.join(store_dir, 'rank-%d.err' % rank)
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return '(no traceback: the rank died)'
