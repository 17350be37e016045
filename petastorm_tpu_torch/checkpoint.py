"""Checkpointable iteration state for training loops: the replay fallback.

The port's copy of ``petastorm_tpu/checkpoint.py``.
:class:`CheckpointableLoader` wraps a loader *factory* and tracks
``(epoch, step)``. ``state_dict()`` is a small JSON-able dict that rides
in any model checkpoint; ``load_state_dict()`` then iteration
fast-forwards a freshly built loader to the saved position by reading and
dropping the batches before it.

Exact resume needs a reproducible batch stream: a ``seed`` for the
reader's shuffle and the loader's buffer, and a deterministic results
order (``reader_pool_type='dummy'`` or ``workers_count=1``). Otherwise
epoch boundaries are exact and the position inside an epoch approximate.

For O(1) exact resume with any worker count use
:func:`~petastorm_tpu_torch.indexed.make_indexed_loader`,
:func:`~petastorm_tpu_torch.indexed_ngram.make_indexed_ngram_loader` and
:class:`~petastorm_tpu_torch.indexed_mixture.WeightedIndexedMixture`,
whose cursors restore at once, without replay. This module is for
streaming pipelines that cannot move to them (a live worker-side
predicate over a streaming pool, an endless ``num_epochs=None`` stream).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict

logger = logging.getLogger(__name__)


class CheckpointableLoader(object):
    """Iterate ``loader_factory()`` epochs while tracking a resumable cursor.

    :param loader_factory: zero-argument callable returning a fresh
        single-epoch iterable of batches (e.g. one building ``make_reader``
        + ``TorchDataLoader`` with fixed seeds). A loader is built each
        epoch, so epoch boundaries stay clean after a restore.

    Usage::

        ckpt_loader = CheckpointableLoader(make_loader)
        for batch in ckpt_loader.epochs(num_epochs=10):
            train_step(batch)
            if should_save():
                save(model_state, data_state=ckpt_loader.state_dict())

        # later, in a new process
        ckpt_loader = CheckpointableLoader(make_loader)
        ckpt_loader.load_state_dict(saved['data_state'])
        for batch in ckpt_loader.epochs(num_epochs=10):   # resumes mid-epoch
            ...
    """

    def __init__(self, loader_factory: Callable[[], object]):
        self._factory = loader_factory
        self.epoch = 0
        self.step = 0          # batches yielded in the current epoch
        self._skip = 0         # fast-forward pending after load_state_dict

    # -- state ----------------------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        # a restore that has not started iterating still owes `_skip`
        # batches: a save before it resumes must not move the cursor back
        return {'epoch': self.epoch, 'step': max(self.step, self._skip),
                'version': 1}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        """Restore the cursor. A state that is not a dict, has no or an
        unknown ``version``, or lacks a cursor key raises: a fast-forward
        from garbage would resume training at the wrong place with no
        symptom."""
        if not isinstance(state, dict):
            raise ValueError('checkpoint state must be a dict, got '
                             '{!r}'.format(type(state).__name__))
        if 'version' not in state:
            raise ValueError("checkpoint state has no 'version' key — it "
                             'was not produced by state_dict() (keys: '
                             '{})'.format(sorted(state)))
        if state['version'] != 1:
            raise ValueError('Unknown checkpoint state version {!r} '
                             '(this build reads version 1)'.format(
                                 state['version']))
        missing = [k for k in ('epoch', 'step') if k not in state]
        if missing:
            raise ValueError('checkpoint state is missing key(s) {} '
                             '(keys present: {})'.format(
                                 missing, sorted(state)))
        self.epoch = int(state['epoch'])
        self.step = 0
        self._skip = int(state['step'])

    # -- iteration ------------------------------------------------------------

    def epochs(self, num_epochs: int):
        """Yield the batches of epochs ``[self.epoch, num_epochs)``, skipping
        ``step`` batches into the first epoch after a restore."""
        while self.epoch < num_epochs:
            yield from self._one_epoch()
            self.epoch += 1
            self.step = 0

    def _one_epoch(self):
        loader = self._factory()
        skip = self._skip
        self._skip = 0
        if skip:
            logger.info('Fast-forwarding %d batches into epoch %d', skip,
                        self.epoch)
        self.step = 0   # batch index within the epoch, the skipped included
        try:
            for batch in iter(loader):
                self.step += 1
                if self.step <= skip:
                    continue
                yield batch
            if self.step < skip:
                # the epoch is shorter than the saved cursor (a smaller
                # store, or a stream that is not deterministic): say so
                # rather than yield a truncated next epoch quietly
                logger.warning('Checkpoint cursor %d exceeds epoch length %d',
                               skip, self.step)
        finally:
            # a loader owns its reader's pool: release it each epoch
            for method in ('stop', 'join'):
                fn = getattr(loader, method, None) or getattr(
                    getattr(loader, 'reader', None), method, None)
                if fn is not None:
                    try:
                        fn()
                    except Exception:  # cleanup must not mask the iteration's
                        logger.exception('Loader %s() failed', method)
