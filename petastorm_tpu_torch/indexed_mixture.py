"""Deterministic weighted mixture of indexed loaders with O(1) exact resume.

The port's copy of ``petastorm_tpu/indexed_mixture.py``. The whole mixed
stream is a pure function of ``(sources, probabilities, seed, step)``:

- the source drawn at step ``k`` is ``choice(seed, k)``, a draw keyed by
  ``np.random.default_rng((seed, k))`` (seeded as JAX seeds it),
  independent of what was consumed before;
- each source is an indexed loader
  (:class:`~petastorm_tpu_torch.indexed.IndexedBatchLoader` or
  :class:`~petastorm_tpu_torch.indexed_ngram.IndexedNGramLoader`) whose
  own stream is a pure function of its cursor;
- so ``state_dict()`` is ``{'step': k, 'sources': [cursors]}``, and a
  restored mixture gives the rest of the stream byte for byte, with any
  worker counts.

The stream ends when the drawn source is exhausted (the reference
mixture's semantics).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from petastorm_tpu_torch.weighted_sampling_reader import (draw_index,
                                                          normalize_cumulative)


class WeightedIndexedMixture:
    """Mix the batch streams of several indexed loaders by probability.

    :param loaders: indexed loaders. They need not share a schema (the
        caller mixes what it can consume), but each pick yields one batch.
    :param probabilities: the loaders' sampling weights (normalized).
    :param seed: the mixture's OWN seed; the draw at step ``k`` depends only
        on ``(seed, k)``, so the choice sequence survives a resume without
        being recorded.
    """

    def __init__(self, loaders: Sequence, probabilities: Sequence[float],
                 seed: int = 0):
        if len(loaders) != len(probabilities):
            raise ValueError('loaders and probabilities must have equal length')
        if not loaders:
            raise ValueError('At least one loader is required')
        for loader in loaders:
            # the cursor pair and the iteration surface this class drives
            # (a replay checkpoint that grew all four would still be wrong
            # here, which no structural check can see)
            missing = [attr for attr in ('state_dict', 'load_state_dict',
                                         '__iter__', 'close')
                       if not hasattr(loader, attr)]
            if missing:
                raise ValueError(
                    'WeightedIndexedMixture needs indexed-family loaders '
                    '(cursor state_dict/load_state_dict + __iter__/close); '
                    '{!r} lacks {}. Use WeightedSamplingReader for '
                    'streaming readers.'.format(type(loader).__name__,
                                                missing))
        self._loaders = list(loaders)
        self._cumulative = normalize_cumulative(probabilities)
        self.seed = seed
        self.step = 0

    # -- deterministic addressing ---------------------------------------------

    def _choice(self, step: int) -> int:
        """The source drawn at global step ``step``: a pure function of
        (seed, step), not of what was consumed."""
        return draw_index(self._cumulative,
                          np.random.default_rng((self.seed, step)).random())

    # -- checkpoint state ------------------------------------------------------

    def state_dict(self) -> Dict:
        """O(1): the mixture's step and each source's own cursor."""
        return {'step': self.step,
                'sources': [ld.state_dict() for ld in self._loaders],
                'version': 1}

    def load_state_dict(self, state: Dict) -> None:
        if state.get('version', 1) != 1:
            raise ValueError('Unknown state version {}'.format(
                state.get('version')))
        if len(state['sources']) != len(self._loaders):
            raise ValueError('state has {} sources, mixture has {}'.format(
                len(state['sources']), len(self._loaders)))
        self.step = int(state['step'])
        for loader, sub in zip(self._loaders, state['sources']):
            loader.load_state_dict(sub)

    # -- iteration -------------------------------------------------------------

    def __iter__(self):
        iterators: List[Optional[object]] = [None] * len(self._loaders)
        try:
            while True:
                pick = self._choice(self.step)
                if iterators[pick] is None:
                    iterators[pick] = iter(self._loaders[pick])
                batch = next(iterators[pick], None)
                if batch is None:
                    return          # the drawn source is exhausted
                self.step += 1
                yield batch
        finally:
            first_error = None
            for it in iterators:
                if it is None:
                    continue
                try:
                    it.close()
                except Exception as e:  # noqa: BLE001 - close the others first
                    # one source's failing teardown must not leak the other
                    # sources' pools and handles
                    if first_error is None:
                        first_error = e
            if first_error is not None:
                raise first_error

    def close(self):
        for loader in self._loaders:
            loader.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
