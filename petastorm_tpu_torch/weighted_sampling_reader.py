"""Mixes several readers with given sampling probabilities.

The port's copy of ``petastorm_tpu/weighted_sampling_reader.py``: the
cumulative-probability draw of each ``next()`` from a seedable generator
(``normalize_cumulative`` :15, ``draw_index`` :31), and the schema,
``batched_output`` and NGram checks of :class:`WeightedSamplingReader`
(:37), in JAX's words. The indexed mixture
(:mod:`petastorm_tpu_torch.indexed_mixture`) draws through the same two
functions.

An NGram reader's ``next()`` gives its windows one by one, as JAX's
does, so the mixture mixes windows as JAX's does. The mixture itself is a
window stream (``ngram_chunked`` False), which
:class:`~petastorm_tpu_torch.torch_utils.TorchDataLoader` batches window
by window.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def normalize_cumulative(probabilities) -> np.ndarray:
    """Validated, normalized cumulative probability edges."""
    probabilities = list(probabilities)
    if not probabilities:
        raise ValueError('At least one probability is required')
    if any(p < 0 for p in probabilities):
        raise ValueError('probabilities must be non-negative, got {!r}'
                         .format(probabilities))
    total = float(sum(probabilities))
    if total <= 0:
        raise ValueError('probabilities must sum to a positive value')
    return np.cumsum([p / total for p in probabilities])


def draw_index(cumulative: np.ndarray, unit_sample: float) -> int:
    """Map one uniform [0, 1) draw onto the cumulative edges."""
    idx = int(np.searchsorted(cumulative, unit_sample, side='right'))
    return min(idx, len(cumulative) - 1)


class WeightedSamplingReader:
    """On every ``next()``, picks reader ``i`` with probability
    ``probabilities[i]``.

    Iteration stops when any underlying reader is exhausted (the reference
    semantics).
    """

    def __init__(self, readers: List, probabilities: List[float],
                 seed: Optional[int] = None):
        if len(readers) != len(probabilities):
            raise ValueError('readers and probabilities must have equal '
                             'length')
        if not readers:
            raise ValueError('At least one reader is required')
        self._readers = readers
        self._cumulative = normalize_cumulative(probabilities)
        self._rng = np.random.default_rng(seed)

        first = readers[0]
        for other in readers[1:]:
            if set(other.schema.fields.keys()) != set(
                    first.schema.fields.keys()):
                raise ValueError('All readers must share the same schema '
                                 'fields')
            if other.batched_output != first.batched_output:
                raise ValueError('All readers must have the same '
                                 'batched_output mode')
            if (getattr(other, 'ngram', None) is None) != (
                    getattr(first, 'ngram', None) is None):
                raise ValueError('Cannot mix ngram and non-ngram readers')
        self.schema = first.schema
        self.batched_output = first.batched_output
        self.ngram = getattr(first, 'ngram', None)
        #: the mixture yields windows one by one, never chunks
        self.ngram_chunked = False
        self.last_row_consumed = False

    def __iter__(self):
        return self

    def __next__(self):
        choice = draw_index(self._cumulative, self._rng.random())
        try:
            return next(self._readers[choice])
        except StopIteration:
            self.last_row_consumed = True
            raise

    def next(self):
        return self.__next__()

    def stop(self):
        for r in self._readers:
            r.stop()

    def join(self):
        for r in self._readers:
            r.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()
