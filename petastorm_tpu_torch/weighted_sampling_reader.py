"""Mixes several readers with given sampling probabilities.

The port's copy of ``petastorm_tpu/weighted_sampling_reader.py``: the
cumulative-probability draw of each ``next()`` from a seedable generator
(``normalize_cumulative`` :15, ``draw_index`` :31), and the schema,
``batched_output`` and NGram checks of :class:`WeightedSamplingReader`
(:37), in JAX's words. The indexed mixture
(:mod:`petastorm_tpu_torch.indexed_mixture`) draws through the same two
functions.

The port's NGram reader yields window chunks where it can
(``ngram_chunked``); the mixture takes such a reader's windows out of its
chunks one by one, last first, as the JAX reader pops them, so it mixes
windows as JAX's does. The mixture itself is a window stream
(``ngram_chunked`` False), which :class:`~petastorm_tpu_torch.torch_utils.
TorchDataLoader` batches window by window.
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


def _chunk_windows(reader):
    """The windows of a chunked NGram reader as ``{offset: namedtuple}``,
    each chunk's last first."""
    ngram, schema = reader.ngram, reader.schema
    offsets, base, fields_at = ngram.timestep_layout(schema.fields)
    for chunk in reader.iter_ngram_chunks():
        for start in chunk.starts[::-1]:
            yield ngram.make_namedtuples(
                {off: {name: chunk.columns[name][start + off - base]
                       for name in fields_at[off]} for off in offsets},
                schema)


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
        self._streams = [_chunk_windows(r)
                         if getattr(r, 'ngram_chunked', False) else r
                         for r in readers]

    def __iter__(self):
        return self

    def __next__(self):
        choice = draw_index(self._cumulative, self._rng.random())
        try:
            return next(self._streams[choice])
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
