"""Host-side document packing: variable-length token sequences → fixed-width
``(tokens, segment_ids, positions)`` batches for packed-attention training.

The port's copy of ``petastorm_tpu/packing.py`` (``PackedBatch`` :24,
``pack_documents`` :33-87, ``packed_lm_targets`` :90-101). Several documents
share one row; the flash kernels' ``segment_ids`` mask attention across
documents, and positions restart per document so rotary embeddings see each
document at offset 0. Packing wastes only the tail of each row, where
padding every document to the row width wastes ``(width - len)`` of each.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from petastorm_tpu_torch.device import resolve_device


class PackedBatch(NamedTuple):
    """``tokens`` (B, L); ``segment_ids`` (B, L) int32, 0 marking padding and
    documents counted from 1 in each row; ``positions`` (B, L) int32,
    restarting at 0 on every document boundary."""
    tokens: torch.Tensor
    segment_ids: torch.Tensor
    positions: torch.Tensor


def pack_documents(docs: Sequence[Sequence[int]], seq_len: int, *,
                   pad_token: int = 0, dtype=np.int32,
                   num_rows: Optional[int] = None,
                   device=None) -> PackedBatch:
    """Greedy first-fit packing: documents in order, each placed into the
    first row with room (deterministic, so a resumed pipeline packs the same
    batches). Every document must fit a row (``len(doc) <= seq_len``).

    ``num_rows`` pins the batch dimension: the output is padded with
    all-padding rows up to ``num_rows``, and packing raises if the documents
    need more. Without it the row count follows the data. ``docs`` are
    sequences, numpy arrays or CPU tensors; the output tensors (``tokens``
    in ``dtype``) are on ``device`` (the CUDA device unless
    ``device='cpu'``)."""
    device = resolve_device(device)
    rows: List[List[Sequence[int]]] = []
    space: List[int] = []
    for doc in docs:
        n = len(doc)
        if n == 0:
            raise ValueError('cannot pack an empty document')
        if n > seq_len:
            raise ValueError('document of length %d exceeds seq_len=%d; '
                             'split it upstream' % (n, seq_len))
        for i, free in enumerate(space):
            if free >= n:
                rows[i].append(doc)
                space[i] -= n
                break
        else:
            rows.append([doc])
            space.append(seq_len - n)

    if num_rows is not None:
        if len(rows) > num_rows:
            raise ValueError(
                'documents need %d rows but num_rows=%d; feed fewer '
                'documents per batch' % (len(rows), num_rows))
        rows.extend([[] for _ in range(num_rows - len(rows))])
    b = len(rows)
    tokens = np.full((b, seq_len), pad_token, dtype=dtype)
    segment_ids = np.zeros((b, seq_len), dtype=np.int32)
    positions = np.zeros((b, seq_len), dtype=np.int32)
    for i, row_docs in enumerate(rows):
        cursor = 0
        for seg, doc in enumerate(row_docs, start=1):
            n = len(doc)
            tokens[i, cursor:cursor + n] = np.asarray(doc, dtype=dtype)
            segment_ids[i, cursor:cursor + n] = seg
            positions[i, cursor:cursor + n] = np.arange(n)
            cursor += n
    return PackedBatch(*(torch.from_numpy(a).to(device)
                         for a in (tokens, segment_ids, positions)))


def packed_lm_targets(tokens, segment_ids):
    """Next-token targets and float32 loss weights of a packed batch:
    weight 1 where the slot and the next one belong to the same (nonzero)
    document, so the last token of each document and all padding get weight
    0 and no document learns to predict its neighbour's first token."""
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    next_seg = torch.cat([segment_ids[:, 1:],
                          torch.zeros_like(segment_ids[:, :1])], 1)
    weights = ((segment_ids > 0) & (segment_ids == next_seg)).float()
    return targets, weights
