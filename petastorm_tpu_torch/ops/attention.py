"""Attention ops of the port: the blockwise plain path, the flash forward and
backward, and ``flash_attention`` as a ``torch.autograd.Function``.

Counterpart of ``petastorm_tpu/ops/attention.py``. Shapes follow the JAX
package: q ``(..., Lq, D)``, k/v ``(..., Lk, D)``; grouped-query attention
when k/v carry fewer heads on axis -3; ``segment_ids`` ``(..., Lq)``
broadcastable over the batch/head axes (``kv_segment_ids`` defaults to
them); ``window`` is a causal look-back of that many positions.

Dispatch rule: tensors on a CUDA device go to the hand-written kernels of
:mod:`petastorm_tpu_torch.ops.kernels`; tensors on the CPU go to their plain
PyTorch twins. The model hands attention ``(B, H, L, dh)`` tensors made by
``transpose``; :class:`_FlashDims` flattens them with ``reshape``, which
copies them into the contiguous ``(B*H, L, dh)`` layout the kernels take.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from petastorm_tpu_torch.ops import kernels


def _check_window(window, causal: bool) -> None:
    """Sliding windows look back (Mistral-style): they need causal masking."""
    if window is None:
        return
    if not causal:
        raise ValueError('window requires causal=True (sliding-window '
                         'attention looks back, not around)')
    if window < 1:
        raise ValueError('window must be >= 1, got %r' % (window,))


class _FlashDims:
    """Shape policy shared by the forward and backward: validates the q/kv
    batch dims (equal, or differing only in the head axis -3 with q heads a
    multiple of kv heads), flattens operands to the kernels' ``(rows, L, D)``
    and segment ids to ``(rows, L)`` int32, and sums per-q-head kv
    gradients per head group. The reference's zero-padding to block
    multiples is gone: the kernels mask the ragged edge themselves."""

    def __init__(self, q_shape, kv_shape):
        *batch, q_len, head_dim = q_shape
        *kv_batch, kv_len, kv_head_dim = kv_shape
        self.batch, self.kv_batch = tuple(batch), tuple(kv_batch)
        if self.batch != self.kv_batch and (
                kv_head_dim != head_dim
                or len(self.batch) != len(self.kv_batch)
                or not self.batch
                or self.batch[:-1] != self.kv_batch[:-1]
                or self.kv_batch[-1] <= 0
                or self.batch[-1] % self.kv_batch[-1] != 0):
            raise ValueError(
                'q/kv batch dims must match, or differ only in the head '
                'axis (-3) with q heads a multiple of kv heads (GQA); '
                'got q %r vs kv %r' % (tuple(q_shape), tuple(kv_shape)))
        if kv_head_dim != head_dim:
            raise ValueError('q and kv head dims differ: %d vs %d'
                             % (head_dim, kv_head_dim))
        self.n_heads = self.batch[-1] if self.batch else 1
        self.n_kv_heads = self.kv_batch[-1] if self.kv_batch else 1
        self.group = self.n_heads // self.n_kv_heads
        self.q_len, self.kv_len, self.head_dim = q_len, kv_len, head_dim
        self.flat = math.prod(self.batch)
        self.kv_flat = math.prod(self.kv_batch)

    def flat_q(self, x):
        return x.reshape(self.flat, self.q_len, self.head_dim).contiguous()

    def flat_kv(self, x):
        return x.reshape(self.kv_flat, self.kv_len,
                         self.head_dim).contiguous()

    def unflat_q(self, x):
        return x.reshape(self.batch + (self.q_len, self.head_dim))

    def unflat_kv(self, x):
        return x.reshape(self.kv_batch + (self.kv_len, self.head_dim))

    def _seg(self, seg, batch, length, rows, name, device):
        seg = torch.as_tensor(seg, device=device)
        if seg.device.type == 'cpu' and bool((seg < 0).any()):
            # checked for host tensors only: a device check would sync
            raise ValueError('%s must be non-negative' % name)
        if seg.shape[-1] != length or seg.ndim > len(batch) + 1:
            raise ValueError('%s must have shape (..., %d) broadcastable '
                             'over the attention operands; got %r'
                             % (name, length, tuple(seg.shape)))
        while seg.ndim < len(batch) + 1:
            seg = seg.unsqueeze(-2)
        seg = seg.expand(batch + (length,))
        return seg.reshape(rows, length).to(torch.int32).contiguous()

    def segments(self, segment_ids, kv_segment_ids, device):
        """``(seg_q, seg_kv)`` flattened, or ``(None, None)``."""
        if segment_ids is None:
            if kv_segment_ids is not None:
                raise ValueError('kv_segment_ids requires segment_ids '
                                 '(kv-only masking has no q-side ids)')
            return None, None
        kv = segment_ids if kv_segment_ids is None else kv_segment_ids
        return (self._seg(segment_ids, self.batch, self.q_len, self.flat,
                          'segment_ids', device),
                self._seg(kv, self.kv_batch, self.kv_len, self.kv_flat,
                          'kv_segment_ids', device))

    def sum_head_groups(self, x, dtype):
        """Per-q-head kv gradients ``(flat, L, D)`` → per-kv-head, summed in
        float32 before the cast to the storage dtype."""
        if self.group == 1:
            return x.to(dtype)
        b = self.flat // self.n_heads
        return x.reshape(b, self.n_kv_heads, self.group, self.kv_len,
                         self.head_dim).sum(2).reshape(
                             self.kv_flat, self.kv_len,
                             self.head_dim).to(dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, block_k: int = 512,
                        segment_ids=None, kv_segment_ids=None, window=None):
    """Memory-efficient attention in plain PyTorch: online softmax over kv
    blocks of ``block_k``; differentiable by autograd on any device. Shapes
    as :func:`flash_attention` but without GQA (repeat kv heads first)."""
    _check_window(window, causal)
    dims = _FlashDims(q.shape, k.shape)
    if dims.group != 1:
        raise ValueError('blockwise_attention takes equal q/kv heads; '
                         'repeat kv heads first')
    seg_q, seg_kv = dims.segments(segment_ids, kv_segment_ids, q.device)
    o, _ = kernels.flash_fwd_plain(
        dims.flat_q(q), dims.flat_kv(k), dims.flat_kv(v),
        n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads, causal=causal,
        window=window, seg_q=seg_q, seg_kv=seg_kv, block_k=block_k)
    return dims.unflat_q(o)


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             segment_ids=None, kv_segment_ids=None,
                             window=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward ``(o, lse)`` (the ring-attention building block of the
    reference): o in q's dtype ``(..., Lq, D)``, lse float32 ``(..., Lq)``
    (``-1e30`` on fully masked rows, where o is 0). Kernel K1 on CUDA
    tensors, its plain twin on CPU tensors. Not differentiable."""
    _check_window(window, causal)
    dims = _FlashDims(q.shape, k.shape)
    seg_q, seg_kv = dims.segments(segment_ids, kv_segment_ids, q.device)
    o, lse = kernels.flash_fwd(
        dims.flat_q(q), dims.flat_kv(k), dims.flat_kv(v),
        n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads, causal=causal,
        window=window, seg_q=seg_q, seg_kv=seg_kv)
    return dims.unflat_q(o), lse.reshape(dims.batch + (dims.q_len,))


def _backward_flat(dims, q, k, v, o, lse, do, seg_q, seg_kv, causal, window):
    delta = (do.float() * o.float()).sum(-1)   # Δ = rowsum(do·o), as :762
    kw = dict(n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads,
              causal=causal, window=window, seg_q=seg_q, seg_kv=seg_kv)
    dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = kernels.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    return (dq, dims.sum_head_groups(dk, k.dtype),
            dims.sum_head_groups(dv, v.dtype))


def flash_backward(q, k, v, o, lse, do, *, causal: bool = True,
                   segment_ids=None, kv_segment_ids=None, window=None):
    """``(dq, dk, dv)`` in the input dtypes from the forward's o and lse:
    kernels K2 (dq) and K3 (dk/dv) on CUDA tensors, their plain twins on
    CPU tensors."""
    _check_window(window, causal)
    dims = _FlashDims(q.shape, k.shape)
    seg_q, seg_kv = dims.segments(segment_ids, kv_segment_ids, q.device)
    dq, dk, dv = _backward_flat(
        dims, dims.flat_q(q), dims.flat_kv(k), dims.flat_kv(v),
        dims.flat_q(o), lse.reshape(dims.flat, dims.q_len).float()
        .contiguous(), dims.flat_q(do.to(q.dtype)), seg_q, seg_kv, causal,
        window)
    return dims.unflat_q(dq), dims.unflat_kv(dk), dims.unflat_kv(dv)


class _FlashFunction(torch.autograd.Function):
    """Flash attention over flattened contiguous operands: K1 forward, K2 +
    K3 backward (plain twins on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, dims, seg_q, seg_kv, causal, window):
        o, lse = kernels.flash_fwd(
            q, k, v, n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads,
            causal=causal, window=window, seg_q=seg_q, seg_kv=seg_kv)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.dims, ctx.segs, ctx.causal, ctx.window = (dims, (seg_q, seg_kv),
                                                      causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward_flat(ctx.dims, q, k, v, o, lse,
                                    do.to(q.dtype).contiguous(), *ctx.segs,
                                    ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, segment_ids=None,
                    kv_segment_ids=None, window: Optional[int] = None):
    """Fused attention over ``(..., L, D)`` inputs, differentiable, any
    sequence length, GQA read through the head map (repeated kv is never
    materialized), packed sequences through ``segment_ids``. The forward
    runs kernel K1 and the backward K2 and K3 on CUDA tensors; CPU tensors
    take the plain twins (the JAX package's ``backend='jnp'`` role)."""
    _check_window(window, causal)
    dims = _FlashDims(q.shape, k.shape)
    seg_q, seg_kv = dims.segments(segment_ids, kv_segment_ids, q.device)
    o = _FlashFunction.apply(dims.flat_q(q), dims.flat_kv(k),
                             dims.flat_kv(v), dims, seg_q, seg_kv, causal,
                             window)
    return dims.unflat_q(o)
