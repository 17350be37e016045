"""Ring attention: exact attention over a sequence split across ranks.

The port's counterpart of ``petastorm_tpu/parallel/ring.py``. Each rank
of a sequence group holds one chunk of q, k and v, the global sequence
being the chunks in group rank order. The k/v chunks rotate around the
group (:func:`~petastorm_tpu_torch.parallel.mesh.ring_shift`) while every
rank folds each visiting chunk into its float32 accumulators.

The kernel path (``impl='kernel'``) is a ``torch.autograd.Function``, the
counterpart of JAX's ``_ring_flash`` custom VJP (``ring.py:125-275``):

- forward: n steps; each runs K1 on the visiting kv chunk (non-causal for
  an earlier chunk, causal on the diagonal, skipped for a later one: the
  chunks are aligned to global positions, so causality is one of three
  whole-chunk cases), merges its ``(o, lse)`` into the accumulators
  (:func:`~petastorm_tpu_torch.ops.attention.merge_attention_chunks`), and
  rotates k and v on to the next rank. It returns o and keeps the global
  lse for the backward.
- backward: dq accumulates locally; k, v and their float32 gradient
  accumulators rotate a full cycle together, each rank adding the chunk
  pair's K2 and K3 gradients, recomputed from the global lse (``p = exp(s
  - lse)`` is already the global softmax), so dk and dv arrive home with
  every rank's contribution after n steps.

GQA flows through the kernels' head map: only the kv heads rotate.
``impl='plain'`` runs the same ring on the kernels' plain twins in float32
(JAX's ``'jnp'`` and ``'interpret'`` names are aliases of it, ``'pallas'``
of ``'kernel'``). Tensors on the CPU reach the twins either way.

Nothing here imports torch when the module is imported.
"""

from __future__ import annotations

_ALIASES = {'pallas': 'kernel', 'jnp': 'plain', 'interpret': 'plain'}

#: The chunk pair a rank computes: 0 = the kv chunk lies wholly before its
#: queries, 1 = the diagonal (causal inside the chunk), 2 = wholly after
#: (masked: skipped).
FULL, DIAGONAL, MASKED = 0, 1, 2


def chunk_case(src_idx: int, my_idx: int) -> int:
    """JAX's ``_chunk_case`` for one (kv chunk, query chunk) pair."""
    if src_idx == my_idx:
        return DIAGONAL
    return FULL if src_idx < my_idx else MASKED


def resolve_ring_impl(impl=None, mesh=None, device_type=None) -> str:
    """``'kernel'`` or ``'plain'``: an explicit ``impl`` wins (JAX's names
    read as aliases); otherwise ``'kernel'`` exactly when the mesh's (or
    ``device_type``'s) devices are CUDA devices."""
    if impl is not None:
        resolved = _ALIASES.get(impl, impl)
        if resolved not in ('kernel', 'plain'):
            raise ValueError("impl must be 'pallas', 'jnp' or 'interpret' "
                             "(or the port's 'kernel', 'plain'), got %r"
                             % (impl,))
        return resolved
    if mesh is not None:
        device_type = mesh.device_type
    return 'kernel' if device_type == 'cuda' else 'plain'


def _resolve_group(group_or_axis):
    """A process group from a group, a ``(mesh, axis)`` pair, or None (the
    default group)."""
    if isinstance(group_or_axis, tuple):
        mesh, axis = group_or_axis
        return mesh.get_group(axis)
    return group_or_axis


def ring_attention(q, k, v, group_or_axis=None, *, causal: bool = True,
                   impl=None):
    """Exact (optionally causal) attention over a ring-split sequence.

    :param q, k, v: this rank's chunks ``(..., L_local, D)``; k/v may carry
        fewer heads on axis -3 (GQA).
    :param group_or_axis: the sequence group: a process group, a ``(mesh,
        axis_name)`` pair, or None for the default group.
    :param causal: mask by global token positions.
    :param impl: ``'kernel'`` (K1-K3 per chunk pair) or ``'plain'`` (their
        twins in float32); by default ``'kernel'`` for CUDA tensors.
    :returns: this rank's output chunk ``(..., L_local, D)`` in q's dtype,
        differentiable in q, k and v.
    """
    from petastorm_tpu_torch.ops.attention import _FlashDims
    impl = resolve_ring_impl(impl, device_type=q.device.type)
    dims = _FlashDims(q.shape, k.shape)       # JAX's head-ratio words
    if k.shape != v.shape:
        raise ValueError('k and v shapes differ: %r vs %r'
                         % (tuple(k.shape), tuple(v.shape)))
    group = _resolve_group(group_or_axis)
    return _ring_function().apply(q, k, v, dims, group, bool(causal),
                                  impl == 'plain')


def make_ring_attention(mesh, seq_axis: str = 'seq', causal: bool = True,
                        impl=None):
    """``fn(q, k, v)`` running :func:`ring_attention` over ``mesh``'s
    ``seq_axis`` group on this rank's chunks ``(batch_local, heads,
    L_local, D)`` (the batch split over ``data`` when the mesh has it).
    ``impl`` defaults to the mesh's device type's."""
    impl = resolve_ring_impl(impl, mesh)

    def fn(q, k, v):
        return ring_attention(q, k, v, (mesh, seq_axis), causal=causal,
                              impl=impl)

    return fn


def _ring_forward(dims, qf, kf, vf, group, causal, plain):
    """The forward ring on flattened operands: ``(o, lse)`` flat, o in
    q's dtype, lse the global float32 logsumexp."""
    import torch.distributed as dist

    from petastorm_tpu_torch.ops.attention import (_chunk_forward,
                                                   attention_accumulators,
                                                   finalize_attention,
                                                   merge_attention_chunks,
                                                   merged_lse)
    from petastorm_tpu_torch.parallel.mesh import ring_shift
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    me = dist.get_rank(group) if dist.is_initialized() else 0
    o_acc, m, l = attention_accumulators(dims.q_len, dims.head_dim,
                                         (dims.flat,), qf.device)
    k_cur, v_cur = kf, vf
    for step in range(n):
        case = chunk_case((me - step) % n, me) if causal else FULL
        if case != MASKED:
            o_i, lse_i = _chunk_forward(dims, qf, k_cur, v_cur,
                                        causal=case == DIAGONAL, plain=plain)
            o_acc, m, l = merge_attention_chunks(o_acc, m, l, o_i, lse_i)
        if step < n - 1:
            k_cur, v_cur = ring_shift((k_cur, v_cur), group)
    return finalize_attention(o_acc, l).to(qf.dtype), merged_lse(m, l)


def _ring_backward(dims, prep, kf, vf, group, causal, plain):
    """The backward ring: flat float32 ``(dq, dk, dv)``."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.ops.attention import \
        _flash_backward_from_prepared
    from petastorm_tpu_torch.parallel.mesh import ring_shift
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    me = dist.get_rank(group) if dist.is_initialized() else 0
    dq = torch.zeros(prep[0].shape, dtype=torch.float32,
                     device=prep[0].device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
    dv = torch.zeros_like(dk)
    k_cur, v_cur = kf, vf
    for step in range(n):
        case = chunk_case((me - step) % n, me) if causal else FULL
        if case != MASKED:
            dq_p, dk_p, dv_p = _flash_backward_from_prepared(
                dims, prep, k_cur, v_cur, causal=case == DIAGONAL,
                plain=plain, kv_grad_dtype=torch.float32)
            dq += dq_p.float()
            dk += dk_p
            dv += dv_p
        # the chunk and its gradient move on together; after n shifts
        # both are home (the chunk itself need not make the last move)
        if step < n - 1:
            k_cur, v_cur, dk, dv = ring_shift((k_cur, v_cur, dk, dv), group)
        elif n > 1:
            dk, dv = ring_shift((dk, dv), group)
    return dq, dk, dv


_FUNCTION = None


def _ring_function():
    """The ring's ``torch.autograd.Function``, made on first use (torch is
    imported then, not when this module is)."""
    global _FUNCTION
    if _FUNCTION is not None:
        return _FUNCTION
    import torch

    from petastorm_tpu_torch.ops.attention import _prepare_flash_bwd_q_side

    class _RingAttention(torch.autograd.Function):

        @staticmethod
        def forward(ctx, q, k, v, dims, group, causal, plain):
            work = torch.float32 if plain else q.dtype
            qf, kf, vf = (dims.flat_q(q.to(work)), dims.flat_kv(k.to(work)),
                          dims.flat_kv(v.to(work)))
            o, lse = _ring_forward(dims, qf, kf, vf, group, causal, plain)
            ctx.save_for_backward(qf, kf, vf, o, lse)
            ctx.dims, ctx.group, ctx.causal, ctx.plain = (dims, group,
                                                          causal, plain)
            ctx.dtypes = (q.dtype, k.dtype, v.dtype)
            return dims.unflat_q(o).to(q.dtype)

        @staticmethod
        def backward(ctx, do):
            qf, kf, vf, o, lse = ctx.saved_tensors
            dims = ctx.dims
            prep = _prepare_flash_bwd_q_side(dims, qf, o, lse,
                                             do.to(qf.dtype))
            dq, dk, dv = _ring_backward(dims, prep, kf, vf, ctx.group,
                                        ctx.causal, ctx.plain)
            qd, kd, vd = ctx.dtypes
            return (dims.unflat_q(dq).to(qd), dims.unflat_kv(dk).to(kd),
                    dims.unflat_kv(dv).to(vd), None, None, None, None)

    _FUNCTION = _RingAttention
    return _FUNCTION


def ring_lse(q, k, v, group_or_axis=None, *, causal: bool = True,
             impl=None):
    """The forward ring's ``(o, lse)`` with no autograd: o in q's dtype,
    lse the global float32 logsumexp ``(..., L_local)``. For checks."""
    import torch

    from petastorm_tpu_torch.ops.attention import _FlashDims
    plain = resolve_ring_impl(impl, device_type=q.device.type) == 'plain'
    dims = _FlashDims(q.shape, k.shape)
    work = torch.float32 if plain else q.dtype
    with torch.no_grad():
        o, lse = _ring_forward(dims, dims.flat_q(q.to(work)),
                               dims.flat_kv(k.to(work)),
                               dims.flat_kv(v.to(work)),
                               _resolve_group(group_or_axis), causal, plain)
    return (dims.unflat_q(o).to(q.dtype),
            lse.reshape(dims.batch + (dims.q_len,)))
