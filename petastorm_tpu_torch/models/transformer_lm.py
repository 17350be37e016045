"""Flagship decoder-only transformer LM of the port, on one device or a
mesh.

Counterpart of ``petastorm_tpu/models/transformer_lm.py``
(``TransformerConfig`` :36-80, ``init`` :86-130, ``_rms_norm``/``_rope``
:181-200, ``_attention`` :228-269, ``_dense_ffn`` :272-275, the
mixture-of-experts FFN ``_moe_ffn_dense``/``_moe_router``/``_moe_ffn``
:278-377, ``forward``/``loss_fn`` :393-452, ``make_train_step`` :620-653)
and its KV-cache decode (``init_kv_cache``, ``_attend_cache``,
``_decode_layer``, ``_sample_logits`` and ``generate`` :459-613).
Parameters are a plain dict of float32
tensors with the JAX pytree's structure and layout (see
:mod:`petastorm_tpu_torch.weights`): weights are ``(in, out)`` and applied
as ``x @ w``. Compute runs in ``config.dtype`` (bfloat16 by default) with
explicit ``w.to(x.dtype)`` casts, as the JAX model does, so gradients land
on the float32 parameters; norms, softmax statistics and the loss run in
float32.

``generate`` decodes one token a step for every sequence, prompt included,
through the same single-token path, against per-layer caches that it
writes in place; it attends the cache with plain einsums, as the JAX
decode does (no kernel), and samples with an explicit
``torch.Generator``.

With ``n_experts > 0`` each layer's FFN is a top-k mixture of experts
with sort-based sparse dispatch into per-expert buffers of fixed capacity
(``moe_capacity_factor``) and the Switch load-balancing aux loss, added to
the loss with weight ``moe_aux_weight``. Packed batches pass
``segment_ids``, ``positions`` and ``weights`` (see
:mod:`petastorm_tpu_torch.packing`).

On a mesh (:mod:`petastorm_tpu_torch.parallel`; JAX ``param_specs`` /
``batch_spec`` :137-177, ``_ring_attention_sharded`` :203-225,
``_moe_ffn(mesh=)`` :313-377, ``make_train_step(mesh=)`` :620-653), one
process a device, each rank holding its ``param_specs`` block of every
leaf (:func:`~petastorm_tpu_torch.weights.shard_params`) and its
``(B / data, L / seq)`` tokens:

- ``data`` and ``seq``: the ranks hold different tokens. The default
  positions are the global offsets of the rank's chunk, ``attention='ring'``
  runs ring attention over the ``seq`` group (K1-K3 per chunk pair on the
  card), and the loss is each rank's share of the global mean: the shares
  and the gradients are summed over the data x seq group before AdamW.
- ``model`` (Megatron tensor parallelism): ``wq``/``wk``/``wv`` and
  ``w_gate``/``w_up`` are column-parallel behind :func:`~petastorm_tpu_torch.
  parallel.mesh.pvary`, ``wo`` and ``w_down`` row-parallel closed by a
  :func:`~petastorm_tpu_torch.parallel.mesh.psum`; attention (K1-K3, or the
  ring) runs on the rank's heads. Where the kv heads do not split evenly
  (GQA 4 -> 2 on 4 ranks puts half a head on a rank), k and v are gathered
  over the group and the rank takes the kv heads its q heads read. The
  embedding's ``(B, L, d / model)`` lookup is gathered over the group; the
  unembedding gives the rank's ``(B, L, V / model)`` float32 logits, and
  the cross entropy takes the global max, sum of exponentials and target
  logit over the group: no rank forms the whole vocabulary.
- ``expert``: the mixture of experts routes the global token stream (the
  normed activations gathered over data x seq, token ``b * L + l``), so
  every unit's expert, slot and drop are one process's; a rank runs the
  experts of its block on their capacity rows, with ``d_ff`` split over
  ``model``, and the outputs are summed over expert x model back to each
  rank's tokens. The aux loss is the global one, counted once.
- ``pipe``: the LM's specs name no pipe axis, so its ranks replicate the
  step (:mod:`petastorm_tpu_torch.parallel.pipeline` stages a model).

Ranks that hold the same tokens (model, expert and pipe) compute the same
loss and hold whole gradients of their replicated activations, so no
gradient is ever summed over an axis that splits its leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.ops.attention import (blockwise_attention,
                                               flash_attention)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: Optional[int] = None     # None = n_heads (MHA)
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 2048
    n_experts: int = 0                   # 0: dense FFN; > 0: top-k MoE
    # experts a token consults: 1 = Switch (scaled by the raw top prob),
    # > 1 = GShard (scales normalised over the chosen experts)
    moe_top_k: int = 1
    # per-expert buffer = ceil(tokens * top_k / n_experts * factor); units
    # routed past it are dropped (that choice contributes zero)
    moe_capacity_factor: float = 1.25
    # weight of the load-balancing aux loss (0 disables it); its dispatch
    # fractions count all k choices, as the JAX model's
    moe_aux_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    # 'flash' | 'blockwise' | 'ring' (over a mesh's 'seq' axis)
    attention: str = 'blockwise'
    attention_window: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


def _check_supported(config: TransformerConfig) -> None:
    if config.attention not in ('flash', 'blockwise', 'ring'):
        raise ValueError("attention must be 'flash', 'blockwise' or 'ring', "
                         'got %r' % (config.attention,))
    if config.n_heads % config.kv_heads:
        raise ValueError('n_heads (%d) must be a multiple of n_kv_heads (%d)'
                         % (config.n_heads, config.kv_heads))
    if config.n_experts > 0 and not 1 <= config.moe_top_k <= config.n_experts:
        raise ValueError('moe_top_k (%d) must be in [1, n_experts=%d]'
                         % (config.moe_top_k, config.n_experts))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(config: TransformerConfig,
         generator: Optional[torch.Generator] = None, device=None) -> Dict:
    """float32 parameters drawn with the JAX ``init``'s distributions
    (``normal / sqrt(fan_in)``, embedding scaled by 0.02, norms at one) from
    ``generator``. The numbers differ from ``jax.random``'s; for parity load
    JAX's draw with :func:`petastorm_tpu_torch.weights.params_from_jax`."""
    _check_supported(config)
    device = resolve_device(device)
    c = config
    kv_dim = c.kv_heads * c.head_dim

    def dense(fan_in, *shape):
        w = torch.randn(*shape, generator=generator, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    params = {'embed': dense(1, c.vocab_size, c.d_model) * 0.02,
              'final_norm': ones(c.d_model),
              'unembed': dense(c.d_model, c.d_model, c.vocab_size),
              'layers': []}
    experts = (c.n_experts,) if c.n_experts > 0 else ()
    for _ in range(c.n_layers):
        layer = {
            'ln1': ones(c.d_model),
            'wq': dense(c.d_model, c.d_model, c.d_model),
            'wk': dense(c.d_model, c.d_model, kv_dim),
            'wv': dense(c.d_model, c.d_model, kv_dim),
            'wo': dense(c.d_model, c.d_model, c.d_model),
            'ln2': ones(c.d_model),
            'w_up': dense(c.d_model, *experts, c.d_model, c.d_ff),
            'w_gate': dense(c.d_model, *experts, c.d_model, c.d_ff),
            'w_down': dense(c.d_ff, *experts, c.d_ff, c.d_model),
        }
        if experts:
            layer['gate'] = dense(c.d_model, c.d_model, c.n_experts)
        params['layers'].append(layer)
    return params


def parameters(params: Dict) -> List[torch.Tensor]:
    """The parameter leaves in a fixed order (the optimizer's list)."""
    leaves = [params['embed'], params['final_norm'], params['unembed']]
    for layer in params['layers']:
        leaves.extend(layer[name] for name in sorted(layer))
    return leaves


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def param_specs(config: TransformerConfig, mesh) -> Dict:
    """The JAX ``param_specs`` tree: a spec per leaf of :func:`init`'s
    structure, written as a tuple of axis names or ``None`` per dim, using
    only the axes the mesh has (absent axes replicate)."""
    from petastorm_tpu_torch.parallel.mesh import axis_names
    names = set(axis_names(mesh))
    tp = 'model' if 'model' in names else None
    ep = 'expert' if 'expert' in names else None
    layer = {'ln1': (), 'ln2': (), 'wq': (None, tp), 'wk': (None, tp),
             'wv': (None, tp), 'wo': (tp, None)}
    if config.n_experts > 0:
        layer.update({'gate': (), 'w_up': (ep, None, tp),
                      'w_gate': (ep, None, tp), 'w_down': (ep, tp, None)})
    else:
        layer.update({'w_up': (None, tp), 'w_gate': (None, tp),
                      'w_down': (tp, None)})
    return {'embed': (None, tp), 'final_norm': (),
            'unembed': (None, tp),
            'layers': [dict(layer) for _ in range(config.n_layers)]}


def batch_spec(mesh):
    """The spec of a ``(batch, seq)`` token array: ``data`` and ``seq``
    where the mesh has them."""
    from petastorm_tpu_torch.parallel.mesh import axis_names
    names = set(axis_names(mesh))
    return ('data' if 'data' in names else None,
            'seq' if 'seq' in names else None)


#: Axes whose ranks hold different tokens: losses and gradients sum over
#: them. Ranks differing only on the others hold the same tokens.
_TOKEN_AXES = ('data', 'seq')
#: Axes that split the MoE's experts (their block) and d_ff.
_EXPERT_AXES = ('expert', 'model')


def _axis(mesh, axis: str) -> int:
    from petastorm_tpu_torch.parallel.mesh import axis_size
    return 1 if mesh is None else axis_size(mesh, axis)


def _check_mesh(config: TransformerConfig, mesh) -> None:
    """What ``mesh`` must divide that the specs' shapes do not say: whole
    experts an ``expert`` rank (heads may split anywhere: see
    :func:`_head_plan`)."""
    ep = _axis(mesh, 'expert')
    if config.n_experts > 0 and config.n_experts % ep:
        raise ValueError('n_experts (%d) must be a multiple of the mesh '
                         "'expert' axis (%d)" % (config.n_experts, ep))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _rms_norm(x, scale):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _rope(x, positions):
    """Rotary embedding. x ``(B, H, L, D)``, positions ``(L,)`` or
    ``(B, L)``."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(10000.0) / half))
    angles = positions[..., None].float() * freqs        # (..., L, half)
    angles = angles[None, None] if angles.ndim == 2 else angles[:, None]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _ring_attention_sharded(q, k, v, mesh):
    """Ring attention over the mesh's ``seq`` group on this rank's chunks
    (JAX ``_ring_attention_sharded``): K1-K3 per chunk pair on a CUDA mesh,
    the float32 twins on a CPU mesh."""
    from petastorm_tpu_torch.parallel.ring import (ring_attention,
                                                   resolve_ring_impl)
    return ring_attention(q, k, v, (mesh, 'seq'), causal=True,
                          impl=resolve_ring_impl(None, mesh))


def _head_plan(config: TransformerConfig, mesh):
    """Which heads a rank computes under tensor parallelism. Its ``wo``
    rows are o's columns ``[c0, c0 + cols)``, ``cols = d / model``; they
    touch q heads ``[h0, h1)``. Returns ``(h0, h1, gather_q, gather_kv,
    kv_pick, offset, cols)``: where the columns cut a q head the rank's q
    columns are gathered whole over the group (``gather_q``), and where
    its kv columns are not the kv heads its q heads read (a kv head split
    mid-head, or q gathered) k and v are gathered and ``kv_pick`` (a slice
    where the q heads form whole GQA groups, else one kv head a q head)
    takes them; ``offset`` is the rank's first o column within its
    heads'. On one rank: every head, nothing gathered."""
    from petastorm_tpu_torch.parallel.mesh import axis_index
    h, hkv, dh = config.n_heads, config.kv_heads, config.head_dim
    tp = _axis(mesh, 'model')
    cols = h * dh // tp
    c0 = (axis_index(mesh, 'model') if tp > 1 else 0) * cols
    h0, h1 = c0 // dh, -(-(c0 + cols) // dh)
    gather_q = cols % dh != 0
    gather_kv = gather_q or hkv % tp != 0
    need = [j // (h // hkv) for j in range(h0, h1)]
    nq, n = h1 - h0, need[-1] - need[0] + 1
    if nq % n == 0 and all(kv - need[0] == jl // (nq // n)
                           for jl, kv in enumerate(need)):
        pick = slice(need[0], need[-1] + 1)
    else:
        pick = need
    return h0, h1, gather_q, gather_kv, pick, c0 - h0 * dh, cols


def _attention(x, layer, config: TransformerConfig, positions,
               segment_ids=None, mesh=None):
    """Attention on the rank's tokens and heads. Under a ``seq`` split,
    ``segment_ids`` are the whole sequence's (:func:`forward` gathers
    them)."""
    from petastorm_tpu_torch.parallel.mesh import (all_gather_tiled,
                                                   axis_index, psum, pvary)
    c = config
    b, l, _ = x.shape
    tp = _axis(mesh, 'model')
    h0, h1, gather_q, gather_kv, pick, offset, cols = _head_plan(c, mesh)
    h, hkv, dh = h1 - h0, c.kv_heads, c.head_dim
    x = pvary(x, mesh, 'model')

    def heads(y, n):
        return y.reshape(b, l, n, dh).transpose(1, 2)  # (B, n, L, dh)

    q = x @ layer['wq'].to(x.dtype)
    if gather_q:        # the rank's o columns cut a head: q whole
        q = heads(all_gather_tiled(q, mesh, 'model', dim=-1),
                  c.n_heads)[:, h0:h1]
    else:
        q = heads(q, h)
    q = _rope(q, positions)
    k, v = (x @ layer[w].to(x.dtype) for w in ('wk', 'wv'))
    if gather_kv:       # the rank's kv columns are not its q heads' kv
        k, v = (heads(all_gather_tiled(y, mesh, 'model', dim=-1), hkv)[:, pick]
                for y in (k, v))
        hkv = k.shape[1]
    else:
        hkv //= tp
        k, v = heads(k, hkv), heads(v, hkv)
    k = _rope(k, positions)
    # 'flash'/'blockwise' on a seq-split batch attend the whole sequence,
    # as JAX's do (XLA gathers over seq): gather q, k and v, keep this
    # rank's rows of o
    whole = c.attention != 'ring' and _axis(mesh, 'seq') > 1
    if whole:
        q, k, v = (all_gather_tiled(t, mesh, 'seq', dim=2) for t in (q, k, v))
    if c.attention == 'ring':
        if segment_ids is not None:
            raise ValueError('packed segment_ids are not supported with '
                             "attention='ring' (use 'flash'/'blockwise', or "
                             'shard unpacked sequences)')
        if c.attention_window is not None:
            raise ValueError('attention_window is not supported with '
                             "attention='ring'")
        if mesh is None or 'seq' not in (mesh.mesh_dim_names or ()):
            raise ValueError("attention='ring' needs a mesh with a 'seq' axis")
        o = _ring_attention_sharded(q, k, v, mesh)
    elif c.attention == 'flash':
        o = flash_attention(q, k, v, causal=True, segment_ids=segment_ids,
                            window=c.attention_window)
    else:
        if hkv != h:     # blockwise needs the explicit head repeat
            k = k.repeat_interleave(h // hkv, dim=1)
            v = v.repeat_interleave(h // hkv, dim=1)
        o = blockwise_attention(q, k, v, causal=True,
                                segment_ids=segment_ids,
                                window=c.attention_window)
    if whole:
        o = o.narrow(2, axis_index(mesh, 'seq') * l, l)
    o = o.transpose(1, 2).reshape(b, l, h * dh)
    if gather_q:
        o = o[..., offset:offset + cols]
    return psum(o @ layer['wo'].to(x.dtype), mesh, 'model')


def _dense_ffn(x, layer, mesh=None):
    """The SwiGLU FFN; under tensor parallelism ``w_gate``/``w_up`` are
    the rank's columns and ``w_down`` its rows, summed over the group."""
    from petastorm_tpu_torch.parallel.mesh import psum, pvary
    x = pvary(x, mesh, 'model')
    gate = F.silu(x @ layer['w_gate'].to(x.dtype))
    up = x @ layer['w_up'].to(x.dtype)
    return psum((gate * up) @ layer['w_down'].to(x.dtype), mesh, 'model')


def _moe_router(probs, k: int):
    """``(N, E)`` router probabilities → each token's ``k`` expert choices
    and combine scales ``(N, k)``: the raw top probability for k = 1
    (Switch), normalised over the chosen experts for k > 1 (GShard). Of
    tied probabilities the lower expert index comes first, as in
    ``jax.lax.top_k`` (``torch.topk`` promises no order for ties)."""
    top_idx = torch.argsort(-probs, dim=-1, stable=True)[..., :k]
    top_probs = torch.gather(probs, -1, top_idx)
    if k > 1:
        top_probs = top_probs / top_probs.sum(-1, keepdim=True)
    return top_idx, top_probs


def _moe_ffn_dense(x, layer, config: TransformerConfig):
    """Dense one-hot top-k dispatch: every token through every expert,
    weighted by zeros where not routed. O(E · tokens · d_ff) operations:
    the test oracle of :func:`_moe_ffn`, which it equals whenever no unit
    is dropped."""
    e = config.n_experts
    logits = x.float() @ layer['gate']                       # (B, L, E)
    top_idx, top_probs = _moe_router(torch.softmax(logits, -1),
                                     config.moe_top_k)
    # combine weight per expert: the sum over the choices that picked it
    combine = torch.einsum('blk,blke->ble', top_probs.float(),
                           F.one_hot(top_idx, e).float()).to(x.dtype)
    onehot = (combine != 0).to(x.dtype)
    xe = torch.einsum('bld,ble->ebld', x, onehot)
    gate = F.silu(torch.einsum('ebld,edf->eblf', xe,
                               layer['w_gate'].to(x.dtype)))
    up = torch.einsum('ebld,edf->eblf', xe, layer['w_up'].to(x.dtype))
    down = torch.einsum('eblf,efd->ebld', gate * up,
                        layer['w_down'].to(x.dtype))
    return torch.einsum('ebld,ble->bld', down, combine)


def _gather_tokens(x, mesh):
    """The global ``(B, L, d)`` batch from every data x seq rank's ``(B /
    data, L / seq, d)`` block, in the global order (token ``b * L + l``);
    ``x`` itself without such ranks. The backward sums the gradient over
    the group and keeps this rank's block."""
    from petastorm_tpu_torch.parallel.mesh import (all_gather_tiled,
                                                   axes_group, axis_names)
    if axes_group(mesh, _TOKEN_AXES) is None:
        return x
    b, l, d = x.shape
    # the parts come in mesh axis order, the first axis slowest
    axes = [a for a in axis_names(mesh) if a in _TOKEN_AXES
            and _axis(mesh, a) > 1]
    parts = all_gather_tiled(x[None], mesh, _TOKEN_AXES, dim=0)
    parts = parts.reshape(*(_axis(mesh, a) for a in axes), b, l, d)
    if axes == ['seq', 'data']:
        parts = parts.transpose(0, 1)
    nd, ns = _axis(mesh, 'data'), _axis(mesh, 'seq')
    return parts.reshape(nd, ns, b, l, d).transpose(1, 2).reshape(
        nd * b, ns * l, d)


def _local_tokens(y, mesh):
    """This rank's ``batch_spec`` block of a global ``(B, L, d)``."""
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, axes_group
    if axes_group(mesh, _TOKEN_AXES) is None:
        return y
    return y[NamedSharding(mesh, batch_spec(mesh)).shard_slices(y.shape)]


def _moe_ffn(x, layer, config: TransformerConfig,
             capacity: Optional[int] = None, stats: Optional[Dict] = None,
             mesh=None):
    """Top-k MoE with sort-based sparse dispatch (k = 1 Switch, k > 1
    GShard), as the JAX ``_moe_ffn``: each (token, choice) pair is a unit;
    units are stably sorted by expert, the first ``capacity`` of each
    expert's group scattered into an ``(E · capacity + 1, d)`` buffer whose
    last row is the overflow, run through three batched expert products,
    un-sorted, and summed over each token's k choices weighted by their
    scales, in the compute dtype. The stable sort keeps a group in token
    order, so the earliest tokens win a contended expert. Dropped units all
    write the overflow row, which no expert reads (whichever write lands),
    and read back its zeros: their choices contribute nothing and get zero
    gradient, as in the JAX model. Returns ``(y, aux)``: the Switch
    load-balancing loss ``E · Σ_e frac_e · mean_prob_e`` over all k
    choices. With ``stats`` (a dict), adds the units dropped to
    ``stats['dropped']`` (a tensor, no host sync); where ``stats`` holds a
    list under ``'routes'``, appends each unit's ``expert``, ``slot`` and
    ``kept`` (in unit order) and each token's ``top`` k + 1 probabilities.

    With ``mesh``, ``x`` is this rank's block of tokens: they are gathered
    over data x seq and the whole global stream is routed on every rank,
    the capacity counting its units, so routing equals one process's on
    the global batch. A rank runs only the experts of its ``expert`` block
    (on its ``model`` block of d_ff); the experts' input and the scales
    pass through :func:`~petastorm_tpu_torch.parallel.mesh.pvary` and the
    combined outputs of the rank's tokens are summed over expert x model.
    The aux loss is the global batch's."""
    from petastorm_tpu_torch.parallel.mesh import (axes_group, axis_index,
                                                   psum, pvary)
    xg = _gather_tokens(x, mesh)
    b, l, d = xg.shape
    e, k = config.n_experts, config.moe_top_k
    n = b * l
    n_units = n * k
    xf = xg.reshape(n, d)
    probs = torch.softmax(xf.float() @ layer['gate'], -1)    # (N, E)
    top_idx, top_probs = _moe_router(probs, k)
    unit_expert = top_idx.reshape(n_units)                   # unit u: token u//k
    scale = pvary(top_probs.to(x.dtype), mesh, _EXPERT_AXES)
    if capacity is None:
        capacity = max(1, int(math.ceil(n_units / e
                                        * config.moe_capacity_factor)))
    order = torch.argsort(unit_expert, stable=True)
    sorted_expert = unit_expert[order]
    group_starts = torch.searchsorted(
        sorted_expert, torch.arange(e, device=x.device), side='left')
    pos = torch.arange(n_units, device=x.device) - group_starts[sorted_expert]
    kept = pos < capacity
    # this rank's experts: [e0, e0 + e_l); the others' units, like the
    # dropped ones, write and read the overflow row
    e_l = e // _axis(mesh, 'expert')
    e0 = axis_index(mesh, 'expert') * e_l if mesh is not None else 0
    mine = kept & (sorted_expert >= e0) & (sorted_expert < e0 + e_l)
    dest = torch.where(mine, (sorted_expert - e0) * capacity + pos,
                       torch.full_like(pos, e_l * capacity))
    xin = pvary(xf, mesh, _EXPERT_AXES)
    buf = x.new_zeros(e_l * capacity + 1, d).index_put((dest,),
                                                       xin[order // k])
    expert_in = buf[:-1].reshape(e_l, capacity, d)
    gate = F.silu(torch.bmm(expert_in, layer['w_gate'].to(x.dtype)))
    up = torch.bmm(expert_in, layer['w_up'].to(x.dtype))
    out = torch.bmm(gate * up, layer['w_down'].to(x.dtype))
    flat = torch.cat([out.reshape(e_l * capacity, d), x.new_zeros(1, d)])
    unit_out = x.new_zeros(n_units, d).index_put((order,), flat[dest])
    if axes_group(mesh, _EXPERT_AXES) is None:
        y = torch.einsum('nkd,nk->nd', unit_out.reshape(n, k, d), scale)
    else:
        # the ranks' shares of a token's k choices add in float32 and are
        # rounded once, as one process's einsum rounds its accumulation
        y = torch.einsum('nkd,nk->nd', unit_out.reshape(n, k, d).float(),
                         scale.float())
    y = psum(_local_tokens(y.reshape(b, l, d), mesh), mesh,
             _EXPERT_AXES).to(x.dtype)
    # units an expert got, from the group starts (``bincount`` would wait
    # on the card for the largest index)
    counts = torch.diff(group_starts, append=group_starts.new_full(
        (1,), n_units))
    aux = e * torch.sum(counts.float() / n_units * probs.mean(0))
    if stats is not None:
        stats['dropped'] = stats.get('dropped', 0) + (~kept).sum()
        if isinstance(stats.get('routes'), list):
            slot = torch.empty_like(pos).index_put((order,), pos)
            stats['routes'].append({
                'expert': unit_expert.detach(), 'slot': slot,
                'kept': slot < capacity,
                'top': probs.detach().sort(-1, descending=True).values[
                    :, :min(k + 1, e)]})
    return y, aux


def _segment_positions(segment_ids):
    """Per-document positions 0, 1, 2, ... restarting wherever the (B, L)
    segment id changes."""
    seg = torch.as_tensor(segment_ids)
    idx = torch.arange(seg.shape[-1], device=seg.device)
    boundary = torch.cat([torch.ones_like(seg[..., :1], dtype=torch.bool),
                          seg[..., 1:] != seg[..., :-1]], dim=-1)
    starts = torch.cummax(torch.where(boundary, idx, torch.zeros_like(idx)),
                          dim=-1).values
    return idx - starts


def forward(params, tokens, config: TransformerConfig, positions=None,
            segment_ids=None, return_aux: bool = False,
            moe_stats: Optional[Dict] = None, mesh=None):
    """tokens ``(B, L)`` integer → logits ``(B, L, vocab)`` float32.
    ``segment_ids`` ``(B, L)`` masks attention to same-segment pairs and
    restarts rotary positions per document (unless ``positions`` is
    given). With ``return_aux``, also the MoE load-balancing aux loss summed
    over layers (0 for a dense model). With ``moe_stats`` (a dict), the MoE
    layers add their dropped units to ``moe_stats['dropped']``. With
    ``mesh``, ``tokens`` are this rank's ``(B / data, L / seq)`` shard
    and ``params`` its blocks: the default positions start at the chunk's
    global offset, ``attention='ring'`` attends over the ``seq`` group,
    and the logits are the rank's ``(B / data, L / seq, V / model)`` block
    (:func:`~petastorm_tpu_torch.parallel.mesh.gather_global` with
    ``NamedSharding(mesh, batch_spec(mesh) + ('model',))`` assembles
    them)."""
    c = config
    _check_supported(c)
    tokens = tokens.long()
    chunk = None
    if segment_ids is not None and _axis(mesh, 'seq') > 1:
        # the whole sequence's ids: a document may begin on an earlier
        # rank's chunk, and attention over a split reads them whole
        from petastorm_tpu_torch.parallel.mesh import all_gather, axis_index
        n = segment_ids.shape[-1]
        chunk = slice(axis_index(mesh, 'seq') * n,
                      (axis_index(mesh, 'seq') + 1) * n)
        segment_ids = torch.cat(all_gather(segment_ids.contiguous(),
                                           mesh.get_group('seq')), -1)
    if positions is None:
        if segment_ids is not None:
            positions = _segment_positions(segment_ids)
            if chunk is not None:
                positions = positions[..., chunk]
        else:
            offset = 0
            if mesh is not None:
                from petastorm_tpu_torch.parallel.mesh import axis_index
                offset = axis_index(mesh, 'seq') * tokens.shape[1]
            positions = torch.arange(offset, offset + tokens.shape[1],
                                     device=tokens.device)
    if mesh is not None:
        _check_mesh(c, mesh)
    from petastorm_tpu_torch.parallel.mesh import all_gather_invariant, pvary
    # (B, L, D), the embedding's d_model split over 'model' gathered whole
    x = all_gather_invariant(params['embed'].to(c.dtype)[tokens], mesh,
                             'model', dim=-1)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params['layers']:
        x = x + _attention(_rms_norm(x, layer['ln1']), layer, c, positions,
                           segment_ids, mesh)
        h = _rms_norm(x, layer['ln2'])
        if c.n_experts > 0:
            ffn_out, aux = _moe_ffn(h, layer, c, stats=moe_stats, mesh=mesh)
            x = x + ffn_out
            aux_total = aux_total + aux
        else:
            x = x + _dense_ffn(h, layer, mesh)
    x = pvary(_rms_norm(x, params['final_norm']), mesh, 'model')
    logits = (x @ params['unembed'].to(c.dtype)).float()
    return (logits, aux_total) if return_aux else logits


def _cross_entropy(logits, targets, mesh):
    """Each token's ``-log softmax(logits)[target]`` in float32, flat. With
    a ``model`` axis the logits are this rank's vocabulary block: the max,
    the sum of exponentials and the target's logit are taken over the
    group (:func:`~petastorm_tpu_torch.parallel.mesh.pmax`, ``psum``), so
    no rank holds the whole vocabulary."""
    from petastorm_tpu_torch.parallel.mesh import axis_index, pmax, psum
    logits = logits.reshape(-1, logits.shape[-1])
    targets = targets.reshape(-1).long()
    if _axis(mesh, 'model') == 1:
        return F.cross_entropy(logits, targets, reduction='none')
    v = logits.shape[-1]
    local = targets - axis_index(mesh, 'model') * v
    inside = (local >= 0) & (local < v)
    m = pmax(logits.amax(-1), mesh, 'model')
    sumexp = psum(torch.exp(logits - m[:, None]).sum(-1), mesh, 'model')
    picked = torch.gather(logits, 1, local.clamp(0, v - 1)[:, None])[:, 0]
    target = psum(torch.where(inside, picked, torch.zeros_like(picked)),
                  mesh, 'model')
    return torch.log(sumexp) + m - target


def loss_fn(params, tokens, targets, config: TransformerConfig, *,
            positions=None, segment_ids=None, weights=None,
            moe_stats: Optional[Dict] = None, mesh=None):
    """Next-token cross entropy; with ``weights`` the weighted mean over
    weighted slots (packed batches), plus ``moe_aux_weight`` times the MoE
    aux loss, as the JAX ``loss_fn``. With ``moe_stats`` (a dict), also
    ``moe_stats['aux']`` (the aux loss, detached) and
    ``moe_stats['dropped']`` (units dropped over the layers). With a
    ``mesh``, the loss is this rank's share of the global mean over every
    data x seq rank's tokens: those ranks' shares sum to it (the weights'
    global sum is all-reduced first), the MoE aux counted once among them;
    ranks holding the same tokens (model, expert, pipe) hold the same
    share."""
    logits, aux = forward(params, tokens, config, positions=positions,
                          segment_ids=segment_ids, return_aux=True,
                          moe_stats=moe_stats, mesh=mesh)
    nll = _cross_entropy(logits, targets, mesh)
    from petastorm_tpu_torch.parallel.mesh import (all_reduce_sum_,
                                                   axes_group, group_size)
    group = axes_group(mesh, _TOKEN_AXES)
    ranks = group_size(group)
    if weights is None:
        loss = nll.mean() if group is None else nll.sum() / (nll.numel()
                                                             * ranks)
    else:
        w = weights.reshape(-1).float()
        total = w.sum().detach().clone()
        if group is not None:
            all_reduce_sum_([total], group)
        loss = (nll * w).sum() / torch.clamp(total, min=1.0)
    if moe_stats is not None:
        moe_stats['aux'] = aux.detach()
    if config.n_experts > 0 and config.moe_aux_weight:
        # the global batch's aux, once over the ranks' shares
        loss = loss + config.moe_aux_weight * aux / ranks
    return loss


# ---------------------------------------------------------------------------
# decoding (KV-cache autoregressive generation)
# ---------------------------------------------------------------------------

_NEG_INF_LOGIT = -1e30


def init_kv_cache(config: TransformerConfig, batch_size: int, max_len: int,
                  device=None) -> List[Dict]:
    """Per-layer key and value caches ``(B, kv_heads, max_len, head_dim)``
    of zeros in the compute dtype, on the card unless ``device='cpu'``."""
    c = config
    device = resolve_device(device)
    shape = (batch_size, c.kv_heads, max_len, c.head_dim)
    return [{'k': torch.zeros(shape, dtype=c.dtype, device=device),
             'v': torch.zeros(shape, dtype=c.dtype, device=device)}
            for _ in range(c.n_layers)]


def _attend_cache(q, ck, cv, index: int, window: Optional[int] = None):
    """One token's attention over the cache: q ``(B, H, 1, dh)``, cache
    ``(B, Hkv, max, dh)``; a q head group shares one cache head (GQA).
    Positions after ``index``, and with ``window`` those at ``index -
    window`` or before, are masked. Scores and softmax in float32."""
    b, h, _, dh = q.shape
    hkv = ck.shape[1]
    qg = q.reshape(b, hkv, h // hkv, dh)
    s = torch.einsum('bkgd,bkld->bkgl', qg.float(),
                     ck.float()) / math.sqrt(dh)
    pos = torch.arange(ck.shape[2], device=q.device)
    mask = pos <= index
    if window is not None:
        mask = mask & (index - pos < window)
    s = s.masked_fill(~mask, _NEG_INF_LOGIT)
    o = torch.einsum('bkgl,bkld->bkgd', torch.softmax(s, dim=-1), cv.float())
    return o.reshape(b, h, 1, dh).to(q.dtype)


def _decode_layer(x, layer, config: TransformerConfig, cache, index: int):
    """One layer for one token a sequence (x ``(B, 1, D)``) at position
    ``index``: its key and value are written into ``cache`` in place, then
    the token attends the cache. Returns ``(x, cache)``."""
    c = config
    b = x.shape[0]
    h, hkv, dh = c.n_heads, c.kv_heads, c.head_dim
    positions = torch.arange(index, index + 1, device=x.device)
    hn = _rms_norm(x, layer['ln1'])

    def heads(w, n):
        return (hn @ w.to(hn.dtype)).reshape(b, 1, n, dh).transpose(1, 2)

    q = _rope(heads(layer['wq'], h), positions)
    cache['k'][:, :, index] = _rope(heads(layer['wk'], hkv),
                                    positions)[:, :, 0]
    cache['v'][:, :, index] = heads(layer['wv'], hkv)[:, :, 0]
    att = _attend_cache(q, cache['k'], cache['v'], index,
                        window=c.attention_window)
    x = x + att.transpose(1, 2).reshape(b, 1, h * dh) @ layer['wo'].to(
        x.dtype)
    h2 = _rms_norm(x, layer['ln2'])
    if c.n_experts > 0:
        # capacity = every unit of the step: a step routes only B units (B·L
        # in training), and the training capacity would drop choices that
        # teacher forcing keeps
        return x + _moe_ffn(h2, layer, c, capacity=b * c.moe_top_k)[0], cache
    return x + _dense_ffn(h2, layer), cache


def _sample_logits(logits, temperature: float, top_k, top_p,
                   generator: torch.Generator):
    """One sampling step over ``(B, vocab)`` float32 logits: argmax at
    temperature 0, else a categorical draw (Gumbel-max, as
    ``jax.random.categorical``) after optional top-k and top-p (nucleus)
    truncation, the smallest set of tokens whose probabilities reach
    ``top_p``. Ranks come from a stable ascending sort, reversed, so of
    tied logits the higher index ranks first, as in the JAX decode."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None or top_p is not None:
        order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
        sorted_desc = torch.gather(logits, -1, order)
        keep = torch.ones_like(sorted_desc, dtype=torch.bool)
        if top_k is not None:
            keep &= torch.arange(keep.shape[-1], device=logits.device) < top_k
        if top_p is not None:
            probs = torch.softmax(
                sorted_desc.masked_fill(~keep, _NEG_INF_LOGIT), dim=-1)
            keep &= torch.cumsum(probs, dim=-1) - probs < top_p
        # the keep-mask is over ranks: scatter it back to token ids
        logits = logits.masked_fill(
            ~torch.empty_like(keep).scatter_(-1, order, keep),
            _NEG_INF_LOGIT)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(dim=-1)


def generate(params, tokens, config: TransformerConfig, max_new_tokens: int,
             *, temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             return_logits: bool = False):
    """Autoregressive decoding with per-layer KV caches, on the device of
    ``tokens`` and ``params``.

    ``tokens`` ``(B, Lp)`` prompts of one length → ``(B, max_new_tokens)``
    continuations in ``tokens``' dtype. ``temperature`` 0 is greedy, > 0
    samples with ``generator`` (seed 0 on ``tokens``' device when None),
    after optional ``top_k`` / ``top_p`` truncation. The prompt goes
    through the same single-token path as the continuation, so prefill and
    decode are identical; the config's ``attention`` mode only affects
    training. With ``return_logits``, also the float32 ``(B,
    max_new_tokens, vocab)`` logits each new token was drawn from."""
    c = config
    b, prompt_len = tokens.shape
    total = prompt_len + max_new_tokens
    if c.attention_window is not None and c.attention_window < 1:
        raise ValueError('attention_window must be >= 1, got %r'
                         % (c.attention_window,))
    if top_k is not None and not 1 <= top_k <= c.vocab_size:
        raise ValueError('top_k must be in [1, vocab_size]')
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError('top_p must be in (0, 1]')
    device = tokens.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    caches = init_kv_cache(c, b, total, device=device)
    buf = torch.cat([tokens, tokens.new_zeros(b, max_new_tokens)], dim=1)
    drawn = []
    with torch.no_grad():
        for t in range(total - 1):
            x = params['embed'].to(c.dtype)[buf[:, t].long()][:, None, :]
            for layer, cache in zip(params['layers'], caches):
                x, _ = _decode_layer(x, layer, c, cache, t)
            if t + 1 < prompt_len:
                continue            # prefill: the next token is the prompt's
            x = _rms_norm(x, params['final_norm'])
            logits = (x @ params['unembed'].to(c.dtype))[:, 0].float()
            buf[:, t + 1] = _sample_logits(logits, temperature, top_k, top_p,
                                           generator).to(buf.dtype)
            if return_logits:
                drawn.append(logits)
    out = buf[:, prompt_len:]
    if return_logits:
        return out, (torch.stack(drawn, dim=1) if drawn else
                     torch.zeros(b, 0, c.vocab_size, device=device))
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def make_train_step(config: TransformerConfig, params: Dict, mesh=None):
    """``(optimizer, step)`` with ``step(tokens, targets, **kw) -> loss``
    (``kw``: :func:`loss_fn`'s ``positions``, ``segment_ids``, ``weights``
    and ``moe_stats``): one step of ``torch.optim.AdamW`` over every leaf,
    the MoE router and experts included, configured as the JAX default
    ``optax.adamw(3e-4, weight_decay=0.01)`` — betas (0.9, 0.999), eps 1e-8
    added outside the square root, decoupled decay ``p -= lr * wd * p`` on
    every parameter. Unlike the JAX step, which returns new params and
    optimizer state, this one updates ``params`` and the optimizer state in
    place.

    With ``mesh``, ``tokens`` and ``targets`` are this rank's ``(B / data,
    L / seq)`` shard and ``params`` its blocks (:func:`~petastorm_tpu_torch.
    weights.shard_params`). Every rank's gradient of a leaf is then the
    gradient of its loss share for its block: the ring's backward carries
    each seq rank's share to the k/v chunks it attended, the gathers over
    data x seq scatter their gradients back, and the ``model`` and
    ``expert`` collectives leave every rank's gradient of a replicated
    activation whole. So the shares and gradients are summed over the data
    x seq group alone before AdamW, never over an axis that splits a leaf,
    and each rank's AdamW (elementwise, no global norm) takes its block of
    the unsharded step."""
    _check_supported(config)
    if mesh is not None:
        _check_mesh(config, mesh)
    leaves = parameters(params)
    for p in leaves:
        p.requires_grad_(True)
    optimizer = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.01)
    from petastorm_tpu_torch.parallel.mesh import all_reduce_sum_, axes_group
    group = axes_group(mesh, _TOKEN_AXES)

    def step(tokens, targets, **loss_kwargs):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, targets, config, mesh=mesh,
                       **loss_kwargs)
        loss.backward()
        loss = loss.detach()
        if group is not None:
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_sum_([p.grad for p in leaves] + [loss], group)
        optimizer.step()
        return loss

    return optimizer, step


def make_forward(config: TransformerConfig):
    """``fn(params, tokens) -> logits``: one device's inference with no
    autograd (JAX ``make_forward``)."""
    _check_supported(config)

    def fn(params, tokens):
        with torch.no_grad():
            return forward(params, tokens, config)

    return fn
