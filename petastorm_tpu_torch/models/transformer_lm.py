"""Flagship decoder-only transformer LM of the port, single device.

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
``make_train_step(mesh=)`` :620-653): data and sequence parallelism, one
process a device. Each rank holds the replicated parameters and its
``(B / data, L / seq)`` tokens; ``attention='ring'`` runs ring attention
over the ``seq`` group (K1-K3 per chunk pair on the card), the default
positions are the global offsets of the rank's chunk, and the train step
sums the ranks' shares of the global mean loss and of its gradients
before AdamW, so one step equals the unsharded step. A ``model``,
``expert`` or ``pipe`` axis larger than 1, and a mixture of experts under
a mesh with ``data`` x ``seq`` > 1, raise ``NotImplementedError``: tensor,
expert and pipeline parallelism are not ported yet.
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

#: Axes whose parallelism the port does not run yet (slice 3b).
_UNPORTED_AXES = ('model', 'expert', 'pipe')


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


def _check_mesh(config: TransformerConfig, mesh) -> None:
    """Raise for what the port cannot run on ``mesh`` yet: tensor, expert
    or pipeline parallelism, and a mixture of experts over a split batch
    (JAX routes its capacity over the global batch; routing each rank's
    tokens alone would drop other tokens)."""
    from petastorm_tpu_torch.parallel.mesh import axis_size
    for axis in _UNPORTED_AXES:
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(
                "a mesh '%s' axis of %d: tensor, expert and pipeline "
                'parallelism come with slice 3b of the port'
                % (axis, axis_size(mesh, axis)))
    if (config.n_experts > 0
            and axis_size(mesh, 'data') * axis_size(mesh, 'seq') > 1):
        raise NotImplementedError(
            'a mixture of experts under a mesh with data x seq = %d: MoE '
            'routing over the global batch comes with slice 3b of the port'
            % (axis_size(mesh, 'data') * axis_size(mesh, 'seq')))


def _sharded(mesh) -> bool:
    """Whether more than one rank shares the step on ``mesh``."""
    import torch.distributed as dist
    return (mesh is not None and dist.is_initialized()
            and dist.get_world_size() > 1)


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


def _attention(x, layer, config: TransformerConfig, positions,
               segment_ids=None, mesh=None):
    c = config
    b, l, _ = x.shape
    h, hkv, dh = c.n_heads, c.kv_heads, c.head_dim

    def heads(w, n):
        y = (x @ w.to(x.dtype)).reshape(b, l, n, dh)
        return y.transpose(1, 2)                        # (B, n, L, dh)

    q = _rope(heads(layer['wq'], h), positions)
    k = _rope(heads(layer['wk'], hkv), positions)
    v = heads(layer['wv'], hkv)
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
    o = o.transpose(1, 2).reshape(b, l, h * dh)
    return o @ layer['wo'].to(x.dtype)


def _dense_ffn(x, layer):
    gate = F.silu(x @ layer['w_gate'].to(x.dtype))
    up = x @ layer['w_up'].to(x.dtype)
    return (gate * up) @ layer['w_down'].to(x.dtype)


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


def _moe_ffn(x, layer, config: TransformerConfig,
             capacity: Optional[int] = None, stats: Optional[Dict] = None):
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
    ``stats['dropped']`` (a tensor, no host sync)."""
    b, l, d = x.shape
    e, k = config.n_experts, config.moe_top_k
    n = b * l
    n_units = n * k
    xf = x.reshape(n, d)
    probs = torch.softmax(xf.float() @ layer['gate'], -1)    # (N, E)
    top_idx, top_probs = _moe_router(probs, k)
    unit_expert = top_idx.reshape(n_units)                   # unit u: token u//k
    scale = top_probs.to(x.dtype)
    if capacity is None:
        capacity = max(1, int(math.ceil(n_units / e
                                        * config.moe_capacity_factor)))
    order = torch.argsort(unit_expert, stable=True)
    sorted_expert = unit_expert[order]
    group_starts = torch.searchsorted(
        sorted_expert, torch.arange(e, device=x.device), side='left')
    pos = torch.arange(n_units, device=x.device) - group_starts[sorted_expert]
    kept = pos < capacity
    dest = torch.where(kept, sorted_expert * capacity + pos,
                       torch.full_like(pos, e * capacity))
    buf = x.new_zeros(e * capacity + 1, d).index_put((dest,), xf[order // k])
    expert_in = buf[:-1].reshape(e, capacity, d)
    gate = F.silu(torch.bmm(expert_in, layer['w_gate'].to(x.dtype)))
    up = torch.bmm(expert_in, layer['w_up'].to(x.dtype))
    out = torch.bmm(gate * up, layer['w_down'].to(x.dtype))
    flat = torch.cat([out.reshape(e * capacity, d), x.new_zeros(1, d)])
    unit_out = x.new_zeros(n_units, d).index_put((order,), flat[dest])
    y = torch.einsum('nkd,nk->nd', unit_out.reshape(n, k, d), scale)
    # units an expert got, from the group starts (``bincount`` would wait
    # on the card for the largest index)
    counts = torch.diff(group_starts, append=group_starts.new_full(
        (1,), n_units))
    aux = e * torch.sum(counts.float() / n_units * probs.mean(0))
    if stats is not None:
        stats['dropped'] = stats.get('dropped', 0) + (~kept).sum()
    return y.reshape(b, l, d), aux


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
    ``mesh``, ``tokens`` are this rank's ``(B / data, L / seq)`` shard:
    the default positions start at the chunk's global offset, and
    ``attention='ring'`` attends over the ``seq`` group."""
    c = config
    _check_supported(c)
    tokens = tokens.long()
    if positions is None:
        if segment_ids is not None:
            positions = _segment_positions(segment_ids)
        else:
            offset = 0
            if mesh is not None:
                from petastorm_tpu_torch.parallel.mesh import axis_index
                offset = axis_index(mesh, 'seq') * tokens.shape[1]
            positions = torch.arange(offset, offset + tokens.shape[1],
                                     device=tokens.device)
    x = params['embed'].to(c.dtype)[tokens]             # (B, L, D)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params['layers']:
        x = x + _attention(_rms_norm(x, layer['ln1']), layer, c, positions,
                           segment_ids, mesh)
        h = _rms_norm(x, layer['ln2'])
        if c.n_experts > 0:
            ffn_out, aux = _moe_ffn(h, layer, c, stats=moe_stats)
            x = x + ffn_out
            aux_total = aux_total + aux
        else:
            x = x + _dense_ffn(h, layer)
    x = _rms_norm(x, params['final_norm'])
    logits = (x @ params['unembed'].to(c.dtype)).float()
    return (logits, aux_total) if return_aux else logits


def loss_fn(params, tokens, targets, config: TransformerConfig, *,
            positions=None, segment_ids=None, weights=None,
            moe_stats: Optional[Dict] = None, mesh=None):
    """Next-token cross entropy; with ``weights`` the weighted mean over
    weighted slots (packed batches), plus ``moe_aux_weight`` times the MoE
    aux loss, as the JAX ``loss_fn``. With ``moe_stats`` (a dict), also
    ``moe_stats['aux']`` (the aux loss, detached) and
    ``moe_stats['dropped']`` (units dropped over the layers). With a
    ``mesh`` of more than one rank, the loss is this rank's share of the
    global mean over every rank's tokens: the shares sum to it (the weights'
    global sum is all-reduced first)."""
    logits, aux = forward(params, tokens, config, positions=positions,
                          segment_ids=segment_ids, return_aux=True,
                          moe_stats=moe_stats, mesh=mesh)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1).long(), reduction='none')
    if _sharded(mesh):
        import torch.distributed as dist

        from petastorm_tpu_torch.parallel.mesh import all_reduce_sum_
        if weights is None:
            loss = nll.sum() / (nll.numel() * dist.get_world_size())
        else:
            w = weights.reshape(-1).float()
            total = w.sum().detach().clone()
            all_reduce_sum_([total])
            loss = (nll * w).sum() / torch.clamp(total, min=1.0)
    elif weights is None:
        loss = nll.mean()
    else:
        w = weights.reshape(-1).float()
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    if moe_stats is not None:
        moe_stats['aux'] = aux.detach()
    if config.n_experts > 0 and config.moe_aux_weight:
        loss = loss + config.moe_aux_weight * aux
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

    With ``mesh`` (data and sequence axes; :func:`_check_mesh` raises for
    the others), ``tokens`` and ``targets`` are this rank's ``(B / data, L /
    seq)`` shard and ``params`` its replica (:func:`~petastorm_tpu_torch.
    weights.shard_params`). The ring's backward already carries each
    rank's share of the loss to the k/v chunks it attended, so the ranks'
    gradients of their loss shares sum, over the whole mesh, to the
    gradient of the global mean loss: they are summed (with the loss)
    before AdamW, and every replica takes the unsharded step."""
    _check_supported(config)
    if mesh is not None:
        _check_mesh(config, mesh)
    leaves = parameters(params)
    for p in leaves:
        p.requires_grad_(True)
    optimizer = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.01)
    sharded = _sharded(mesh)

    def step(tokens, targets, **loss_kwargs):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, targets, config, mesh=mesh,
                       **loss_kwargs)
        loss.backward()
        loss = loss.detach()
        if sharded:
            from petastorm_tpu_torch.parallel.mesh import all_reduce_sum_
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_sum_([p.grad for p in leaves] + [loss])
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
