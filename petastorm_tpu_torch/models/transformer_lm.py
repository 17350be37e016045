"""Flagship decoder-only transformer LM of the port, single device.

Counterpart of ``petastorm_tpu/models/transformer_lm.py``
(``TransformerConfig`` :36-80, ``init`` :86-130, ``_rms_norm``/``_rope`` :181-200, ``_attention``
:228-269, ``_dense_ffn`` :272-275, ``forward``/``loss_fn`` :393-452,
``make_train_step`` :620-653). Parameters are a plain dict of float32
tensors with the JAX pytree's structure and layout (see
:mod:`petastorm_tpu_torch.weights`): weights are ``(in, out)`` and applied
as ``x @ w``. Compute runs in ``config.dtype`` (bfloat16 by default) with
explicit ``w.to(x.dtype)`` casts, as the JAX model does, so gradients land
on the float32 parameters; norms, softmax statistics and the loss run in
float32.

Not in this slice: mixture-of-experts FFNs, ring attention (multi-GPU) and
KV-cache decoding (``generate``); they raise ``NotImplementedError``.
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
    n_experts: int = 0                   # > 0 (MoE) is not ported yet
    dtype: torch.dtype = torch.bfloat16
    attention: str = 'blockwise'         # 'flash' | 'blockwise'
    attention_window: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


def _check_supported(config: TransformerConfig) -> None:
    if config.n_experts > 0:
        raise NotImplementedError('mixture-of-experts FFNs are not ported '
                                  'yet (the MoE / GQA config slice)')
    if config.attention not in ('flash', 'blockwise'):
        raise NotImplementedError(
            "attention=%r is not ported yet (ring attention is the "
            "multi-GPU slice); use 'flash' or 'blockwise'"
            % (config.attention,))
    if config.n_heads % config.kv_heads:
        raise ValueError('n_heads (%d) must be a multiple of n_kv_heads (%d)'
                         % (config.n_heads, config.kv_heads))


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
    for _ in range(c.n_layers):
        params['layers'].append({
            'ln1': ones(c.d_model),
            'wq': dense(c.d_model, c.d_model, c.d_model),
            'wk': dense(c.d_model, c.d_model, kv_dim),
            'wv': dense(c.d_model, c.d_model, kv_dim),
            'wo': dense(c.d_model, c.d_model, c.d_model),
            'ln2': ones(c.d_model),
            'w_up': dense(c.d_model, c.d_model, c.d_ff),
            'w_gate': dense(c.d_model, c.d_model, c.d_ff),
            'w_down': dense(c.d_ff, c.d_ff, c.d_model),
        })
    return params


def parameters(params: Dict) -> List[torch.Tensor]:
    """The parameter leaves in a fixed order (the optimizer's list)."""
    leaves = [params['embed'], params['final_norm'], params['unembed']]
    for layer in params['layers']:
        leaves.extend(layer[name] for name in sorted(layer))
    return leaves


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


def _attention(x, layer, config: TransformerConfig, positions,
               segment_ids=None):
    c = config
    b, l, _ = x.shape
    h, hkv, dh = c.n_heads, c.kv_heads, c.head_dim

    def heads(w, n):
        y = (x @ w.to(x.dtype)).reshape(b, l, n, dh)
        return y.transpose(1, 2)                        # (B, n, L, dh)

    q = _rope(heads(layer['wq'], h), positions)
    k = _rope(heads(layer['wk'], hkv), positions)
    v = heads(layer['wv'], hkv)
    if c.attention == 'flash':
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
            segment_ids=None):
    """tokens ``(B, L)`` integer → logits ``(B, L, vocab)`` float32.
    ``segment_ids`` ``(B, L)`` masks attention to same-segment pairs and
    restarts rotary positions per document (unless ``positions`` is
    given)."""
    c = config
    _check_supported(c)
    tokens = tokens.long()
    if positions is None:
        positions = (_segment_positions(segment_ids)
                     if segment_ids is not None
                     else torch.arange(tokens.shape[1],
                                       device=tokens.device))
    x = params['embed'].to(c.dtype)[tokens]             # (B, L, D)
    for layer in params['layers']:
        x = x + _attention(_rms_norm(x, layer['ln1']), layer, c, positions,
                           segment_ids)
        x = x + _dense_ffn(_rms_norm(x, layer['ln2']), layer)
    x = _rms_norm(x, params['final_norm'])
    return (x @ params['unembed'].to(c.dtype)).float()


def loss_fn(params, tokens, targets, config: TransformerConfig, *,
            positions=None, segment_ids=None, weights=None):
    """Next-token cross entropy; with ``weights`` the weighted mean over
    weighted slots (packed batches), as the JAX ``loss_fn``."""
    logits = forward(params, tokens, config, positions=positions,
                     segment_ids=segment_ids)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1).long(), reduction='none')
    if weights is None:
        return nll.mean()
    w = weights.reshape(-1).float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def make_train_step(config: TransformerConfig, params: Dict):
    """``(optimizer, step)`` with ``step(tokens, targets) -> loss``: one
    step of ``torch.optim.AdamW`` configured as the JAX default
    ``optax.adamw(3e-4, weight_decay=0.01)`` — betas (0.9, 0.999), eps 1e-8
    added outside the square root, decoupled decay ``p -= lr * wd * p`` on
    every parameter. Unlike the JAX step, which returns new params and
    optimizer state, this one updates ``params`` and the optimizer state in
    place."""
    _check_supported(config)
    leaves = parameters(params)
    for p in leaves:
        p.requires_grad_(True)
    optimizer = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.01)

    def step(tokens, targets):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, targets, config)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return optimizer, step
