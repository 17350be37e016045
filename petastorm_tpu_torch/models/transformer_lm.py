"""Flagship decoder-only transformer LM of the port, single device.

Counterpart of ``petastorm_tpu/models/transformer_lm.py``
(``TransformerConfig`` :36-80, ``init`` :86-130, ``_rms_norm``/``_rope`` :181-200, ``_attention``
:228-269, ``_dense_ffn`` :272-275, ``forward``/``loss_fn`` :393-452,
``make_train_step`` :620-653) and its KV-cache decode (``init_kv_cache``,
``_attend_cache``, ``_decode_layer``, ``_sample_logits`` and ``generate``
:459-613). Parameters are a plain dict of float32
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

Not in this slice: mixture-of-experts FFNs and ring attention (multi-GPU);
they raise ``NotImplementedError``.
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


def _check_dense(config: TransformerConfig) -> None:
    if config.n_experts > 0:
        raise NotImplementedError('mixture-of-experts FFNs are not ported '
                                  'yet (the MoE / GQA config slice)')


def _check_supported(config: TransformerConfig) -> None:
    _check_dense(config)
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
    _check_dense(c)
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
    return x + _dense_ffn(_rms_norm(x, layer['ln2']), layer), cache


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
