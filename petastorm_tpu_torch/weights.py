"""Load the JAX package's transformer-LM parameters into the port.

The JAX ``init`` pytree (``petastorm_tpu/models/transformer_lm.py:86-130``)
is ``{'embed', 'final_norm', 'unembed', 'layers': [...]}`` of float32
arrays. The port keeps that structure and layout unchanged:

- ``embed`` ``(vocab, d_model)``; ``final_norm`` ``(d_model,)``;
  ``unembed`` ``(d_model, vocab)``;
- per layer: ``ln1``/``ln2`` ``(d_model,)``; ``wq`` ``(d_model, d_model)``,
  ``wk``/``wv`` ``(d_model, kv_heads * head_dim)``, ``wo``
  ``(d_model, d_model)``; ``w_gate``/``w_up`` ``(d_model, d_ff)``,
  ``w_down`` ``(d_ff, d_model)``.

Weights are ``(in, out)`` and applied as ``x @ w`` (not ``nn.Linear``'s
``(out, in)``), so no transpose happens and a parity test compares
gradients leaf by leaf. Arrays arrive as numpy (``jax.device_get`` the
pytree first); this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from petastorm_tpu_torch.device import resolve_device

_LAYER_KEYS = ('ln1', 'wq', 'wk', 'wv', 'wo', 'ln2', 'w_up', 'w_gate',
               'w_down')


def params_from_jax(numpy_pytree: Dict, config, device=None) -> Dict:
    """float32 torch parameters (same structure, same layout) from a numpy
    copy of the JAX ``init`` pytree, checked against ``config``'s shapes."""
    device = resolve_device(device)
    c = config
    kv_dim = c.kv_heads * c.head_dim
    expect = {'ln1': (c.d_model,), 'ln2': (c.d_model,),
              'wq': (c.d_model, c.d_model), 'wk': (c.d_model, kv_dim),
              'wv': (c.d_model, kv_dim), 'wo': (c.d_model, c.d_model),
              'w_up': (c.d_model, c.d_ff), 'w_gate': (c.d_model, c.d_ff),
              'w_down': (c.d_ff, c.d_model)}

    def leaf(x, shape, name):
        arr = np.asarray(x, dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError('%s has shape %s, config expects %s'
                             % (name, arr.shape, tuple(shape)))
        return torch.from_numpy(arr.copy()).to(device)

    layers = numpy_pytree['layers']
    if len(layers) != c.n_layers:
        raise ValueError('pytree has %d layers, config %d'
                         % (len(layers), c.n_layers))
    out = {'embed': leaf(numpy_pytree['embed'], (c.vocab_size, c.d_model),
                         'embed'),
           'final_norm': leaf(numpy_pytree['final_norm'], (c.d_model,),
                              'final_norm'),
           'unembed': leaf(numpy_pytree['unembed'],
                           (c.d_model, c.vocab_size), 'unembed'),
           'layers': []}
    for i, layer in enumerate(layers):
        extra = set(layer) - set(_LAYER_KEYS)
        if extra:
            raise NotImplementedError(
                'layer %d carries %s: mixture-of-experts weights are not '
                'ported yet' % (i, sorted(extra)))
        out['layers'].append({k: leaf(layer[k], expect[k],
                                      'layers[%d].%s' % (i, k))
                              for k in _LAYER_KEYS})
    return out
