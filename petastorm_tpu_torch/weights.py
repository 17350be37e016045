"""Load the JAX package's model parameters into the port.

:func:`params_from_jax` (transformer LM), :func:`image_cnn_params_from_jax`
and :func:`mnist_params_from_jax` take a numpy copy of the JAX ``init``
pytree and return float32 torch tensors of the same structure and layout,
with shape checks.

:func:`shard_params` and :func:`gather_params` move the LM's parameters
onto a mesh (each rank's shard of each leaf under
``transformer_lm.param_specs``) and back.

The transformer LM's pytree (``petastorm_tpu/models/transformer_lm.py:86-130``)
is ``{'embed', 'final_norm', 'unembed', 'layers': [...]}``:

- ``embed`` ``(vocab, d_model)``; ``final_norm`` ``(d_model,)``;
  ``unembed`` ``(d_model, vocab)``;
- per layer: ``ln1``/``ln2`` ``(d_model,)``; ``wq`` ``(d_model, d_model)``,
  ``wk``/``wv`` ``(d_model, kv_heads * head_dim)``, ``wo``
  ``(d_model, d_model)``; ``w_gate``/``w_up`` ``(d_model, d_ff)``,
  ``w_down`` ``(d_ff, d_model)``; with ``n_experts = E > 0`` (a
  mixture-of-experts layer) ``gate`` ``(d_model, E)``, ``w_gate``/``w_up``
  ``(E, d_model, d_ff)`` and ``w_down`` ``(E, d_ff, d_model)``.

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

def params_from_jax(numpy_pytree: Dict, config, device=None) -> Dict:
    """float32 torch parameters (same structure, same layout) from a numpy
    copy of the JAX ``init`` pytree, checked against ``config``'s shapes."""
    device = resolve_device(device)
    c = config
    kv_dim = c.kv_heads * c.head_dim
    experts = (c.n_experts,) if c.n_experts > 0 else ()
    expect = {'ln1': (c.d_model,), 'ln2': (c.d_model,),
              'wq': (c.d_model, c.d_model), 'wk': (c.d_model, kv_dim),
              'wv': (c.d_model, kv_dim), 'wo': (c.d_model, c.d_model),
              'w_up': experts + (c.d_model, c.d_ff),
              'w_gate': experts + (c.d_model, c.d_ff),
              'w_down': experts + (c.d_ff, c.d_model)}
    if experts:
        expect['gate'] = (c.d_model, c.n_experts)

    def leaf(x, shape, name):
        return _leaf(x, shape, name, device)

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
        if set(layer) != set(expect):
            raise ValueError('layer %d has leaves %s, the config expects %s'
                             % (i, sorted(layer), sorted(expect)))
        out['layers'].append({k: leaf(layer[k], shape,
                                      'layers[%d].%s' % (i, k))
                              for k, shape in expect.items()})
    return out


def _leaf(x, shape, name, device):
    arr = np.asarray(x, dtype=np.float32)
    if arr.shape != tuple(shape):
        raise ValueError('%s has shape %s, expected %s'
                         % (name, arr.shape, tuple(shape)))
    return torch.from_numpy(arr.copy()).to(device)


def image_cnn_params_from_jax(numpy_pytree: Dict, device=None) -> Dict:
    """The image CNN's parameters (``petastorm_tpu/models/image_cnn.py``
    ``init`` :34-66): ``stem`` HWIO ``(7, 7, 3, w0)``, ``stem_scale`` /
    ``stem_bias`` ``(w0,)``, ``stages`` a list of lists of blocks
    (``conv1`` ``(3, 3, cin, w)``, ``conv2`` ``(3, 3, w, w)``, ``scale1/2``
    ``bias1/2`` ``(w,)``, and ``proj`` ``(1, 1, cin, w)`` exactly where
    ``cin != w``), ``head_w`` ``(cin, classes)``, ``head_b``
    ``(classes,)``. The widths are read from the pytree and every leaf is
    checked against them."""
    device = resolve_device(device)
    tree = numpy_pytree
    w0 = np.shape(tree['stem'])[-1]
    out = {'stem': _leaf(tree['stem'], (7, 7, 3, w0), 'stem', device),
           'stem_scale': _leaf(tree['stem_scale'], (w0,), 'stem_scale',
                               device),
           'stem_bias': _leaf(tree['stem_bias'], (w0,), 'stem_bias', device),
           'stages': []}
    cin = w0
    for s, stage in enumerate(tree['stages']):
        blocks = []
        for b, block in enumerate(stage):
            name = 'stages[%d][%d].' % (s, b)
            w = np.shape(block['conv1'])[-1]
            shapes = {'conv1': (3, 3, cin, w), 'conv2': (3, 3, w, w),
                      'scale1': (w,), 'bias1': (w,), 'scale2': (w,),
                      'bias2': (w,)}
            if cin != w:
                shapes['proj'] = (1, 1, cin, w)
            if set(block) != set(shapes):
                raise ValueError('%s has leaves %s, expected %s'
                                 % (name, sorted(block), sorted(shapes)))
            blocks.append({k: _leaf(block[k], shape, name + k, device)
                           for k, shape in shapes.items()})
            cin = w
        out['stages'].append(blocks)
    classes = np.shape(tree['head_w'])[-1]
    out['head_w'] = _leaf(tree['head_w'], (cin, classes), 'head_w', device)
    out['head_b'] = _leaf(tree['head_b'], (classes,), 'head_b', device)
    return out


def mnist_params_from_jax(numpy_pytree: Dict, device=None) -> Dict:
    """The MNIST MLP's parameters (``petastorm_tpu/models/mnist_mlp.py``
    ``init`` :11-21): ``w1`` ``(input, hidden)``, ``b1`` ``(hidden,)``,
    ``w2`` ``(hidden, classes)``, ``b2`` ``(classes,)``."""
    device = resolve_device(device)
    tree = numpy_pytree
    d_in, hidden = np.shape(tree['w1'])
    classes = np.shape(tree['w2'])[-1]
    shapes = {'w1': (d_in, hidden), 'b1': (hidden,), 'w2': (hidden, classes),
              'b2': (classes,)}
    if set(tree) != set(shapes):
        raise ValueError('MLP pytree has leaves %s, expected %s'
                         % (sorted(tree), sorted(shapes)))
    return {k: _leaf(tree[k], shape, k, device) for k, shape in shapes.items()}


def _lm_leaves(params: Dict, specs: Dict):
    """``(path, leaf, spec)`` of the LM tree in a fixed order."""
    for name in ('embed', 'final_norm', 'unembed'):
        yield (name,), params[name], specs[name]
    for i, layer in enumerate(params['layers']):
        for name in sorted(layer):
            yield ('layers', i, name), layer[name], specs['layers'][i][name]


def _set(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def _copy_tree(params: Dict) -> Dict:
    return {'embed': None, 'final_norm': None, 'unembed': None,
            'layers': [dict(layer) for layer in params['layers']]}


def shard_params(params: Dict, config, mesh, src: int = 0) -> Dict:
    """This rank's shard of the LM's parameters on ``mesh``'s device: every
    leaf is first made equal to global rank ``src``'s (one broadcast), then
    cut to the block ``transformer_lm.param_specs`` gives this rank (the
    whole leaf where the spec replicates). Float32 leaves, new tensors."""
    from petastorm_tpu_torch.models.transformer_lm import param_specs
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, broadcast_
    device = resolve_device(mesh.device_type)
    full = [leaf.detach().to(device, torch.float32).clone()
            for _, leaf, _ in _lm_leaves(params, param_specs(config, mesh))]
    broadcast_(full, src=src)
    out = _copy_tree(params)
    for (path, _, spec), leaf in zip(
            _lm_leaves(params, param_specs(config, mesh)), full):
        blocks = NamedSharding(mesh, spec).shard_slices(leaf.shape)
        _set(out, path, leaf[blocks].contiguous())
    return out


def gather_params(params: Dict, config, mesh) -> Dict:
    """The whole LM parameters from every rank's shard
    (:func:`shard_params`' inverse): each split dim all-gathered over its
    axis's group; detached float32 copies on the shards' device."""
    from petastorm_tpu_torch.models.transformer_lm import param_specs
    from petastorm_tpu_torch.parallel.mesh import (NamedSharding,
                                                   gather_global)
    out = _copy_tree(params)
    for path, leaf, spec in _lm_leaves(params, param_specs(config, mesh)):
        _set(out, path, gather_global(leaf.detach().float(),
                                      NamedSharding(mesh, spec)).clone())
    return out
