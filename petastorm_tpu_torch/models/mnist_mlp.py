"""Minimal MLP classifier in float32: the MNIST line of the port.

Counterpart of ``petastorm_tpu/models/mnist_mlp.py`` (``init`` :11-21,
``forward`` :24-27, ``loss_fn`` :30-34, ``train_step`` :37-41,
``accuracy`` :44-46). Parameters are a plain dict ``w1, b1, w2, b2`` of
float32 tensors with the JAX layout (weights ``(in, out)``, applied as
``x @ w``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from petastorm_tpu_torch.device import resolve_device


def init(generator: Optional[torch.Generator] = None, input_dim: int = 784,
         hidden: int = 512, num_classes: int = 10, device=None) -> Dict:
    """He-normal weights and zero biases drawn from ``generator`` (other
    numbers than ``jax.random``'s; for parity load JAX's draw with
    :func:`petastorm_tpu_torch.weights.mnist_params_from_jax`)."""
    device = resolve_device(device)
    w1 = torch.randn(input_dim, hidden, generator=generator)
    w2 = torch.randn(hidden, num_classes, generator=generator)
    return {'w1': (w1 * math.sqrt(2.0 / input_dim)).to(device),
            'b1': torch.zeros(hidden, device=device),
            'w2': (w2 * math.sqrt(2.0 / hidden)).to(device),
            'b2': torch.zeros(num_classes, device=device)}


def forward(params, images):
    """images ``(B, 784)`` float32 in [0, 1] → logits ``(B, classes)``."""
    h = F.relu(images @ params['w1'] + params['b1'])
    return h @ params['w2'] + params['b2']


def loss_fn(params, images, labels):
    logp = F.log_softmax(forward(params, images), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def train_step(params, images, labels, lr: float = 1e-3):
    """One SGD step ``p - lr * g``, in place on ``params`` (the JAX step
    returns new params); returns the loss before the step."""
    leaves = [params[k] for k in ('w1', 'b1', 'w2', 'b2')]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = loss_fn(params, images, labels)
    loss.backward()
    with torch.no_grad():
        for p in leaves:
            p.sub_(lr * p.grad)
    return loss.detach()


@torch.no_grad()
def accuracy(params, images, labels):
    return (forward(params, images).argmax(-1) == labels).float().mean()
