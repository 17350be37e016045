"""Compact residual CNN for image classification, on one device.

Counterpart of ``petastorm_tpu/models/image_cnn.py`` (``_conv`` :18-21,
``_norm`` :24-31, ``init`` :34-66, ``forward`` :69-96, ``loss_fn`` :99-102,
``make_train_step`` :105-116). Parameters are a plain dict of float32
tensors with the JAX pytree's structure and layout: convolution weights are
HWIO and are permuted to OIHW and cast to the compute dtype inside
:func:`forward`, so gradients land on the HWIO float32 leaves and compare
with JAX's leaf by leaf.

Activations stay NHWC in memory: the ``(N, C, H, W)`` tensors here are
``permute`` views of NHWC (channels_last) storage, which cuDNN takes as they
are. JAX's ``'SAME'`` padding puts the odd pixel at the end (low = total //
2, high = total - low), so every convolution and the max pool pad
explicitly before running unpadded. GroupNorm(1), the global pool, the head
and the log-softmax run in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.ops.normalize import normalize_images


def _same_pad(size: int, k: int, stride: int):
    """XLA's 'SAME' padding of one spatial dim: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, value=0.0):
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x.contiguous(memory_format=torch.channels_last)


def _conv(x, w, stride=1):
    """'SAME' convolution of ``x`` (N, C, H, W) with HWIO ``w``."""
    x = _pad_same(x, w.shape[0], w.shape[1], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride)


def _norm(x, scale, bias):
    """GroupNorm(1) == LayerNorm over (C, H, W), in float32."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (out * scale[:, None, None] + bias[:, None, None]).to(x.dtype)


def _max_pool_same(x):
    """3x3 stride-2 max pool with 'SAME' padding by -inf."""
    return F.max_pool2d(_pad_same(x, 3, 3, 2, value=-math.inf), 3, 2)


def init(generator: Optional[torch.Generator] = None, num_classes: int = 1000,
         widths=(64, 128, 256), blocks_per_stage: int = 2,
         device=None) -> Dict:
    """float32 parameters of a stem conv + ``len(widths)`` stages of
    ``blocks_per_stage`` residual blocks + a linear head, drawn with the JAX
    ``init``'s distributions (He-normal convolutions, head ``normal /
    sqrt(fan_in)``) from ``generator``. The numbers differ from
    ``jax.random``'s; for parity load JAX's draw with
    :func:`petastorm_tpu_torch.weights.image_cnn_params_from_jax`."""
    device = resolve_device(device)

    def conv_w(kh, kw, cin, cout):
        w = torch.randn(kh, kw, cin, cout, generator=generator)
        return (w * math.sqrt(2.0 / (kh * kw * cin))).to(device)

    def const(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    params = {'stem': conv_w(7, 7, 3, widths[0]),
              'stem_scale': const(widths[0], 1.0),
              'stem_bias': const(widths[0], 0.0),
              'stages': []}
    cin = widths[0]
    for width in widths:
        stage = []
        for _ in range(blocks_per_stage):
            block = {'conv1': conv_w(3, 3, cin, width),
                     'scale1': const(width, 1.0), 'bias1': const(width, 0.0),
                     'conv2': conv_w(3, 3, width, width),
                     'scale2': const(width, 1.0), 'bias2': const(width, 0.0)}
            if cin != width:
                block['proj'] = conv_w(1, 1, cin, width)
            stage.append(block)
            cin = width
        params['stages'].append(stage)
    head = torch.randn(cin, num_classes, generator=generator)
    params['head_w'] = (head / math.sqrt(cin)).to(device)
    params['head_b'] = const(num_classes, 0.0)
    return params


def parameters(params: Dict) -> List[torch.Tensor]:
    """The parameter leaves in a fixed order."""
    leaves = [params['stem'], params['stem_scale'], params['stem_bias']]
    for stage in params['stages']:
        for block in stage:
            leaves.extend(block[name] for name in sorted(block))
    leaves.extend([params['head_w'], params['head_b']])
    return leaves


def forward(params, images, dtype: torch.dtype = torch.bfloat16):
    """images ``(B, H, W, 3)`` float in [0, 1] → logits ``(B, classes)``
    float32."""
    x = images.to(dtype).permute(0, 3, 1, 2)           # NHWC storage
    x = _conv(x, params['stem'], stride=2)
    x = F.relu(_norm(x, params['stem_scale'], params['stem_bias']))
    x = _max_pool_same(x)
    for s, stage in enumerate(params['stages']):
        for b, block in enumerate(stage):
            stride = 2 if (s > 0 and b == 0) else 1
            h = _conv(x, block['conv1'], stride=stride)
            h = F.relu(_norm(h, block['scale1'], block['bias1']))
            h = _conv(h, block['conv2'])
            h = _norm(h, block['scale2'], block['bias2'])
            shortcut = x
            if 'proj' in block:
                shortcut = _conv(x, block['proj'], stride=stride)
            elif stride != 1:
                shortcut = x[:, :, ::stride, ::stride]
            x = F.relu(h + shortcut)
    x = x.float().mean(dim=(2, 3))                       # global pool
    return x @ params['head_w'] + params['head_b']


def loss_fn(params, images, labels, dtype: torch.dtype = torch.bfloat16):
    logp = F.log_softmax(forward(params, images, dtype), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_train_step(params: Dict, lr: float = 1e-3,
                    dtype: torch.dtype = torch.bfloat16):
    """``step(images_u8, labels) -> loss``: one plain SGD step ``p - lr * g``
    over a uint8 NHWC batch. Its first op scales the batch to [0, 1] in
    ``dtype`` with :func:`normalize_images` (mean 0, std 1), which is kernel
    K4 on a CUDA device. Unlike the JAX step, which returns new params, this
    one updates ``params`` in place."""
    leaves = parameters(params)
    for p in leaves:
        p.requires_grad_(True)

    def step(images_u8, labels):
        for p in leaves:
            p.grad = None
        images = normalize_images(images_u8, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                  dtype)
        loss = loss_fn(params, images, labels, dtype)
        loss.backward()
        with torch.no_grad():
            for p in leaves:
                p.sub_(lr * p.grad)
        return loss.detach()

    return step
