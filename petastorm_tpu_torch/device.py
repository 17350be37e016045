"""Device resolution for the port's entry points.

Every entry point (the loader, device staging, model init) runs on the CUDA
device unless the caller asks for the CPU. There is no silent fallback: a
host without CUDA raises, so a CPU run is never mistaken for a device run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` (the current CUDA device) by default; raises when CUDA is
    absent. Returns the CPU only when the caller passes ``device='cpu'``."""
    if device is None:
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'petastorm_tpu_torch runs on a CUDA device and none is '
            "available; pass device='cpu' to run on the CPU explicitly")
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('unsupported device %r (cuda or cpu)' % (device,))
    return device
