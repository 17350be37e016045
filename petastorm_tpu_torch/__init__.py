"""petastorm_tpu_torch: the PyTorch / CUDA port of petastorm_tpu.

The port runs the data plane (Parquet store → NGram reader → torch loader →
device staging) and the flagship transformer LM on an NVIDIA GPU, with the
attention forward and backward on hand-written CUDA kernels. It imports
``torch`` and never ``jax`` or the JAX package. Entry points run on the
CUDA device unless the caller passes ``device='cpu'``.

Public API: :func:`make_reader`, :func:`materialize_dataset`,
:class:`TorchDataLoader`, :func:`prefetch_to_device`,
:func:`flash_attention`.
"""

__version__ = '0.1.0'

__all__ = ['make_reader', 'materialize_dataset', 'TorchDataLoader',
           'prefetch_to_device', 'flash_attention', '__version__']


def __getattr__(name):
    # lazy imports keep `import petastorm_tpu_torch` light
    if name == 'make_reader':
        from petastorm_tpu_torch.reader import make_reader
        return make_reader
    if name == 'materialize_dataset':
        from petastorm_tpu_torch.etl.dataset_metadata import \
            materialize_dataset
        return materialize_dataset
    if name in ('TorchDataLoader', 'prefetch_to_device'):
        from petastorm_tpu_torch import torch_utils
        return getattr(torch_utils, name)
    if name == 'flash_attention':
        from petastorm_tpu_torch.ops.attention import flash_attention
        return flash_attention
    raise AttributeError('module {!r} has no attribute {!r}'.format(
        __name__, name))
