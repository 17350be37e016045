"""petastorm_tpu_torch: the PyTorch / CUDA port of petastorm_tpu.

The port runs the data plane (Parquet store → NGram, columnar, row or batch
reader, with predicates, filters, sharding and row-group selectors → torch
loader → device staging) and three models on an NVIDIA GPU: the
flagship transformer LM, with the attention forward and backward on
hand-written CUDA kernels; the image CNN, whose input normalisation is a
hand-written CUDA kernel; and the MNIST MLP. It imports ``torch`` and never
``jax`` or the JAX package. Entry points run on the CUDA device unless the
caller passes ``device='cpu'``.

Public API: :func:`make_reader`, :func:`make_columnar_reader`,
:func:`make_batch_reader`, :func:`materialize_dataset`,
:class:`TransformSpec`, :class:`NoDataAvailableError`,
:class:`TorchDataLoader`, :func:`prefetch_to_device`,
:func:`flash_attention`, :func:`normalize_images`.
"""

__version__ = '0.1.0'

__all__ = ['make_reader', 'make_columnar_reader', 'make_batch_reader',
           'materialize_dataset', 'TransformSpec', 'NoDataAvailableError',
           'TorchDataLoader', 'prefetch_to_device',
           'flash_attention', 'normalize_images', '__version__']


def __getattr__(name):
    # lazy imports keep `import petastorm_tpu_torch` light
    if name in ('make_reader', 'make_columnar_reader', 'make_batch_reader'):
        from petastorm_tpu_torch import reader
        return getattr(reader, name)
    if name == 'TransformSpec':
        from petastorm_tpu_torch.transform import TransformSpec
        return TransformSpec
    if name == 'NoDataAvailableError':
        from petastorm_tpu_torch.errors import NoDataAvailableError
        return NoDataAvailableError
    if name == 'normalize_images':
        from petastorm_tpu_torch.ops.normalize import normalize_images
        return normalize_images
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
