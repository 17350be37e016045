"""MNIST-style training from a store through the row reader, on the card.

The twin of ``examples/mnist/main.py``: synthetic digits (class-dependent
blobs) written with ``materialize_dataset``, read row by row with
``make_reader``, shuffled and batched by ``TorchDataLoader``, and fed to
the float32 MLP.

Usage::

    python -m petastorm_tpu_torch.examples.mnist.main
"""

from __future__ import annotations

import tempfile

import numpy as np

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

MnistSchema = Unischema('MnistSchema', [
    UnischemaField('idx', np.int64, (), ScalarCodec(), False),
    UnischemaField('digit', np.int64, (), ScalarCodec(), False),
    UnischemaField('image', np.uint8, (28, 28), NdarrayCodec(), False),
])


def generate_synthetic_mnist(output_url, n=2048, seed=0):
    """Class-dependent blob images: learnable, standalone, deterministic."""
    from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
    rng = np.random.default_rng(seed)

    def row(i):
        digit = int(rng.integers(0, 10))
        img = rng.integers(0, 30, (28, 28), dtype=np.uint8)
        r, c = divmod(digit, 4)
        img[5 + 6 * r: 11 + 6 * r, 3 + 6 * c: 9 + 6 * c] += 200
        return {'idx': np.int64(i), 'digit': np.int64(digit), 'image': img}

    with materialize_dataset(output_url, MnistSchema, rows_per_file=512) as w:
        w.write_rows(row(i) for i in range(n))


def train(dataset_url, epochs=5, lr=5e-2, batch_size=64, device=None,
          seed=0, log=print):
    """``epochs`` epochs of SGD; returns ``(params, per-step losses,
    accuracy over the last 10 batches)``."""
    import torch

    from petastorm_tpu_torch.models import mnist_mlp
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.torch_utils import TorchDataLoader

    params = mnist_mlp.init(torch.Generator().manual_seed(seed),
                            device=device)
    losses, accs = [], []
    for epoch in range(epochs):
        with make_reader(dataset_url, num_epochs=1, seed=epoch,
                         workers_count=4) as reader:
            loader = TorchDataLoader(reader, batch_size=batch_size,
                                     shuffling_queue_capacity=512,
                                     seed=epoch, device=device)
            for batch in loader:
                dev = params['w1'].device
                images = batch['image'].to(dev, non_blocking=True)
                images = images.reshape(len(images), -1).float() / 255.0
                labels = batch['digit'].to(dev, non_blocking=True)
                losses.append(mnist_mlp.train_step(params, images, labels,
                                                   lr))
                accs.append(mnist_mlp.accuracy(params, images, labels))
        log('epoch {}: loss {:.4f} acc {:.3f}'.format(
            epoch, float(torch.stack(losses[-10:]).mean()),
            float(torch.stack(accs[-10:]).mean())))
    return (params, [float(x) for x in losses],
            float(torch.stack(accs[-10:]).mean()))


if __name__ == '__main__':
    url = 'file://' + tempfile.mkdtemp() + '/mnist'
    generate_synthetic_mnist(url)
    train(url)
