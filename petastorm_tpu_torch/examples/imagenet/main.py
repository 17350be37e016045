"""Train the compact residual CNN on an ImageNet-style store, on the card.

The image line (``examples/imagenet/main.py``): ``make_columnar_reader``
decodes png/jpeg cells on the worker threads, a columnar ``TransformSpec``
resizes the variable-shape images to a fixed square on the workers (cv2
releases the GIL), ``TorchDataLoader`` assembles uint8 batches in pinned
memory, ``prefetch_to_device`` stages them to the card at 1 byte per pixel,
and the train step's first op, kernel K4, scales them to bfloat16.

Usage::

    python -m petastorm_tpu_torch.examples.imagenet.main \
        --dataset-url file:///tmp/imagenet_pq --batch-size 64 --steps 100
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np

IMAGE_SIZE = 224


def make_resize_transform(size: int = IMAGE_SIZE):
    """Columnar TransformSpec: ragged ``(H, W, 3)`` images → ``(size, size,
    3)`` by ``cv2.INTER_AREA``, keeping ``image`` and ``label``."""
    from petastorm_tpu_torch.transform import TransformSpec

    def resize_batch(columns):
        import cv2
        images = columns['image']
        out = np.empty((len(images), size, size, 3), dtype=np.uint8)
        for i, img in enumerate(images):
            out[i] = cv2.resize(img, (size, size),
                                interpolation=cv2.INTER_AREA)
        columns['image'] = out
        return columns

    return TransformSpec(
        resize_batch,
        edit_fields=[('image', np.uint8, (size, size, 3), False)],
        selected_fields=['image', 'label'])


def train(dataset_url: str, batch_size: int = 64, steps: int = 100,
          workers_count: int = None, num_classes: int = 16,
          lr: float = 1e-3, log_every: int = 20,
          image_size: int = IMAGE_SIZE, seed: int = 0, device=None,
          log=print, then=None):
    """``steps`` SGD steps of the CNN (widths 64/128/256, 2 blocks, bf16)
    from the store. Each step's loss is read back before the next step, so
    the step times include the device's work.

    :param then: called as ``then(batches, step)`` after the last step,
        while the reader still runs: ``next(batches)`` gives a staged batch
        and ``step(images, labels)`` runs one more step (for profiling).
    :returns: ``(params, losses, times)``, ``times`` holding per step the
        seconds waited for the batch and the seconds of the whole step.
    """
    import torch

    from petastorm_tpu_torch.models import image_cnn
    from petastorm_tpu_torch.reader import make_columnar_reader
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 prefetch_to_device)

    params = image_cnn.init(torch.Generator().manual_seed(seed),
                            num_classes=num_classes, device=device)
    step = image_cnn.make_train_step(params, lr=lr)
    workers = workers_count or min(8, max(2, os.cpu_count() or 2))
    losses, times = [], []
    with make_columnar_reader(dataset_url, num_epochs=None,
                              workers_count=workers, seed=seed,
                              transform_spec=make_resize_transform(image_size)
                              ) as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size,
                                 drop_last=True, device=device)
        batches = prefetch_to_device(iter(loader), size=2, device=device)
        with contextlib.closing(batches):
            for done in range(1, steps + 1):
                t0 = time.perf_counter()
                batch = next(batches)
                t1 = time.perf_counter()
                losses.append(float(step(batch['image'], batch['label'])))
                times.append((t1 - t0, time.perf_counter() - t0))
                if done % log_every == 0 or done == steps:
                    log('step {:4d}  loss {:.6f}  {:.2f} ms (batch wait '
                        '{:.2f} ms)  {:.1f} images/sec'.format(
                            done, losses[-1], times[-1][1] * 1e3,
                            times[-1][0] * 1e3, batch_size / times[-1][1]))
            if then is not None:
                then(batches, step)
    return params, losses, times


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url', type=str, required=True)
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--workers', type=int, default=None)
    parser.add_argument('--num-classes', type=int, default=16)
    parser.add_argument('--image-size', type=int, default=IMAGE_SIZE)
    args = parser.parse_args(argv)
    train(args.dataset_url, batch_size=args.batch_size, steps=args.steps,
          workers_count=args.workers, num_classes=args.num_classes,
          image_size=args.image_size)


if __name__ == '__main__':
    main()
