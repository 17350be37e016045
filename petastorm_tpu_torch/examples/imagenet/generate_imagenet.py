"""Write a synthetic ImageNet-style store (``examples/imagenet/
generate_imagenet.py`` ``synthetic_rows`` / ``generate`` :56-97).

Usage::

    python -m petastorm_tpu_torch.examples.imagenet.generate_imagenet \
        --synthetic 512 -o file:///tmp/imagenet_pq
"""

from __future__ import annotations

import argparse

import numpy as np

from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
from petastorm_tpu_torch.examples.imagenet.schema import make_imagenet_schema


def synthetic_rows(n: int, classes: int = 16, seed: int = 0,
                   base_hw=(375, 500)):
    """Photo-like random images about the ImageNet median size (500 x 375),
    each side jittered by up to 20%: a low-frequency random field plus mild
    noise, so png sizes and decode cost resemble real photos'."""
    import cv2
    rng = np.random.default_rng(seed)
    for i in range(n):
        h = int(base_hw[0] * rng.uniform(0.8, 1.2))
        w = int(base_hw[1] * rng.uniform(0.8, 1.2))
        label = i % classes
        small = rng.integers(0, 255, size=(24, 32, 3), dtype=np.uint8)
        img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
        img = np.clip(img.astype(np.int16)
                      + rng.integers(-8, 8, size=img.shape),
                      0, 255).astype(np.uint8)
        yield {'noun_id': 'n{:08d}'.format(label),
               'text': 'class {}'.format(label),
               'label': np.int64(label), 'image': img}


def generate(output_url: str, rows, row_group_size_mb: float = 32.0,
             image_codec: str = 'png') -> int:
    """Write ``rows`` under the ImageNet schema; returns the row count."""
    written = 0

    def counting():
        nonlocal written
        for row in rows:
            written += 1
            yield row

    with materialize_dataset(output_url, make_imagenet_schema(image_codec),
                             row_group_size_mb=row_group_size_mb) as writer:
        writer.write_rows(counting())
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-o', '--output-url', type=str, required=True)
    parser.add_argument('--synthetic', type=int, required=True,
                        help='number of synthetic images to write')
    parser.add_argument('--row-group-size-mb', type=float, default=32.0)
    parser.add_argument('--image-codec', default='png',
                        choices=('png', 'jpeg'))
    args = parser.parse_args(argv)
    n = generate(args.output_url, synthetic_rows(args.synthetic),
                 args.row_group_size_mb, image_codec=args.image_codec)
    print('wrote {} rows to {}'.format(n, args.output_url))


if __name__ == '__main__':
    main()
