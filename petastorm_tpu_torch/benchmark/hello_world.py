"""Hello-world dataset generator (JAX ``benchmark/hello_world.py``): the
workload behind original petastorm's headline throughput number, so
benchmarks are reproducible without external data.

Schema: an int id, a (128, 256, 3) png-compressed image, and a
wildcard-shaped uint8 4-d array, written with the pyarrow writer.

Usage::

    python -m petastorm_tpu_torch.benchmark.hello_world [URL]
"""

from __future__ import annotations

import sys

import numpy as np

from petastorm_tpu_torch.codecs import (CompressedImageCodec, NdarrayCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

HelloWorldSchema = Unischema('HelloWorldSchema', [
    UnischemaField('id', np.int32, (), ScalarCodec(), False),
    UnischemaField('image1', np.uint8, (128, 256, 3), CompressedImageCodec('png'), False),
    UnischemaField('array_4d', np.uint8, (None, 128, 30, None), NdarrayCodec(), False),
])


def row_generator(x: int) -> dict:
    rng = np.random.default_rng(x)
    return {'id': np.int32(x),
            'image1': rng.integers(0, 255, dtype=np.uint8, size=(128, 256, 3)),
            'array_4d': rng.integers(0, 255, dtype=np.uint8, size=(4, 128, 30, 3))}


def generate_hello_world_dataset(output_url: str = 'file:///tmp/hello_world_dataset',
                                 rows_count: int = 10,
                                 row_group_size_mb: float = 256) -> str:
    with materialize_dataset(output_url, HelloWorldSchema,
                             row_group_size_mb=row_group_size_mb) as writer:
        writer.write_rows(row_generator(i) for i in range(rows_count))
    return output_url


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    url = argv[0] if argv else 'file:///tmp/hello_world_dataset'
    print(generate_hello_world_dataset(url))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
