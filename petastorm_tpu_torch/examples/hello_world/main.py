"""Hello world: write a petastorm store, read it back three ways.

The twin of ``examples/hello_world/main.py``: the store read row by row
with ``make_reader``, batched by ``TorchDataLoader``, and a plain Parquet
store (no petastorm metadata) read column-wise with ``make_batch_reader``.

Usage::

    python -m petastorm_tpu_torch.examples.hello_world.main
"""

from __future__ import annotations

import tempfile

import numpy as np

from petastorm_tpu_torch import (TorchDataLoader, make_batch_reader,
                                 make_reader, materialize_dataset)
from petastorm_tpu_torch.codecs import (CompressedImageCodec, NdarrayCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

HelloWorldSchema = Unischema('HelloWorldSchema', [
    UnischemaField('id', np.int32, (), ScalarCodec(), False),
    UnischemaField('image1', np.uint8, (128, 256, 3),
                   CompressedImageCodec('png'), False),
    UnischemaField('array_4d', np.uint8, (None, 128, 30, None),
                   NdarrayCodec(), False),
])


def row_generator(x):
    rng = np.random.default_rng(x)
    return {'id': np.int32(x),
            'image1': rng.integers(0, 255, (128, 256, 3), dtype=np.uint8),
            'array_4d': rng.integers(0, 255, (4, 128, 30, 3),
                                     dtype=np.uint8)}


def generate_petastorm_tpu_dataset(output_url, rows_count=10):
    with materialize_dataset(output_url, HelloWorldSchema,
                             row_group_size_mb=256) as writer:
        writer.write_rows(row_generator(i) for i in range(rows_count))


def python_hello_world(dataset_url):
    with make_reader(dataset_url, num_epochs=1) as reader:
        for row in reader:
            print(row.id, row.image1.shape, row.array_4d.shape)


def torch_hello_world(dataset_url, device=None):
    """Batches of 4 rows through a 10-row shuffling buffer, on ``device``
    (the CUDA device unless ``'cpu'`` is given)."""
    with make_reader(dataset_url, num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=4,
                                 shuffling_queue_capacity=10, device=device)
        for batch in loader:
            print('batch of', len(batch['id']), 'images',
                  tuple(batch['image1'].shape))


def external_dataset_hello_world(parquet_url):
    """Read any Parquet store (no petastorm metadata) column-wise."""
    with make_batch_reader(parquet_url, num_epochs=1) as reader:
        for batch in reader:
            print('columns:', batch._fields, 'rows:', len(batch[0]))


if __name__ == '__main__':
    url = 'file://' + tempfile.mkdtemp() + '/hello_world'
    generate_petastorm_tpu_dataset(url)
    python_hello_world(url)
    torch_hello_world(url)
