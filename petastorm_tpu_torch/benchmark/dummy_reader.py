"""Loader micro-benchmark over a zero-I/O dummy reader (JAX
``benchmark/dummy_reader.py``): the consumer-side cost of
:class:`~petastorm_tpu_torch.torch_utils.TorchDataLoader` and
:class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader` at several batch
sizes, with storage and decode out of the picture.

Usage::

    python -m petastorm_tpu_torch.benchmark.dummy_reader [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

BenchmarkSchema = Unischema('BenchmarkSchema', [
    UnischemaField('int_col', np.int64, (), ScalarCodec(), False),
    UnischemaField('float_col', np.float64, (), ScalarCodec(), False),
    UnischemaField('vector', np.float32, (64,), NdarrayCodec(), False),
])


class DummyBatchReader(object):
    """Batched reader yielding a constant pre-built column batch."""

    def __init__(self, chunk_size: int = 1000, num_chunks: int = 100):
        self.schema = BenchmarkSchema
        self.ngram = None
        self.batched_output = True
        self.last_row_consumed = False
        self._num_chunks = num_chunks
        self._produced = 0
        self._chunk = self.schema.make_batch_namedtuple(
            int_col=np.arange(chunk_size, dtype=np.int64),
            float_col=np.random.default_rng(0).random(chunk_size),
            vector=np.zeros((chunk_size, 64), np.float32))

    def __iter__(self):
        return self

    def __next__(self):
        if self._produced >= self._num_chunks:
            self.last_row_consumed = True
            raise StopIteration
        self._produced += 1
        return self._chunk

    def reset(self):
        self._produced = 0
        self.last_row_consumed = False

    def stop(self):
        pass

    def join(self):
        pass


def _measure(make_loader, label: str, rows_total: int) -> float:
    start = time.perf_counter()
    count = 0
    for batch in make_loader():
        first = batch[next(iter(batch))]
        count += len(first)
    elapsed = time.perf_counter() - start
    rate = count / elapsed
    print('{:>24}: {:>12.0f} samples/sec ({} rows)'.format(label, rate, count))
    return rate


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Loader cost over a zero-I/O dummy reader')
    parser.add_argument('--device', default='cuda',
                        help="where batches are meant for: 'cuda' (the "
                             "default; raises without CUDA) or 'cpu'")
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(args.device,
                                'python -m petastorm_tpu_torch.benchmark.'
                                'dummy_reader')
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    from petastorm_tpu_torch.torch_utils import TorchDataLoader

    for batch_size in (10, 100, 1000, 10000):
        reader = DummyBatchReader()
        rows = 1000 * 100
        _measure(lambda: TorchDataLoader(reader, batch_size=batch_size,
                                         device=device),
                 'TorchDataLoader bs={}'.format(batch_size), rows)
        reader2 = DummyBatchReader()
        _measure(lambda: BatchedDataLoader(reader2, batch_size=batch_size,
                                           device=device),
                 'BatchedDataLoader bs={}'.format(batch_size), rows)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
