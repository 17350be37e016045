"""North-star benchmark (JAX ``benchmark/northstar.py``): **samples/sec and
the infeed-stall share** of real train steps fed from Parquet.

The workloads run the port's production path ``make_reader`` /
``make_columnar_reader`` -> ``TorchDataLoader`` -> ``prefetch_to_device``
(or :func:`~petastorm_tpu_torch.torch_utils.prefetch_batches`) -> a train
step on ``device``:

- ``mnist``: png-compressed 28x28 images decoded by the worker pool,
  feeding an MLP classifier: the decode-heavy regime where infeed stalls
  live.
- ``imagenet``: realistic-size images decoded and resized by the workers,
  feeding the residual CNN (its input normalisation is kernel K4 on a CUDA
  device).
- ``transformer``: int32 token windows feeding the flagship transformer
  LM, at ``TransformerConfig``'s default attention (``'blockwise'``, as
  JAX's bench): the compute-heavy regime where the pipeline must keep up.
  The NGram pair feeds it windows of timestep chunks, assembled by the
  streaming reader or by the indexed window loader.

Initial weights come from a ``torch.Generator`` seeded with 0. Every entry
point runs on the CUDA device unless the caller passes ``device='cpu'``.
The stall accounting is :mod:`petastorm_tpu_torch.benchmark.infeed`'s.
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.benchmark.infeed import (InfeedReport,
                                                  attach_sync_probe,
                                                  measure_infeed_overlap)
from petastorm_tpu_torch.codecs import (ArrowListCodec, CompressedImageCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

MnistImageSchema = Unischema('MnistImageSchema', [
    UnischemaField('idx', np.int64, (), ScalarCodec(), False),
    UnischemaField('image', np.uint8, (28, 28), CompressedImageCodec('png'), False),
    UnischemaField('label', np.int64, (), ScalarCodec(), False),
])

#: Seed of the benches' initial weights.
WEIGHTS_SEED = 0


def generate_mnist_images_dataset(output_url: str, rows: int = 16384,
                                  seed: int = 0,
                                  row_group_size_mb: float = 0.5) -> str:
    """Synthetic MNIST-shaped dataset: png images + labels.

    Small row groups by default: a row group is the unit of worker
    parallelism, and tiny-png groups must outnumber the decode workers."""
    rng = np.random.default_rng(seed)

    def gen():
        for i in range(rows):
            yield {'idx': np.int64(i),
                   'image': rng.integers(0, 255, size=(28, 28), dtype=np.uint8),
                   'label': np.int64(i % 10)}

    with materialize_dataset(output_url, MnistImageSchema,
                             row_group_size_mb=row_group_size_mb) as writer:
        writer.write_rows(gen())
    return output_url


def make_token_schema(seq_len: int, ndarray_codec: bool = False) -> Unischema:
    # arrow_list: token windows decode vectorized in C++ (no per-row
    # np.load). ndarray_codec=True stores np.save payloads instead: the
    # layout the device decode plans (fixed-shape NdarrayCodec)
    from petastorm_tpu_torch.codecs import NdarrayCodec
    codec = NdarrayCodec() if ndarray_codec else ArrowListCodec()
    return Unischema('TokenSchema', [
        UnischemaField('tokens', np.int32, (seq_len + 1,), codec, False),
    ])


def generate_token_dataset(output_url: str, rows: int = 2048,
                           seq_len: int = 256, vocab: int = 8192,
                           seed: int = 0,
                           row_group_size_mb: float = 4.0,
                           ndarray_codec: bool = False) -> str:
    """LM token windows: each row holds seq_len+1 tokens (input + shifted
    target), the shape the NGram pipeline emits for next-token training."""
    rng = np.random.default_rng(seed)
    schema = make_token_schema(seq_len, ndarray_codec=ndarray_codec)

    def gen():
        for _ in range(rows):
            yield {'tokens': rng.integers(0, vocab, size=(seq_len + 1,),
                                          dtype=np.int32)}

    with materialize_dataset(output_url, schema,
                             row_group_size_mb=row_group_size_mb) as writer:
        writer.write_rows(gen())
    return output_url


def _default_workers() -> int:
    import os
    return min(8, max(2, os.cpu_count() or 2))


def _weights_generator():
    import torch
    return torch.Generator().manual_seed(WEIGHTS_SEED)


def _make_mnist_step(hidden: int, device):
    from petastorm_tpu_torch.models import mnist_mlp

    params = mnist_mlp.init(_weights_generator(), hidden=hidden,
                            device=device)

    def step_fn(batch):
        images = batch['image'].to(device, non_blocking=True)
        images = images.reshape(images.shape[0], -1).float() / 255.0
        labels = batch['label'].to(device, non_blocking=True)
        return mnist_mlp.train_step(params, images, labels, lr=1e-3)

    return step_fn


def _make_image_step(num_classes: int, device):
    from petastorm_tpu_torch.models import image_cnn

    params = image_cnn.init(_weights_generator(), num_classes=num_classes,
                            device=device)
    step = image_cnn.make_train_step(params)

    def step_fn(batch):
        return step(batch['image'].to(device, non_blocking=True),
                    batch['label'].to(device, non_blocking=True))

    return step_fn


#: Train benches bound the pool's results queue to this many row-group chunks.
#: The default (50) lets workers pre-decode tens of thousands of rows during
#: warmup; a short measured window then partially drains pre-decoded buffers
#: and reads ABOVE the pipeline's true rate. A small bound keeps the measured
#: window steady-state.
_TRAIN_BENCH_QUEUE_CHUNKS = 4


def run_mnist_train_bench(dataset_url: str, batch_size: int = 512,
                          num_steps: int = 120, warmup_steps: int = 5,
                          workers_count: int = None, hidden: int = 2048,
                          prefetch: int = 4, device=None) -> InfeedReport:
    """Train the MLP from parquet png images, decoding every epoch from disk;
    report overlap + samples/sec (the decode-bound regime)."""
    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 prefetch_to_device)

    device = resolve_device(device)
    step_fn = _make_mnist_step(hidden, device)
    with make_columnar_reader(dataset_url, reader_pool_type='thread',
                              workers_count=workers_count or _default_workers(),
                              results_queue_size=_TRAIN_BENCH_QUEUE_CHUNKS,
                              num_epochs=None) as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size,
                                 drop_last=True, device=device)
        batches = prefetch_to_device(iter(loader), size=prefetch,
                                     device=device)
        return measure_infeed_overlap(
            batches, step_fn, num_steps=num_steps, warmup_steps=warmup_steps,
            count_fn=lambda b: int(b['label'].shape[0]))


def _shared_cache_kwargs(cache_dir: str) -> dict:
    """Reader kwargs for the host-wide tiered shared cache: the cached
    north-star lines ride ``cache_type='shared'``. The shared-memory tier is
    pointed inside the bench scratch so an aborted run leaves nothing behind
    in ``/dev/shm``."""
    import os
    return dict(cache_type='shared', cache_location=cache_dir,
                cache_size_limit=20 * 2**30,
                cache_extra_settings={
                    'mem_dir': os.path.join(cache_dir, 'mem')})


def run_mnist_cached_train_bench(dataset_url: str, rows: int,
                                 batch_size: int = 512,
                                 num_steps: int = 60,
                                 workers_count: int = None,
                                 hidden: int = 2048,
                                 prefetch: int = 4,
                                 cache_location: str = None,
                                 device=None) -> InfeedReport:
    """Steady-state epochs with the device-side epoch cache: epoch 1 decodes
    from parquet and stages every batch onto ``device``; epochs 2+ replay
    the device tensors with zero host work
    (:func:`~petastorm_tpu_torch.torch_utils.epoch_cache_on_device`).
    Warmup spans the whole first epoch so the measured window is pure steady
    state. The fill epoch's reader publishes its decoded row groups into the
    host-wide shared cache (``cache_type='shared'``) so concurrent readers
    of the same store skip the decode the device cache already paid."""
    import tempfile

    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 epoch_cache_on_device)

    device = resolve_device(device)
    step_fn = _make_mnist_step(hidden, device)
    cache_dir = cache_location or tempfile.mkdtemp(
        prefix='petastorm_tpu_mnist_shared_cache_')
    try:
        with make_columnar_reader(dataset_url, reader_pool_type='thread',
                                  workers_count=(workers_count
                                                 or _default_workers()),
                                  num_epochs=1,
                                  **_shared_cache_kwargs(cache_dir)) as reader:
            loader = TorchDataLoader(reader, batch_size=batch_size,
                                     drop_last=True, device=device)
            # Warmup must span the entire cache-fill epoch (plus a couple
            # of steps) so the measured window replays device tensors only.
            steps_per_epoch = max(1, rows // batch_size)
            batches = epoch_cache_on_device(loader, device=device)
            return measure_infeed_overlap(
                batches, step_fn, num_steps=num_steps,
                warmup_steps=steps_per_epoch + 2,
                count_fn=lambda b: int(b['label'].shape[0]))
    finally:
        if cache_location is None:
            import shutil
            shutil.rmtree(cache_dir, ignore_errors=True)


def generate_imagenet_dataset(output_url: str, rows: int = 256,
                              classes: int = 16, seed: int = 0,
                              row_group_size_mb: float = 8.0,
                              image_codec: str = 'png') -> str:
    """Synthetic ImageNet-style dataset at realistic sizes (~500x375),
    via the port's imagenet example. ``image_codec='jpeg'`` matches real
    ImageNet files and enables DCT-scaled decode hints."""
    from petastorm_tpu_torch.examples.imagenet import generate_imagenet as gen
    gen.generate(output_url, gen.synthetic_rows(rows, classes=classes, seed=seed),
                 row_group_size_mb=row_group_size_mb, image_codec=image_codec)
    return output_url


def _columnar_throughput(dataset_url: str, workers_count=None,
                         transform_spec=None, decode_hints=None) -> dict:
    """Rows/sec through the vectorized columnar reader (optionally with a
    transform and decode hints).

    A full untimed warmup pass precedes the measurement so the reported
    number is steady state (page cache, codec imports, pool spin-up)."""
    import time

    from petastorm_tpu_torch import make_columnar_reader

    def one_pass() -> dict:
        n = 0
        with make_columnar_reader(
                dataset_url, num_epochs=1, reader_pool_type='thread',
                workers_count=workers_count or _default_workers(),
                transform_spec=transform_spec, decode_hints=decode_hints,
                shuffle_row_groups=False) as reader:
            t0 = time.perf_counter()
            for batch in reader:
                n += len(batch[0])     # any column: row count per batch
            dt = time.perf_counter() - t0
        return {'samples': n, 'samples_per_sec': round(n / dt, 2)}

    one_pass()                         # warmup
    return one_pass()


def run_image_decode_bench(dataset_url: str, workers_count: int = None,
                           image_size: int = 224, decode_hints=None) -> dict:
    """Pure pipeline throughput: image decode + resize on the worker pool, no
    accelerator involved. Returns {'samples_per_sec': ...}."""
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    return _columnar_throughput(dataset_url, workers_count,
                                make_resize_transform(image_size),
                                decode_hints=decode_hints)


def run_imagenet_train_bench(dataset_url: str, batch_size: int = 32,
                             num_steps: int = 100, warmup_steps: int = 3,
                             workers_count: int = None, num_classes: int = 16,
                             prefetch: int = 4,
                             image_size: int = 224,
                             decode_hints=None, device=None) -> InfeedReport:
    """Train the residual CNN from realistic-size parquet images (worker-side
    decode + resize): the ImageNet-class north-star workload.

    ``decode_hints={'image': {'scale': 2}}`` on a jpeg store decodes at half
    resolution during entropy decode; on png stores hints are a no-op."""
    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 prefetch_to_device)

    device = resolve_device(device)
    step_fn = _make_image_step(num_classes, device)
    with make_columnar_reader(dataset_url, num_epochs=None,
                              reader_pool_type='thread',
                              workers_count=workers_count or _default_workers(),
                              results_queue_size=_TRAIN_BENCH_QUEUE_CHUNKS,
                              transform_spec=make_resize_transform(image_size),
                              decode_hints=decode_hints,
                              ) as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size,
                                 drop_last=True, device=device)
        batches = prefetch_to_device(iter(loader), size=prefetch,
                                     device=device)
        return measure_infeed_overlap(
            batches, step_fn, num_steps=num_steps, warmup_steps=warmup_steps,
            count_fn=lambda b: int(b['label'].shape[0]))


def run_imagenet_cached_train_bench(dataset_url: str, rows: int,
                                    batch_size: int = 32,
                                    num_steps: int = 120,
                                    workers_count: int = None,
                                    num_classes: int = 16,
                                    prefetch: int = 4,
                                    image_size: int = 224,
                                    decode_hints=None,
                                    cache_location: str = None,
                                    device=None) -> InfeedReport:
    """ImageNet-class training with the host-wide tiered shared cache, the
    epoch >= 2 story for stores too big for device memory on a decode-poor
    host. Epoch 1 decodes + resizes and the columnar worker publishes the
    post-transform columns into the shared decoded tier (``cache_type=
    'shared'``: shm segments + disk spill); epochs 2+ skip png/jpeg decode
    AND resize entirely. Warmup spans the whole fill epoch so the measured
    window replays cache only."""
    import tempfile

    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 prefetch_to_device)

    device = resolve_device(device)
    step_fn = _make_image_step(num_classes, device)
    cache_dir = cache_location or tempfile.mkdtemp(
        prefix='petastorm_tpu_imagenet_cache_')
    try:
        with make_columnar_reader(dataset_url, num_epochs=None,
                                  reader_pool_type='thread',
                                  workers_count=(workers_count
                                                 or _default_workers()),
                                  results_queue_size=_TRAIN_BENCH_QUEUE_CHUNKS,
                                  transform_spec=make_resize_transform(
                                      image_size),
                                  decode_hints=decode_hints,
                                  **_shared_cache_kwargs(cache_dir)) as reader:
            loader = TorchDataLoader(reader, batch_size=batch_size,
                                     drop_last=True, device=device)
            batches = prefetch_to_device(iter(loader), size=prefetch,
                                         device=device)
            steps_per_epoch = max(1, rows // batch_size)
            return measure_infeed_overlap(
                batches, step_fn, num_steps=num_steps,
                warmup_steps=steps_per_epoch + 4,
                count_fn=lambda b: int(b['label'].shape[0]))
    finally:
        if cache_location is None:
            # a defaulted temp cache is per-run scratch
            import shutil
            shutil.rmtree(cache_dir, ignore_errors=True)


def _make_lm_step(config, device, prepare=None):
    """``step_fn(batch) -> loss`` of the flagship LM's AdamW step on
    ``device``; ``prepare(batch)`` gives the ``(B, L + 1)`` token tensor
    (default ``batch['tokens']``), which the step moves to the device and
    shifts into inputs and targets."""
    from petastorm_tpu_torch.models import transformer_lm as tlm

    params = tlm.init(config, _weights_generator(), device=device)
    _, step = tlm.make_train_step(config, params)

    def step_fn(batch):
        tokens = prepare(batch) if prepare is not None else batch['tokens']
        tokens = tokens.to(device, non_blocking=True).long()
        return step(tokens[:, :-1], tokens[:, 1:])

    return step_fn


def run_transformer_train_bench(dataset_url: str, batch_size: int = 64,
                                num_steps: int = 40, warmup_steps: int = 3,
                                workers_count: int = None, prefetch: int = 8,
                                d_model: int = 256, n_layers: int = 4,
                                n_heads: int = 8, d_ff: int = 1024,
                                seq_len: int = 256, vocab: int = 8192,
                                dispatch_ahead: int = 2,
                                device=None) -> InfeedReport:
    """Train the flagship LM from parquet token windows.

    Batches prefetch on the host (``prefetch_batches``: no side stream, no
    pinning of its own) and the step moves each batch to the device as it
    launches: one hand-off per step. ``dispatch_ahead=2`` measures the loop
    users run (asynchronous launches; see ``measure_infeed_overlap``)."""
    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 prefetch_batches)

    device = resolve_device(device)
    config = tlm.TransformerConfig(vocab_size=vocab, d_model=d_model,
                                   n_heads=n_heads, n_layers=n_layers,
                                   d_ff=d_ff, max_seq_len=seq_len)
    step_fn = _make_lm_step(config, device)

    with make_columnar_reader(dataset_url, reader_pool_type='thread',
                              workers_count=workers_count or _default_workers(),
                              results_queue_size=_TRAIN_BENCH_QUEUE_CHUNKS,
                              num_epochs=None) as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size,
                                 drop_last=True, device=device)
        batches = prefetch_batches(iter(loader), size=prefetch)
        report = measure_infeed_overlap(
            batches, step_fn, num_steps=num_steps, warmup_steps=warmup_steps,
            count_fn=lambda b: int(b['tokens'].shape[0]),
            dispatch_ahead=dispatch_ahead)
        return attach_sync_probe(report, batches, step_fn)


def generate_timeseries_token_dataset(output_url: str, rows: int = 4096,
                                      chunk: int = 64, vocab: int = 8192,
                                      seed: int = 0,
                                      rows_per_group: int = 256) -> str:
    """Timestamped token chunks, the raw material of the NGram LM pipeline.
    Each row is one timestep: ``ts`` orders rows, ``tokens`` holds a
    fixed-size chunk; the NGram reader assembles consecutive rows into
    windows at read time.

    ``rows_per_group`` bounds the windows a single ventilated row group can
    pre-assemble: a row group is the streaming bench's unit of read-ahead,
    and huge groups would let a short measured window be served entirely
    from warmup surplus."""
    rng = np.random.default_rng(seed)
    schema = Unischema('TimeseriesTokens', [
        UnischemaField('ts', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (chunk,), ArrowListCodec(), False),
    ])

    def gen():
        for i in range(rows):
            yield {'ts': np.int64(i),
                   'tokens': rng.integers(0, vocab, size=(chunk,),
                                          dtype=np.int32)}

    with materialize_dataset(output_url, schema, row_group_size_mb=256,
                             rows_per_file=rows_per_group) as writer:
        writer.write_rows(gen())
    return output_url


def _make_ngram_lm_parts(window: int, chunk: int, d_model: int,
                         n_layers: int, n_heads: int, d_ff: int, vocab: int,
                         device):
    """Shared setup for the NGram LM bench pair: the window spec and a
    ``step_fn`` that concatenates a window's timestep chunks on the device
    into one (B, window*chunk) sequence and runs the LM train step on the
    shift-by-one (inputs, targets)."""
    import torch

    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ngram import NGram

    config = tlm.TransformerConfig(vocab_size=vocab, d_model=d_model,
                                   n_heads=n_heads, n_layers=n_layers,
                                   d_ff=d_ff, max_seq_len=window * chunk)
    fields = {0: ['ts', 'tokens']}
    fields.update({i: ['tokens'] for i in range(1, window)})
    ngram = NGram(fields, delta_threshold=1, timestamp_field='ts')

    def concat(batch):
        return torch.cat([torch.as_tensor(batch[i]['tokens']).to(
            device, non_blocking=True) for i in range(window)], dim=1)

    return ngram, _make_lm_step(config, device, prepare=concat)


def run_ngram_transformer_train_bench(dataset_url: str, window: int = 4,
                                      chunk: int = 64, batch_size: int = 64,
                                      num_steps: int = 40,
                                      warmup_steps: int = 8,
                                      workers_count: int = None,
                                      prefetch: int = 8,
                                      d_model: int = 256, n_layers: int = 4,
                                      n_heads: int = 8, d_ff: int = 1024,
                                      vocab: int = 8192,
                                      dispatch_ahead: int = 2,
                                      device=None) -> InfeedReport:
    """The full NGram -> loader -> LM loop: parquet rows -> NGram window
    assembly (``make_reader(schema_fields=NGram(...))``) -> per-timestep
    collated batches (``TorchDataLoader``) -> flagship LM train step."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 prefetch_batches)

    device = resolve_device(device)
    ngram, step_fn = _make_ngram_lm_parts(window, chunk, d_model, n_layers,
                                          n_heads, d_ff, vocab, device)
    # queue bound of 2 window-group chunks: with ~256-row groups that is a
    # few hundred pre-assembled windows of read-ahead, drainable by the
    # warmup steps, so the measured window is steady state
    with make_reader(dataset_url, schema_fields=ngram,
                     reader_pool_type='thread',
                     workers_count=workers_count or _default_workers(),
                     results_queue_size=2,
                     num_epochs=None) as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size,
                                 drop_last=True, device=device)
        batches = prefetch_batches(iter(loader), size=prefetch)
        report = measure_infeed_overlap(
            batches, step_fn, num_steps=num_steps, warmup_steps=warmup_steps,
            count_fn=lambda b: int(b[0]['tokens'].shape[0]),
            dispatch_ahead=dispatch_ahead)
        return attach_sync_probe(report, batches, step_fn,
                                 count_fn=lambda b: int(b[0]['tokens'].shape[0]))


def run_indexed_ngram_transformer_train_bench(
        dataset_url: str, window: int = 4, chunk: int = 64,
        batch_size: int = 64, num_steps: int = 40, warmup_steps: int = 8,
        workers_count: int = None, prefetch: int = 16,
        d_model: int = 256, n_layers: int = 4, n_heads: int = 8,
        d_ff: int = 1024, vocab: int = 8192,
        dispatch_ahead: int = 2, device=None) -> InfeedReport:
    """The resume-capable NGram LM pipeline: the SAME window workload as
    :func:`run_ngram_transformer_train_bench` (matched worker counts), fed
    by the indexed window loader (vectorized per-offset gathers, O(1) exact
    resume) instead of the streaming row-granular assembler. The loader's
    own worker pool is the prefetch pipeline (no extra wrapper); its
    batches are numpy, moved to the device by the step."""
    import math

    from petastorm_tpu_torch.benchmark.infeed import (SYNC_PROBE_STEPS,
                                                      SYNC_PROBE_WARMUP)
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.indexed_ngram import make_indexed_ngram_loader

    device = resolve_device(device)
    ngram, step_fn = _make_ngram_lm_parts(window, chunk, d_model, n_layers,
                                          n_heads, d_ff, vocab, device)
    loader = make_indexed_ngram_loader(
        dataset_url, ngram, batch_size=batch_size, num_epochs=1, seed=0,
        workers_count=workers_count or _default_workers(),
        prefetch_batches=prefetch)
    # one index build: bump the epoch budget on the already-built loader
    # (num_epochs is only consulted when iteration starts); the reserve
    # covers the sync-protocol probe window
    loader.num_epochs = max(1, math.ceil(
        (num_steps + warmup_steps + SYNC_PROBE_STEPS + SYNC_PROBE_WARMUP + 2)
        / loader.batches_per_epoch))
    try:
        batches = iter(loader)
        report = measure_infeed_overlap(
            batches, step_fn, num_steps=num_steps,
            warmup_steps=warmup_steps,
            count_fn=lambda b: int(b[0]['tokens'].shape[0]),
            dispatch_ahead=dispatch_ahead)
        return attach_sync_probe(report, batches, step_fn,
                                 count_fn=lambda b: int(b[0]['tokens'].shape[0]))
    finally:
        loader.close()


def run_columnar_read_bench(dataset_url: str, workers_count: int = None) -> dict:
    """Vectorized columnar decode throughput (rows/sec) over a codec dataset,
    the zero-per-row-Python read path the torch loader feeds from."""
    return _columnar_throughput(dataset_url, workers_count)
