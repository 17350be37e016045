"""petastorm_tpu_torch: the PyTorch / CUDA port of petastorm_tpu.

The port runs the data plane (Parquet store → NGram, columnar, row or batch
reader, with predicates, filters, sharding and row-group selectors → torch
loader, with ragged padding, epoch caches and per-step goodput → device
staging, with fixed-shape ``NdarrayCodec`` columns decoded on the device
and a thread, process or in-line worker pool) and three models on an
NVIDIA GPU: the flagship transformer LM
(dense or mixture-of-experts, grouped-query attention, packed documents
through :mod:`petastorm_tpu_torch.packing`), with the attention forward and
backward on hand-written CUDA kernels; the image CNN, whose input normalisation is a
hand-written CUDA kernel; and the MNIST MLP. It imports ``torch`` and never
``jax`` or the JAX package. Entry points run on the CUDA device unless the
caller passes ``device='cpu'``.

Every item a reader yields carries sample lineage (provenance, the
coverage audit, replay, and bad-sample quarantine under
``on_decode_error``; :mod:`petastorm_tpu_torch.lineage`).

Public API: :func:`make_reader`, :func:`make_columnar_reader`,
:func:`make_batch_reader`, :func:`materialize_dataset`,
:class:`TransformSpec`, :class:`NoDataAvailableError`,
:class:`TorchDataLoader`, :func:`make_torch_loader`,
:func:`prefetch_to_device`, :func:`flash_attention`, :func:`normalize_images`,
:class:`CoverageAuditor`, :class:`Provenance`, :class:`SharedRowGroupCache`,
:class:`LatencyHistogram`, :class:`SLOMonitor`, :class:`RetryPolicy`,
:class:`HedgedRead`, :class:`FaultInjector`, :class:`PipelineController`,
:func:`make_indexed_loader`, :func:`make_indexed_ngram_loader`,
:class:`WeightedIndexedMixture`, :class:`PodObserver`,
:class:`ElasticPodSim`, :class:`PodMembership`, :class:`LeasePlan`,
:func:`make_mesh`, :func:`host_shard`, :func:`batch_sharding`,
:func:`replicated_sharding`, :func:`ring_attention`, :func:`launch_ranks`,
:class:`ShardedTorchLoader`, :func:`make_dataset_converter`.

The stats, latency and tracing planes: ``reader.stats``,
``reader.diagnostics``, ``reader.latency``, ``reader.tracer`` and
``reader.slo`` (:mod:`petastorm_tpu_torch.workers.stats`,
:mod:`petastorm_tpu_torch.latency`, :mod:`petastorm_tpu_torch.tracing`).

Remote stores: the factories take ``s3://``, ``gs://``, ``hdfs://`` and
``memory://`` URLs with ``storage_options``, and ``remote_read`` picks
the workers' read plane (``'serial'``, ``'prebuffer'`` or ``'ranged'``;
:mod:`petastorm_tpu_torch.fs`, :mod:`petastorm_tpu_torch.objectstore`);
the shared cache's ``peers`` form a pod of cache roots
(:mod:`petastorm_tpu_torch.sharedcache`).

Fault tolerance: the factories' ``retry`` (on), ``hedge`` (off) and
``worker_recovery`` (on), and the seeded fault injector armed by
``PETASTORM_TPU_CHAOS`` (:mod:`petastorm_tpu_torch.resilience`,
:mod:`petastorm_tpu_torch.faultfs`).

Deterministic resume and mixing: the indexed row and NGram loaders, whose
batch ``b`` of epoch ``e`` is a pure function of ``(dataset, seed, e, b)``
(``state_dict()`` / ``load_state_dict()`` restore in O(1), byte for byte,
with any worker count; :mod:`petastorm_tpu_torch.indexed`,
:mod:`petastorm_tpu_torch.indexed_ngram`); their weighted mixture
(:mod:`petastorm_tpu_torch.indexed_mixture`); the streaming mixture
(:mod:`petastorm_tpu_torch.weighted_sampling_reader`); and the replay
fallback for streaming pipelines (:mod:`petastorm_tpu_torch.checkpoint`).

The pod planes: each reader's debug endpoint serves its host's
``/observe/snapshot``, and a :class:`PodObserver` merges a pod's
snapshots into one report (``/podmetrics``, ``petastorm-tpu-torch-podstat``;
:mod:`petastorm_tpu_torch.podobs`); shard leases that move when a host
dies or joins, with an exactly-once certificate, and the factories'
``elastic=`` (:mod:`petastorm_tpu_torch.podelastic`).

Data and sequence parallelism, one process a device
(:mod:`petastorm_tpu_torch.parallel`): the mesh and its sharding records,
ring attention running the attention kernels per chunk pair, the rank
launcher, ``shard_by_jax_process`` on the factories, the sharded streaming
loader (``make_torch_loader(mesh=)``, :class:`ShardedTorchLoader`, with
its lockstep stop and ``Reader.drain``), the sharded indexed loaders
(``mesh=`` on both factories) and the LM's train step on a ``{'data',
'seq'}`` mesh.

Adapters and tools: the PyTorch ``DataLoader`` and ``BatchedDataLoader``
(:mod:`petastorm_tpu_torch.pytorch`), the dataset converter
(:func:`make_dataset_converter`, :mod:`petastorm_tpu_torch.converter`),
the TensorFlow dataset (:mod:`petastorm_tpu_torch.tf_utils`), the console
tools ``petastorm-tpu-torch-copy-dataset``,
``petastorm-tpu-torch-generate-metadata`` and
``petastorm-tpu-torch-metadata``, and the codec extension surface
(:class:`~petastorm_tpu_torch.codecs.DataframeColumnCodec`,
:func:`~petastorm_tpu_torch.codecs.register_codec`).
"""

__version__ = '0.1.0'

__all__ = ['make_reader', 'make_columnar_reader', 'make_batch_reader',
           'materialize_dataset', 'TransformSpec', 'NoDataAvailableError',
           'TorchDataLoader', 'make_torch_loader', 'prefetch_to_device',
           'flash_attention', 'normalize_images', 'CoverageAuditor',
           'Provenance', 'SharedRowGroupCache', 'LatencyHistogram',
           'SLOMonitor', 'RetryPolicy', 'HedgedRead', 'FaultInjector',
           'PipelineController', 'make_indexed_loader',
           'make_indexed_ngram_loader', 'WeightedIndexedMixture',
           'PodObserver', 'ElasticPodSim', 'PodMembership', 'LeasePlan',
           'make_mesh', 'host_shard', 'batch_sharding',
           'replicated_sharding', 'ring_attention', 'launch_ranks',
           'ShardedTorchLoader', 'make_dataset_converter', '__version__']


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
    if name in ('make_mesh', 'host_shard', 'batch_sharding',
                'replicated_sharding', 'ring_attention', 'launch_ranks'):
        from petastorm_tpu_torch import parallel
        return getattr(parallel, name)
    if name in ('TorchDataLoader', 'make_torch_loader', 'prefetch_to_device',
                'ShardedTorchLoader'):
        from petastorm_tpu_torch import torch_utils
        return getattr(torch_utils, name)
    if name in ('CoverageAuditor', 'Provenance'):
        from petastorm_tpu_torch import lineage
        return getattr(lineage, name)
    if name == 'SharedRowGroupCache':
        from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
        return SharedRowGroupCache
    if name in ('LatencyHistogram', 'SLOMonitor'):
        from petastorm_tpu_torch import latency
        return getattr(latency, name)
    if name in ('RetryPolicy', 'HedgedRead'):
        from petastorm_tpu_torch import resilience
        return getattr(resilience, name)
    if name == 'FaultInjector':
        from petastorm_tpu_torch.faultfs import FaultInjector
        return FaultInjector
    if name == 'PipelineController':
        from petastorm_tpu_torch.autotune import PipelineController
        return PipelineController
    if name == 'make_indexed_loader':
        from petastorm_tpu_torch.indexed import make_indexed_loader
        return make_indexed_loader
    if name == 'make_indexed_ngram_loader':
        from petastorm_tpu_torch.indexed_ngram import \
            make_indexed_ngram_loader
        return make_indexed_ngram_loader
    if name == 'WeightedIndexedMixture':
        from petastorm_tpu_torch.indexed_mixture import \
            WeightedIndexedMixture
        return WeightedIndexedMixture
    if name == 'PodObserver':
        from petastorm_tpu_torch.podobs import PodObserver
        return PodObserver
    if name in ('ElasticPodSim', 'PodMembership', 'LeasePlan'):
        from petastorm_tpu_torch import podelastic
        return getattr(podelastic, name)
    if name == 'make_dataset_converter':
        from petastorm_tpu_torch.converter import make_dataset_converter
        return make_dataset_converter
    if name == 'flash_attention':
        from petastorm_tpu_torch.ops.attention import flash_attention
        return flash_attention
    raise AttributeError('module {!r} has no attribute {!r}'.format(
        __name__, name))
