"""Data, sequence, tensor, expert and pipeline parallelism of the port.

Counterpart of ``petastorm_tpu/parallel``: the mesh, its sharding records
and the collectives with a backward (:mod:`~petastorm_tpu_torch.parallel.
mesh`: ``psum``, ``pvary``, ``all_gather_tiled``, ``all_gather_invariant``,
``pmax``, ``ppermute`` over the group of one or more axes), ring attention
over the ``seq`` axis running K1-K3 per chunk pair
(:mod:`~petastorm_tpu_torch.parallel.ring`), GPipe pipelines over the
``pipe`` axis (:mod:`~petastorm_tpu_torch.parallel.pipeline`), the
launcher that starts a program's ranks on one host
(:mod:`~petastorm_tpu_torch.parallel.launch`) and the multi-rank dry run
(:mod:`~petastorm_tpu_torch.parallel.dryrun`). A torch mesh is one process
a device over ``torch.distributed``; JAX's ``shard_map_fn`` has no
counterpart (each rank runs its shard's program). The LM's tensor and
expert parallelism live in :mod:`petastorm_tpu_torch.models.
transformer_lm`.
"""

from petastorm_tpu_torch.parallel.dryrun import dryrun_multichip, factor_axes
from petastorm_tpu_torch.parallel.launch import launch_ranks
from petastorm_tpu_torch.parallel.mesh import (all_gather_invariant,
                                               all_gather_tiled, axes_group,
                                               batch_sharding, host_shard,
                                               make_mesh, pmax, ppermute,
                                               psum, pvary,
                                               replicated_sharding)
from petastorm_tpu_torch.parallel.pipeline import (make_pipeline_fn,
                                                   pipeline_apply)
from petastorm_tpu_torch.parallel.ring import ring_attention

__all__ = ['make_mesh', 'host_shard', 'batch_sharding', 'replicated_sharding',
           'ring_attention', 'launch_ranks']
