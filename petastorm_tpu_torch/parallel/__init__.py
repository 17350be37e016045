"""Data and sequence parallelism of the port.

Counterpart of ``petastorm_tpu/parallel``: the mesh and its sharding
records (:mod:`~petastorm_tpu_torch.parallel.mesh`), ring attention over
the ``seq`` axis running K1-K3 per chunk pair
(:mod:`~petastorm_tpu_torch.parallel.ring`), and the launcher that starts
a program's ranks on one host (:mod:`~petastorm_tpu_torch.parallel.launch`).
A torch mesh is one process a device over ``torch.distributed``; JAX's
``shard_map_fn`` has no counterpart (each rank runs its shard's program).
Tensor, expert and pipeline parallelism are not ported yet.
"""

from petastorm_tpu_torch.parallel.launch import launch_ranks
from petastorm_tpu_torch.parallel.mesh import (batch_sharding, host_shard,
                                               make_mesh,
                                               replicated_sharding)
from petastorm_tpu_torch.parallel.ring import ring_attention

__all__ = ['make_mesh', 'host_shard', 'batch_sharding', 'replicated_sharding',
           'ring_attention', 'launch_ranks']
