"""Mesh construction, sharding records and the ranks' transport.

The port's counterpart of ``petastorm_tpu/parallel/mesh.py``. A JAX mesh
is an array of devices driven by one program; a torch mesh is one process
a device over ``torch.distributed``, each process holding its shard of
every sharded array. The axis vocabulary is JAX's:

- ``data``  data parallelism (batch dim)
- ``seq``   sequence parallelism (ring attention)
- ``model`` tensor parallelism; ``pipe`` pipeline stages; ``expert``
  expert parallelism (not ported yet: the port's model raises on them)

- :func:`make_mesh` builds a ``torch.distributed.device_mesh.DeviceMesh``
  with the axes in dict order over the initialised process group; a
  product of sizes other than the world size raises with JAX's words.
- :func:`host_shard` is JAX's ``(process_index, process_count)``: this
  rank and the world size, ``(0, 1)`` without a process group.
- :class:`NamedSharding` (:func:`batch_sharding`,
  :func:`replicated_sharding`) says which slice of a global array this rank
  holds; :func:`gather_global` assembles the global array from the ranks'
  shards.
- The transport (:func:`ring_shift`, :func:`all_reduce_sum_`,
  :func:`all_gather`, :func:`broadcast_`) moves tensors between the ranks
  of a group: device tensors directly over NCCL, CPU tensors directly over
  gloo, and CUDA tensors over gloo through pinned host memory (several
  ranks on one card cannot form a NCCL group). :data:`TRANSPORT_STATS`
  counts the bytes and host seconds of each route.

Nothing here imports torch when the module is imported: the reader
factories resolve ``shard_by_jax_process`` through :func:`host_shard`.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, Optional, Tuple

#: Bytes sent and host seconds per transport route since
#: :func:`reset_transport_stats`: ``'nccl'`` (device tensors over NCCL),
#: ``'gloo'`` (CPU tensors) and ``'gloo-host'`` (CUDA tensors staged
#: through pinned host memory for a gloo group).
TRANSPORT_STATS: Dict[str, Dict[str, float]] = {}


def reset_transport_stats() -> None:
    TRANSPORT_STATS.clear()


def _account(route: str, nbytes: int, seconds: float) -> None:
    entry = TRANSPORT_STATS.setdefault(route, {'bytes': 0, 'seconds': 0.0})
    entry['bytes'] += int(nbytes)
    entry['seconds'] += seconds


def _dist():
    import torch.distributed as dist
    return dist


def make_mesh(axis_sizes: Dict[str, int], device_type: Optional[str] = None):
    """A ``DeviceMesh`` with named axes over the initialised process group
    (one process a device; see :func:`petastorm_tpu_torch.parallel.launch.
    launch_ranks`). ``axis_sizes`` maps axis name to size in dict order;
    the product must equal the world size. ``device_type`` is ``'cuda'``
    unless the caller asks for ``'cpu'`` (without CUDA, ``'cuda'`` raises).

    >>> mesh = make_mesh({'data': 2, 'seq': 2})
    """
    from petastorm_tpu_torch.device import resolve_device
    device_type = resolve_device(device_type).type
    dist = _dist()
    sizes = [int(s) for s in axis_sizes.values()]
    total = int(math.prod(sizes)) if sizes else 1
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if total != world:
        raise ValueError('Mesh axes {} require {} devices, got {}'.format(
            axis_sizes, total, world))
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs an initialised torch.distributed '
                           'process group (one process a device); start the '
                           'ranks with petastorm_tpu_torch.parallel.'
                           'launch_ranks or init_process_group')
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(axis_sizes))


def host_shard() -> Tuple[int, int]:
    """``(cur_shard, shard_count)`` of this rank: its rank and the world
    size, or ``(0, 1)`` without a process group (JAX's ``process_index()``
    and ``process_count()`` in one process). Each rank reads only its own
    row-group shard."""
    dist = sys.modules.get('torch.distributed')
    if (dist is None or not dist.is_available()
            or not dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


# ---------------------------------------------------------------------------
# axes of a mesh
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis``; 1 when the mesh has no such axis."""
    names = axis_names(mesh)
    return int(mesh.shape[names.index(axis)]) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``; 0 when the mesh has no such
    axis."""
    if axis not in axis_names(mesh):
        return 0
    return int(mesh.get_local_rank(axis))


# ---------------------------------------------------------------------------
# sharding records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Which slice of a global array this rank holds (JAX's
    ``NamedSharding(mesh, PartitionSpec(*spec))``): dim ``i`` is split over
    mesh axis ``spec[i]`` (``None``, or a dim past the spec, is
    replicated), this rank taking the block at its coordinate on that
    axis. An axis the mesh lacks is replicated."""
    mesh: object
    spec: Tuple[Optional[str], ...] = ()

    def shard_slices(self, global_shape) -> Tuple[slice, ...]:
        """The slice of each dim of ``global_shape`` this rank holds;
        raises when a sharded dim does not split evenly."""
        out = []
        for dim, n in enumerate(global_shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            size = axis_size(self.mesh, axis) if axis else 1
            if n % size:
                raise ValueError(
                    'dim {} of global shape {} must divide evenly over the '
                    "{} devices of mesh axis '{}'".format(
                        dim, tuple(global_shape), size, axis))
            step = n // size
            start = axis_index(self.mesh, axis) * step if axis else 0
            out.append(slice(start, start + step))
        return tuple(out)


def batch_sharding(mesh, batch_axis: str = 'data') -> NamedSharding:
    """Dim 0 split over ``batch_axis``, the other dims replicated."""
    return NamedSharding(mesh, (batch_axis,))


def replicated_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def gather_global(x, sharding: NamedSharding):
    """The global array of which ``x`` is this rank's shard under
    ``sharding``: the shards of each split dim all-gathered over that
    axis's group and concatenated in coordinate order (every rank gets the
    whole array). For checks and tests; the train step never calls it."""
    import torch
    for dim, axis in enumerate(sharding.spec):
        if axis is None or axis_size(sharding.mesh, axis) == 1:
            continue
        parts = all_gather(x, sharding.mesh.get_group(axis))
        x = torch.cat(parts, dim=dim)
    return x


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------

def _route(group, tensor) -> str:
    backend = _dist().get_backend(group)
    if backend == 'nccl':
        return 'nccl'
    return 'gloo-host' if tensor.is_cuda else 'gloo'


def _to_host(buf):
    """A pinned host copy of the CUDA byte buffer ``buf``."""
    import torch
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf)
    return host


def _pack(tensors):
    """One flat uint8 buffer of the tensors' bytes, and how to split it."""
    import torch
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    return torch.cat(flat) if len(flat) > 1 else flat[0], [
        (t.shape, t.dtype, t.numel() * t.element_size()) for t in tensors]


def _unpack(buf, layout):
    out, at = [], 0
    for shape, dtype, nbytes in layout:
        out.append(buf[at:at + nbytes].view(dtype).reshape(shape))
        at += nbytes
    return out


def ring_shift(tensors, group=None):
    """Send ``tensors`` to the next rank of ``group`` (the default group
    when None) and return those received from the previous one, in one
    message: rank ``i`` of the group sends to ``i + 1`` and receives from
    ``i - 1`` (mod the group size). A group of one returns ``tensors``."""
    dist = _dist()
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt, prv = ((dist.get_global_rank(group, r) if group is not None else r)
                for r in ((me + 1) % n, (me - 1) % n))
    start = time.perf_counter()
    buf, layout = _pack(tensors)
    route = _route(group, buf)
    device = buf.device
    if route == 'gloo-host':
        buf = _to_host(buf)
    recv = buf.new_empty(buf.shape)
    if route == 'nccl':      # one NCCL group call: no send-send deadlock
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.irecv, recv, prv, group),
            dist.P2POp(dist.isend, buf, nxt, group)])
    else:
        reqs = [dist.irecv(recv, prv, group=group),
                dist.isend(buf, nxt, group=group)]
    for req in reqs:
        req.wait()
    if route == 'gloo-host':
        recv = recv.to(device, non_blocking=True)
    _account(route, buf.numel(), time.perf_counter() - start)
    return _unpack(recv, layout)


def all_reduce_sum_(tensors, group=None):
    """Sum ``tensors`` in place over the ranks of ``group`` (float32, one
    packed buffer), so every rank holds the same values."""
    import torch
    dist = _dist()
    if dist.get_world_size(group) == 1 or not tensors:
        return tensors
    start = time.perf_counter()
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    route = _route(group, flat)
    work = _to_host(flat) if route == 'gloo-host' else flat
    dist.all_reduce(work, group=group)
    if route == 'gloo-host':
        flat.copy_(work, non_blocking=True)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    _account(route, flat.numel() * 4, time.perf_counter() - start)
    return tensors


def all_gather(tensor, group=None):
    """The ranks' ``tensor`` (equal shapes) in group rank order."""
    dist = _dist()
    n = dist.get_world_size(group)
    if n == 1:
        return [tensor]
    start = time.perf_counter()
    x = tensor.contiguous()
    route = _route(group, x)
    work = _to_host(x) if route == 'gloo-host' else x
    parts = [work.new_empty(work.shape) for _ in range(n)]
    dist.all_gather(parts, work, group=group)
    if route == 'gloo-host':
        parts = [p.to(x.device) for p in parts]
    _account(route, x.numel() * x.element_size(), time.perf_counter() - start)
    return parts


def broadcast_(tensors, src: int = 0, group=None):
    """Overwrite ``tensors`` in place with global rank ``src``'s."""
    dist = _dist()
    if dist.get_world_size(group) == 1 or not tensors:
        return tensors
    start = time.perf_counter()
    buf, layout = _pack(tensors)
    route = _route(group, buf)
    work = _to_host(buf) if route == 'gloo-host' else buf.clone()
    dist.broadcast(work, src=src, group=group)
    for t, got in zip(tensors, _unpack(work.to(buf.device), layout)):
        t.copy_(got)
    _account(route, buf.numel(), time.perf_counter() - start)
    return tensors
