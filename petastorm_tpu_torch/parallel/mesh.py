"""Mesh construction, sharding records and the ranks' transport.

The port's counterpart of ``petastorm_tpu/parallel/mesh.py``. A JAX mesh
is an array of devices driven by one program; a torch mesh is one process
a device over ``torch.distributed``, each process holding its shard of
every sharded array. The axis vocabulary is JAX's:

- ``data``  data parallelism (batch dim)
- ``seq``   sequence parallelism (ring attention)
- ``model`` tensor parallelism (heads, d_ff and vocabulary blocks)
- ``pipe``  pipeline stages (:mod:`petastorm_tpu_torch.parallel.pipeline`)
- ``expert`` expert parallelism (MoE expert blocks)

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
- The collectives with a backward (JAX's words where JAX has them) run
  over the group of one or more mesh axes (:func:`axes_group`):
  :func:`pvary` and :func:`psum` are the pair Megatron calls f and g
  (identity forward with a sum backward; a sum forward with an identity
  backward), :func:`all_gather_tiled` gathers along a dim with a
  reduce-scatter backward and :func:`all_gather_invariant` with a slice
  backward, :func:`pmax` takes a maximum (no gradient), and
  :func:`ppermute` shifts to the next rank of the group with a backward
  that shifts the gradient to the previous one. Each is the identity
  when the axes' group has one rank.

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


def ring_shift(tensors, group=None, shift: int = 1):
    """Send ``tensors`` to the next rank of ``group`` (the default group
    when None) and return those received from the previous one, in one
    message: rank ``i`` of the group sends to ``i + shift`` and receives
    from ``i - shift`` (mod the group size). A group of one returns
    ``tensors``."""
    dist = _dist()
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt, prv = ((dist.get_global_rank(group, r) if group is not None else r)
                for r in ((me + shift) % n, (me - shift) % n))
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


def all_reduce_sum_(tensors, group=None, op: str = 'sum'):
    """Sum ``tensors`` in place over the ranks of ``group`` (float32, one
    packed buffer), so every rank holds the same values; ``op='max'``
    takes the maximum instead."""
    import torch
    dist = _dist()
    if dist.get_world_size(group) == 1 or not tensors:
        return tensors
    start = time.perf_counter()
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    route = _route(group, flat)
    work = _to_host(flat) if route == 'gloo-host' else flat
    dist.all_reduce(work, group=group, op={'sum': dist.ReduceOp.SUM,
                                           'max': dist.ReduceOp.MAX}[op])
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


# ---------------------------------------------------------------------------
# groups of several axes, and the collectives with a backward
# ---------------------------------------------------------------------------

def _axes(axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axes_group(mesh, axis):
    """The process group of the ranks that differ from this one only on
    ``axis`` (a name or a tuple of names), ordered by their coordinates on
    those axes in the mesh's axis order, the first slowest (group rank
    order is global rank order); None when that group is this rank alone
    (no mesh, or every axis of size 1 or absent). A group of one axis is
    the mesh's own; a group of several is made on first use, by every rank
    in the same order (``new_group`` is collective), and kept on the
    mesh."""
    if mesh is None:
        return None
    names = axis_names(mesh)
    wanted = _axes(axis)
    axes = tuple(a for a in names if a in wanted and axis_size(mesh, a) > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault('_petastorm_axes_groups', {})
    if axes not in cache:
        dist = _dist()
        rest = [i for i, n in enumerate(names) if n not in axes]
        order = rest + [names.index(a) for a in axes]
        size = int(math.prod(axis_size(mesh, a) for a in axes))
        rows = mesh.mesh.permute(*order).reshape(-1, size).tolist()
        me = dist.get_rank()
        for ranks in rows:
            group = dist.new_group(ranks=ranks)
            if me in ranks:
                cache[axes] = group
    return cache[axes]


def group_size(group) -> int:
    """The ranks of ``group`` (1 for None: this rank alone)."""
    return 1 if group is None else _dist().get_world_size(group)


_FUNCTIONS: Dict[str, object] = {}


def _functions():
    """The collectives' ``torch.autograd.Function`` classes, made on first
    use (torch is imported then, not when this module is)."""
    if _FUNCTIONS:
        return _FUNCTIONS
    import torch

    def summed(x, group):
        out = x.detach().clone()
        all_reduce_sum_([out], group)
        return out

    class _Psum(torch.autograd.Function):      # Megatron's g
        @staticmethod
        def forward(ctx, x, group):
            return summed(x, group)

        @staticmethod
        def backward(ctx, g):
            return g, None

    class _Pvary(torch.autograd.Function):     # Megatron's f
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return summed(g.contiguous(), ctx.group), None

    def gathered(x, group, dim):
        return torch.cat(all_gather(x.detach(), group), dim=dim)

    def my_slice(g, group, dim):
        n, me = group_size(group), _dist().get_rank(group)
        step = g.shape[dim] // n
        return g.narrow(dim, me * step, step).contiguous()

    class _AllGatherTiled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            ctx.group, ctx.dim = group, dim
            return gathered(x, group, dim)

        @staticmethod
        def backward(ctx, g):
            return my_slice(summed(g, ctx.group), ctx.group, ctx.dim), \
                None, None

    class _AllGatherInvariant(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            ctx.group, ctx.dim = group, dim
            return gathered(x, group, dim)

        @staticmethod
        def backward(ctx, g):
            return my_slice(g, ctx.group, ctx.dim), None, None

    class _Ppermute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return ring_shift([x.detach()], group)[0]

        @staticmethod
        def backward(ctx, g):
            return ring_shift([g], ctx.group, shift=-1)[0], None

    _FUNCTIONS.update(psum=_Psum, pvary=_Pvary, tiled=_AllGatherTiled,
                      invariant=_AllGatherInvariant, ppermute=_Ppermute)
    return _FUNCTIONS


def psum(x, mesh, axis):
    """The sum of ``x`` over the ranks of ``axis`` (JAX's ``psum``; Megatron's
    g): every rank gets the sum, and the gradient of the sum, which every
    rank holds whole, passes to each rank's ``x`` unchanged. Its float32
    sum is cast back to ``x``'s dtype."""
    group = axes_group(mesh, axis)
    return x if group is None else _functions()['psum'].apply(x, group)


def pvary(x, mesh, axis):
    """``x`` unchanged, its gradient summed over the ranks of ``axis``
    (Megatron's f): where each rank of the group uses a replicated ``x``
    for its own block of a computation, the sum makes every rank's
    gradient of ``x`` whole."""
    group = axes_group(mesh, axis)
    return x if group is None else _functions()['pvary'].apply(x, group)


def all_gather_tiled(x, mesh, axis, dim: int = 0):
    """The ranks' ``x`` of ``axis`` concatenated along ``dim`` in coordinate
    order (JAX's ``all_gather(tiled=True)``). Its backward is a
    reduce-scatter: the gradient is summed over the group and each rank
    keeps its own slice, for a gathered value whose ranks each use it for
    their own part of the result."""
    group = axes_group(mesh, axis)
    return (x if group is None
            else _functions()['tiled'].apply(x, group, dim % x.dim()))


def all_gather_invariant(x, mesh, axis, dim: int = 0):
    """As :func:`all_gather_tiled`, for a gathered value whose gradient
    every rank holds whole (JAX's ``all_gather_invariant``): the backward
    keeps this rank's slice, unsummed."""
    group = axes_group(mesh, axis)
    return (x if group is None
            else _functions()['invariant'].apply(x, group, dim % x.dim()))


def pmax(x, mesh, axis):
    """The elementwise maximum of ``x`` over the ranks of ``axis``
    (JAX's ``pmax``), detached: no gradient passes through it."""
    group = axes_group(mesh, axis)
    out = x.detach().clone()
    if group is not None:
        all_reduce_sum_([out], group, op='max')
    return out


def ppermute(x, mesh, axis):
    """``x`` sent to the next rank of ``axis`` (coordinate ``i`` to ``i +
    1``, the last to the first) and the previous rank's received: JAX's
    ``ppermute`` with the ring permutation. The backward sends the
    gradient the other way."""
    group = axes_group(mesh, axis)
    return x if group is None else _functions()['ppermute'].apply(x, group)
