"""Rank bodies of the port's multi-rank CPU tests.

Each function runs in every rank that
:func:`petastorm_tpu_torch.parallel.launch_ranks` starts: a fresh
interpreter in a gloo process group that rendezvoused through a
``FileStore``. This module imports torch, numpy and the port only (no JAX:
a rank starts in a second, and the JAX references run in the test
process). Results go back as numpy arrays and plain Python values.
"""

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel import make_mesh
from petastorm_tpu_torch.parallel.mesh import (NamedSharding, axis_index,
                                               batch_sharding, gather_global,
                                               host_shard)


def _numpy(batch):
    """A staged batch (nested dicts of tensors; ``'_host'`` kept, its
    lineage record dropped) as numpy."""
    if isinstance(batch, dict):
        return {k: _numpy(v) for k, v in batch.items()
                if k != '_provenance'}
    return batch.numpy() if torch.is_tensor(batch) else batch


def ring_inputs(seed, shape, hkv):
    """Seeded float32 global q, k, v, do ``(B, H, L, D)`` (k, v with
    ``hkv`` heads)."""
    b, h, l, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, hh, l, d)).astype(np.float32)
            for hh in (h, hkv, hkv, h)]


def mesh_facts(global_shape, specs):
    """The 4-rank mesh ``{'data': 2, 'seq': 2}``: its axes and this rank's
    coordinates, ``host_shard()``, the block each spec gives this rank and
    the global array :func:`gather_global` assembles from the blocks."""
    mesh = make_mesh({'data': 2, 'seq': 2}, 'cpu')
    full = torch.arange(int(np.prod(global_shape)),
                        dtype=torch.float32).reshape(global_shape)
    blocks, gathered = {}, {}
    for spec in specs:
        sharding = NamedSharding(mesh, spec)
        sl = sharding.shard_slices(global_shape)
        blocks[spec] = [(s.start, s.stop) for s in sl]
        gathered[spec] = gather_global(full[sl].contiguous(),
                                       sharding).numpy()
    return {'names': tuple(mesh.mesh_dim_names), 'shape': tuple(mesh.shape),
            'coords': (axis_index(mesh, 'data'), axis_index(mesh, 'seq')),
            'device_type': mesh.device_type, 'host_shard': host_shard(),
            'blocks': blocks, 'gathered': gathered,
            'batch': batch_sharding(mesh).spec}


def ring_cases(cases):
    """Ring attention over a ``{'seq': world}`` mesh, one case at a time
    (``(seed, shape, hkv, causal, impl)``): this rank's chunk of the seeded
    inputs forward and backward; returns this rank's o, dq, dk, dv."""
    from petastorm_tpu_torch.parallel.ring import make_ring_attention
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh({'seq': n}, 'cpu')
    out = []
    for seed, shape, hkv, causal, impl in cases:
        q, k, v, do = (torch.from_numpy(x) for x in ring_inputs(seed, shape,
                                                                hkv))
        c = shape[2] // n
        sl = slice(rank * c, (rank + 1) * c)
        ql, kl, vl = (x[:, :, sl].contiguous().requires_grad_(True)
                      for x in (q, k, v))
        o = make_ring_attention(mesh, causal=causal, impl=impl)(ql, kl, vl)
        o.backward(do[:, :, sl].contiguous())
        out.append([x.detach().numpy() for x in (o, ql.grad, kl.grad,
                                                 vl.grad)])
    return out


def lm_step(axes, cfg_kwargs, params_np, tokens, targets, steps=1):
    """``steps`` train steps of the LM on a CPU mesh of ``axes`` from the
    given (numpy, JAX-layout) parameters, each rank on its ``batch_spec``
    block of the global ``tokens`` / ``targets``. Returns the losses and,
    on rank 0, the gathered parameter leaves (``tlm.parameters`` order)."""
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.weights import (gather_params, params_from_jax,
                                             shard_params)
    mesh = make_mesh(axes, 'cpu')
    cfg = tlm.TransformerConfig(**cfg_kwargs)
    params = shard_params(params_from_jax(params_np, cfg, device='cpu'), cfg,
                          mesh)
    _, step = tlm.make_train_step(cfg, params, mesh)
    sharding = NamedSharding(mesh, tlm.batch_spec(mesh))
    sl = sharding.shard_slices(tokens.shape)
    losses = [float(step(torch.from_numpy(tokens[sl]).contiguous(),
                         torch.from_numpy(targets[sl]).contiguous()))
              for _ in range(steps)]
    full = gather_params(params, cfg, mesh)
    leaves = ([p.numpy() for p in tlm.parameters(full)]
              if dist.get_rank() == 0 else None)
    return {'losses': losses, 'leaves': leaves}


def streaming(url, local_batch, fields=None, ngram=None, passes=2):
    """``make_reader(shard_by_jax_process=True)`` (one thread, row groups
    in order) -> ``make_torch_loader(mesh={'data': world})``: ``passes``
    passes (each after the loader's reset), as numpy batches, and how often
    the lockstep stop drained the reader."""
    from petastorm_tpu_torch import make_reader, make_torch_loader
    from petastorm_tpu_torch.ngram import NGram
    mesh = make_mesh({'data': dist.get_world_size()}, 'cpu')
    schema_fields = (NGram(ngram, delta_threshold=1, timestamp_field='ts')
                     if ngram else fields)
    reader = make_reader(url, schema_fields=schema_fields,
                         shard_by_jax_process=True, shuffle_row_groups=False,
                         workers_count=1)
    drains = []
    drain = reader.drain
    reader.drain = lambda: (drains.append(1), drain())[1]
    loader = make_torch_loader(reader, batch_size=local_batch, mesh=mesh)
    out = []
    with reader:
        for _ in range(passes):
            out.append([_numpy(b) for b in loader])
        consumed = reader.last_row_consumed
    return {'passes': out, 'drains': len(drains), 'consumed': consumed,
            'host_shard': host_shard(), 'spec': loader.sharding.spec}


def indexed(url, batch, axes, ngram=None, num_epochs=1, stop=None,
            state=None, seed=3):
    """A sharded indexed loader (rows, or NGram windows of ``ngram``) on a
    CPU mesh of ``axes``: this rank's batches as numpy, from ``state`` when
    given, and the cursor after ``stop`` batches when given."""
    from petastorm_tpu_torch import (make_indexed_loader,
                                     make_indexed_ngram_loader)
    from petastorm_tpu_torch.ngram import NGram
    mesh = make_mesh(axes, 'cpu')
    if ngram:
        loader = make_indexed_ngram_loader(
            url, NGram(ngram, delta_threshold=1, timestamp_field='ts'),
            batch_size=batch, num_epochs=num_epochs, seed=seed, mesh=mesh,
            workers_count=2)
    else:
        loader = make_indexed_loader(url, batch_size=batch,
                                     num_epochs=num_epochs, seed=seed,
                                     mesh=mesh, workers_count=2)
    if state is not None:
        loader.load_state_dict(state)
    batches, saved = [], None
    with loader:
        for b in loader:
            batches.append(_numpy(b))
            if stop is not None and len(batches) == stop:
                saved = loader.state_dict()
                break
    return {'batches': batches, 'state': saved,
            'coords': {a: axis_index(mesh, a) for a in axes},
            'spec': loader.sharding.spec}


def example_train(url, steps, axes, params_np):
    """The ``examples/transformer_lm`` twin's ``train`` on a CPU mesh of
    ``axes`` from the given (numpy, JAX-layout) parameters; its losses."""
    from petastorm_tpu_torch.examples.transformer_lm import main
    from petastorm_tpu_torch.weights import params_from_jax
    mesh = make_mesh(axes, 'cpu')
    cfg = main.make_config(mesh)
    losses, _, _ = main.train(url, steps=steps, mesh=mesh,
                              params=params_from_jax(params_np, cfg,
                                                     device='cpu'),
                              log=lambda *a: None)
    return losses


def fail_or_sleep(fail_rank=None, sleep_rank=None, seconds=0.0):
    """Raise on ``fail_rank``; sleep ``seconds`` on ``sleep_rank``; return
    the rank elsewhere (the launcher's failure and time-limit paths)."""
    import time
    rank = dist.get_rank()
    if rank == fail_rank:
        raise ValueError('rank %d fails on purpose' % rank)
    if rank == sleep_rank:
        time.sleep(seconds)
    return rank


def indexed_jobs(jobs):
    """:func:`indexed` once for each job (a dict of its arguments), in
    order, in one launch."""
    return [indexed(**job) for job in jobs]


def lm_jobs(jobs):
    """:func:`lm_step` once for each job (a dict of its arguments, ``axes``
    naming a mesh of the whole world), in order, in one launch."""
    return [lm_step(**job) for job in jobs]


def collective_grads(inputs):
    """Each collective with a backward over a ``{'model': world}`` mesh:
    ``inputs`` holds the whole world's ``x`` ``(world, n, m)`` and the
    cotangent weights ``g`` ``(world, ...)``; every rank uses its own row.
    Returns this rank's forward values and input gradients by name."""
    from petastorm_tpu_torch.parallel import mesh as pmesh
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh({'model': n}, 'cpu')
    xs, gs = (torch.from_numpy(inputs[k]) for k in ('x', 'g'))
    out = {}
    for name in ('psum', 'pvary', 'all_gather_tiled', 'all_gather_invariant',
                 'ppermute', 'pmax'):
        x = xs[rank].clone().requires_grad_(True)
        fn = getattr(pmesh, name)
        y = (fn(x, mesh, 'model', dim=1) if name.startswith('all_gather')
             else fn(x, mesh, 'model'))
        # a replicated result's cotangent is one, equal on every rank
        g = gs[0 if name in ('psum', 'all_gather_invariant')
               else rank][..., :y.shape[-1]]
        if name == 'pmax':
            out[name] = (y.numpy(), y.requires_grad)
            continue
        (y * g).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def vocab_parallel(axes, cfg_kwargs, params_np, tokens, targets,
                   segment_ids=None, weights=None):
    """The LM's forward and loss on a CPU mesh of ``axes`` (no step), with
    packed ``segment_ids`` and ``weights`` when given: this rank's logits
    block shape, the gathered logits and the loss."""
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.parallel.mesh import all_reduce_sum_, axes_group
    from petastorm_tpu_torch.weights import params_from_jax, shard_params
    mesh = make_mesh(axes, 'cpu')
    cfg = tlm.TransformerConfig(**cfg_kwargs)
    params = shard_params(params_from_jax(params_np, cfg, device='cpu'), cfg,
                          mesh)
    spec = tlm.batch_spec(mesh)
    sl = NamedSharding(mesh, spec).shard_slices(tokens.shape)
    tok, tgt = (torch.from_numpy(a[sl]).contiguous() for a in (tokens,
                                                               targets))
    kw = {k: torch.from_numpy(a[sl]).contiguous()
          for k, a in (('segment_ids', segment_ids), ('weights', weights))
          if a is not None}
    with torch.no_grad():
        logits = tlm.forward(params, tok, cfg, mesh=mesh,
                             segment_ids=kw.get('segment_ids'))
        loss = tlm.loss_fn(params, tok, tgt, cfg, mesh=mesh, **kw)
    group = axes_group(mesh, ('data', 'seq'))
    if group is not None:
        all_reduce_sum_([loss], group)
    whole = gather_global(logits, NamedSharding(mesh, spec + ('model',)))
    return {'block': tuple(logits.shape), 'logits': whole.numpy(),
            'loss': float(loss)}


def moe_step(axes, cfg_kwargs, params_np, tokens, targets):
    """One train step of the MoE LM on a CPU mesh of ``axes``: the loss,
    the forward's global aux and each layer's routing (rank 0's record,
    which every rank routes alike), and on rank 0 the gathered leaves."""
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.weights import params_from_jax, shard_params
    mesh = make_mesh(axes, 'cpu')
    cfg = tlm.TransformerConfig(**cfg_kwargs)
    params = shard_params(params_from_jax(params_np, cfg, device='cpu'), cfg,
                          mesh)
    sl = NamedSharding(mesh, tlm.batch_spec(mesh)).shard_slices(tokens.shape)
    tok, tgt = (torch.from_numpy(a[sl]).contiguous() for a in (tokens,
                                                               targets))
    stats = {'routes': []}
    with torch.no_grad():
        tlm.forward(params, tok, cfg, mesh=mesh, moe_stats=stats)
    routes = [{k: v.numpy() for k, v in r.items()} for r in stats['routes']]
    out = lm_step(axes, cfg_kwargs, params_np, tokens, targets)
    with torch.no_grad():
        aux = tlm.forward(params, tok, cfg, mesh=mesh, return_aux=True)[1]
    out.update(routes=routes, aux=float(aux))
    return out


def pipeline_cases(cases):
    """``make_pipeline_fn`` over a ``{'pipe': S}`` mesh (``{'pipe': S,
    'data': world / S}`` with ``batch_axis``) for each case ``(stacked,
    x, batch_axis, grads)`` of numpy arrays: the outputs (this rank's
    block) and, with ``grads``, this stage's gradients of ``sum(out **
    2)`` summed over the data ranks."""
    from petastorm_tpu_torch.parallel.mesh import all_reduce_sum_, axes_group
    from petastorm_tpu_torch.parallel.pipeline import make_pipeline_fn
    out = []
    for stacked, x, batch_axis, grads in cases:
        s = stacked['w'].shape[0]
        axes = ({'pipe': s} if batch_axis is None
                else {'pipe': s, batch_axis: dist.get_world_size() // s})
        mesh = make_mesh(axes, 'cpu')
        pipe = NamedSharding(mesh, ('pipe',))
        mine = {k: torch.from_numpy(v[pipe.shard_slices(v.shape)])
                .requires_grad_(True) for k, v in stacked.items()}
        xs = torch.from_numpy(
            x[NamedSharding(mesh, (None, batch_axis)).shard_slices(x.shape)]
            .copy())

        def stage(p, h):
            return torch.tanh(h @ p['w'] + p['b'])

        y = make_pipeline_fn(stage, mesh, batch_axis=batch_axis)(mine, xs)
        got = {'out': y.detach().numpy()}
        if grads:
            (y ** 2).sum().backward()
            g = [mine[k].grad for k in sorted(mine)]
            if axes_group(mesh, batch_axis) is not None:
                all_reduce_sum_(g, axes_group(mesh, batch_axis))
            got['grads'] = {k: mine[k].grad.numpy() for k in sorted(mine)}
        out.append(got)
    return out
