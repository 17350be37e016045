"""The multi-rank dry run: one train step of the LM on a mesh over every
parallel axis, a pipeline step and an expert-parallel step.

The port's twin of ``__graft_entry__.py``'s ``dryrun_multichip`` (:94-287):
:func:`dryrun_multichip` starts ``n_devices`` ranks (one process a device,
:func:`~petastorm_tpu_torch.parallel.launch.launch_ranks`) and runs

1. one AdamW step of the LM on :func:`factor_axes` ``(n_devices)`` with the
   JAX dry run's tiny config (vocab 128, d_model 64, 4 heads, 2 layers,
   d_ff 128, L = 32 x seq, ``2 x expert`` experts, top-2 when the expert
   axis is split, ring attention when the seq axis is, float32);
2. when ``n_devices`` is even, one SGD step of a GPipe-staged ``tanh``
   layer pair on ``{'pipe': 2, 'data': n / 2}``;
3. when the expert axis was not split and 4 divides ``n_devices``, the LM
   step again on ``{'data': n / 4, 'seq': 1, 'model': 2, 'expert': 2}``,

and prints JAX's three lines. The LM's parameters come from the port's
``init`` with seed 0, or from ``params_fn(config)`` (a JAX-layout numpy
pytree, e.g. the JAX package's ``init`` in a test); the batches and the
pipeline's arrays are JAX's numpy draws.

Nothing here imports torch when the module is imported.
"""

from __future__ import annotations

import tempfile


def factor_axes(n_devices):
    """Split a device count over (data, seq, model, expert) mesh axes.

    Invariants: the axis sizes always multiply to exactly ``n_devices``;
    'model' and 'seq' stay powers of two (capped at 4 and 8) so they divide
    the tiny config's n_heads=4 and per-device sequence chunks; any odd factor
    goes to 'data', which has no divisibility constraint on its own (the dry
    run sizes the batch as a multiple of it)."""
    axes = {'data': 1, 'seq': 1, 'model': 1, 'expert': 1}
    rem = n_devices
    twos = 0
    while rem % 2 == 0:
        rem //= 2
        twos += 1
    axes['data'] *= rem              # odd part: only 'data' can absorb it
    order = ['data', 'seq', 'model', 'expert']
    caps = {'data': None, 'seq': 8, 'model': 4, 'expert': 2}
    i = 0
    for _ in range(twos):            # round-robin the powers of two
        for j in range(len(order)):
            ax = order[(i + j) % len(order)]
            if caps[ax] is None or axes[ax] < caps[ax]:
                axes[ax] *= 2
                i = (i + j + 1) % len(order)
                break
    return axes


def lm_config(axes):
    """The keyword arguments of the dry run's ``TransformerConfig`` on a
    mesh of ``axes``, but its dtype (float32)."""
    seq_len = 32 * max(1, axes['seq'])
    return dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                max_seq_len=seq_len, n_experts=2 * axes['expert'],
                moe_top_k=2 if axes['expert'] > 1 else 1,
                attention='ring' if axes['seq'] > 1 else 'blockwise')


def lm_batch(axes):
    """JAX's draws of the dry run's global ``(tokens, targets)``."""
    import numpy as np
    seq_len = 32 * max(1, axes['seq'])
    batch = 2 * axes['data']
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, (batch, seq_len)).astype(np.int32)
    targets = rng.integers(0, 128, (batch, seq_len)).astype(np.int32)
    return tokens, targets


def pipeline_arrays(n_devices):
    """JAX's draws of the pipeline step's stacked params ``{'w', 'b'}``,
    input and target ``(4, 2 x n / 2, 16)``."""
    import numpy as np
    n_stages, d = 2, 16
    rng = np.random.default_rng(0)
    stacked = {'w': (rng.standard_normal((n_stages, d, d)) * 0.3)
               .astype(np.float32),
               'b': np.zeros((n_stages, d), np.float32)}
    mb_rows = 2 * (n_devices // n_stages)
    x = rng.standard_normal((4, mb_rows, d)).astype(np.float32)
    target = rng.standard_normal((4, mb_rows, d)).astype(np.float32)
    return stacked, x, target


def _mesh_text(axes):
    return str(dict(axes))


def _lm_step(axes, params_np, device_type):
    """One rank's LM step on a mesh of ``axes``: the global loss."""
    import torch

    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, make_mesh
    from petastorm_tpu_torch.weights import params_from_jax, shard_params
    mesh = make_mesh(axes, device_type)
    config = tlm.TransformerConfig(dtype=torch.float32, **lm_config(axes))
    if params_np is None:
        params = tlm.init(config, torch.Generator().manual_seed(0),
                          device=device_type)
    else:
        params = params_from_jax(params_np, config, device=device_type)
    params = shard_params(params, config, mesh)
    _, step = tlm.make_train_step(config, params, mesh)
    tokens, targets = lm_batch(axes)
    sl = NamedSharding(mesh, tlm.batch_spec(mesh)).shard_slices(tokens.shape)
    loss = step(torch.from_numpy(tokens[sl]).contiguous().to(device_type),
                torch.from_numpy(targets[sl]).contiguous().to(device_type))
    return float(loss)


def _stage_fn(p, h):
    import torch
    return torch.tanh(h @ p['w'] + p['b'])


def _pipeline_step(n_devices, device_type):
    """One rank's pipeline (pp x dp) SGD step: the global loss."""
    import torch

    from petastorm_tpu_torch.parallel.mesh import (NamedSharding,
                                                   all_reduce_sum_,
                                                   axes_group, make_mesh)
    from petastorm_tpu_torch.parallel.pipeline import make_pipeline_fn
    axes = {'pipe': 2, 'data': n_devices // 2}
    mesh = make_mesh(axes, device_type)
    stacked_np, x_np, target_np = pipeline_arrays(n_devices)
    pipe = NamedSharding(mesh, ('pipe',))
    stacked = {k: torch.from_numpy(v[pipe.shard_slices(v.shape)])
               .to(device_type).requires_grad_(True)
               for k, v in stacked_np.items()}
    mb = NamedSharding(mesh, (None, 'data'))
    x, target = (torch.from_numpy(a[mb.shard_slices(a.shape)])
                 .contiguous().to(device_type) for a in (x_np, target_np))
    out = make_pipeline_fn(_stage_fn, mesh, batch_axis='data')(stacked, x)
    # this data rank's share of the global mean
    loss = ((out - target) ** 2).sum() / target_np.size
    loss.backward()
    grads = [stacked[k].grad for k in sorted(stacked)]
    loss = loss.detach()
    data = axes_group(mesh, 'data')
    if data is not None:
        all_reduce_sum_(grads + [loss], data)
    with torch.no_grad():
        for k in stacked:
            stacked[k] -= 0.1 * stacked[k].grad
    return float(loss)


def _dryrun_rank(runs, device_type):
    """Every run of the dry run on this rank, in order: ``('lm', axes,
    params)`` or ``('pipeline', n)``; their global losses and this rank's
    kernel launches."""
    from petastorm_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    losses = []
    for run in runs:
        if run[0] == 'lm':
            losses.append(_lm_step(run[1], run[2], device_type))
        else:
            losses.append(_pipeline_step(run[1], device_type))
    return losses, dict(kernels.LAUNCHES)


def dryrun_multichip(n_devices: int, device_type=None, params_fn=None,
                     timeout_s: float = 600.0, log=print):
    """Run the dry run's steps on ``n_devices`` ranks of this host and
    print JAX's three lines (see the module's docstring). ``device_type``
    is ``'cuda'`` unless the caller asks for ``'cpu'`` (without CUDA,
    ``'cuda'`` raises; the ranks of one card share it over gloo).
    ``params_fn(config_kwargs)`` gives the LM's starting parameters as a
    JAX-layout numpy pytree; the port's seeded ``init`` by default.
    Returns ``{'runs': [(label, axes, loss), ...], 'launches': {kernel:
    launches summed over the ranks}}``."""
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.parallel.launch import launch_ranks
    device_type = resolve_device(device_type).type
    if device_type == 'cuda':
        # build once here: the ranks load the cached library
        from petastorm_tpu_torch.ops import kernels
        kernels.build()
    axes = factor_axes(n_devices)
    plan = [('dryrun_multichip', 'lm', axes)]
    if n_devices % 2 == 0:
        plan.append(('dryrun_pipeline', 'pipeline',
                     {'pipe': 2, 'data': n_devices // 2}))
    if axes['expert'] < 2 and n_devices % 4 == 0:
        plan.append(('dryrun_expert', 'lm',
                     {'data': n_devices // 4, 'seq': 1, 'model': 2,
                      'expert': 2}))
    runs = []
    for _, kind, run_axes in plan:
        if kind == 'lm':
            params = (None if params_fn is None
                      else params_fn(lm_config(run_axes)))
            runs.append(('lm', run_axes, params))
        else:
            runs.append(('pipeline', n_devices))
    with tempfile.TemporaryDirectory(prefix='dryrun-') as d:
        ranks = launch_ranks(_dryrun_rank, n_devices, d,
                             args=(runs, device_type), timeout_s=timeout_s)
    out = []
    for i, (label, _, run_axes) in enumerate(plan):
        loss = ranks[0][0][i]
        log('{} OK: mesh={} loss={:.4f}'.format(label, _mesh_text(run_axes),
                                                loss))
        out.append((label, run_axes, loss))
    launches = {}
    for _, counts in ranks:
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    return {'runs': out, 'launches': launches}
