"""GPipe-style pipeline parallelism over a mesh axis.

The port's counterpart of ``petastorm_tpu/parallel/pipeline.py``. Stages
live one a rank along the ``pipe`` axis; microbatches stream through the
ring: at step ``t`` stage ``s`` computes microbatch ``t - s`` and sends its
activation to stage ``s + 1`` with the differentiable
:func:`~petastorm_tpu_torch.parallel.mesh.ppermute`. The schedule is JAX's:
``M + S - 1`` steps, stage 0 injecting microbatch ``t``, bubble steps
masked out of the output buffer, the last stage's outputs shared with
every stage by a :func:`~petastorm_tpu_torch.parallel.mesh.psum`. The
bubble costs ``S - 1`` of ``M + S - 1`` steps, so efficiency is ``M / (M
+ S - 1)``: pick ``n_microbatches >> n_stages``.

Autograd through the schedule runs the reverse schedule across the ranks:
each step's ``ppermute`` sends the gradient back to the previous stage,
and the ``psum``'s backward hands the loss's gradient to the last stage
once. A stage computes on every step, bubbles included (their outputs are
masked, as in JAX), and stage 0 selects its input with ``torch.where``, so
every rank's graph holds every send and the ranks' backward sends pair up
in the same order. JAX's ``pcast``/``pvary`` casts have no counterpart:
a torch rank's tensors carry no varying-axes type.

Nothing here imports torch when the module is imported.
"""

from __future__ import annotations


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn, stage_params, microbatches, group_or_axis):
    """Run ``microbatches`` through the pipeline, this rank being one
    stage.

    :param stage_fn: ``(params_for_one_stage, x) -> y`` with ``y.shape ==
        x.shape`` (inter-stage activations must be shape-stable).
    :param stage_params: this stage's params (its slot of the stacked
        params, the stage axis squeezed away).
    :param microbatches: ``(n_micro, mb, ...)``, equal on every stage; only
        stage 0 consumes it.
    :param group_or_axis: the pipe axis as a ``(mesh, axis_name)`` pair.
    :returns: ``(n_micro, mb, ...)`` outputs, equal on every stage.
    """
    import torch

    from petastorm_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                                   ppermute, psum)
    mesh, axis = group_or_axis
    n_stages, stage = axis_size(mesh, axis), axis_index(mesh, axis)
    n_micro = microbatches.shape[0]
    first, last = (torch.tensor(flag, device=microbatches.device)
                   for flag in (stage == 0, stage == n_stages - 1))
    incoming = torch.zeros_like(microbatches[0])
    outputs = [torch.zeros_like(incoming) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t; the others take the ring's
        x_in = torch.where(first, microbatches[min(t, n_micro - 1)],
                           incoming)
        y = stage_fn(stage_params, x_in)
        # bubble steps compute garbage; only the last stage's live steps
        # fill the output buffer (the select keeps every stage's graph
        # whole: its loss reaches its sends with a zero gradient)
        out_idx = t - (n_stages - 1)
        if 0 <= out_idx < n_micro:
            outputs[out_idx] = torch.where(last, y, outputs[out_idx])
        # the last stage's wrap-around send is ignored by stage 0's select
        incoming = ppermute(y, mesh, axis)
    # outputs live on the last stage; share them with every stage
    return psum(torch.stack(outputs), mesh, axis)


def make_pipeline_fn(stage_fn, mesh, pipe_axis: str = 'pipe',
                     batch_axis: str = None):
    """``fn(stacked_params, microbatches) -> outputs`` running
    :func:`pipeline_apply` over ``mesh``'s ``pipe_axis``.

    ``stacked_params`` is this rank's ``P(pipe_axis)`` block of the
    stage-stacked params: every leaf with a leading stage dim of 1.
    ``microbatches`` is ``(n_micro, mb, ...)``; with ``batch_axis``, this
    rank's block of it split on dim 1 over that axis (pipeline composed
    with data parallelism), and the outputs are this rank's block too.
    """
    def fn(stacked_params, microbatches):
        mine = _tree_map(lambda a: a[0], stacked_params)
        return pipeline_apply(stage_fn, mine, microbatches,
                              (mesh, pipe_axis))

    return fn
