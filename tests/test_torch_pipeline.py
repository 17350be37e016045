"""The port's GPipe pipeline against the JAX package's, on the CPU.

JAX's ``tests/test_pipeline.py`` cases, each on the same inputs in both
packages: ``make_pipeline_fn`` over ``{'pipe': S}`` gloo ranks (started by
``launch_ranks`` over a ``FileStore`` under the test's temp directory)
against JAX's ``make_pipeline_fn`` on S virtual CPU devices, for (S, M) =
(4, 8), (2, 3) and (8, 8); the gradients of ``sum(out ** 2)`` on 4 stages;
and pipeline x data parallelism on ``{'pipe': 2, 'data': 4}``. Outputs and
gradients within 1e-5. Every stage returns the whole output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from petastorm_tpu.parallel import make_mesh as jmake_mesh
from petastorm_tpu.parallel.pipeline import make_pipeline_fn as jpipeline

from petastorm_tpu_torch.parallel import launch_ranks

jax.config.update('jax_default_matmul_precision', 'highest')


def _stage_fn(p, x):
    return jnp.tanh(x @ p['w'] + p['b'])


def _setup(n_stages, n_micro, mb, d=16):
    rng = np.random.default_rng(0)
    stacked = {'w': (rng.standard_normal((n_stages, d, d)) * 0.3)
               .astype(np.float32),
               'b': (rng.standard_normal((n_stages, d)) * 0.1)
               .astype(np.float32)}
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return stacked, x


def _jax(axes, stacked, x, batch_axis=None, grads=False):
    n = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(axes, devices=jax.devices()[:n])
    fn = jpipeline(_stage_fn, mesh, batch_axis=batch_axis)
    p = {k: jnp.asarray(v) for k, v in stacked.items()}
    out = np.asarray(fn(p, jnp.asarray(x)))
    if not grads:
        return out, None
    g = jax.grad(lambda p: jnp.sum(fn(p, jnp.asarray(x)) ** 2))(p)
    return out, {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.timeout(300)
@pytest.mark.parametrize('n_stages,n_micro', [(4, 8), (2, 3), (8, 8)])
def test_forward_matches_jax(n_stages, n_micro, tmp_path):
    stacked, x = _setup(n_stages, n_micro, 2)
    want, _ = _jax({'pipe': n_stages}, stacked, x)
    ranks = launch_ranks('torch_mesh_ranks:pipeline_cases', n_stages,
                         str(tmp_path),
                         args=([(stacked, x, None, False)],), timeout_s=240)
    for r in ranks:
        np.testing.assert_allclose(r[0]['out'], want, atol=1e-5, rtol=1e-5)


@pytest.mark.timeout(300)
def test_grads_match_jax(tmp_path):
    stacked, x = _setup(4, 8, 2)
    want, grads = _jax({'pipe': 4}, stacked, x, grads=True)
    ranks = launch_ranks('torch_mesh_ranks:pipeline_cases', 4,
                         str(tmp_path),
                         args=([(stacked, x, None, True)],), timeout_s=240)
    for stage, r in enumerate(ranks):
        np.testing.assert_allclose(r[0]['out'], want, atol=1e-5, rtol=1e-5)
        for k in grads:
            # the rank's P('pipe') block: its stage's slot, leading dim 1
            np.testing.assert_allclose(r[0]['grads'][k],
                                       grads[k][stage:stage + 1],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.timeout(300)
def test_pp_with_dp_matches_jax(tmp_path):
    stacked, x = _setup(2, 4, 8)
    axes = {'pipe': 2, 'data': 4}
    want, grads = _jax(axes, stacked, x, batch_axis='data', grads=True)
    ranks = launch_ranks('torch_mesh_ranks:pipeline_cases', 8,
                         str(tmp_path),
                         args=([(stacked, x, 'data', True)],), timeout_s=240)
    for rank, r in enumerate(ranks):
        stage, data = divmod(rank, 4)
        np.testing.assert_allclose(r[0]['out'],
                                   want[:, 2 * data:2 * data + 2],
                                   atol=1e-5, rtol=1e-5)
        for k in grads:
            np.testing.assert_allclose(r[0]['grads'][k],
                                       grads[k][stage:stage + 1],
                                       atol=1e-5, rtol=1e-5)


def test_public_names():
    from petastorm_tpu_torch import parallel as tparallel
    from petastorm_tpu_torch.parallel import dryrun, mesh, pipeline
    for module, names in ((pipeline, ('pipeline_apply', 'make_pipeline_fn')),
                          (dryrun, ('dryrun_multichip', 'factor_axes')),
                          (mesh, ('psum', 'pvary', 'all_gather_tiled',
                                  'all_gather_invariant', 'pmax', 'ppermute',
                                  'axes_group'))):
        for name in names:
            assert getattr(tparallel, name) is getattr(module, name)
    # JAX's __all__ plus the launcher
    assert tparallel.__all__ == ['make_mesh', 'host_shard', 'batch_sharding',
                                 'replicated_sharding', 'ring_attention',
                                 'launch_ranks']
