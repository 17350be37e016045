"""The port's twin of ``__graft_entry__.py``'s ``dryrun_multichip``
against the JAX package's, on the CPU.

``factor_axes`` equals JAX's ``_factor_axes`` for every device count of
``tests/test_models.py``'s ``test_factor_axes``. ``dryrun_multichip(8,
device_type='cpu', params_fn=...)`` runs on 8 gloo ranks from JAX's
parameters and prints JAX's three lines, word for word up to the loss;
each loss is within 1e-4 of JAX's step on the same mesh of virtual CPU
devices (the LM on ``{'data': 2, 'seq': 2, 'model': 2, 'expert': 1}``
with ring attention, the GPipe pair on ``{'pipe': 2, 'data': 4}``, the
MoE LM on ``{'data': 2, 'seq': 1, 'model': 2, 'expert': 2}``).
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from petastorm_tpu.models import transformer_lm as jtlm
from petastorm_tpu.parallel import make_mesh as jmake_mesh
from petastorm_tpu.parallel.pipeline import make_pipeline_fn

from petastorm_tpu_torch.parallel import dryrun


def _graft():
    spec = importlib.util.spec_from_file_location(
        'graft_entry_torch_dryrun',
        os.path.join(os.path.dirname(__file__), '..', '__graft_entry__.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('n', [1, 2, 4, 6, 8, 16, 24, 81, 245, 256])
def test_factor_axes_is_jax(n):
    assert dryrun.factor_axes(n) == _graft()._factor_axes(n)


def _jax_params(config_kwargs):
    cfg = jtlm.TransformerConfig(dtype=jnp.float32, **config_kwargs)
    return jax.device_get(jtlm.init(jax.random.PRNGKey(0), cfg))


def _jax_lm_loss(axes):
    n = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(axes, devices=jax.devices()[:n])
    cfg = jtlm.TransformerConfig(dtype=jnp.float32, **dryrun.lm_config(axes))
    params = jtlm.init(jax.random.PRNGKey(0), cfg)
    optimizer, step = jtlm.make_train_step(cfg, mesh)
    tokens, targets = dryrun.lm_batch(axes)
    _, _, loss = step(params, optimizer.init(params), jnp.asarray(tokens),
                      jnp.asarray(targets))
    return float(loss)


def _jax_pipeline_loss(n):
    mesh = jmake_mesh({'pipe': 2, 'data': n // 2}, devices=jax.devices()[:n])
    stacked, x, target = dryrun.pipeline_arrays(n)
    fn = make_pipeline_fn(lambda p, h: jnp.tanh(h @ p['w'] + p['b']), mesh,
                          batch_axis='data')
    p = {k: jnp.asarray(v) for k, v in stacked.items()}
    return float(jnp.mean((fn(p, jnp.asarray(x)) - jnp.asarray(target))
                          ** 2))


@pytest.mark.timeout(400)
def test_dryrun_multichip_on_8_cpu_ranks_matches_jax():
    lines = []
    result = dryrun.dryrun_multichip(8, device_type='cpu',
                                     params_fn=_jax_params, log=lines.append)
    out = result['runs']
    # the CPU ranks run the kernels' twins: no launch
    assert set(result['launches'].values()) == {0}
    assert [label for label, _, _ in out] == [
        'dryrun_multichip', 'dryrun_pipeline', 'dryrun_expert']
    want = {'dryrun_multichip': _jax_lm_loss(dryrun.factor_axes(8)),
            'dryrun_pipeline': _jax_pipeline_loss(8),
            'dryrun_expert': _jax_lm_loss({'data': 2, 'seq': 1, 'model': 2,
                                           'expert': 2})}
    for (label, axes, loss), line in zip(out, lines):
        assert abs(loss - want[label]) <= 1e-4 * max(1.0, abs(want[label]))
        # JAX's words: label, the mesh's axis sizes, 4 decimals
        assert line == '{} OK: mesh={} loss={:.4f}'.format(label, axes, loss)
        assert re.fullmatch(r"\w+ OK: mesh=\{('\w+': \d+(, )?)+\} "
                            r'loss=\d+\.\d{4}', line)
    assert out[0][1] == {'data': 2, 'seq': 2, 'model': 2, 'expert': 1}
