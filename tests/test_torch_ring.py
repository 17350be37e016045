"""The port's ring attention and chunk primitives against the JAX
package's, on the CPU.

Ring attention (``petastorm_tpu_torch.parallel.ring``) on 2 and 4 gloo
ranks (started by ``launch_ranks`` over a ``FileStore`` under the test's
temp directory), each rank holding one sequence chunk, against JAX's
``make_ring_attention(make_mesh({'seq': n}), impl='jnp')`` on n virtual
CPU devices: the output and the gradients of q, k and v, causal and not,
multi-head and GQA 4 -> 2, at JAX's test shape (2, 4, 128, 32) float32;
one case against ``impl='interpret'`` (the Pallas kernels interpreted).
The chunk primitives (``attention_block_step``, ``finalize_attention``,
``merge_attention_chunks``, ``flash_attention_chunk_grads``) against
JAX's, and the error words for a bad head ratio and a bad impl.
Tolerance: 1e-5 (float32) throughout, for the ring's outputs relative to
each tensor's scale (``atol = 1e-5 max(1, max|ref|)``, ``rtol = 1e-5``):
a gradient element is a float32 sum of terms that can cancel to far below
the tensor's magnitude, and the ring sums them in another order than
JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops import attention as jattn
from petastorm_tpu.parallel import make_mesh as jmake_mesh
from petastorm_tpu.parallel import ring as jring

from petastorm_tpu_torch.ops import attention as tattn
from petastorm_tpu_torch.parallel import launch_ranks
from petastorm_tpu_torch.parallel import ring as tring
from torch_mesh_ranks import ring_inputs

TOL = 1e-5
SHAPE = (2, 4, 128, 32)
#: (causal, kv heads, the port's impl name): 'kernel' runs the kernels'
#: wrappers (their twins on CPU tensors), 'jnp' the plain ring by JAX's name
CASES = [(True, 4, 'kernel'), (True, 2, 'jnp'), (False, 4, 'jnp'),
         (False, 2, 'kernel')]


def _jax_ring(n, inputs, causal, impl):
    mesh = jmake_mesh({'seq': n}, devices=jax.devices()[:n])
    fn = jring.make_ring_attention(mesh, causal=causal, impl=impl)
    @jax.jit
    def run(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o,) + tuple(vjp(do))

    return [np.asarray(x) for x in run(*(jnp.asarray(x) for x in inputs))]


@pytest.fixture(scope='module')
def port_rings(tmp_path_factory):
    """Each world size's ranks run every case once: ``{n: [per case:
    [per rank: (o, dq, dk, dv)]]}``."""
    out = {}
    for n in (2, 4):
        cases = [(seed, SHAPE, hkv, causal, impl)
                 for seed, (causal, hkv, impl) in enumerate(CASES)]
        cases.append((9, SHAPE, 4, True, None))       # the interpret case
        ranks = launch_ranks('torch_mesh_ranks:ring_cases', n,
                             str(tmp_path_factory.mktemp('ring%d' % n)),
                             args=(cases,), timeout_s=240)
        out[n] = [[r[i] for r in ranks] for i in range(len(cases))]
    return out


def _close(got, want, name):
    np.testing.assert_allclose(
        got, want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=name)


def _gathered(per_rank):
    """The ranks' chunks of (o, dq, dk, dv) concatenated on the sequence
    axis."""
    return [np.concatenate([r[i] for r in per_rank], axis=2)
            for i in range(4)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('case', range(len(CASES)))
def test_ring_matches_jax_jnp_ring(port_rings, n, case):
    causal, hkv, _ = CASES[case]
    inputs = ring_inputs(case, SHAPE, hkv)
    want = _jax_ring(n, inputs, causal, 'jnp')
    got = _gathered(port_rings[n][case])
    for name, g, w in zip(('o', 'dq', 'dk', 'dv'), got, want):
        assert g.shape == w.shape, name
        _close(g, w, name)


@pytest.mark.timeout(300)
def test_ring_matches_jax_interpreted_kernels(port_rings):
    inputs = ring_inputs(9, SHAPE, 4)
    want = _jax_ring(2, inputs, True, 'interpret')
    got = _gathered(port_rings[2][len(CASES)])
    for name, g, w in zip(('o', 'dq', 'dk', 'dv'), got, want):
        _close(g, w, name)


def test_one_rank_ring_is_whole_sequence_attention():
    """Without a process group the ring has one chunk: the whole
    sequence's attention (the twins on the CPU)."""
    q, k, v, do = (torch.from_numpy(x) for x in ring_inputs(5, (1, 4, 48, 16),
                                                            2))
    for causal in (True, False):
        qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
        o = tring.ring_attention(qa, ka, va, causal=causal)
        o.backward(do)
        qb, kb, vb = (x.clone().requires_grad_(True) for x in (q, k, v))
        ref = tattn.flash_attention(qb, kb, vb, causal=causal)
        ref.backward(do)
        for g, w in ((o, ref), (qa.grad, qb.grad), (ka.grad, kb.grad),
                     (va.grad, vb.grad)):
            np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                       atol=TOL, rtol=TOL)


def test_error_words_are_jax():
    q = np.zeros((1, 3, 8, 4), np.float32)
    k = np.zeros((1, 2, 8, 4), np.float32)
    mesh = jmake_mesh({'seq': 1}, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as jerr:
        jring.make_ring_attention(mesh, impl='jnp')(q, k, k)
    with pytest.raises(ValueError) as terr:
        tring.ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(k))
    assert str(terr.value) == str(jerr.value)
    q = np.zeros((1, 2, 8, 4), np.float32)
    with pytest.raises(ValueError) as jerr:
        jring.make_ring_attention(mesh, impl='bogus')(q, q, q)
    with pytest.raises(ValueError) as terr:
        tring.ring_attention(*(torch.from_numpy(q) for _ in range(3)),
                             impl='bogus')
    prefix = "impl must be 'pallas', 'jnp' or 'interpret'"
    assert str(jerr.value).startswith(prefix)
    assert str(terr.value).startswith(prefix)
    assert str(terr.value).endswith("got 'bogus'")
    assert str(jerr.value).endswith("got 'bogus'")


def test_resolve_ring_impl():
    assert tring.resolve_ring_impl(None, device_type='cpu') == 'plain'
    assert tring.resolve_ring_impl(None, device_type='cuda') == 'kernel'
    for alias, impl in (('jnp', 'plain'), ('interpret', 'plain'),
                        ('pallas', 'kernel'), ('kernel', 'kernel'),
                        ('plain', 'plain')):
        assert tring.resolve_ring_impl(alias, device_type='cuda') == impl
    # JAX resolves from the mesh the same way: a CPU mesh gets jnp
    mesh = jmake_mesh({'seq': 1}, devices=jax.devices()[:1])
    assert jring.resolve_ring_impl(None, mesh) == 'jnp'

    class Mesh:
        device_type = 'cpu'
    assert tring.resolve_ring_impl(None, Mesh()) == 'plain'


def test_chunk_case_as_jax():
    for src in range(4):
        for me in range(4):
            assert tring.chunk_case(src, me) == int(jring._chunk_case(src,
                                                                      me))


# -- the chunk primitives ------------------------------------------------------

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_attention_block_step_and_finalize_as_jax():
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, 2, 3, 16, 8), _rand(rng, 2, 3, 12, 8), \
        _rand(rng, 2, 3, 12, 8)
    o, m, l = jattn.attention_accumulators(16, 8, (2, 3))
    to, tm, tl = tattn.attention_accumulators(16, 8, (2, 3))
    for i, causal in enumerate((True, False)):
        qpos, kpos = np.arange(16) + 8, np.arange(12) + 6 * i
        o, m, l = jattn.attention_block_step(
            q, k, v, o, m, l, q_positions=jnp.asarray(qpos),
            k_positions=jnp.asarray(kpos), causal=causal)
        to, tm, tl = tattn.attention_block_step(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            to, tm, tl, q_positions=torch.from_numpy(qpos),
            k_positions=torch.from_numpy(kpos), causal=causal)
        for g, w in ((to, o), (tm, m), (tl, l)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                       rtol=TOL)
    np.testing.assert_allclose(tattn.finalize_attention(to, tl).numpy(),
                               np.asarray(jattn.finalize_attention(o, l)),
                               atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match='q_positions'):
        tattn.attention_block_step(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), to, tm, tl)


def test_merge_attention_chunks_as_jax_and_a_masked_chunk():
    rng = np.random.default_rng(1)
    o_acc = _rand(rng, 2, 16, 8)
    m = _rand(rng, 2, 16)
    l = np.abs(_rand(rng, 2, 16)) + 0.5
    o_i, lse_i = _rand(rng, 2, 16, 8), _rand(rng, 2, 16)
    want = jattn.merge_attention_chunks(o_acc, m, l, o_i, lse_i)
    got = tattn.merge_attention_chunks(*(torch.from_numpy(x) for x in
                                         (o_acc, m, l, o_i, lse_i)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    # a fully masked chunk (lse -1e30, o 0) changes nothing, with no NaN
    masked = tattn.merge_attention_chunks(
        *(torch.from_numpy(x) for x in (o_acc, m, l)),
        torch.zeros(2, 16, 8), torch.full((2, 16), -1e30))
    for g, w in zip(masked, (o_acc, m, l)):
        assert torch.isfinite(g).all()
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(
        tattn.merged_lse(*got[1:]).numpy(),
        np.asarray(want[1] + jnp.log(want[2])), atol=TOL, rtol=TOL)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('hkv', [4, 2])
def test_chunk_grads_as_jax(causal, hkv):
    rng = np.random.default_rng(2)
    q, do = _rand(rng, 1, 4, 64, 32), _rand(rng, 1, 4, 64, 32)
    k, v = _rand(rng, 1, hkv, 64, 32), _rand(rng, 1, hkv, 64, 32)
    o, lse = tattn.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    want = jattn.flash_attention_chunk_grads(
        q, k, v, o.numpy(), lse.numpy(), do, causal=causal, interpret=True)
    got = tattn.flash_attention_chunk_grads(
        *(torch.from_numpy(x) for x in (q, k, v)), o, lse,
        torch.from_numpy(do), causal=causal)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)
