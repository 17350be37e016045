"""The port's document packing against the JAX package's.

``pack_documents`` must give JAX's tokens, segment ids and positions (and
its errors, word for word) on documents of lengths drawn from a seed, with
and without ``num_rows``; ``packed_lm_targets`` JAX's targets and weights;
and the packed loss (segment-masked attention, per-document positions,
weighted mean) and its gradients JAX's ``loss_fn`` on the same parameters,
for a dense and a mixture-of-experts GQA model (float32; loss 1e-5,
gradients 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu import packing as jpacking
from petastorm_tpu.models import transformer_lm as jtlm
from petastorm_tpu_torch import packing as tpacking
from petastorm_tpu_torch.models import transformer_lm as ttlm
from petastorm_tpu_torch.weights import params_from_jax

SEQ = 16


def _docs(seed, n=9, longest=SEQ):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, int(m)).astype(np.int32)
            for m in rng.integers(1, longest + 1, n)]


@pytest.mark.parametrize('num_rows', [None, 8])
@pytest.mark.parametrize('seed', [0, 1])
def test_pack_documents_matches_jax(seed, num_rows):
    docs = _docs(seed)
    ref = jpacking.pack_documents(docs, SEQ, num_rows=num_rows, pad_token=-1)
    got = tpacking.pack_documents(docs, SEQ, num_rows=num_rows, pad_token=-1,
                                  device='cpu')
    assert isinstance(got, tpacking.PackedBatch)
    for name in ('tokens', 'segment_ids', 'positions'):
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.dtype == torch.int32 and a.device.type == 'cpu'
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    if num_rows is not None:
        assert got.tokens.shape[0] == num_rows
    # tensors in, as the loader hands them over
    again = tpacking.pack_documents([torch.from_numpy(d) for d in docs],
                                    SEQ, num_rows=num_rows, pad_token=-1,
                                    device='cpu')
    assert torch.equal(again.tokens, got.tokens)


ERRORS = {
    'empty document': ([np.zeros(0, np.int32)], {}),
    'too long': ([np.ones(SEQ + 1, np.int32)], {}),
    'too many rows': (_docs(2, n=9), {'num_rows': 2}),
}


@pytest.mark.parametrize('case', sorted(ERRORS))
def test_pack_documents_errors_match_jax(case):
    docs, kw = ERRORS[case]
    with pytest.raises(ValueError) as ref:
        jpacking.pack_documents(docs, SEQ, **kw)
    with pytest.raises(ValueError) as got:
        tpacking.pack_documents(docs, SEQ, device='cpu', **kw)
    assert str(got.value) == str(ref.value)


def test_packed_lm_targets_match_jax():
    packed = jpacking.pack_documents(_docs(3), SEQ, num_rows=6)
    ref_t, ref_w = jpacking.packed_lm_targets(packed.tokens,
                                              packed.segment_ids)
    got_t, got_w = tpacking.packed_lm_targets(
        torch.from_numpy(np.array(packed.tokens)),
        torch.from_numpy(np.array(packed.segment_ids)))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    assert got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))


MODELS = {
    'dense': dict(),
    'moe_gqa': dict(n_experts=4, moe_top_k=2, n_kv_heads=2),
}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_packed_loss_and_gradients_match_jax(name):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq_len=SEQ, attention='flash', **MODELS[name])
    jcfg = jtlm.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = ttlm.TransformerConfig(dtype=torch.float32, **base)
    jp = jtlm.init(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.device_get(jp), tcfg, device='cpu')
    docs = _docs(4, n=7)
    jb = jpacking.pack_documents(docs, SEQ)
    jt, jw = jpacking.packed_lm_targets(jb.tokens, jb.segment_ids)
    tb = tpacking.pack_documents(docs, SEQ, device='cpu')
    tt, tw = tpacking.packed_lm_targets(tb.tokens, tb.segment_ids)

    def jloss(params):
        return jtlm.loss_fn(params, jb.tokens, jt, jcfg,
                            positions=jb.positions,
                            segment_ids=jb.segment_ids, weights=jw)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = ttlm.parameters(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttlm.loss_fn(tp, tb.tokens, tt, tcfg, positions=tb.positions,
                        segment_ids=tb.segment_ids, weights=tw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-5, rtol=1e-5)
    ref = [ref_grads['embed'], ref_grads['final_norm'], ref_grads['unembed']]
    for layer in ref_grads['layers']:
        ref.extend(layer[n] for n in sorted(layer))
    assert len(ref) == len(leaves)
    for i, (a, b) in enumerate(zip(leaves, ref)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4, err_msg='leaf %d' % i)
