"""The port's KV-cache decode against the JAX package's.

Tiny float32 LM (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64), the
parameters drawn by the JAX ``init`` and loaded through
``params_from_jax``, prompts made with numpy, in three configurations:
multi-head, grouped-query (``n_kv_heads=2``) and windowed
(``attention_window=3``). ``_attend_cache`` must agree with JAX's within
atol = rtol = 1e-5 (float32 sums in another order); greedy ``generate``
(and ``top_k=1``) must give JAX's tokens exactly; the decode's logits must
equal the port's own teacher-forced ``forward`` within 1e-4. Sampling
cannot match JAX's generator draw for draw: the supports must be equal and
the frequencies of 4,000 draws must agree (chi-square test of the two
count vectors, p > 1e-3), with ties cut as JAX cuts them. The example
twin's first loss must match the JAX example's from the same parameters
within 1e-2 (bf16 compute), and ``sample`` must return ``(1, 32)`` tokens
in range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2_contingency

from petastorm_tpu.models import transformer_lm as jtlm
from petastorm_tpu_torch.models import transformer_lm as ttlm
from petastorm_tpu_torch.weights import params_from_jax

CONFIGS = {
    'mha': dict(),
    'gqa': dict(n_kv_heads=2),
    'window': dict(attention_window=3),
}
PROMPT, NEW = 6, 10


def _configs(extra):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq_len=32, attention='flash', **extra)
    return (jtlm.TransformerConfig(dtype=jnp.float32, **base),
            ttlm.TransformerConfig(dtype=torch.float32, **base))


def _setup(extra, seed=0):
    jcfg, tcfg = _configs(extra)
    jparams = jtlm.init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device='cpu')
    prompt = np.random.default_rng(seed).integers(
        0, 64, (3, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompt


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_attend_cache_matches_jax(name):
    _, tcfg = _configs(CONFIGS[name])
    rng = np.random.default_rng(1)
    h, hkv, dh = tcfg.n_heads, tcfg.kv_heads, tcfg.head_dim
    q = rng.standard_normal((2, h, 1, dh)).astype(np.float32)
    ck = rng.standard_normal((2, hkv, 12, dh)).astype(np.float32)
    cv = rng.standard_normal((2, hkv, 12, dh)).astype(np.float32)
    for index in (0, 5, 11):
        ref = jtlm._attend_cache(jnp.asarray(q), jnp.asarray(ck),
                                 jnp.asarray(cv), index,
                                 window=tcfg.attention_window)
        got = ttlm._attend_cache(torch.from_numpy(q), torch.from_numpy(ck),
                                 torch.from_numpy(cv), index,
                                 window=tcfg.attention_window)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_greedy_generate_matches_jax(name):
    jcfg, tcfg, jp, tp, prompt = _setup(CONFIGS[name])
    ref = np.asarray(jtlm.generate(jp, jnp.asarray(prompt), jcfg, NEW))
    got = ttlm.generate(tp, torch.from_numpy(prompt), tcfg, NEW)
    assert got.dtype == torch.int32 and got.shape == (3, NEW)
    np.testing.assert_array_equal(got.numpy(), ref)
    # top_k=1 keeps only the argmax: JAX's tokens at any temperature
    ref = np.asarray(jtlm.generate(jp, jnp.asarray(prompt), jcfg, NEW,
                                   temperature=0.7, top_k=1))
    got = ttlm.generate(tp, torch.from_numpy(prompt), tcfg, NEW,
                        temperature=0.7, top_k=1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_decode_matches_teacher_forcing(name):
    """Each drawn token's logits equal ``forward`` over the prompt and the
    tokens drawn before it, and sampling with top-p draws from them."""
    _, tcfg, _, tp, prompt = _setup(CONFIGS[name], seed=2)
    gen = torch.Generator().manual_seed(3)
    out, logits = ttlm.generate(tp, torch.from_numpy(prompt), tcfg, NEW,
                                temperature=0.9, top_p=0.8, generator=gen,
                                return_logits=True)
    assert logits.shape == (3, NEW, 64) and logits.dtype == torch.float32
    full = torch.cat([torch.from_numpy(prompt), out], dim=1)
    forced = ttlm.forward(tp, full[:, :-1], tcfg)[:, PROMPT - 1:]
    np.testing.assert_allclose(logits.numpy(), forced.detach().numpy(),
                               atol=1e-4, rtol=1e-4)
    assert int(out.min()) >= 0 and int(out.max()) < 64


def _draws(package, logits, n, seed, **kw):
    """``n`` draws of one step of ``_sample_logits`` over one row."""
    batch = np.repeat(logits[None].astype(np.float32), n, axis=0)
    if package == 'jax':
        return np.asarray(jtlm._sample_logits(
            jnp.asarray(batch), kw.pop('temperature'), kw.get('top_k'),
            kw.get('top_p'), jax.random.PRNGKey(seed)))
    return ttlm._sample_logits(
        torch.from_numpy(batch), kw.pop('temperature'), kw.get('top_k'),
        kw.get('top_p'), torch.Generator().manual_seed(seed)).numpy()


LOGITS = np.array([0.3, 2.0, 1.2, 2.0, -1.0, 0.9, 2.0, 1.5])
SAMPLING = {
    'temperature': ({'temperature': 0.8}, None),
    'top_k_2_tie': ({'temperature': 1.0, 'top_k': 2}, {3, 6}),
    'top_k_4': ({'temperature': 1.0, 'top_k': 4}, {1, 3, 6, 7}),
    'top_p_0.4_tie': ({'temperature': 1.0, 'top_p': 0.4}, {3, 6}),
    'top_k_top_p': ({'temperature': 0.5, 'top_k': 5, 'top_p': 0.9},
                    {1, 3, 6, 7}),
}


@pytest.mark.parametrize('case', sorted(SAMPLING))
def test_sampling_support_and_frequencies_match_jax(case):
    """Of tied logits (indices 1, 3, 6 at 2.0) the higher index ranks first,
    as in JAX's reversed stable sort: a top-k or top-p cut through the tie
    keeps 6 and 3, not 1."""
    kw, support = SAMPLING[case]
    ref = _draws('jax', LOGITS, 4000, 0, **dict(kw))
    got = _draws('torch', LOGITS, 4000, 0, **dict(kw))
    assert set(got.tolist()) == set(ref.tolist())
    if support is not None:
        assert set(got.tolist()) == support
    counts = np.stack([np.bincount(ref, minlength=8),
                       np.bincount(got, minlength=8)])
    counts = counts[:, counts.sum(0) > 0]
    if counts.shape[1] > 1:
        assert chi2_contingency(counts).pvalue > 1e-3
    assert _draws('torch', LOGITS, 4, 0, temperature=0.0).tolist() == [1] * 4


VALIDATION = {
    'window_0': ({'attention_window': 0}, {}),
    'top_k_0': ({}, {'temperature': 1.0, 'top_k': 0}),
    'top_k_past_vocab': ({}, {'temperature': 1.0, 'top_k': 65}),
    'top_p_0': ({}, {'temperature': 1.0, 'top_p': 0.0}),
    'top_p_above_1': ({}, {'temperature': 1.0, 'top_p': 1.5}),
}


@pytest.mark.parametrize('case', sorted(VALIDATION))
def test_generate_validation_errors_match_jax(case):
    extra, kw = VALIDATION[case]
    jcfg, tcfg, jp, tp, prompt = _setup(extra)
    with pytest.raises(ValueError) as ref:
        jtlm.generate(jp, jnp.asarray(prompt), jcfg, 2, **kw)
    with pytest.raises(ValueError) as got:
        ttlm.generate(tp, torch.from_numpy(prompt), tcfg, 2, **kw)
    assert str(got.value) == str(ref.value)


def test_example_twin_trains_and_samples(tmp_path):
    from examples.transformer_lm import main as jmain
    from petastorm_tpu_torch.examples.transformer_lm import main as tmain
    url = 'file://' + str(tmp_path / 'tokens')
    tmain.generate_token_stream(url, n_steps=48)
    quiet = dict(log=lambda _: None)
    jlosses, _, jcfg = jmain.train(url, steps=1)
    tcfg = tmain.make_config()
    params = params_from_jax(jax.device_get(
        jtlm.init(jax.random.PRNGKey(0), jcfg)), tcfg, device='cpu')
    tlosses, params, _ = tmain.train(url, steps=1, params=params,
                                     device='cpu', **quiet)
    assert abs(tlosses[0] - jlosses[0]) < 1e-2
    out = tmain.sample(params, tcfg, **quiet)
    assert tuple(out.shape) == (1, 32)
    assert int(out.min()) >= 0 and int(out.max()) < tcfg.vocab_size


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_cuda_generate_matches_cpu(name):
    """float32 decode on the card against the port on the CPU: the same
    greedy tokens, logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the card path has no CPU mode')
    _, tcfg, _, tp, prompt = _setup(CONFIGS[name])
    cpu, cpu_logits = ttlm.generate(tp, torch.from_numpy(prompt), tcfg, NEW,
                                    return_logits=True)
    tp_cuda = {k: ([{n: w.cuda() for n, w in layer.items()}
                    for layer in v] if k == 'layers' else v.cuda())
               for k, v in tp.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    card, card_logits = ttlm.generate(tp_cuda,
                                      torch.from_numpy(prompt).cuda(), tcfg,
                                      NEW, return_logits=True)
    assert card.is_cuda
    np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())
    np.testing.assert_allclose(card_logits.cpu().numpy(), cpu_logits.numpy(),
                               atol=1e-4, rtol=1e-4)
