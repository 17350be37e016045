"""Train the transformer LM on NGram token windows, then sample from it.

The twin of ``examples/transformer_lm/main.py``: ``make_reader`` with an
NGram of two consecutive 64-token chunks assembles (input window,
continuation window) pairs, ``TorchDataLoader`` collates them per
timestep, ``prefetch_to_device`` stages them to the card, and the LM takes
AdamW steps; ``sample`` continues a prompt with the KV-cache decode. The
config is the JAX example's. There is no mesh: the port trains on one
device.

Usage::

    python -m petastorm_tpu_torch.examples.transformer_lm.main
"""

from __future__ import annotations

import contextlib
import tempfile

import numpy as np

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

TokenSchema = Unischema('TokenSchema', [
    UnischemaField('step', np.int64, (), ScalarCodec(), False),
    UnischemaField('tokens', np.int32, (64,), NdarrayCodec(), False),
])


def generate_token_stream(output_url, n_steps=512, vocab=128, seed=0):
    """Each row is a 64-token chunk; consecutive rows continue the
    stream."""
    rng = np.random.default_rng(seed)
    with materialize_dataset(output_url, TokenSchema, rows_per_file=256,
                             row_group_size_mb=64) as w:
        w.write_rows({'step': np.int64(i),
                      'tokens': rng.integers(0, vocab, 64, dtype=np.int32)}
                     for i in range(n_steps))


def make_config():
    """The JAX example's LM: vocab 128, d_model 128, 4 heads, 2 layers,
    d_ff 256, L 64, bf16, blockwise attention."""
    from petastorm_tpu_torch.models import transformer_lm as tlm
    return tlm.TransformerConfig(vocab_size=128, d_model=128, n_heads=4,
                                 n_layers=2, d_ff=256, max_seq_len=64,
                                 attention='blockwise')


def train(dataset_url, steps=20, params=None, device=None, log=print):
    """``steps`` AdamW steps over the store's windows. ``params``: the
    starting parameters (e.g. the JAX example's through
    :func:`petastorm_tpu_torch.weights.params_from_jax`); a seeded init by
    default. Returns ``(losses, params, config)``."""
    import torch

    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 prefetch_to_device)

    device = resolve_device(device)
    # a window of 2 consecutive chunks: (input window, continuation window)
    ngram = NGram(fields={0: ['step', 'tokens'], 1: ['tokens']},
                  delta_threshold=1, timestamp_field='step')
    config = make_config()
    if params is None:
        params = tlm.init(config, torch.Generator().manual_seed(0),
                          device=device)
    _, step = tlm.make_train_step(config, params)
    losses = []
    with make_reader(dataset_url, schema_fields=ngram, num_epochs=None,
                     shuffle_row_groups=False) as reader:
        loader = TorchDataLoader(reader, batch_size=8, drop_last=True,
                                 device=device)
        batches = prefetch_to_device(iter(loader), size=2, device=device)
        with contextlib.closing(batches):
            for batch in batches:
                tokens = batch[0]['tokens']
                # next-token targets: shift within the window; the next
                # chunk's first token closes the gap
                nxt = batch[1]['tokens'][:, 0]
                targets = torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)
                losses.append(float(step(tokens, targets)))
                if len(losses) >= steps:
                    break
    log('first loss {:.3f} -> last loss {:.3f}'.format(losses[0],
                                                       losses[-1]))
    return losses, params, config


def sample(params, config, prompt_len=8, max_new_tokens=32, temperature=0.8,
           top_p=0.9, seed=0, log=print):
    """Continue a seeded random prompt with the trained model (KV-cache
    decode, nucleus sampling) on the parameters' device. Returns the
    sampled ``(1, max_new_tokens)`` continuation."""
    import torch

    from petastorm_tpu_torch.models import transformer_lm as tlm

    device = params['embed'].device
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(
        0, config.vocab_size, (1, prompt_len)).astype(np.int32)).to(device)
    out = tlm.generate(params, prompt, config, max_new_tokens,
                       temperature=temperature, top_p=top_p,
                       generator=torch.Generator(device=device)
                       .manual_seed(seed))
    log('prompt {} -> continuation {}'.format(
        prompt.cpu().numpy()[0][:8], out.cpu().numpy()[0][:8]))
    return out


if __name__ == '__main__':
    url = 'file://' + tempfile.mkdtemp() + '/tokens'
    generate_token_stream(url)
    _, params, config = train(url)
    sample(params, config)
