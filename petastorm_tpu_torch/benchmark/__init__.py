"""The port's instruments (``petastorm_tpu/benchmark/``): reader throughput
with host metrics and its ``petastorm-tpu-torch-throughput`` command, the
loader micro-benchmark over a dummy reader, the infeed/compute overlap of
real training steps, the north-star train benches, the goodput and
device-decode benches, and a twin of each other JAX bench: batched decode,
transport, readahead, shared cache, roofline, autotune, chaos, object
store, the lineage / trace / latency / health overheads, pod
observability, pod elasticity and worker scaling. Each entry point that
works on a device runs on the CUDA device unless the caller passes
``device='cpu'`` (``--device cpu`` for the commands), and raises without
CUDA otherwise. The modules import no torch until a bench runs.

Each of those twins states its timing bars once, in ``_bars(result)``: a
list of ``(label, value, op, bar)``, JAX's bar for the run's size. Its own
check asserts them (:func:`assert_bars`); ``chip_smoke.py`` prints them
beside whether they held (:func:`bar_held`)."""

import operator

#: a timing bar's comparison, by the sign it prints
BAR_OPS = {'>=': operator.ge, '>': operator.gt, '<=': operator.le,
           '<': operator.lt}


def bar_held(value, op: str, bar) -> bool:
    """Whether ``value`` holds the bar ``op bar`` (a missing value does
    not)."""
    return value is not None and BAR_OPS[op](value, bar)


def assert_bars(bars) -> None:
    """Asserts each ``(label, value, op, bar)`` of a twin's ``_bars``."""
    for label, value, op, bar in bars:
        assert bar_held(value, op, bar), '{}: measured {!r}, bar {} {}'.format(
            label, value, op, bar)


def resolve_cli_device(device, command: str):
    """``device`` of a command's ``--device`` flag resolved to a
    ``torch.device``; without CUDA and without ``--device cpu`` it raises a
    ``RuntimeError`` that names ``command`` and the flag."""
    import torch

    from petastorm_tpu_torch.device import resolve_device
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            '{} runs on a CUDA device and none is available; pass '
            '--device cpu to run on the CPU explicitly'.format(command))
    return resolve_device(device)
