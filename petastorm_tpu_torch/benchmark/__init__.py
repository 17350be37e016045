"""The port's instruments (``petastorm_tpu/benchmark/``): reader throughput
with host metrics and its ``petastorm-tpu-torch-throughput`` command, the
loader micro-benchmark over a dummy reader, the infeed/compute overlap of
real training steps, the north-star train benches, and the goodput and
device-decode benches. Each entry point runs on the CUDA device unless the
caller passes ``device='cpu'`` (``--device cpu`` for the commands), and
raises without CUDA otherwise. The modules import no torch until a bench
runs."""


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
