"""K1-K3 past the grid's 65,535 blocks along y.

A CUDA grid holds at most 65,535 blocks along y and z (2^31 - 1 along x).
The float32 kernels put batch x heads on y, the bf16 kernels their row
tiles (128 q rows for K1 and K2, 128 kv rows for K3, 64 in K3's split
kernel at head dim 256). Past that limit the C launchers run several
launches, each block adding the first row of its launch to ``blockIdx.y``:
every index a block computes stays absolute, so the grouped-query head map,
the causal and window masks and the segment lookups need no offset and a
launch may start anywhere, inside a kv group too.

On the CPU: ``kernels._launch_args`` takes any batch x heads (it raised
past 65,535 before), and the long cases' method holds: over one causal
sequence with a window of W, the twins on its last T + 2 W rows give the
whole sequence's o, lse, dq, dk and dv on the last T rows (and a slice of
T + W - 2 rows does not), and the twins on its first T + W rows give them
on the first T rows (and a slice of T + W - 2 rows does not). Both ends
are checked because the launches past the limit compute the first q tiles
(K1 and K2 launch the last tiles first) or the last kv tiles (K3): a
launch whose rows go unwritten or wrong fails the check. On the card
(``-m cuda``): batch x heads 65,536 in bf16 and float32 (one head, and 8
q heads over 2 kv heads), and bf16 sequences past 65,535 row tiles (L
8,388,736 at D 64; L 4,194,368 at D 256 for the split K3), against the
twins under ``chip_smoke``'s gates.
This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from petastorm_tpu_torch.ops import kernels

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('rows,d', [(65536, 64), (65536, 16), (8192 * 64, 32),
                                    (70000, 300)])
def test_launch_args_take_any_batch_x_heads(rows, d, dtype):
    """Batch x heads past 65,535 launches (``meta`` tensors: shapes only),
    at the head dim's launch width."""
    q = torch.empty(rows, 128, d, device='meta', dtype=dtype)
    width = kernels.launch_head_dim(d, dtype)
    assert kernels._launch_args(q, 8, 2, True, 128) == (width, 8, 2, 1, 128)
    assert kernels._launch_args(q, 1, 1, False, 128) == (width, 1, 1, 0, 0)


def test_launch_args_still_refuse_past_max_head_dim():
    q = torch.empty(65536, 1, kernels.MAX_HEAD_DIM + 1, device='meta',
                    dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='grid limit of 65535'):
        kernels._launch_args(q, 1, 1, True, None)


def _sequence(seed, l, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, l, d)).astype(
        np.float32)) for _ in range(4)]


def _whole_and_tail(q, k, v, do, rows, window, end='last'):
    """The twins over the whole sequence and over its last (or first)
    ``rows`` rows: (o, lse, dq, dk, dv) of each."""
    kw = dict(n_heads=1, n_kv_heads=1, causal=True, window=window)
    part = slice(-rows, None) if end == 'last' else slice(0, rows)
    out = []
    for x in ((q, k, v, do), tuple(t[:, part] for t in (q, k, v, do))):
        o, lse = kernels.flash_fwd_plain(*x[:3], **kw)
        delta = (x[3] * o).sum(-1)
        out.append((o, lse, kernels.flash_bwd_dq_plain(*x, lse, delta, **kw),
                    *kernels.flash_bwd_dkdv_plain(*x, lse, delta, **kw)))
    return out


@pytest.mark.parametrize('l,window,tail', [(700, 16, 24), (1100, 128, 256),
                                           (300, 1, 5)])
def test_tail_twin_equals_the_whole_sequence_on_its_last_rows(l, window,
                                                              tail):
    """Phase 32 (b)'s method: with a causal window of W, q row p sees keys
    p - W + 1 .. p, so rows from W - 1 into a slice of the last T + 2 W rows
    on see the same keys as in the whole sequence; dq on the last T rows
    and dk, dv there (read by q rows at or past them) match too."""
    q, k, v, do = _sequence(l, l, 32)
    whole, tail_twin = _whole_and_tail(q, k, v, do, tail + 2 * window,
                                       window)
    for name, a, b in zip(('o', 'lse', 'dq', 'dk', 'dv'), whole, tail_twin):
        torch.testing.assert_close(b[:, -tail:], a[:, -tail:], msg=name,
                                   **TOL)


def test_a_shorter_tail_twin_differs():
    """The control: a slice of T + W - 2 rows (one short of the T + W - 1
    that o needs) leaves the first of the last T rows without its oldest
    key, and o there differs."""
    l, window, tail = 700, 16, 24
    q, k, v, do = _sequence(0, l, 32)
    whole, short = _whole_and_tail(q, k, v, do, tail + window - 2, window)
    assert not torch.allclose(short[0][:, -tail:], whole[0][:, -tail:],
                              **TOL)


@pytest.mark.parametrize('l,window,head', [(700, 16, 24), (1100, 128, 256),
                                           (300, 1, 5)])
def test_head_twin_equals_the_whole_sequence_on_its_first_rows(l, window,
                                                               head):
    """Phase 32 (b)'s method at the sequence's start: the first T + W rows
    see no key before them, so the twins there give o, lse and dq on them
    as over the whole sequence, and dk, dv on the first T kv rows (read
    only by q rows below T + W - 1)."""
    q, k, v, do = _sequence(l + 1, l, 32)
    whole, head_twin = _whole_and_tail(q, k, v, do, head + window, window,
                                       end='first')
    for name, a, b in zip(('o', 'lse', 'dq', 'dk', 'dv'), whole, head_twin):
        torch.testing.assert_close(b[:, :head], a[:, :head], msg=name,
                                   **TOL)


def test_a_shorter_head_twin_differs():
    """The control: a slice of T + W - 2 rows leaves out q row T + W - 2,
    the last that reads kv row T - 1, and dk there differs."""
    l, window, head = 700, 16, 24
    q, k, v, do = _sequence(1, l, 32)
    whole, short = _whole_and_tail(q, k, v, do, head + window - 2, window,
                                   end='first')
    assert not torch.allclose(short[3][:, :head], whole[3][:, :head], **TOL)


@pytest.mark.parametrize('end', ['first', 'last'])
@pytest.mark.parametrize('wrapper,out', [('flash_fwd', 0),
                                         ('flash_bwd_dq', None),
                                         ('flash_bwd_dkdv', 0),
                                         ('flash_bwd_dkdv', 1)])
def test_tail_case_fails_on_wrong_rows_at_either_end(monkeypatch, wrapper,
                                                     out, end):
    """Phase 32 (b) fails when a launch leaves rows of an output wrong at
    either end of the sequence, as a launch past the limit that ignored
    its first row would (the mutant: a wrapper whose output has 40 rows
    there overwritten)."""
    real = getattr(kernels, wrapper)
    rows = slice(0, 40) if end == 'first' else slice(-40, None)

    def spoil(t):
        t = t.clone()
        t[:, rows] = 3.0
        return t

    def mutant(*args, **kw):
        res = real(*args, **kw)
        if out is None:
            return spoil(res)
        return tuple(spoil(t) if i == out else t for i, t in enumerate(res))

    monkeypatch.setattr(kernels, wrapper, mutant)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match='beyond the limit'):
        chip_smoke.tail_case(torch, kernels, 'cpu', gen, l=900, d=64,
                             window=32, tail=40)


def test_phase_32_rehearses_on_the_cpu():
    """``chip_smoke.py``'s phase 32 (b) at a small length on the CPU (the
    wrappers run the twins, launching nothing): every output within its
    gate; (c)'s determinism check on the twins."""
    gen = torch.Generator().manual_seed(0)
    errs = chip_smoke.tail_case(torch, kernels, 'cpu', gen, l=900, d=64,
                                window=32, tail=40)
    assert set(errs) == {'lse', 'o', 'dq', 'dk', 'dv'}
    assert errs['lse'] < 1e-4
    assert chip_smoke.GRID_LONG_CASES[0][1]['l'] == 65537 * 128
    assert chip_smoke.GRID_LONG_CASES[1][1] == dict(l=65537 * 64, d=256)
    for _, case in chip_smoke.GRID_ROWS_CASES:
        assert case['b'] * case['h'] == 65536


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('case', chip_smoke.GRID_ROWS_CASES,
                         ids=[c[0] for c in chip_smoke.GRID_ROWS_CASES])
def test_cuda_batch_heads_past_the_grid_limit(case, dtype):
    """K1-K3 at batch x heads 65,536 against the twins, each launched once
    (run on a GPU host)."""
    gen = _card()
    label, shape = case
    kernels.reset_launch_counts()
    chip_smoke.compare_case(torch, kernels, label, gen,
                            dtype=getattr(torch, dtype), **shape)
    assert all(kernels.LAUNCHES[n] == 1 for n in chip_smoke.FLASH)


@pytest.mark.cuda
@pytest.mark.parametrize('case', chip_smoke.GRID_LONG_CASES,
                         ids=[c[0] for c in chip_smoke.GRID_LONG_CASES])
def test_cuda_sequence_past_the_grid_limit(case):
    """K1-K3 in bf16 over one sequence past 65,535 row tiles, the first and
    the last rows against the twins on the sequence's head and tail (run on
    a GPU host)."""
    gen = _card()
    label, shape = case
    errs = chip_smoke.tail_case(torch, kernels, label, gen, **shape)
    assert set(errs) == {'lse', 'o', 'dq', 'dk', 'dv'}
