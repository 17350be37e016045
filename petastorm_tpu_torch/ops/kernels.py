"""Hand-written CUDA kernels (``csrc/*.cu``), their build and binding, and
the plain PyTorch twin of each.

Four kernels, each behind one wrapper with the same contract as its twin:

- ``flash_fwd`` (K1): ``(o, lse)``; bf16 on the tensor cores
  (``csrc/flash_fwd_sm90.cu``: wgmma fed by TMA), float32 on the FP32 cores
  (``csrc/flash_fwd.cu``);
- ``flash_bwd_dq`` (K2): ``dq``; bf16 on the tensor cores
  (``csrc/flash_bwd_dq_sm90.cu``), float32 on the FP32 cores
  (``csrc/flash_bwd.cu``);
- ``flash_bwd_dkdv`` (K3): ``(dk, dv)`` per q head; bf16 on the tensor cores
  (``csrc/flash_bwd_sm90.cu``), float32 on the FP32 cores
  (``csrc/flash_bwd.cu``);
- ``normalize`` (K4, ``csrc/normalize.cu``): a uint8 image batch of any
  channel count normalised per channel to bfloat16 or float32.

The attention kernels' contract is over flattened, contiguous tensors: q/do/o
``(BH, Lq, D)``, k/v ``(BHkv, Lk, D)`` with ``BH = B * H`` and ``BHkv = B *
Hkv`` (grouped-query attention when ``Hkv < H``; q row ``b`` reads kv row
``(b // H) * Hkv + (b % H) // (H // Hkv)``), lse/delta float32 ``(BH, Lq)``,
segment ids int32 ``(BH, Lq)`` / ``(BHkv, Lk)`` or None, ``window`` 0 for
none. A wrapper given CPU tensors runs the plain twin; given CUDA tensors it
launches its kernel or raises — there is no fallback.

The kernels are compiled on first use, one ``nvcc`` call a source, all
started together and linked into
``petastorm_tpu_torch/_build/<hash of the sources>``, and loaded with
``ctypes``; nothing is built or imported from CUDA when this module is
imported. The attention kernels are instantiated at the head dims of
:data:`HEAD_DIMS`: 32, 64 and 128 in bf16 (the tensor-core kernels), and
16, 32, 64 and 128 in float32 (the FP32-core kernels). A launch at any
other head dim up to :data:`MAX_HEAD_DIM` runs at the next instantiated
one (:func:`launch_head_dim`): q, k, v and do get zero columns up to it
(:func:`pad_heads`), the scale stays that of the true head dim, and o, dq,
dk and dv are cut back (:func:`unpad`). That is exact: zero columns add
nothing to q k^T and give zero output columns. A head dim past 128 raises.

The bf16 tensor-core kernels round p (K1), ds (K2), and p and ds (K3), to
bf16 before their second products, where the twins keep float32: their
outputs are held to :func:`flash_gate_limit`, a bound derived from that
one rounding (:func:`flash_rounding_bounds`), and to :func:`rounding_bias`
within :data:`BIAS_LIMIT` on non-negative operands. Every float32 output
keeps atol = rtol = 1e-4.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30

_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
_SOURCES = ('flash_common.cuh', 'sm90.cuh', 'flash_fwd.cu',
            'flash_fwd_sm90.cu', 'flash_bwd.cu', 'flash_bwd_dq_sm90.cu',
            'flash_bwd_sm90.cu', 'normalize.cu')
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Head dims the attention kernels are instantiated for, by dtype
#: (``csrc/flash_common.cuh`` for float32, ``csrc/sm90.cuh``'s ``Tile<D>``
#: for bf16).
HEAD_DIMS = {torch.float32: (16, 32, 64, 128),
             torch.bfloat16: (32, 64, 128)}
MAX_HEAD_DIM = 128

#: Launches per kernel since the last :func:`reset_launch_counts`; each
#: wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {'flash_fwd': 0, 'flash_bwd_dq': 0,
                            'flash_bwd_dkdv': 0, 'normalize': 0}

_lib = None
_lib_lock = threading.Lock()
#: ``{'seconds': float, 'path': str, 'log': str, 'cached': bool}`` of the
#: build that produced the loaded library.
BUILD_INFO: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels are compiled on '
                       'first use and need the CUDA toolkit')


#: Argument types of the C entry points, as declared in ``csrc/*.cu``: p a
#: pointer (or the stream), i an int, l a long long, f a float. Flash: the
#: pointers; BH, H, Hkv, Lq, Lk, D, causal, window; scale; dtype (and
#: out_f32); stream. normalize_u8: x, out; n; C; the (2, C) mean / inv_std
#: table; out dtype; stream.
_SIGNATURES = {'flash_fwd': 'p' * 7 + 'i' * 8 + 'fip',
               'flash_bwd_dq': 'p' * 9 + 'i' * 8 + 'fip',
               'flash_bwd_dkdv': 'p' * 10 + 'i' * 8 + 'fiip',
               'normalize_u8': 'pplipip'}
_CTYPES = {'p': ctypes.c_void_p, 'i': ctypes.c_int, 'l': ctypes.c_longlong,
           'f': ctypes.c_float}


def bind(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    """Declare ``argtypes`` and ``restype`` (a cudaError_t) of each entry
    point named in ``signatures`` (name -> :data:`_SIGNATURES` string)."""
    for name, sig in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in sig]
        fn.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library: one
    ``nvcc -c`` a source, all started together, then one link."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(' '.join(_NVCC_FLAGS).encode())
        for name in _SOURCES:
            digest.update((_CSRC / name).read_bytes())
        out_dir = _CSRC.parent / '_build' / digest.hexdigest()[:16]
        lib_path = out_dir / 'libpetastorm_kernels.so'
        start = time.perf_counter()
        log, cached = '', lib_path.exists()
        if not cached:
            out_dir.mkdir(parents=True, exist_ok=True)
            log = _compile(out_dir, lib_path)
            (out_dir / 'build.log').write_text(log)
        lib = bind(ctypes.CDLL(str(lib_path)), _SIGNATURES)
        BUILD_INFO.update(seconds=time.perf_counter() - start,
                          path=str(lib_path), log=log, cached=cached)
        _lib = lib
        return lib


def _compile(out_dir: Path, lib_path: Path) -> str:
    """Build ``lib_path`` from every ``.cu`` of :data:`_SOURCES`; returns
    the compilers' report (``-Xptxas -v``: registers and spills)."""
    nvcc, tag = _nvcc(), '%d' % os.getpid()
    compile_flags = [f for f in _NVCC_FLAGS if f != '-shared'] + ['-c']
    objects, procs = [], []
    for name in _SOURCES:
        if not name.endswith('.cu'):
            continue
        obj = out_dir / ('%s.%s.o' % (name[:-3], tag))
        objects.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *compile_flags, '-o', str(obj), str(_CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append('== %s\n%s' % (name, out))
        if proc.returncode != 0:
            failed.append(name)
    if not failed:
        tmp = out_dir / ('.tmp-%s.so' % tag)
        link = subprocess.run([nvcc, *_NVCC_FLAGS[:2], '-shared', '-o',
                               str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        logs.append('== link\n%s%s' % (link.stdout, link.stderr))
        if link.returncode != 0:
            failed.append('link')
        else:
            os.replace(tmp, lib_path)   # atomic: concurrent builds agree
    for obj in objects:
        obj.unlink(missing_ok=True)
    log = ''.join(logs)
    if failed:
        raise RuntimeError('nvcc failed (%s):\n%s' % (', '.join(failed), log))
    return log


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------

def _heads(bh: int, bhkv: int, n_heads: int, n_kv_heads: int) -> None:
    if (n_heads <= 0 or n_kv_heads <= 0 or n_heads % n_kv_heads
            or bh % n_heads or bhkv % n_kv_heads
            or bh // n_heads != bhkv // n_kv_heads):
        raise ValueError('rows %d/%d do not factor as batch x heads with '
                         'H=%d, Hkv=%d' % (bh, bhkv, n_heads, n_kv_heads))


def kv_index(bh: int, n_heads: int, n_kv_heads: int,
             device=None) -> torch.Tensor:
    """Flat kv row read by every flat q row (the GQA head map)."""
    b = torch.arange(bh, device=device)
    group = n_heads // n_kv_heads
    return (b // n_heads) * n_kv_heads + (b % n_heads) // group


def _check_cuda(name, tensors, dtype, shapes):
    for label, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError('%s: %s is on %s, expected a CUDA tensor'
                             % (name, label, t.device))
        want = shapes[label][1]
        if tuple(t.shape) != tuple(want):
            raise ValueError('%s: %s has shape %s, expected %s'
                             % (name, label, tuple(t.shape), tuple(want)))
        if t.dtype != shapes[label][0]:
            raise ValueError('%s: %s has dtype %s, expected %s'
                             % (name, label, t.dtype, shapes[label][0]))
        if not t.is_contiguous():
            raise ValueError('%s: %s must be contiguous' % (name, label))
    if dtype not in _DTYPES:
        raise ValueError('%s: dtype %s not supported (float32, bfloat16)'
                         % (name, dtype))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError('%s: CUDA launch failed with cudaError_t %d'
                           % (name, err))


def _geometry(q, k, n_heads, n_kv_heads, window):
    bh, lq, d = q.shape
    bhkv, lk, dk = k.shape
    _heads(bh, bhkv, n_heads, n_kv_heads)
    if dk != d:
        raise ValueError('q and k head dims differ: %d vs %d' % (d, dk))
    if window is not None and window < 1:
        raise ValueError('window must be >= 1, got %r' % (window,))
    return bh, bhkv, lq, lk, d


# ---------------------------------------------------------------------------
# plain twins (float32 math, kv streamed in blocks like the kernels)
# ---------------------------------------------------------------------------

_PLAIN_BLOCK = 512


def _block_mask(q_pos, k_pos, lk, causal, window, seg_q, seg_k):
    """(BH or 1, Lq, bk) validity of one kv block (the kernels' Mask)."""
    mask = (k_pos < lk)[None, None, :].expand(1, q_pos.numel(), -1)
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])[None]
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)[None]
    if seg_q is not None:
        mask = mask & (seg_q[:, :, None] == seg_k[:, None, :])
    return mask


def _plain_setup(q, k, v, seg_q, seg_kv, n_heads, n_kv_heads):
    """float32 operands with kv gathered per q row (GQA head map)."""
    idx = kv_index(q.shape[0], n_heads, n_kv_heads, q.device)
    k32, v32 = k.float()[idx], v.float()[idx]
    sk = seg_kv[idx] if seg_kv is not None else None
    return q.float(), k32, v32, sk


def _kv_blocks(lk, block=_PLAIN_BLOCK):
    for k0 in range(0, lk, block):
        yield k0, min(k0 + block, lk)


def flash_fwd_plain(q, k, v, *, n_heads, n_kv_heads, causal=True,
                    window=None, seg_q=None, seg_kv=None, scale=None,
                    block_k=_PLAIN_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch: online softmax over kv blocks of
    ``block_k`` (differentiable by autograd)."""
    bh, _, lq, lk, d = _geometry(q, k, n_heads, n_kv_heads, window)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q32, k32, v32, sk = _plain_setup(q, k, v, seg_q, seg_kv, n_heads,
                                     n_kv_heads)
    q_pos = torch.arange(lq, device=q.device)
    o = torch.zeros(bh, lq, d, dtype=torch.float32, device=q.device)
    m = torch.full((bh, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(bh, lq, dtype=torch.float32, device=q.device)
    for k0, k1 in _kv_blocks(lk, block_k):
        k_pos = torch.arange(k0, k1, device=q.device)
        mask = _block_mask(q_pos, k_pos, lk, causal, window, seg_q,
                           None if sk is None else sk[:, k0:k1])
        s = torch.einsum('bqd,bkd->bqk', q32, k32[:, k0:k1]) * scale
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum('bqk,bkd->bqd', p,
                                               v32[:, k0:k1])
        m = m_new
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF),
                      m + torch.log(safe_l))
    return (o / safe_l[..., None]).to(q.dtype), lse


def _recompute_p_ds(q32, do32, k_blk, v_blk, lse, delta, mask, scale):
    """The reference's ``_bwd_recompute_p_ds``: p gated by the mask and by
    ``lse > NEG_INF / 2``; ds = p * (do v^T - delta) * scale."""
    s = torch.einsum('bqd,bkd->bqk', q32, k_blk) * scale
    live = mask & (lse > NEG_INF / 2)[..., None]
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum('bqd,bkd->bqk', do32, v_blk)
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, n_heads, n_kv_heads,
                       causal=True, window=None, seg_q=None, seg_kv=None,
                       scale=None) -> torch.Tensor:
    """K2's function in plain PyTorch: dq = sum over kv blocks of ds k."""
    _, _, lq, lk, d = _geometry(q, k, n_heads, n_kv_heads, window)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q32, k32, v32, sk = _plain_setup(q, k, v, seg_q, seg_kv, n_heads,
                                     n_kv_heads)
    do32 = do.float()
    q_pos = torch.arange(lq, device=q.device)
    dq = torch.zeros_like(q32)
    for k0, k1 in _kv_blocks(lk):
        k_pos = torch.arange(k0, k1, device=q.device)
        mask = _block_mask(q_pos, k_pos, lk, causal, window, seg_q,
                           None if sk is None else sk[:, k0:k1])
        _, ds = _recompute_p_ds(q32, do32, k32[:, k0:k1], v32[:, k0:k1], lse,
                                delta, mask, scale)
        dq = dq + torch.einsum('bqk,bkd->bqd', ds, k32[:, k0:k1])
    return dq.to(q.dtype)


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, *, n_heads, n_kv_heads,
                         causal=True, window=None, seg_q=None, seg_kv=None,
                         scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: per-q-head dk = ds^T q, dv = p^T do,
    in k's dtype for multi-head attention and float32 partials for GQA."""
    bh, _, lq, lk, d = _geometry(q, k, n_heads, n_kv_heads, window)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q32, k32, v32, sk = _plain_setup(q, k, v, seg_q, seg_kv, n_heads,
                                     n_kv_heads)
    do32 = do.float()
    q_pos = torch.arange(lq, device=q.device)
    dks, dvs = [], []
    for k0, k1 in _kv_blocks(lk):
        k_pos = torch.arange(k0, k1, device=q.device)
        mask = _block_mask(q_pos, k_pos, lk, causal, window, seg_q,
                           None if sk is None else sk[:, k0:k1])
        p, ds = _recompute_p_ds(q32, do32, k32[:, k0:k1], v32[:, k0:k1], lse,
                                delta, mask, scale)
        dvs.append(torch.einsum('bqk,bqd->bkd', p, do32))
        dks.append(torch.einsum('bqk,bqd->bkd', ds, q32))
    out = torch.float32 if n_heads != n_kv_heads else k.dtype
    if not dks:
        empty = torch.zeros(bh, 0, d, dtype=out, device=q.device)
        return empty, empty.clone()
    return torch.cat(dks, 1).to(out), torch.cat(dvs, 1).to(out)


#: Largest relative error of rounding a float32 to nearest bfloat16.
BF16_ROUND = 2.0 ** -8


def flash_rounding_bounds(q, k, v, do, lse, delta, *, n_heads, n_kv_heads,
                          causal=True, window=None, seg_q=None, seg_kv=None,
                          scale=None) -> Dict[str, torch.Tensor]:
    """What one rounding of p (K1), ds (K2) or p and ds (K3) to bf16 can
    move each output, divided by :data:`BF16_ROUND`, from the twins' float32
    values: ``o``: sum_j (p_j / l) |v_j|; ``dq``: sum_j |ds_j| |k_j|;
    ``dv``: sum_i p_i |do_i|; ``dk``: sum_i |ds_i| |q_i|, each shaped like
    the wrapper's output (dk, dv per q head). For the gates of the tests
    and ``chip_smoke.py``; no path of the port calls it."""
    _, _, lq, lk, d = _geometry(q, k, n_heads, n_kv_heads, window)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, causal=causal,
              window=window, seg_q=seg_q, seg_kv=seg_kv, scale=scale)
    b_o, _ = flash_fwd_plain(q.float(), k.float(), v.float().abs(), **kw)
    q32, k32, v32, sk = _plain_setup(q, k, v, seg_q, seg_kv, n_heads,
                                     n_kv_heads)
    do32 = do.float()
    q_pos = torch.arange(lq, device=q.device)
    b_dk = torch.zeros(q.shape[0], lk, d, device=q.device)
    b_dv = torch.zeros_like(b_dk)
    b_dq = torch.zeros_like(q32)
    for k0, k1 in _kv_blocks(lk):
        k_pos = torch.arange(k0, k1, device=q.device)
        mask = _block_mask(q_pos, k_pos, lk, causal, window, seg_q,
                           None if sk is None else sk[:, k0:k1])
        p, ds = _recompute_p_ds(q32, do32, k32[:, k0:k1], v32[:, k0:k1], lse,
                                delta, mask, scale)
        b_dv[:, k0:k1] = torch.einsum('bqk,bqd->bkd', p, do32.abs())
        b_dk[:, k0:k1] = torch.einsum('bqk,bqd->bkd', ds.abs(), q32.abs())
        b_dq += torch.einsum('bqk,bkd->bqd', ds.abs(), k32[:, k0:k1].abs())
    return {'o': b_o, 'dq': b_dq, 'dk': b_dk, 'dv': b_dv}


def flash_gate_limit(ref, bound, dtype) -> torch.Tensor:
    """Per-element limit on ``|kernel - twin|`` for an output of a bf16
    tensor-core kernel: half a bf16 ulp of ``ref`` when the output is
    stored in bf16, plus ``BF16_ROUND * bound`` for the rounding of p or
    ds, plus ``1e-5 (1 + |ref|)`` for the float32 sums' order."""
    ref = ref.float()
    limit = BF16_ROUND * bound.float() + 1e-5 * (1 + ref.abs())
    if dtype == torch.bfloat16:
        _, exp = torch.frexp(ref)
        limit = limit + torch.ldexp(torch.ones_like(ref), exp - 9)
    return limit


#: Largest ``|rounding_bias|`` an output on non-negative operands may show.
BIAS_LIMIT = 0.1


def rounding_bias(got, ref, bound) -> float:
    """Mean signed error of ``got`` against ``ref`` over the mean of
    ``BF16_ROUND * bound``. Near 0 for rounding to nearest; where every
    term of the sums is non-negative, a truncating kernel reads clearly
    negative (beyond :data:`BIAS_LIMIT`)."""
    scale = float((BF16_ROUND * bound.float()).mean())
    return float((got.float() - ref.float()).mean()) / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _stream():
    return torch.cuda.current_stream().cuda_stream


def _seg_shapes(seg_q, seg_kv, bh, bhkv, lq, lk):
    if (seg_q is None) != (seg_kv is None):
        raise ValueError('pass both seg_q and seg_kv, or neither')
    return {'seg_q': (torch.int32, (bh, lq)),
            'seg_kv': (torch.int32, (bhkv, lk))}


def _check_tma(name, *tensors):
    """The bf16 kernels load tiles by TMA, which needs 16-byte-aligned
    global addresses."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError('%s: bf16 operands must be 16-byte aligned for '
                             'TMA (data_ptr %% 16 = %d)'
                             % (name, t.data_ptr() % 16))


def launch_head_dim(d: int, dtype) -> int:
    """The head dim a CUDA launch at head dim ``d`` runs at: the least one
    of :data:`HEAD_DIMS` for ``dtype`` that is at least ``d``. Raises
    ``ValueError`` past :data:`MAX_HEAD_DIM`."""
    for width in HEAD_DIMS.get(dtype, ()):
        if width >= d:
            return width
    raise ValueError('head dim %d not supported by the CUDA kernels: at most '
                     '%d (built for %s)' % (d, MAX_HEAD_DIM,
                                            HEAD_DIMS.get(dtype)))


def pad_heads(width: int, *tensors) -> Tuple[torch.Tensor, ...]:
    """Each tensor with zero columns appended to its last (head) dim up to
    ``width`` (a new contiguous tensor; as it is when already that wide)."""
    return tuple(t if t.shape[-1] == width
                 else F.pad(t, (0, width - t.shape[-1])) for t in tensors)


def unpad(d: int, *tensors) -> Tuple[torch.Tensor, ...]:
    """Each tensor cut back to its first ``d`` head-dim columns
    (contiguous)."""
    return tuple(t if t.shape[-1] == d else t[..., :d].contiguous()
                 for t in tensors)


def _launch_args(q, n_heads, n_kv_heads, causal, window):
    bh, lq, d = q.shape
    width = launch_head_dim(d, q.dtype)
    if bh > 65535:
        raise ValueError('batch x heads = %d exceeds the grid limit 65535'
                         % bh)
    return (width, n_heads, n_kv_heads, int(bool(causal)),
            int(window) if causal and window is not None else 0)


def flash_fwd(q, k, v, *, n_heads, n_kv_heads, causal=True, window=None,
              seg_q=None, seg_kv=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(o, lse)``; o in q's dtype, lse float32 ``(BH, Lq)``."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, n_heads=n_heads,
                               n_kv_heads=n_kv_heads, causal=causal,
                               window=window, seg_q=seg_q, seg_kv=seg_kv)
    bh, bhkv, lq, lk, d = _geometry(q, k, n_heads, n_kv_heads, window)
    shapes = {'q': (q.dtype, (bh, lq, d)), 'k': (q.dtype, (bhkv, lk, d)),
              'v': (q.dtype, (bhkv, lk, d))}
    shapes.update(_seg_shapes(seg_q, seg_kv, bh, bhkv, lq, lk))
    _check_cuda('flash_fwd', {'q': q, 'k': k, 'v': v, 'seg_q': seg_q,
                              'seg_kv': seg_kv}, q.dtype, shapes)
    width, h, hkv, c, w = _launch_args(q, n_heads, n_kv_heads, causal,
                                       window)
    if lq == 0 or bh == 0 or lk == 0:   # nothing to attend to: no launch
        return (torch.zeros_like(q),
                torch.full((bh, lq), NEG_INF, device=q.device))
    q, k, v = pad_heads(width, q, k, v)
    if q.dtype == torch.bfloat16:
        _check_tma('flash_fwd', q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(bh, lq, dtype=torch.float32, device=q.device)
    lib = build()
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        _ptr(seg_q), _ptr(seg_kv), o.data_ptr(),
                        lse.data_ptr(), bh, h, hkv, lq, lk, width, c, w,
                        1.0 / math.sqrt(d), _DTYPES[q.dtype], _stream())
    LAUNCHES['flash_fwd'] += 1
    _raise_on('flash_fwd', err)
    return unpad(d, o)[0], lse


def _check_bwd(name, q, k, v, do, lse, delta, seg_q, seg_kv, n_heads,
               n_kv_heads, window):
    bh, bhkv, lq, lk, d = _geometry(q, k, n_heads, n_kv_heads, window)
    shapes = {'q': (q.dtype, (bh, lq, d)), 'k': (q.dtype, (bhkv, lk, d)),
              'v': (q.dtype, (bhkv, lk, d)), 'do': (q.dtype, (bh, lq, d)),
              'lse': (torch.float32, (bh, lq)),
              'delta': (torch.float32, (bh, lq))}
    shapes.update(_seg_shapes(seg_q, seg_kv, bh, bhkv, lq, lk))
    _check_cuda(name, {'q': q, 'k': k, 'v': v, 'do': do, 'lse': lse,
                       'delta': delta, 'seg_q': seg_q, 'seg_kv': seg_kv},
                q.dtype, shapes)
    return bh, bhkv, lq, lk, d


def flash_bwd_dq(q, k, v, do, lse, delta, *, n_heads, n_kv_heads,
                 causal=True, window=None, seg_q=None,
                 seg_kv=None) -> torch.Tensor:
    """K2: dq in q's dtype."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, n_heads=n_heads,
                                  n_kv_heads=n_kv_heads, causal=causal,
                                  window=window, seg_q=seg_q, seg_kv=seg_kv)
    bh, _, lq, lk, d = _check_bwd('flash_bwd_dq', q, k, v, do, lse, delta,
                                  seg_q, seg_kv, n_heads, n_kv_heads, window)
    width, h, hkv, c, w = _launch_args(q, n_heads, n_kv_heads, causal,
                                       window)
    if lq == 0 or bh == 0 or lk == 0:   # no (q, k) pair: no launch
        return torch.zeros_like(q)
    q, k, v, do = pad_heads(width, q, k, v, do)
    if q.dtype == torch.bfloat16:
        _check_tma('flash_bwd_dq', q, k, v, do)
    dq = torch.empty_like(q)
    lib = build()
    err = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           _ptr(seg_q), _ptr(seg_kv), dq.data_ptr(), bh, h,
                           hkv, lq, lk, width, c, w, 1.0 / math.sqrt(d),
                           _DTYPES[q.dtype], _stream())
    LAUNCHES['flash_bwd_dq'] += 1
    _raise_on('flash_bwd_dq', err)
    return unpad(d, dq)[0]


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, n_heads, n_kv_heads,
                   causal=True, window=None, seg_q=None,
                   seg_kv=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: per-q-head ``(dk, dv)`` of shape ``(BH, Lk, D)``; k's dtype for
    multi-head attention, float32 partials for GQA (sum them per group)."""
    if not q.is_cuda:
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, n_heads=n_heads,
                                    n_kv_heads=n_kv_heads, causal=causal,
                                    window=window, seg_q=seg_q,
                                    seg_kv=seg_kv)
    bh, _, lq, lk, d = _check_bwd('flash_bwd_dkdv', q, k, v, do, lse, delta,
                                  seg_q, seg_kv, n_heads, n_kv_heads, window)
    width, h, hkv, c, w = _launch_args(q, n_heads, n_kv_heads, causal,
                                       window)
    out_f32 = n_heads != n_kv_heads
    out = torch.float32 if out_f32 else k.dtype
    if lk == 0 or bh == 0 or lq == 0:   # no (q, k) pair: no launch
        dk = torch.zeros(bh, lk, d, dtype=out, device=q.device)
        return dk, dk.clone()
    q, k, v, do = pad_heads(width, q, k, v, do)
    if q.dtype == torch.bfloat16:
        _check_tma('flash_bwd_dkdv', q, k, v, do)
    dk = torch.empty(bh, lk, width, dtype=out, device=q.device)
    dv = torch.empty(bh, lk, width, dtype=out, device=q.device)
    lib = build()
    err = lib.flash_bwd_dkdv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             _ptr(seg_q), _ptr(seg_kv), dk.data_ptr(),
                             dv.data_ptr(), bh, h, hkv, lq, lk, width, c, w,
                             1.0 / math.sqrt(d), _DTYPES[q.dtype],
                             int(out_f32), _stream())
    LAUNCHES['flash_bwd_dkdv'] += 1
    _raise_on('flash_bwd_dkdv', err)
    return unpad(d, dk, dv)


# ---------------------------------------------------------------------------
# K4: image normalisation
# ---------------------------------------------------------------------------

def _check_channels(images, mean, inv_std, dtype):
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError('normalize: images must be uint8 (N, H, W, C), got '
                         '%s %s' % (images.dtype, tuple(images.shape)))
    c = images.shape[-1]
    for label, t in (('mean', mean), ('inv_std', inv_std)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError('normalize: %s must be float32 (%d,), got %s %s'
                             % (label, c, t.dtype, tuple(t.shape)))
    if dtype not in _DTYPES:
        raise ValueError('normalize: dtype %s not supported (float32, '
                         'bfloat16)' % (dtype,))


def normalize_plain(images, mean, inv_std, dtype=torch.bfloat16):
    """K4's function in plain PyTorch: ``((x * (1/255)) - mean) * inv_std``
    in float32, each operation rounded on its own, then cast to ``dtype``.
    ``mean`` and ``inv_std`` are float32 ``(C,)``."""
    _check_channels(images, mean, inv_std, dtype)
    x = images.float() * (1.0 / 255.0)
    dev = images.device
    return ((x - mean.to(dev)) * inv_std.to(dev)).to(dtype)


@functools.lru_cache(maxsize=64)
def _channel_table(device: str, values: Tuple[float, ...]) -> torch.Tensor:
    """The mean then inv_std ``values`` as one float32 (2, C) table on
    ``device``, made once for each set of values (the copy is waited for,
    so a launch on any stream sees it; the kernels only read it)."""
    table = torch.tensor(values, dtype=torch.float32).view(2, -1).to(device)
    torch.cuda.synchronize(device)
    return table


def normalize(images, mean, inv_std, dtype=torch.bfloat16) -> torch.Tensor:
    """K4: the uint8 ``(N, H, W, C)`` batch normalised per channel to
    ``dtype`` (float32 or bfloat16), any ``C``. ``mean`` and ``inv_std`` are
    float32 ``(C,)`` tensors on any device; the kernel reads them as one
    table on the card (:func:`_channel_table`)."""
    if not images.is_cuda:
        return normalize_plain(images, mean, inv_std, dtype)
    _check_channels(images, mean, inv_std, dtype)
    if not images.is_contiguous():
        raise ValueError('normalize: images must be contiguous')
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    if images.numel() == 0:
        return out
    table = _channel_table(str(images.device),
                           tuple(mean.tolist() + inv_std.tolist()))
    lib = build()
    err = lib.normalize_u8(images.data_ptr(), out.data_ptr(), images.numel(),
                           images.shape[-1], table.data_ptr(),
                           _DTYPES[dtype], _stream())
    LAUNCHES['normalize'] += 1
    _raise_on('normalize', err)
    return out
