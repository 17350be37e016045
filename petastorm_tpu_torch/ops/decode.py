"""Device decode of bytes-through columns.

The port's copy of ``petastorm_tpu/ops/decode.py``. A column whose stored
cells all share one ``np.save`` header (a fixed-shape, non-nullable,
little-endian ``NdarrayCodec`` column) need not be decoded on the host:

- **plan** (:func:`plan_device_decode`, JAX :178-244): when a reader is
  made, each column of its view either gets a :class:`DeviceColumnPlan`
  pinning the header and the cell's bytes, or declines with a reason.
  Features that need decoded host values (a predicate, NGram windows, a
  decode hint, a host ``TransformSpec``, row-granular output) decline the
  whole reader. A declined column decodes on the host; it never raises.
- **ship** (:func:`raw_column_view`, :251-290): workers skip the codec for
  planned columns and publish each as one ``(n, stride)`` uint8 grid, a
  zero-copy view of the arrow data buffer. A chunk that does not match the
  plan (nulls, another header, another stride) is host-decoded and
  re-laid as the grid (:func:`repack_to_raw`), so a column keeps one
  representation for the reader's lifetime.
- **decode** (:func:`decode_raw_torch`, :320-342): on the loader's
  device, strip the header and reinterpret the bytes (``Tensor.view``),
  then run a ``device=True`` ``TransformSpec`` (:func:`build_fused_infeed`).
  :func:`decode_raw_host` is the numpy reference and the reader's host
  fallback when no loader claims the plans.

Unlike JAX without x64, torch keeps 8-byte dtypes, so int64, uint64 and
float64 columns plan as the JAX package plans them under
``JAX_ENABLE_X64``. The JAX package's decliner for a missing jax backend
has no counterpart here.

This module imports no torch at import time: the workers import it.
"""

from __future__ import annotations

import io
import os
import sys
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import (BATCHED_DECODE_ENV_VAR,
                                        _parse_fast_npy_header,
                                        batched_decode_enabled,
                                        split_binary_chunk)

#: The JAX package's switch (default on where eligible); ``0``, ``false``
#: or ``off`` plans nothing. Read once per reader, when it is made.
DEVICE_DECODE_ENV_VAR = 'PETASTORM_TPU_DEVICE_DECODE'


def device_decode_enabled() -> bool:
    """The :data:`DEVICE_DECODE_ENV_VAR` switch (default on)."""
    value = os.environ.get(DEVICE_DECODE_ENV_VAR, '').strip().lower()
    return value not in ('0', 'false', 'off')


class DeviceColumnPlan(NamedTuple):
    """One column's decode plan, made when the reader is made and passed
    to the workers: every cell is ``header`` (the ``np.save`` v1 prefix of
    ``(descr, shape)``) followed by ``stride - header_len`` payload
    bytes."""

    name: str
    descr: str          # normalized dtype.str, e.g. '<f4' / '|u1'
    shape: Tuple[int, ...]
    header: bytes       # the full np.save v1 prefix (magic + len + dict)

    @property
    def header_len(self) -> int:
        return len(self.header)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.descr)

    @property
    def cell_count(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def cell_nbytes(self) -> int:
        return self.cell_count * self.dtype.itemsize

    @property
    def stride(self) -> int:
        return self.header_len + self.cell_nbytes


def npy_header_bytes(dtype, shape) -> Optional[bytes]:
    """The ``np.save`` v1 prefix every cell of a fixed ``(dtype, shape)``
    column shares, or None when the writer does not emit the form the
    strict header parser accepts. Made by running the writer itself on a
    dummy and parsed back."""
    dtype = np.dtype(dtype)
    if dtype.hasobject:
        return None
    buf = io.BytesIO()
    try:
        np.save(buf, np.zeros(tuple(shape), dtype=dtype))
    except (TypeError, ValueError):
        return None
    raw = buf.getvalue()
    parsed = _parse_fast_npy_header(memoryview(raw))
    if parsed is None:
        return None
    parsed_dtype, parsed_shape, header_end = parsed
    if parsed_dtype != dtype or parsed_shape != tuple(shape):
        return None
    return raw[:header_end]


def plan_for_field(field) -> Tuple[Optional[DeviceColumnPlan], Optional[str]]:
    """``(plan, None)`` when ``field`` can decode on the device, else
    ``(None, reason)``. The codec gives the verdict
    (``device_decode_unsupported_reason``); the header is pinned here.
    A header whose length is not a multiple of the itemsize declines:
    ``Tensor.view(dtype)`` of the payload needs its offset and row stride
    to be multiples of it (numpy pads v1 headers to 64 bytes, so this
    holds for what ``np.save`` writes)."""
    codec = field.codec
    if codec is None:
        return None, 'native arrow column (no codec payload to strip)'
    check = getattr(codec, 'device_decode_unsupported_reason', None)
    if check is None:
        return None, 'codec {} has no device-decode path'.format(
            type(codec).__name__)
    reason = check(field)
    if reason:
        return None, reason
    dtype = np.dtype(field.numpy_dtype)
    header = npy_header_bytes(dtype, field.shape)
    if header is None:
        return None, 'np.save header for {} {} is not the machine-' \
            'generated v1 form'.format(dtype, field.shape)
    if len(header) % dtype.itemsize:
        return None, 'np.save header of {} bytes does not align {}'.format(
            len(header), dtype)
    return DeviceColumnPlan(name=field.name, descr=dtype.str,
                            shape=tuple(field.shape), header=header), None


def plan_device_decode(schema, enabled: Optional[bool] = None,
                       has_predicate: bool = False,
                       has_ngram: bool = False,
                       decode_hints: Optional[dict] = None,
                       transform_spec=None,
                       transformed_schema=None,
                       batched_output: bool = True,
                       tolerant_decode: bool = False,
                       worker_supported: bool = True):
    """``(plans, declined)`` for a reader's view ``schema``: ``plans``
    maps a column name to its :class:`DeviceColumnPlan`; ``declined`` maps
    a column name, or ``'*'`` for a reason that holds for the whole
    reader, to why it decodes on the host. The whole-reader reasons come
    first, in the JAX package's order and words. ``tolerant_decode``
    (``on_decode_error`` other than ``'raise'``) declines every column:
    only the host decode sees which cell failed."""
    declined: Dict[str, str] = {}
    if enabled is None:
        enabled = device_decode_enabled()
    if not enabled:
        return {}, {'*': '{}=off'.format(DEVICE_DECODE_ENV_VAR)}
    if not batched_decode_enabled():
        # the per-cell switch sends every codec cell through the host loop;
        # a raw grid would go round it
        return {}, {'*': '{}=off forces the host per-cell loop'.format(
            BATCHED_DECODE_ENV_VAR)}
    if not batched_output:
        return {}, {'*': 'row-granular reader (rows split out of columns '
                         'before any loader could decode them)'}
    if not worker_supported:
        return {}, {'*': 'worker class has no bytes-through publish path '
                         '(supports_device_decode is unset)'}
    if has_predicate:
        return {}, {'*': 'predicate evaluates on decoded host values'}
    if has_ngram:
        return {}, {'*': 'NGram windows regroup decoded rows on the host'}
    if tolerant_decode:
        return {}, {'*': 'on_decode_error quarantines per-cell codec '
                         'failures, which only the host decode can observe'}
    if transform_spec is not None and not getattr(transform_spec, 'device',
                                                  False):
        return {}, {'*': 'host TransformSpec receives decoded columns '
                         '(declare device=True to fuse it into the jitted '
                         'decode instead)'}
    if (transform_spec is not None and transformed_schema is not None
            and set(transformed_schema.fields) != set(schema.fields)):
        return {}, {'*': 'device TransformSpec changes the field set '
                         '(edit dtypes/shapes in place to stay fusable)'}
    plans: Dict[str, DeviceColumnPlan] = {}
    hints = decode_hints or {}
    for name, field in schema.fields.items():
        if name in hints:
            declined[name] = 'per-field decode hint overrides the codec'
            continue
        plan, reason = plan_for_field(field)
        if plan is None:
            declined[name] = reason or 'ineligible'
        else:
            plans[name] = plan
    return plans, declined


# ---------------------------------------------------------------------------
# worker side: raw views and the host repack
# ---------------------------------------------------------------------------

def raw_column_view(column, plan: DeviceColumnPlan) -> Optional[np.ndarray]:
    """The ``(n, stride)`` uint8 grid of a binary column's cells, zero-copy
    out of the arrow data buffer (several chunks are concatenated), or
    None when the stored bytes do not match the plan: nulls, another
    stride, a cell with another header. None means host-decode and
    repack, never an error."""
    chunks = column.chunks if isinstance(column, pa.ChunkedArray) else [column]
    header = np.frombuffer(plan.header, dtype=np.uint8)
    stride = plan.stride
    parts = []
    for chunk in chunks:
        if chunk.null_count:
            return None
        n = len(chunk)
        if n == 0:
            continue
        offsets, data = split_binary_chunk(chunk)
        if int(offsets[1]) - int(offsets[0]) != stride or not bool(
                np.all(np.diff(offsets) == stride)):
            return None
        grid = data[int(offsets[0]):int(offsets[-1])].reshape(n, stride)
        if not bool((grid[:, :plan.header_len] == header).all()):
            return None
        parts.append(grid)
    if not parts:
        return np.empty((0, stride), dtype=np.uint8)
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts, axis=0)


def repack_to_raw(plan: DeviceColumnPlan, decoded) -> np.ndarray:
    """Host-decoded ``(n, *shape)`` values laid out as the plan's raw
    ``(n, stride)`` grid: the fallback when :func:`raw_column_view`
    declines a chunk."""
    decoded = np.ascontiguousarray(decoded, dtype=plan.dtype)
    n = decoded.shape[0] if decoded.ndim else 0
    if decoded.shape[1:] != plan.shape:
        raise ValueError('repack_to_raw: column {!r} decoded to {} but the '
                         'plan pins cell shape {}'.format(
                             plan.name, decoded.shape[1:], plan.shape))
    out = np.empty((n, plan.stride), dtype=np.uint8)
    out[:, :plan.header_len] = np.frombuffer(plan.header, dtype=np.uint8)
    if plan.cell_nbytes:
        out[:, plan.header_len:] = decoded.reshape(n, -1).view(np.uint8)
    return out


# ---------------------------------------------------------------------------
# decode: the numpy reference and the torch decode
# ---------------------------------------------------------------------------

def decode_raw_host(plan: DeviceColumnPlan, raw) -> np.ndarray:
    """The numpy reference of :func:`decode_raw_torch`, and the reader's
    host fallback: a writable ``(n, *shape)`` array."""
    raw = np.asarray(raw)
    n = raw.shape[0]
    if not plan.cell_count:
        return np.empty((n,) + plan.shape, dtype=plan.dtype)
    payload = np.ascontiguousarray(raw[:, plan.header_len:])
    if not payload.flags.writeable:
        payload = payload.copy()
    return payload.view(plan.dtype).reshape((n,) + plan.shape)


def decode_raw_torch(plan: DeviceColumnPlan, raw):
    """One planned column's decode on ``raw``'s device: a ``(n, stride)``
    uint8 tensor → a fresh contiguous ``(n, *shape)`` tensor of the plan's
    dtype, bit-identical to :func:`decode_raw_host`. The payload
    ``raw[:, header_len:]`` is reinterpreted in place (``Tensor.view``),
    then copied out contiguous, so the result does not hold the grid. A
    bool column decodes as ``payload != 0`` (``np.save`` stores 0 or 1)."""
    import torch
    n = raw.shape[0]
    dtype = torch.from_numpy(np.empty(0, plan.dtype)).dtype
    if not plan.cell_count:
        return torch.zeros((n,) + plan.shape, dtype=dtype, device=raw.device)
    payload = raw[:, plan.header_len:]
    if dtype == torch.bool:
        out = payload != 0
    else:
        out = payload.view(dtype).contiguous()
    return out.reshape((n,) + plan.shape)


def build_fused_infeed(plans: Dict[str, DeviceColumnPlan],
                       transform_spec=None):
    """The staging step of a bytes-through batch: decode every planned raw
    column, then run the ``device=True`` ``TransformSpec`` over the whole
    column dict. The returned function takes and returns a dict of
    tensors; the caller keeps host-only columns out and merges them back
    (``TorchDataLoader`` and :func:`prefetch_to_device` share it). A plain
    function: each step launches its own kernels on the current stream."""
    plans = dict(plans)
    func = getattr(transform_spec, 'func', None)

    def fused(columns):
        out = dict(columns)
        for name, plan in plans.items():
            if name in out:
                out[name] = decode_raw_torch(plan, out[name])
        if func is not None:
            out = func(out)
        return out

    return fused


def split_device_columns(batch, plans: Dict[str, DeviceColumnPlan],
                         include_unplanned: bool = False):
    """``(device_cols, host_cols)``: planned raw columns go to the device
    decode; every other column stays where it is. ``include_unplanned``
    also sends the other numeric columns (numpy arrays or tensors): a
    device ``TransformSpec`` receives the whole column dict. Object and
    string columns stay on the host either way."""
    device_cols, host_cols = {}, {}
    for name, value in batch.items():
        if name in plans:
            device_cols[name] = value
        elif include_unplanned and _is_numeric(value):
            device_cols[name] = value
        else:
            host_cols[name] = value
    return device_cols, host_cols


def _is_numeric(value) -> bool:
    if isinstance(value, np.ndarray):
        return value.dtype.kind in 'biufc'
    torch = sys.modules.get('torch')    # no tensor exists without torch
    return torch is not None and torch.is_tensor(value)
