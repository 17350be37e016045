"""Per-field codecs of the port: ``NdarrayCodec`` and ``ScalarCodec``.

A copy of the two codecs the token-store path needs from
``petastorm_tpu/codecs.py`` (``NdarrayCodec`` :247, ``ScalarCodec`` :633, the
strict ``np.save`` header parser ``_parse_fast_npy_header`` :205). Codecs are
serialized to JSON by registered name, never pickled, under the same names
as the JAX package, so stores written by either package read in the other.
A schema naming any other codec raises ``NotImplementedError``.
"""

from __future__ import annotations

import io
import re
from typing import Any, Dict

import numpy as np
import pyarrow as pa

#: Codecs of the JAX package that this port does not carry yet, with the
#: slice that brings them.
_LATER = {
    'compressed_image': 'the image slice',
    'compressed_ndarray': 'the image slice',
    'arrow_list': 'the columnar-reader slice',
}


def split_binary_chunk(chunk: pa.Array):
    """``(offsets, data)`` of one (large_)binary arrow chunk, zero-copy."""
    n = len(chunk)
    _validity, offsets_buf, data_buf = chunk.buffers()
    off_dtype = np.dtype(
        np.int64 if pa.types.is_large_binary(chunk.type) else np.int32)
    offsets = np.frombuffer(offsets_buf, dtype=off_dtype, count=n + 1,
                            offset=chunk.offset * off_dtype.itemsize)
    data = (np.frombuffer(data_buf, dtype=np.uint8)
            if data_buf is not None else np.empty(0, np.uint8))
    return offsets, data


def _is_compliant_shape(actual: tuple, expected: tuple) -> bool:
    """True if ``actual`` matches ``expected`` where ``None`` is a wildcard."""
    return len(actual) == len(expected) and all(
        e is None or a == e for a, e in zip(actual, expected))


def _check_shape(field, value: np.ndarray):
    if not _is_compliant_shape(value.shape, field.shape):
        raise ValueError(
            'Field {!r} with shape {} got a value of non-compliant shape {}'
            .format(field.name, field.shape, value.shape))


def _check_dtype(field, value: np.ndarray):
    declared = field.numpy_dtype
    if declared is str:
        ok = value.dtype.kind == 'U'
    elif declared is bytes:
        ok = value.dtype.kind == 'S'
    else:
        declared = np.dtype(declared)
        ok = (value.dtype.kind == declared.kind if declared.kind in 'US'
              else value.dtype == declared)
    if not ok:
        raise ValueError('Field {!r} expected dtype {} got {}'.format(
            field.name, field.numpy_dtype, value.dtype))


# Strict matcher for the header np.save itself writes; anything else
# (fortran order, structured or object dtypes) goes through np.load.
_NPY_FAST_HEADER = re.compile(
    rb"^\{'descr': '([<>=|][a-zA-Z]\d*)', 'fortran_order': False, "
    rb"'shape': \((\d*(?:, ?\d+)*,?)\), \}\s*$")


def _parse_fast_npy_header(value):
    """``(dtype, shape, header_end)`` of a standard-form ``np.save`` v1
    payload prefix, or ``None`` when the header is not machine-generated
    v1. ``value`` is any sliceable buffer (bytes or memoryview)."""
    if len(value) < 10 or bytes(value[:8]) != b'\x93NUMPY\x01\x00':
        return None
    hlen = value[8] | (value[9] << 8)
    header_end = 10 + hlen
    m = _NPY_FAST_HEADER.match(value[10:header_end])
    if m is None:
        return None
    dtype = np.dtype(m.group(1).decode())
    if dtype.hasobject:
        return None
    shape_src = m.group(2)
    shape = tuple(int(p) for p in shape_src.replace(b' ', b'').split(b',')
                  if p) if shape_src else ()
    return dtype, shape, header_end


def _fast_npy_decode(value):
    """Decode an ``np.save`` payload without ast header parsing (a writable
    copy); None when the payload is not in the standard v1 form."""
    if isinstance(value, np.ndarray):
        value = memoryview(value)
    parsed = _parse_fast_npy_header(value)
    if parsed is None:
        return None
    dtype, shape, header_end = parsed
    return np.frombuffer(value, dtype=dtype,
                         offset=header_end).reshape(shape).copy()


class _Codec:
    """JSON identity shared by the codecs: registered name plus options."""

    codec_name: str = None

    def to_json_dict(self) -> Dict[str, Any]:
        return {'codec': self.codec_name}

    @classmethod
    def from_json_dict(cls, d):
        return cls()

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.to_json_dict() == other.to_json_dict())

    def __hash__(self):
        return hash(repr(sorted(self.to_json_dict().items())))


class NdarrayCodec(_Codec):
    """Lossless ndarray <-> bytes via ``np.save``."""

    codec_name = 'ndarray'

    def encode(self, field, value):
        _check_dtype(field, value)
        _check_shape(field, value)
        memfile = io.BytesIO()
        np.save(memfile, value)
        return memfile.getvalue()

    def decode(self, field, value):
        fast = _fast_npy_decode(value)
        return fast if fast is not None else np.load(io.BytesIO(value))

    def decode_column(self, field, chunk: pa.Array) -> np.ndarray:
        """One binary chunk → ``(n, *shape)``. Fixed-shape columns whose
        cells share one ``np.save`` header (what :meth:`encode` writes)
        decode with one compare and one copy; anything else goes cell by
        cell. Both give the same bytes."""
        fast = self._decode_uniform(field, chunk)
        if fast is not None:
            return fast
        cells = [self.decode(field, v) for v in chunk.to_pylist()]
        shapes = {c.shape for c in cells}
        if len(shapes) == 1:
            return np.stack(cells) if cells else np.empty(
                (0,) + tuple(s or 0 for s in field.shape),
                np.dtype(field.numpy_dtype))
        out = np.empty(len(cells), dtype=object)
        out[:] = cells
        return out

    @staticmethod
    def _decode_uniform(field, chunk):
        shape = field.shape
        if (shape is None or any(s is None for s in shape)
                or chunk.null_count or len(chunk) == 0):
            return None
        n = len(chunk)
        offsets, data = split_binary_chunk(chunk)
        stride = int(offsets[1]) - int(offsets[0])
        if stride <= 10 or not bool(np.all(np.diff(offsets) == stride)):
            return None
        block = data[int(offsets[0]):int(offsets[-1])]
        parsed = _parse_fast_npy_header(memoryview(block[:stride]))
        if parsed is None:
            return None
        dtype, cell_shape, header_end = parsed
        expected = int(np.prod(cell_shape, dtype=np.int64)) * dtype.itemsize
        if stride - header_end != expected or expected == 0:
            return None
        grid = block.reshape(n, stride)
        if not bool((grid[:, :header_end] == grid[0, :header_end]).all()):
            return None
        payload = np.array(grid[:, header_end:])      # writable copy
        return payload.view(dtype).reshape((n,) + cell_shape)

    def arrow_type(self, field):
        return pa.binary()

    def __repr__(self):
        return 'NdarrayCodec()'


class ScalarCodec(_Codec):
    """A scalar stored natively in the column, cast to a numpy dtype (the
    field's own unless one is given)."""

    codec_name = 'scalar'

    def __init__(self, numpy_dtype=None):
        self._dtype = (np.dtype(numpy_dtype) if numpy_dtype is not None
                       else None)

    def _storage_dtype(self, field):
        return (self._dtype if self._dtype is not None
                else np.dtype(field.numpy_dtype))

    def encode(self, field, value):
        if isinstance(value, np.ndarray) and value.ndim > 0:
            raise TypeError('Field {!r} is scalar but got an array of shape '
                            '{}'.format(field.name, value.shape))
        dtype = self._storage_dtype(field)
        if dtype.kind in ('U', 'S', 'O'):
            return value if isinstance(value, (str, bytes)) else str(value)
        if dtype.kind == 'b':
            return bool(value)
        return np.asarray(value).astype(dtype).item()

    def decode(self, field, value):
        dtype = np.dtype(field.numpy_dtype)
        return value if dtype.kind in ('U', 'S', 'O') else dtype.type(value)

    def decode_column(self, field, chunk: pa.Array) -> np.ndarray:
        dtype = np.dtype(field.numpy_dtype)
        if dtype.kind in ('U', 'S', 'O') or chunk.null_count:
            out = np.empty(len(chunk), dtype=object)
            out[:] = [None if v is None else self.decode(field, v)
                      for v in chunk.to_pylist()]
            return out
        return chunk.to_numpy(zero_copy_only=False).astype(dtype, copy=False)

    def arrow_type(self, field):
        dtype = self._storage_dtype(field)
        if dtype.kind in ('U', 'O'):
            return pa.string()
        if dtype.kind == 'S':
            return pa.binary()
        if dtype.kind == 'M':
            return pa.timestamp('ns')
        return pa.from_numpy_dtype(dtype)

    def to_json_dict(self):
        d = {'codec': self.codec_name}
        if self._dtype is not None:
            d['dtype'] = self._dtype.str
        return d

    @classmethod
    def from_json_dict(cls, d):
        return cls(numpy_dtype=d.get('dtype'))

    def __repr__(self):
        return 'ScalarCodec({})'.format(
            self._dtype if self._dtype is not None else '')


_CODEC_REGISTRY = {c.codec_name: c for c in (NdarrayCodec, ScalarCodec)}


def codec_from_json_dict(d: Dict[str, Any]):
    name = d['codec']
    if name in _LATER:
        raise NotImplementedError(
            'codec {!r} is not ported to petastorm_tpu_torch yet; it comes '
            'with {}'.format(name, _LATER[name]))
    if name not in _CODEC_REGISTRY:
        raise ValueError('Unknown codec name {!r}; known: {}'.format(
            name, sorted(_CODEC_REGISTRY)))
    return _CODEC_REGISTRY[name].from_json_dict(d)
