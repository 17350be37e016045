"""Per-field codecs of the port: ``NdarrayCodec``, ``ScalarCodec``,
``CompressedNdarrayCodec`` and ``CompressedImageCodec``.

A copy of the codecs the token and image paths need from
``petastorm_tpu/codecs.py`` (``NdarrayCodec`` :247, ``CompressedNdarrayCodec``
:387, ``CompressedImageCodec`` :421, ``ScalarCodec`` :633, the strict
``np.save`` header parser ``_parse_fast_npy_header`` :205). Codecs are
serialized to JSON by registered name, never pickled, under the same names
as the JAX package, so stores written by either package read in the other.
A schema naming any other codec raises ``NotImplementedError``.
"""

from __future__ import annotations

import io
import re
from typing import Any, Callable, Dict

import numpy as np
import pyarrow as pa

#: Codecs of the JAX package that this port does not carry yet, with the
#: slice that brings them.
_LATER = {
    'arrow_list': 'the MoE / GQA config slice',
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


def _is_fixed(field) -> bool:
    return field.shape is not None and all(s is not None for s in field.shape)


def decode_cells(field, chunk: pa.Array,
                 decode_cell: Callable) -> np.ndarray:
    """Decode a binary chunk cell by cell (cells are zero-copy uint8 views):
    ``(n, *shape)`` for a fixed-shape null-free field, else an object array
    with ``None`` for null cells (the JAX reader's ``_decode_cells``)."""
    n = len(chunk)
    if n == 0:
        if _is_fixed(field):
            return np.empty((0,) + tuple(field.shape),
                            np.dtype(field.numpy_dtype))
        return np.empty(0, dtype=object)
    offsets, data = split_binary_chunk(chunk)
    valid = (chunk.is_valid().to_numpy(zero_copy_only=False)
             if chunk.null_count else None)
    cells = [data[int(offsets[i]):int(offsets[i + 1])]
             if valid is None or valid[i] else None for i in range(n)]
    if _is_fixed(field) and valid is None:
        first = decode_cell(cells[0])
        out = np.empty((n,) + first.shape, dtype=first.dtype)
        out[0] = first
        for i in range(1, n):
            out[i] = decode_cell(cells[i])
        return out
    out = np.empty(n, dtype=object)
    for i, cell in enumerate(cells):
        out[i] = None if cell is None else decode_cell(cell)
    return out


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


class CompressedNdarrayCodec(_Codec):
    """zlib-compressed ndarray via ``np.savez_compressed``."""

    codec_name = 'compressed_ndarray'

    def encode(self, field, value):
        _check_dtype(field, value)
        _check_shape(field, value)
        memfile = io.BytesIO()
        np.savez_compressed(memfile, arr=value)
        return memfile.getvalue()

    def decode(self, field, value):
        return np.load(io.BytesIO(value))['arr']

    def make_cell_decoder(self, field):
        def decode_cell(cell):       # BytesIO takes buffer views directly
            return np.load(io.BytesIO(cell))['arr']
        return decode_cell

    def decode_column(self, field, chunk: pa.Array) -> np.ndarray:
        return decode_cells(field, chunk, self.make_cell_decoder(field))

    def arrow_type(self, field):
        return pa.binary()

    def __repr__(self):
        return 'CompressedNdarrayCodec()'


class CompressedImageCodec(_Codec):
    """png/jpeg image compression via OpenCV, imported when first used.

    Values are uint8 (or uint16 for png) ``(H, W)`` or ``(H, W, 3)`` arrays
    in RGB order; cv2's BGR order is converted at the codec boundary."""

    codec_name = 'compressed_image'

    def __init__(self, image_codec='png', quality=80):
        if image_codec not in ('png', 'jpeg', 'jpg'):
            raise ValueError('image_codec must be png or jpeg, got {!r}'
                             .format(image_codec))
        self._image_codec = '.' + image_codec
        self._quality = int(quality)

    @property
    def image_codec(self):
        return self._image_codec[1:]

    @property
    def quality(self):
        return self._quality

    def encode(self, field, value):
        import cv2
        _check_dtype(field, value)
        _check_shape(field, value)
        image = value
        if value.ndim == 3 and value.shape[2] == 3:
            image = cv2.cvtColor(value, cv2.COLOR_RGB2BGR)
        params = ([int(cv2.IMWRITE_JPEG_QUALITY), self._quality]
                  if self._image_codec in ('.jpeg', '.jpg') else [])
        ok, contents = cv2.imencode(self._image_codec, image, params)
        if not ok:
            raise ValueError('cv2.imencode failed for field {!r}'
                             .format(field.name))
        return contents.tobytes()

    def decode(self, field, value):
        return self.make_cell_decoder(field)(value)

    def make_cell_decoder(self, field):
        """``decode`` with the cv2 lookups hoisted out of the per-cell loop;
        takes bytes or a uint8 view."""
        import cv2
        imdecode, cvt_color = cv2.imdecode, cv2.cvtColor
        bgr2rgb, flag = cv2.COLOR_BGR2RGB, cv2.IMREAD_UNCHANGED
        name = field.name

        def decode_cell(cell):
            if not isinstance(cell, np.ndarray):
                cell = np.frombuffer(cell, np.uint8)
            img = imdecode(cell, flag)
            if img is None:
                raise ValueError('cv2.imdecode failed for field {!r}'
                                 .format(name))
            if img.ndim == 3 and img.shape[2] == 3:
                return cvt_color(img, bgr2rgb)
            return img
        return decode_cell

    def make_column_decoder(self, field):
        """``decode_chunk(chunk)``: :meth:`decode_column` for one field."""
        decode_cell = self.make_cell_decoder(field)
        return lambda chunk: decode_cells(field, chunk, decode_cell)

    def decode_column(self, field, chunk: pa.Array) -> np.ndarray:
        """``(n, *shape)`` for a fixed-shape null-free column; wildcard
        shapes (variable-size images) give an object array of frames."""
        return decode_cells(field, chunk, self.make_cell_decoder(field))

    def arrow_type(self, field):
        return pa.binary()

    def to_json_dict(self):
        return {'codec': self.codec_name, 'image_codec': self.image_codec,
                'quality': self._quality}

    @classmethod
    def from_json_dict(cls, d):
        return cls(image_codec=d.get('image_codec', 'png'),
                   quality=d.get('quality', 80))

    def __repr__(self):
        return 'CompressedImageCodec({!r}, quality={})'.format(
            self.image_codec, self._quality)


_CODEC_REGISTRY = {c.codec_name: c for c in (NdarrayCodec, ScalarCodec,
                                             CompressedNdarrayCodec,
                                             CompressedImageCodec)}


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
