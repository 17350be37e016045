"""Per-field codecs of the port: ``NdarrayCodec``, ``ScalarCodec``,
``CompressedNdarrayCodec``, ``CompressedImageCodec`` and ``ArrowListCodec``.

A copy of the codecs of ``petastorm_tpu/codecs.py`` (``NdarrayCodec`` :247,
``ArrowListCodec`` :349-384, ``CompressedNdarrayCodec`` :387,
``CompressedImageCodec`` :421 with its scaled jpeg decode :522-615,
``ScalarCodec`` :633, ``build_decode_overrides`` :712, the strict
``np.save`` header parser ``_parse_fast_npy_header`` :205, the
batched-decode switch ``batched_decode_enabled`` :34-41, the
device-decode verdicts ``device_decode_unsupported_reason`` :110, :320,
:409) and of the
list-column conversion of ``readers/columnar_worker.py``
(``_list_column_to_numpy`` :218-241). Codecs are serialized to JSON by
registered name, never pickled, under the same names as the JAX package,
so stores written by either package read in the other.

The extension surface is JAX's (``DataframeColumnCodec`` :61,
``register_codec`` :144, ``codec_from_json_dict`` :151): a user codec
subclasses :class:`DataframeColumnCodec`, sets a unique ``codec_name``
and joins the registry through :func:`register_codec`; the readers decode
its cells one by one through ``make_cell_decoder`` unless it gives a
whole-column ``make_column_decoder``. A schema naming an unregistered
codec raises ``ValueError``.
"""

from __future__ import annotations

import functools
import inspect
import io
import operator
import os
import re
import sys
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Type

import numpy as np
import pyarrow as pa

#: The JAX package's switch of the whole-column (batched) codec decode
#: (default on); ``0``, ``false`` or ``off`` sends every codec column cell
#: by cell. Both paths give the same bytes.
BATCHED_DECODE_ENV_VAR = 'PETASTORM_TPU_BATCHED_DECODE'


def batched_decode_enabled() -> bool:
    """The :data:`BATCHED_DECODE_ENV_VAR` switch (default on). A worker
    reads it once, when it is made."""
    value = os.environ.get(BATCHED_DECODE_ENV_VAR, '').strip().lower()
    return value not in ('0', 'false', 'off')


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
        # a codec whose cells are not arrays (bytes, say): an object column
        out = (np.empty((n,) + first.shape, dtype=first.dtype)
               if isinstance(first, np.ndarray) else np.empty(n, object))
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


class DataframeColumnCodec(ABC):
    """A field's codec: ``encode`` turns its numpy value into a cell arrow
    stores in a column of ``arrow_type``, ``decode`` turns the cell back.

    Subclasses set a unique ``codec_name``: it is written into the store's
    metadata and names the class in :func:`codec_from_json_dict` (add the
    class with :func:`register_codec`)."""

    codec_name: str = None

    @abstractmethod
    def encode(self, unischema_field, value):
        """``value`` (numpy) as an arrow-storable Python value."""

    @abstractmethod
    def decode(self, unischema_field, value):
        """A stored cell back as the field's numpy value."""

    @abstractmethod
    def arrow_type(self, unischema_field) -> pa.DataType:
        """The arrow type of the field's column."""

    def make_cell_decoder(self, unischema_field):
        """``decode(cell)`` of one cell of the field's column. Cells come as
        zero-copy uint8 views of the arrow buffer; this default hands
        :meth:`decode` their bytes."""
        def decode_cell(cell):
            return self.decode(
                unischema_field,
                cell.tobytes() if isinstance(cell, np.ndarray) else cell)
        return decode_cell

    def make_column_decoder(self, unischema_field):
        """``decode_chunk(chunk)`` decoding a whole null-free binary chunk of
        a fixed-shape field into ``(len(chunk), *shape)``, bit-equal to the
        cell by cell decode (None from it punts the chunk to that path), or
        None when the codec has no whole-column path (the default)."""
        return None

    def decode_column(self, unischema_field, chunk: pa.Array) -> np.ndarray:
        """One binary chunk, cell by cell (:func:`decode_cells`)."""
        return decode_cells(unischema_field, chunk,
                            self.make_cell_decoder(unischema_field))

    def device_decode_unsupported_reason(self, unischema_field):
        """None when this codec's stored cells of ``field`` can decode on
        the device (:mod:`petastorm_tpu_torch.ops.decode`), else why not.
        Device decode is opt-in per codec: a decline leaves the column to
        the host decode and never raises."""
        return 'codec {} has no device-decode path'.format(
            type(self).__name__)

    def to_json_dict(self) -> Dict[str, Any]:
        return {'codec': self.codec_name}

    @classmethod
    def from_json_dict(cls, d: Dict[str, Any]) -> 'DataframeColumnCodec':
        return cls()

    def __eq__(self, other):
        return (isinstance(other, type(self))
                and self.to_json_dict() == other.to_json_dict())

    def __hash__(self):
        return hash(repr(sorted(self.to_json_dict().items())))

    def __repr__(self):
        return '{}()'.format(type(self).__name__)


class _Codec(DataframeColumnCodec):
    """The built-in codecs' base: equal only to a codec of the same class."""

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
        cell. Both give the same bytes. A chunk with null cells gives an
        object array with ``None`` at the nulls."""
        fast = self._decode_uniform(field, chunk)
        if fast is not None:
            return fast
        if chunk.null_count:
            # an object array with None at the null cells, as JAX's
            # ``_decode_cells``
            return decode_cells(field, chunk,
                                lambda cell: self.decode(field, cell))
        cells = [self.decode(field, v) for v in chunk.to_pylist()]
        shapes = {c.shape for c in cells}
        if len(shapes) == 1:
            return np.stack(cells) if cells else np.empty(
                (0,) + tuple(s or 0 for s in field.shape),
                np.dtype(field.numpy_dtype))
        out = np.empty(len(cells), dtype=object)
        out[:] = cells
        return out

    def make_column_decoder(self, field):
        """``decode_chunk(chunk)``, the whole-column path of a fixed-shape
        field (:meth:`_decode_uniform`: None when the chunk cannot take
        it), or None for a wildcard shape."""
        if field.shape is None or any(s is None for s in field.shape):
            return None
        return lambda chunk: self._decode_uniform(field, chunk)

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
        if stride - header_end != expected:
            return None
        grid = block.reshape(n, stride)
        if not bool((grid[:, :header_end] == grid[0, :header_end]).all()):
            return None
        if not expected:          # zero-size cells: nothing to reinterpret
            return np.empty((n,) + cell_shape, dtype=dtype)
        payload = np.array(grid[:, header_end:])      # writable copy
        return payload.view(dtype).reshape((n,) + cell_shape)

    def device_decode_unsupported_reason(self, field):
        """Eligible when the stored layout is fixed: a fixed shape (every
        cell shares one ``np.save`` header), non-nullable (the raw grid has
        no slot for a missing cell), a little-endian numeric or bool dtype
        (the device reinterprets native-order bytes)."""
        shape = field.shape
        if shape is None or any(s is None for s in shape):
            return 'wildcard shape: cells do not share one np.save header'
        if field.nullable:
            return 'nullable field: the raw grid has no missing-cell slot'
        try:
            dtype = np.dtype(field.numpy_dtype)
        except TypeError:
            return 'field dtype is not a numpy dtype'
        if dtype.kind not in 'biuf':
            return 'dtype kind {!r} is not device-representable'.format(
                dtype.kind)
        if dtype.itemsize > 1 and (dtype.str[0] == '>'
                                   or sys.byteorder != 'little'):
            return 'big-endian payload: device bitcast is little-endian'
        return None

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

    def make_column_decoder(self, field):
        """``decode_chunk(chunk)`` for a pass-through field (string, bytes or
        object dtype): one ``to_pylist`` a chunk; None for numeric fields,
        whose cells decode one by one."""
        try:
            kind = np.dtype(field.numpy_dtype).kind
        except TypeError:
            return None
        if kind not in ('U', 'S', 'O'):
            return None

        def decode_chunk(chunk):
            if chunk.null_count:
                return None
            out = np.empty(len(chunk), dtype=object)
            out[:] = chunk.to_pylist()
            return out
        return decode_chunk

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


def list_column_to_numpy(column, field) -> np.ndarray:
    """An arrow list column (an array or a chunked array) → numpy. A
    null-free column of a fixed-shape field flattens in C++ into ``(n,
    *shape)`` of the field's dtype; otherwise a fixed shape goes through
    Python lists, and a wildcard shape gives an object array of 1-D
    arrays."""
    if isinstance(column, pa.ChunkedArray):
        column = column.combine_chunks()
    shape = tuple(field.shape) if field.shape else ()
    fixed = shape and all(s is not None for s in shape)
    if fixed and column.null_count == 0:
        flat = column.flatten().to_numpy(zero_copy_only=False)
        if field.numpy_dtype is not None:
            target = np.dtype(field.numpy_dtype)
            if flat.dtype != target and flat.dtype.kind in 'biuf':
                flat = flat.astype(target)
        if flat.size == len(column) * int(np.prod(shape)):
            return flat.reshape((len(column),) + shape)
        # ragged data under a fixed-shape schema: the Python path below
    rows = column.to_pylist()
    if fixed:
        return np.asarray(rows, dtype=field.numpy_dtype).reshape(
            (len(rows),) + shape)
    out = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        out[i] = np.asarray(r)
    return out


class ArrowListCodec(_Codec):
    """Numeric ndarrays stored as native arrow list columns (the array
    flattened), so a row group decodes with no Python per row. Needs a
    numeric dtype; a wildcard shape must be 1-D."""

    codec_name = 'arrow_list'

    def encode(self, field, value):
        value = np.asarray(value)
        _check_dtype(field, value)
        _check_shape(field, value)
        return value.ravel()

    def decode(self, field, value):
        arr = np.asarray(value, dtype=np.dtype(field.numpy_dtype))
        return arr.reshape(field.shape) if _is_fixed(field) else arr

    def decode_column(self, field, chunk) -> np.ndarray:
        return list_column_to_numpy(chunk, field)

    def arrow_type(self, field):
        dtype = np.dtype(field.numpy_dtype)
        if dtype.kind not in 'biuf':
            raise ValueError('ArrowListCodec requires a numeric dtype; field '
                             '{!r} has {}'.format(field.name, dtype))
        shape = field.shape
        if shape and any(s is None for s in shape) and len(shape) != 1:
            raise ValueError('ArrowListCodec wildcard shapes must be 1-D; '
                             'field {!r} has shape {}'.format(field.name,
                                                               shape))
        return pa.list_(pa.from_numpy_dtype(dtype))

    def __repr__(self):
        return 'ArrowListCodec()'


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

    def device_decode_unsupported_reason(self, field):
        """zlib streams stay a host decode; the device-eligible route is a
        repack of the store to ``NdarrayCodec``
        (:func:`petastorm_tpu_torch.etl.repack.repack_to_ndarray_codec`)."""
        return ('zlib inflate has no device path — repack the store to '
                'NdarrayCodec via etl.repack to make it device-eligible')

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

    def validate_decode_hint(self, field, min_shape=None, scale=None,
                             allow_upscale=False):
        """Check :meth:`decode_scaled`'s hint values when a reader is made,
        so a bad value fails there and not on a worker."""
        if min_shape is not None and scale is not None:
            raise ValueError("decode hint takes 'min_shape' or 'scale', "
                             'not both')
        if scale is not None and scale not in (2, 4, 8):
            raise ValueError('scale must be one of 2, 4, 8 (jpeg DCT '
                             'denominators), got {!r}'.format(scale))
        if min_shape is not None:
            try:        # any 2-sequence of integral values
                vals = [operator.index(s) for s in min_shape]
                ok = len(vals) == 2 and all(v > 0 for v in vals)
            except TypeError:
                ok = False
            if not ok:
                raise ValueError(
                    'min_shape must be a (height, width) pair of positive '
                    'ints, got {!r}'.format(min_shape))

    def _scalable_payload(self, field) -> bool:
        """Whether the payload can decode scaled: jpeg only (png's reduced
        decode rounds instead of taking the ceiling), uint8 only, gray or
        3-channel. The spatial dims may be wildcards."""
        shape = field.shape
        return (self._image_codec in ('.jpg', '.jpeg')
                and np.dtype(field.numpy_dtype) == np.uint8
                and shape is not None and len(shape) >= 2
                and (len(shape) == 2 or (len(shape) == 3 and shape[2] == 3)))

    def can_scale(self, field) -> bool:
        """Whether a ``min_shape`` hint can reduce this field: a scalable
        payload with known spatial dims (the denominator depends on
        them)."""
        return (self._scalable_payload(field)
                and all(s is not None for s in field.shape[:2]))

    def _reduced_flag(self, field, denom):
        import cv2
        if len(field.shape) > 2:
            return {2: cv2.IMREAD_REDUCED_COLOR_2,
                    4: cv2.IMREAD_REDUCED_COLOR_4,
                    8: cv2.IMREAD_REDUCED_COLOR_8}[denom]
        return {2: cv2.IMREAD_REDUCED_GRAYSCALE_2,
                4: cv2.IMREAD_REDUCED_GRAYSCALE_4,
                8: cv2.IMREAD_REDUCED_GRAYSCALE_8}[denom]

    def decode_scaled(self, field, value, min_shape=None, scale=None,
                      allow_upscale=False):
        """Decode at a reduced resolution, the jpeg DCT denominator (2, 4
        or 8) applied during the entropy decode. Two hint forms:

        - ``min_shape=(h, w)``: the largest denominator whose output still
          covers ``min_shape`` (with ``allow_upscale``, stays within one
          halving of it); a field with wildcard spatial dims decodes in
          full;
        - ``scale=2|4|8``: that denominator, for variable-shape fields,
          where the caller knows the reduced size still covers its resize
          target.

        A payload that cannot scale (png, uint16, RGBA) decodes in full."""
        if scale is not None:
            if not self._scalable_payload(field):
                return self.decode(field, value)
            return self._decode_flag(field, value,
                                     self._reduced_flag(field, scale))
        if min_shape is None or not self.can_scale(field):
            return self.decode(field, value)
        shape = field.shape
        min_h, min_w = int(min_shape[0]), int(min_shape[1])
        chosen = None
        for denom in (8, 4, 2):
            h, w = -(-shape[0] // denom), -(-shape[1] // denom)
            if (h >= min_h and w >= min_w) or (
                    allow_upscale and 2 * h >= min_h and 2 * w >= min_w):
                chosen = self._reduced_flag(field, denom)
                break
        return self._decode_flag(field, value, chosen)

    def _decode_flag(self, field, value, flag):
        import cv2
        img = cv2.imdecode(np.frombuffer(value, dtype=np.uint8),
                           cv2.IMREAD_UNCHANGED if flag is None else flag)
        if img is None:
            raise ValueError('cv2.imdecode failed for field {!r}'
                             .format(field.name))
        if img.ndim == 3 and img.shape[2] == 3:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img

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


_CODEC_REGISTRY: Dict[str, Type[DataframeColumnCodec]] = {
    c.codec_name: c for c in (NdarrayCodec, ScalarCodec, ArrowListCodec,
                              CompressedNdarrayCodec, CompressedImageCodec)}


def register_codec(cls: Type[DataframeColumnCodec]
                   ) -> Type[DataframeColumnCodec]:
    """Class decorator adding a codec to the registry of
    :func:`codec_from_json_dict` under its ``codec_name``."""
    assert cls.codec_name, 'codec_name must be set'
    _CODEC_REGISTRY[cls.codec_name] = cls
    return cls


def build_decode_overrides(schema, decode_hints) -> Dict[str, Callable]:
    """``{field name: decode(cell)}`` from a reader's ``decode_hints``
    (field name -> keyword arguments of the codec's ``decode_scaled``, e.g.
    ``{'image': {'scale': 2}}``). Checks, when the reader is made, that
    each hinted field exists, that its codec has ``decode_scaled``, that
    the keywords bind to it, and their values."""
    overrides = {}
    for name, hint in (decode_hints or {}).items():
        field = schema.fields.get(name)
        if field is None:
            raise ValueError('decode_hints names unknown field {!r}'
                             .format(name))
        scaled = getattr(field.codec, 'decode_scaled', None)
        if scaled is None:
            raise ValueError(
                'decode_hints for field {!r}: codec {!r} has no '
                'decode_scaled'.format(name, type(field.codec).__name__))
        try:
            inspect.signature(scaled).bind(field, b'', **hint)
        except TypeError as e:
            raise ValueError(
                'decode_hints for field {!r} do not match {}.decode_scaled: '
                '{}'.format(name, type(field.codec).__name__, e))
        field.codec.validate_decode_hint(field, **hint)
        overrides[name] = functools.partial(scaled, field, **hint)
    return overrides


def codec_from_json_dict(d: Dict[str, Any]) -> DataframeColumnCodec:
    name = d['codec']
    if name not in _CODEC_REGISTRY:
        raise ValueError('Unknown codec name {!r}; known: {}'.format(
            name, sorted(_CODEC_REGISTRY)))
    return _CODEC_REGISTRY[name].from_json_dict(d)
