"""Read stores written by original petastorm: its pickled Unischema.

The port's copy of ``petastorm_tpu/compat.py`` (:1-172). Original petastorm
pickles its ``Unischema`` into ``_common_metadata`` under
``dataset-toolkit.unischema.v1``. This module decodes that pickle without
petastorm installed and without running arbitrary pickle payloads: a
restricted unpickler maps the known petastorm / pyspark class paths onto
inert shim classes (plus a few numpy and stdlib names) and refuses every
other global with ``pickle.UnpicklingError``. The shims are then converted
into the port's :class:`~petastorm_tpu_torch.unischema.Unischema` and
codecs.

Legacy package names (``av.experimental.deepdrive.dataset_toolkit``,
``dataset_toolkit``) are matched by the suffix of the module path.
"""

from __future__ import annotations

import io
import pickle
from collections import OrderedDict
from decimal import Decimal

import numpy as np

from petastorm_tpu_torch.codecs import (CompressedImageCodec,
                                        CompressedNdarrayCodec, NdarrayCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

#: The ``_common_metadata`` key under which original petastorm pickles its
#: Unischema.
PETASTORM_UNISCHEMA_KEY = b'dataset-toolkit.unischema.v1'


class _Shim(object):
    """Inert stand-in: pickle restores attributes into ``__dict__`` without
    running any constructor."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__['_state'] = state


def _make_shim(name):
    return type(name, (_Shim,), {'_shim_name': name})


class _UnischemaFieldShim(tuple):
    """petastorm's UnischemaField is a NamedTuple ``(name, numpy_dtype,
    shape, codec, nullable)``; pickle rebuilds it as ``class(*values)``."""

    def __new__(cls, *args):
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            args = tuple(args[0])
        return super(_UnischemaFieldShim, cls).__new__(cls, args)


_PETASTORM_MODULE_SUFFIXES = ('petastorm.unischema', 'petastorm.codecs',
                              'dataset_toolkit.unischema',
                              'dataset_toolkit.codecs')

_ALLOWED_STDLIB = {
    ('collections', 'OrderedDict'): OrderedDict,
    ('decimal', 'Decimal'): Decimal,
    ('builtins', 'set'): set,
    ('builtins', 'frozenset'): frozenset,
    ('builtins', 'list'): list,
    ('builtins', 'dict'): dict,
    ('builtins', 'tuple'): tuple,
    # str/bytes type objects are the numpy_dtype of string fields;
    # protocol-2 pickles of py2-era petastorm spell them __builtin__.*
    ('builtins', 'str'): str,
    ('builtins', 'bytes'): bytes,
    ('__builtin__', 'unicode'): str,
    ('__builtin__', 'str'): bytes,
}

_CLASS_SHIMS = {
    'Unischema': _make_shim('Unischema'),
    'UnischemaField': _UnischemaFieldShim,
    'ScalarCodec': _make_shim('ScalarCodec'),
    'NdarrayCodec': _make_shim('NdarrayCodec'),
    'CompressedNdarrayCodec': _make_shim('CompressedNdarrayCodec'),
    'CompressedImageCodec': _make_shim('CompressedImageCodec'),
}

#: numpy globals that pickled dtypes, scalars and arrays use; nothing else
#: of numpy (``numpy.save``, ``numpy.fromfile``, ... would be attack
#: surface)
_NUMPY_ALLOWED_NAMES = {'dtype', 'ndarray', 'scalar', '_reconstruct',
                        '_frombuffer'}


def _numpy_global(module, name):
    allowed = name in _NUMPY_ALLOWED_NAMES
    if not allowed:
        # numpy scalar type classes (int32, float64, bool_, datetime64, ...)
        attr = getattr(np, name, None)
        allowed = isinstance(attr, type) and issubclass(attr, np.generic)
    if not allowed:
        raise pickle.UnpicklingError(
            'Refusing to unpickle numpy global {}.{}'.format(module, name))
    return getattr(__import__(module, fromlist=[name]), name)


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in ('numpy', 'numpy.core.multiarray',
                      'numpy._core.multiarray', 'numpy.core.numeric',
                      'numpy._core.numeric'):
            return _numpy_global(module, name)
        if (module, name) in _ALLOWED_STDLIB:
            return _ALLOWED_STDLIB[(module, name)]
        if module.startswith('pyspark.'):
            # spark type instances ride inside ScalarCodec; keep them inert
            return _make_shim('pyspark:{}'.format(name))
        if (any(module.endswith(sfx) for sfx in _PETASTORM_MODULE_SUFFIXES)
                and name in _CLASS_SHIMS):
            return _CLASS_SHIMS[name]
        raise pickle.UnpicklingError(
            'Refusing to unpickle {}.{} from petastorm metadata (not in the '
            'compat allowlist)'.format(module, name))


def _convert_codec(codec_shim):
    if codec_shim is None:
        return None
    kind = getattr(codec_shim, '_shim_name', None)
    if kind == 'ScalarCodec':
        return ScalarCodec()
    if kind == 'NdarrayCodec':
        return NdarrayCodec()
    if kind == 'CompressedNdarrayCodec':
        return CompressedNdarrayCodec()
    if kind == 'CompressedImageCodec':
        # petastorm stores '.png' / '.jpeg' and a quality
        fmt = getattr(codec_shim, '_image_codec', '.png').lstrip('.')
        quality = int(getattr(codec_shim, '_quality', 80))
        if fmt in ('jpg', 'jpeg'):
            return CompressedImageCodec('jpeg', quality=quality)
        return CompressedImageCodec(fmt)
    raise PetastormMetadataError(
        'Unknown codec {!r} in petastorm metadata'.format(kind))


def _convert_field(field_shim) -> UnischemaField:
    name, numpy_dtype, shape, codec, nullable = (
        tuple(field_shim) + (None, False))[:5]
    return UnischemaField(str(name), numpy_dtype,
                          tuple(shape) if shape is not None else (),
                          _convert_codec(codec), bool(nullable))


def unischema_from_petastorm_pickle(payload: bytes) -> Unischema:
    """The port's Unischema of a pickled petastorm ``Unischema``. A global
    outside the allowlist raises ``pickle.UnpicklingError``; any other
    failure to decode raises ``PetastormMetadataError``."""
    try:
        shell = _RestrictedUnpickler(io.BytesIO(payload)).load()
    except pickle.UnpicklingError:
        raise
    except Exception as e:
        raise PetastormMetadataError(
            'Could not decode pickled petastorm unischema: {}'.format(e)
        ) from e
    fields_dict = getattr(shell, '_fields', None)
    if not fields_dict:
        raise PetastormMetadataError(
            'Pickled petastorm unischema carries no fields')
    name = getattr(shell, '_name', 'petastorm_schema')
    return Unischema(str(name),
                     [_convert_field(f) for f in fields_dict.values()])
