"""The port reads stores written by original petastorm as the JAX package
does.

The committed fixture ``tests/data/legacy/legacy_dataset`` (a protocol-2
pickle with py2-era ``__builtin__.unicode`` globals) and the stores forged
by ``tests/test_compat.py`` (its fake ``petastorm`` modules and pickled
schema) are read by ``make_reader``, ``make_columnar_reader`` and
``make_batch_reader`` of both packages: the schemas and the values must be
equal, exactly. The restricted unpickler must refuse what JAX's refuses,
with the same exception type.
"""

import os
import pickle

import numpy as np
import pyarrow.parquet as pq
import pytest

import petastorm_tpu
from petastorm_tpu import compat as jcompat
from petastorm_tpu.etl.dataset_metadata import \
    get_schema_from_dataset_url as jget_schema
from test_compat import _forge_schema_pickle, fake_petastorm_modules  # noqa: F401

import petastorm_tpu_torch
from petastorm_tpu_torch import compat as tcompat
from petastorm_tpu_torch.etl.dataset_metadata import get_schema as tget_schema

LEGACY = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                      'legacy', 'legacy_dataset')
FACTORIES = ['make_reader', 'make_columnar_reader', 'make_batch_reader']


def _field_key(f):
    codec = f.codec
    codec_key = None if codec is None else (
        type(codec).__name__, getattr(codec, 'image_codec', None),
        getattr(codec, 'quality', None))
    dtype = f.numpy_dtype if isinstance(f.numpy_dtype, type) \
        else np.dtype(f.numpy_dtype).str
    return (f.name, dtype, tuple(f.shape), codec_key, f.nullable)


def _schema_key(schema):
    return [_field_key(f) for f in schema.fields.values()]


def _read(package, factory, url):
    """``(schema, {id: {field: value}})``, one reader pass, one worker."""
    make = getattr(package, factory)
    rows = {}
    with make(url, workers_count=1, shuffle_row_groups=False) as reader:
        schema = reader.schema
        for item in reader:
            d = item._asdict()
            if factory == 'make_reader':
                chunk = {k: [v] for k, v in d.items()}
            else:
                chunk = d
            for j in range(len(chunk['id'])):
                key = int(chunk['id'][j])
                assert key not in rows, 'id %d read twice' % key
                rows[key] = {k: v[j] for k, v in chunk.items()}
    return schema, rows


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert sorted(got[key]) == sorted(ref[key])
        for name, want in ref[key].items():
            have = got[key][name]
            if isinstance(want, (bytes, str)):
                assert have == want, (key, name)
            else:
                np.testing.assert_array_equal(have, want, err_msg=name)
                assert np.asarray(have).dtype == np.asarray(want).dtype


def test_schema_of_the_committed_fixture_matches_jax():
    got = tget_schema(LEGACY)
    ref = jget_schema('file://' + LEGACY)
    assert _schema_key(got) == _schema_key(ref)
    assert got.fields['image_png'].codec == \
        petastorm_tpu_torch.codecs.CompressedImageCodec('png')
    assert got.fields['image_png'].shape == (8, 6, 3)
    assert got.fields['sensor_name'].numpy_dtype is str


@pytest.mark.parametrize('factory', FACTORIES)
def test_committed_fixture_reads_as_jax(factory):
    url = 'file://' + LEGACY
    got_schema, got = _read(petastorm_tpu_torch, factory, url)
    ref_schema, ref = _read(petastorm_tpu, factory, url)
    assert _schema_key(got_schema) == _schema_key(ref_schema)
    assert len(got) == 24
    _assert_same(got, ref)
    if factory == 'make_batch_reader':
        # the stored codecs and shapes, not inferred bytes fields
        f = got_schema.fields['image_png']
        assert type(f.codec).__name__ == 'CompressedImageCodec'
        assert f.shape == (8, 6, 3)
    else:
        for i in range(24):
            image = ((np.arange(8 * 6 * 3, dtype=np.int64).reshape(8, 6, 3)
                      * (i + 1)) % 251).astype(np.uint8)
            np.testing.assert_array_equal(got[i]['image_png'], image)
            np.testing.assert_array_equal(
                got[i]['matrix'],
                np.arange(12, dtype=np.float32).reshape(3, 4) + i / 8.0)
            assert got[i]['sensor_name'] == 'sensor_{:02d}'.format(i % 4)


@pytest.fixture()
def forged_store(fake_petastorm_modules, tmp_path):  # noqa: F811
    """``tests/test_compat.py::TestEndToEnd``'s store: 20 rows written by
    the JAX package, its metadata replaced by petastorm's pickled schema
    alone."""
    from petastorm_tpu.codecs import (CompressedImageCodec, NdarrayCodec,
                                      ScalarCodec)
    from petastorm_tpu.unischema import Unischema, UnischemaField
    url = 'file://' + str(tmp_path / 'legacy_ds')
    native = Unischema('LegacySchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(), False),
        UnischemaField('matrix', np.float32, (4, 3), NdarrayCodec(), False),
        UnischemaField('image', np.uint8, (8, 6, 3),
                       CompressedImageCodec('png'), False)])
    rng = np.random.default_rng(0)
    rows = [{'id': np.int32(i),
             'matrix': rng.standard_normal((4, 3)).astype(np.float32),
             'image': rng.integers(0, 255, (8, 6, 3), dtype=np.uint8)}
            for i in range(20)]
    with petastorm_tpu.materialize_dataset(url, native, rows_per_file=10) as w:
        w.write_rows(rows)
    meta_path = str(tmp_path / 'legacy_ds' / '_common_metadata')
    payload = _forge_schema_pickle(fake_petastorm_modules)
    pq.write_metadata(pq.read_schema(meta_path).with_metadata(
        {tcompat.PETASTORM_UNISCHEMA_KEY: payload}), meta_path)
    return url, payload, rows


@pytest.mark.parametrize('factory', FACTORIES)
def test_forged_store_reads_as_jax(forged_store, factory):
    url, payload, rows = forged_store
    got_schema, got = _read(petastorm_tpu_torch, factory, url)
    ref_schema, ref = _read(petastorm_tpu, factory, url)
    assert _schema_key(got_schema) == _schema_key(ref_schema)
    assert sorted(got) == list(range(20))
    _assert_same(got, ref)
    if factory != 'make_batch_reader':
        for r in rows:
            np.testing.assert_array_equal(got[int(r['id'])]['image'],
                                          r['image'])
    assert _schema_key(tcompat.unischema_from_petastorm_pickle(payload)) == \
        _schema_key(jcompat.unischema_from_petastorm_pickle(payload))


class _Evil(object):
    def __reduce__(self):
        return (print, ('pwned',))


@pytest.mark.parametrize('payload', [
    pickle.dumps(_Evil()),
    b'cnumpy\nsave\n.',           # protocol 0: GLOBAL numpy.save, STOP
    b'cbuiltins\neval\n.',
], ids=['builtin_print', 'numpy_save', 'builtins_eval'])
def test_refused_globals_raise_as_jax(payload):
    for module in (jcompat, tcompat):
        with pytest.raises(pickle.UnpicklingError, match='Refusing'):
            module.unischema_from_petastorm_pickle(payload)


def test_malformed_payloads_raise_as_jax():
    import io
    # a truncated stream and a pickle without fields: the packages' own
    # metadata errors, of the same name
    for payload in (b'\x80\x02}q\x00', pickle.dumps({'a': 1})):
        names = []
        for module in (jcompat, tcompat):
            with pytest.raises(Exception) as info:
                module.unischema_from_petastorm_pickle(payload)
            names.append(type(info.value).__name__)
        assert names == ['PetastormMetadataError'] * 2
    dtype = pickle.dumps(np.dtype('float32'))
    assert tcompat._RestrictedUnpickler(io.BytesIO(dtype)).load() == \
        np.dtype('float32')
