"""Decode hints of the port against the JAX package on one host.

A store written by the JAX package holds jpeg gray and RGB images, png RGB,
uint16 gray and RGBA images (30 x 44), and variable-size jpeg RGB images.
``CompressedImageCodec.decode_scaled`` must give JAX's pixels, shapes and
dtypes exactly, for both hint forms (``scale`` and ``min_shape``, with and
without ``allow_upscale``) and the full-decode fallback of png, uint16 and
RGBA payloads; ``build_decode_overrides`` must raise JAX's errors;
``reader.schema`` under a hint must equal JAX's, with and without a
transform that redeclares the shape; the rows, column batches and NGram
window chunks of hinted readers must equal JAX's, exactly. Both packages
decode with this host's cv2, so nothing compares bytes across hosts.
"""

import numpy as np
import pytest
import torch

import petastorm_tpu
from petastorm_tpu.codecs import (CompressedImageCodec as JImage,
                                  ScalarCodec as JScalar,
                                  build_decode_overrides as jbuild)
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.transform import TransformSpec as JTransformSpec
from petastorm_tpu.unischema import (Unischema as JUnischema,
                                     UnischemaField as JField)

import petastorm_tpu_torch
from petastorm_tpu_torch.codecs import build_decode_overrides as tbuild
from petastorm_tpu_torch.etl.dataset_metadata import get_schema
from petastorm_tpu_torch.ngram import NGram as TNGram
from petastorm_tpu_torch.transform import TransformSpec as TTransformSpec

H, W, ROWS = 30, 44, 12
FIELDS = {   # name: (codec, dtype, shape)
    'gray': ('jpeg', np.uint8, (H, W)),
    'rgb': ('jpeg', np.uint8, (H, W, 3)),
    'rgb_png': ('png', np.uint8, (H, W, 3)),
    'u16': ('png', np.uint16, (H, W)),
    'rgba': ('png', np.uint8, (H, W, 4)),
    'var': ('jpeg', np.uint8, (None, None, 3)),
}
HINTS = {
    'scale2': {'scale': 2},
    'scale8': {'scale': 8},
    'min_shape': {'min_shape': (8, 6)},
    'upscale': {'min_shape': (12, 20), 'allow_upscale': True},
}
READ_HINTS = {'rgb': {'min_shape': (8, 6)}, 'gray': {'scale': 4},
              'rgb_png': {'scale': 2}, 'var': {'scale': 2}}

_SCHEMA = JUnischema('HintSchema', [
    JField('id', np.int64, (), JScalar(), False)] + [
    JField(name, dtype, shape, JImage(codec), False)
    for name, (codec, dtype, shape) in FIELDS.items()])


def _image(rng, name, i):
    _, dtype, shape = FIELDS[name]
    if name == 'var':
        shape = (H + 3 * (i % 4), W - 2 * (i % 3), 3)
    hi = 65535 if dtype == np.uint16 else 255
    # smooth so jpeg's reduced decode has structure to keep
    base = rng.integers(0, hi, (4, 4) + tuple(shape[2:])).astype(np.float64)
    ys = np.linspace(0, 3, shape[0])[:, None]
    xs = np.linspace(0, 3, shape[1])[None, :]
    y0, x0 = ys.astype(int).clip(0, 2), xs.astype(int).clip(0, 2)
    img = base[y0, x0] if len(shape) == 2 else base[y0, x0, :]
    noise = rng.integers(0, 16, shape)
    return np.clip(img + noise, 0, hi).astype(dtype)


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('hints') / 'store')
    rng = np.random.default_rng(5)
    rows = [dict({'id': np.int64(i)},
                 **{name: _image(rng, name, i) for name in FIELDS})
            for i in range(ROWS)]
    with petastorm_tpu.materialize_dataset(url, _SCHEMA, rows_per_file=6,
                                           row_group_size_mb=0.02) as w:
        w.write_rows(rows)
    return url, rows


def _assert_equal(got, ref, label=''):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, label
    if got.dtype == object:
        for a, b in zip(got, ref):
            _assert_equal(a, b, label)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=label)


@pytest.mark.parametrize('hint', sorted(HINTS))
@pytest.mark.parametrize('name', sorted(FIELDS))
def test_decode_scaled_equals_jax(store, name, hint):
    url, rows = store
    tfield = get_schema(url[len('file://'):]).fields[name]
    jfield = _SCHEMA.fields[name]
    cell = jfield.codec.encode(jfield, rows[3][name])
    got = tfield.codec.decode_scaled(tfield, cell, **HINTS[hint])
    ref = jfield.codec.decode_scaled(jfield, cell, **HINTS[hint])
    _assert_equal(got, ref)
    full = tfield.codec.decode(tfield, cell)
    if FIELDS[name][0] == 'png' or name == 'rgba':
        assert got.shape == full.shape      # cannot scale: a full decode
    elif hint == 'scale2' or name == 'var' and hint == 'scale8':
        denom = HINTS[hint]['scale']
        assert got.shape[:2] == tuple(-(-s // denom) for s in full.shape[:2])
    assert tfield.codec.can_scale(tfield) == jfield.codec.can_scale(jfield)


OVERRIDE_ERRORS = {
    'unknown_field': {'nope': {'scale': 2}},
    'codec_without_decode_scaled': {'id': {'scale': 2}},
    'unbound_keyword': {'rgb': {'size': 2}},
    'scale_3': {'rgb': {'scale': 3}},
    'min_shape_not_ints': {'rgb': {'min_shape': 'ab'}},
    'min_shape_zero': {'rgb': {'min_shape': (0, 4)}},
    'both_forms': {'rgb': {'scale': 2, 'min_shape': (4, 4)}},
}


@pytest.mark.parametrize('case', sorted(OVERRIDE_ERRORS))
def test_build_decode_overrides_errors_equal_jax(store, case):
    url, _ = store
    hints = OVERRIDE_ERRORS[case]
    with pytest.raises(Exception) as ref:
        jbuild(_SCHEMA, hints)
    with pytest.raises(Exception) as got:
        tbuild(get_schema(url[len('file://'):]), hints)
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)
    with pytest.raises(type(got.value)) as made:
        # and a reader fails when it is made, before any worker runs
        petastorm_tpu_torch.make_reader(url, decode_hints=hints)
    assert str(made.value) == str(ref.value)
    assert set(tbuild(get_schema(url[len('file://'):]), READ_HINTS)) == \
        set(jbuild(_SCHEMA, READ_HINTS))


def _resize_spec(module, columnar):
    """A transform that redeclares ``rgb`` as (8, 8, 3)."""
    import cv2

    def resize(img):
        return cv2.resize(img, (8, 8), interpolation=cv2.INTER_AREA)

    def func(data):
        if columnar:
            data['rgb'] = np.stack([resize(x) for x in data['rgb']])
        else:
            data['rgb'] = resize(data['rgb'])
        return data
    return module(func, edit_fields=[('rgb', np.uint8, (8, 8, 3), False)])


def _shape_key(schema):
    return {name: (tuple(f.shape), np.dtype(f.numpy_dtype).str)
            for name, f in schema.fields.items()}


@pytest.mark.parametrize('transform', [False, True])
@pytest.mark.parametrize('factory', ['make_reader', 'make_columnar_reader'])
def test_reader_schema_under_hint_equals_jax(store, factory, transform):
    url, _ = store
    columnar = factory == 'make_columnar_reader'
    schemas = []
    for package, spec in ((petastorm_tpu, JTransformSpec),
                          (petastorm_tpu_torch, TTransformSpec)):
        kw = dict(decode_hints=READ_HINTS, workers_count=1)
        if transform:
            kw['transform_spec'] = _resize_spec(spec, columnar)
        with getattr(package, factory)(url, **kw) as reader:
            schemas.append(_shape_key(reader.schema))
    assert schemas[1] == schemas[0]
    # the hinted jpeg field with static dims turns dynamic unless the
    # transform redeclares it; png and variable fields keep their shapes
    assert schemas[1]['rgb'][0] == ((8, 8, 3) if transform else
                                    (None, None, 3))
    assert schemas[1]['rgb_png'][0] == (H, W, 3)
    assert schemas[1]['gray'][0] == (None, None)


def _columns(package, factory, url, ngram=None):
    """``{id: {field: value}}`` of one pass with ``READ_HINTS``."""
    kw = dict(decode_hints=READ_HINTS, workers_count=1,
              shuffle_row_groups=False)
    out = {}
    if ngram is not None:
        with package.make_reader(url, schema_fields=ngram, **kw) as reader:
            assert reader.ngram_chunked
            for chunk in reader.iter_ngram_chunks():
                for j, start in enumerate(chunk.starts):
                    key = int(chunk.columns['id'][start])
                    out[key] = {(off, name): chunk.columns[name][start + off]
                                for off, name in ((0, 'id'), (0, 'rgb'),
                                                  (1, 'var'))}
        return out
    with getattr(package, factory)(url, **kw) as reader:
        for item in reader:
            d = item._asdict()
            if factory == 'make_reader':
                d = {k: [v] for k, v in d.items()}
            for j in range(len(d['id'])):
                out[int(d['id'][j])] = {k: v[j] for k, v in d.items()}
    return out


@pytest.mark.parametrize('factory', ['make_reader', 'make_columnar_reader',
                                     'ngram_chunk'])
def test_hinted_reads_equal_jax(store, factory):
    url, rows = store
    if factory == 'ngram_chunk':
        fields = {0: ['id', 'rgb'], 1: ['var']}
        ref = _columns(petastorm_tpu, None, url, JNGram(fields, 1, 'id'))
        got = _columns(petastorm_tpu_torch, None, url,
                       TNGram(fields, 1, 'id'))
    else:
        ref = _columns(petastorm_tpu, factory, url)
        got = _columns(petastorm_tpu_torch, factory, url)
    assert sorted(got) == sorted(ref)
    assert len(ref) == (ROWS if factory != 'ngram_chunk' else ROWS // 2)
    for key in ref:
        assert sorted(got[key], key=str) == sorted(ref[key], key=str)
        for name in ref[key]:
            _assert_equal(got[key][name], ref[key][name], (key, name))
    if factory == 'make_columnar_reader':
        rgb = got[0]['rgb']
        assert rgb.shape == (-(-H // 4), -(-W // 4), 3)   # min_shape (8, 6)
        assert got[0]['rgb_png'].shape == (H, W, 3)
        assert got[0]['var'].shape[:2] == tuple(
            -(-s // 2) for s in rows[0]['var'].shape[:2])


@pytest.mark.cuda
def test_cuda_hinted_jpeg_batches_equal_cv2(store):
    """The jpeg hint path on the card: columnar reader with ``scale=2`` →
    ``TorchDataLoader`` → ``prefetch_to_device``; every image equals
    ``cv2.imdecode(..., IMREAD_REDUCED_COLOR_2)`` of its stored bytes, in
    RGB."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the card path has no CPU mode')
    import cv2
    import pyarrow.parquet as pq
    url, _ = store
    path = url[len('file://'):]
    stored = {}
    for piece in sorted(__import__('glob').glob(path + '/*.parquet')):
        table = pq.read_table(piece, columns=['id', 'rgb'])
        for i, cell in zip(table.column('id').to_pylist(),
                           table.column('rgb').to_pylist()):
            bgr = cv2.imdecode(np.frombuffer(cell, np.uint8),
                               cv2.IMREAD_REDUCED_COLOR_2)
            stored[i] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    with petastorm_tpu_torch.make_columnar_reader(
            url, schema_fields=['id', 'rgb'],
            decode_hints={'rgb': {'scale': 2}}, workers_count=2) as reader:
        loader = petastorm_tpu_torch.TorchDataLoader(reader, batch_size=4)
        seen = 0
        for batch in petastorm_tpu_torch.prefetch_to_device(iter(loader)):
            assert batch['rgb'].is_cuda
            for i, img in zip(batch['id'].tolist(), batch['rgb'].cpu()):
                np.testing.assert_array_equal(img.numpy(), stored[i])
                seen += 1
    assert seen == ROWS
