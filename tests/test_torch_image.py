"""The port's image line against the JAX package on the same inputs.

- K4 (``normalize_images``): the port's plain twin against the JAX function
  run as its Pallas kernel in interpret mode and through its jnp path,
  exhaustively over all 256 uint8 values in each of 3 channels.
- The image CNN: logits, one SGD step and the bf16 step's loss, on the same
  parameters (``image_cnn_params_from_jax``) and numpy-made inputs.
- Codecs and the columnar reader: png stores written by either package read
  by the other's ``make_columnar_reader`` with the worker-side resize, and
  ``TorchDataLoader`` batches against ``JaxDataLoader``'s.

Each test states its tolerance. A CUDA-marked test holds K4 itself against
its twin on the card.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petastorm_tpu
from examples.imagenet import generate_imagenet as jgen
from examples.imagenet.main import make_resize_transform as jresize
from petastorm_tpu.codecs import (CompressedImageCodec as JImageCodec,
                                  CompressedNdarrayCodec as JCNdarrayCodec)
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.models import image_cnn as jcnn
from petastorm_tpu.ops.normalize import normalize_images as jnormalize
from petastorm_tpu.unischema import UnischemaField as JField

from petastorm_tpu_torch import TorchDataLoader, make_columnar_reader
from petastorm_tpu_torch.codecs import (CompressedImageCodec,
                                        CompressedNdarrayCodec,
                                        codec_from_json_dict)
from petastorm_tpu_torch.examples.imagenet import generate_imagenet as tgen
from petastorm_tpu_torch.examples.imagenet.main import (
    make_resize_transform as tresize, train as ttrain)
from petastorm_tpu_torch.models import image_cnn as tcnn
from petastorm_tpu_torch.ops import kernels
from petastorm_tpu_torch.ops.normalize import (IMAGENET_MEAN, IMAGENET_STD,
                                               normalize_images)
from petastorm_tpu_torch.unischema import UnischemaField
from petastorm_tpu_torch.weights import image_cnn_params_from_jax

STATS = {'imagenet': (IMAGENET_MEAN, IMAGENET_STD),
         'zero_one': ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))}
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}
# float32 outputs: x/255 against x*(1/255) (two roundings, and 1/255's own),
# or one FMA against a multiply and a subtract, differ by at most two ulps of
# x/255 (2 * 2^-24) scaled by 1/std (<= 4.45), plus one ulp of the result
# (|r| < 4: 2^-22)
F32_ATOL = 2 * 2.0 ** -24 * 4.45 + 2.0 ** -22
# ...and per element, in ulps of the result, the most seen over the
# exhaustive input: where x/255 - mean cancels to near 0, one ulp of x/255
# is many ulps of the result. Mean 0 / std 1 cancels nothing: x/255 against
# x*(1/255) is one ulp, and the FMA is exact there.
F32_MAX_ULP = {('imagenet', 'interpret'): 56, ('imagenet', 'jnp'): 285,
               ('zero_one', 'interpret'): 0, ('zero_one', 'jnp'): 1}


def _exhaustive():
    """(2, 16, 8, 3) uint8 holding every value 0..255 in every channel."""
    v = np.arange(256, dtype=np.uint8).reshape(2, 16, 8)
    return np.stack([v, np.roll(v, 1), np.roll(v, 2)], axis=-1)


def _bits(x):
    x = np.asarray(x, dtype=np.float32)
    return x.view(np.uint32)


def _twin(images, stats, dtype):
    mean, std = stats
    return normalize_images(torch.from_numpy(images), mean, std, dtype)


def _reference_formula(images, stats, fused):
    """float32 ``((x * (1/255)) - mean) * inv_std`` in numpy, with the
    multiply and subtract rounded once (``fused``, an FMA) or twice. The
    fused sum is exact in float64 (x * (1/255) has at most 32 significant
    bits, mean's lowest bit is above 2^-32)."""
    mean = np.asarray(stats[0], np.float32)
    inv = np.float32(1.0) / np.asarray(stats[1], np.float32)
    scale = np.float32(1.0 / 255.0)
    x = images.astype(np.float32)
    if fused:
        centred = (x.astype(np.float64) * np.float64(scale)
                   - mean.astype(np.float64)).astype(np.float32)
    else:
        centred = x * scale - mean
    return centred * inv


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('stats', sorted(STATS))
@pytest.mark.parametrize('backend', ['interpret', 'jnp'])
def test_normalize_twin_matches_jax(backend, stats, dtype):
    """bfloat16: bit-equal. float32: the twin is the twice-rounded formula
    bit for bit; JAX's interpret mode on the CPU contracts the multiply and
    subtract into one FMA (bit-equal to the fused formula) and its jnp path
    divides by 255, so both stay within F32_ATOL of the twin and within
    F32_MAX_ULP ulps of it per element."""
    images = _exhaustive()
    jdt, tdt = DTYPES[dtype]
    got = _twin(images, STATS[stats], tdt)
    assert got.dtype == tdt and tuple(got.shape) == images.shape
    ref = np.asarray(jnormalize(jnp.asarray(images), *STATS[stats],
                                dtype=jdt, backend=backend)
                     .astype(jnp.float32))
    got32 = got.float().numpy()
    if dtype == 'bfloat16':
        np.testing.assert_array_equal(_bits(got32), _bits(ref))
        return
    np.testing.assert_array_equal(
        _bits(got32), _bits(_reference_formula(images, STATS[stats], False)))
    if backend == 'interpret':
        np.testing.assert_array_equal(
            _bits(ref), _bits(_reference_formula(images, STATS[stats], True)))
    np.testing.assert_allclose(got32, ref, atol=F32_ATOL, rtol=0)
    np.testing.assert_array_max_ulp(got32, ref,
                                    maxulp=F32_MAX_ULP[stats, backend])


def test_path_normalisation_equals_jax_step_input():
    """The CNN step's first op (mean 0, std 1, bf16) equals the JAX step's
    ``(x.astype(f32) / 255).astype(bf16)`` bit for bit."""
    images = _exhaustive()
    got = _twin(images, STATS['zero_one'], torch.bfloat16).float().numpy()
    ref = np.asarray((jnp.asarray(images).astype(jnp.float32) / 255.0)
                     .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_normalize_rejects_bad_input():
    with pytest.raises(ValueError, match='uint8'):
        normalize_images(torch.zeros(1, 2, 2, 3))
    with pytest.raises(ValueError, match='mean'):
        normalize_images(torch.zeros(1, 2, 2, 4, dtype=torch.uint8))
    with pytest.raises(ValueError, match='dtype'):
        normalize_images(torch.zeros(1, 2, 2, 3, dtype=torch.uint8),
                         dtype=torch.float16)
    kernels.reset_launch_counts()
    normalize_images(torch.zeros(1, 2, 2, 3, dtype=torch.uint8))
    assert kernels.LAUNCHES['normalize'] == 0     # CPU: the twin


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['imagenet_bf16', 'imagenet_f32',
                                  'zero_one_bf16', 'tail_misaligned'])
def test_normalize_kernel_matches_twin_on_card(case):
    """K4 against its twin on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    stats = STATS['zero_one' if case.startswith('zero_one') else 'imagenet']
    dtype = torch.float32 if case.endswith('f32') else torch.bfloat16
    x = torch.from_numpy(_exhaustive()).cuda()
    if case == 'tail_misaligned':
        flat = torch.arange(1 + 7 * 5 * 3, device='cuda').to(torch.uint8)
        x = flat[1:].view(1, 7, 5, 3)            # storage offset 1, tail 9
    mean = torch.tensor(stats[0], dtype=torch.float32)
    inv = 1.0 / torch.tensor(stats[1], dtype=torch.float32)
    got = kernels.normalize(x, mean, inv, dtype)
    ref = kernels.normalize_plain(x, mean, inv, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# broken copies of csrc/normalize.cu: (what is replaced, by what)
K4_MUTANTS = {
    'fma_contracted': (
        '  float s = __fmul_rn((float)x, kScale);\n'
        '  return __fmul_rn(__fsub_rn(s, pick(p.mean, c)), '
        'pick(p.inv_std, c));',
        '  float s = (float)x * kScale;\n'
        '  return (s - pick(p.mean, c)) * pick(p.inv_std, c);'),
    'bf16_truncated': (
        'h[j] = __floats2bfloat162_rn(r[2 * j], r[2 * j + 1]);',
        'h[j] = __halves2bfloat162(__float2bfloat16_rz(r[2 * j]), '
        '__float2bfloat16_rz(r[2 * j + 1]));'),
    'channel_phase_lost': ('int c = (int)(base % C);', 'int c = 0;'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('mutant', sorted(K4_MUTANTS))
def test_normalize_gate_rejects_broken_kernel(mutant, tmp_path, monkeypatch):
    """A broken copy of K4, built alone on the card, differs from the twin
    in some configuration of the exhaustive input: the bit-equal gate is
    sharp enough to see an FMA contraction, a truncating bf16 store and a
    lost channel phase."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    import ctypes
    import subprocess
    old, new = K4_MUTANTS[mutant]
    src = (kernels._CSRC / 'normalize.cu').read_text()
    assert old in src
    cu, so = tmp_path / 'normalize.cu', tmp_path / 'libk4.so'
    cu.write_text(src.replace(old, new))
    flags = [f for f in kernels._NVCC_FLAGS if f not in ('-Xptxas', '-v')]
    subprocess.run([kernels._nvcc(), *flags, '-o', str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.normalize_u8.argtypes = [p, p, ctypes.c_longlong, i] + [f] * 8 + [i,
                                                                          p]
    lib.normalize_u8.restype = i
    monkeypatch.setattr(kernels, '_lib', lib)
    x = torch.from_numpy(_exhaustive()).cuda()
    differ = {}
    for stats in sorted(STATS):
        mean = torch.tensor(STATS[stats][0], dtype=torch.float32)
        inv = 1.0 / torch.tensor(STATS[stats][1], dtype=torch.float32)
        for dtype, bits in ((torch.bfloat16, torch.int16),
                            (torch.float32, torch.int32)):
            got = kernels.normalize(x, mean, inv, dtype)
            ref = kernels.normalize_plain(x, mean, inv, dtype)
            torch.cuda.synchronize()
            differ['%s %s' % (stats, dtype)] = int(
                (got.view(bits) != ref.view(bits)).sum())
    print('K4 mutant %s: elements differing from the twin (of 768) %s'
          % (mutant, differ))
    assert any(differ.values()), differ


# ---------------------------------------------------------------------------
# image CNN
# ---------------------------------------------------------------------------

def _cnn_setup(seed, widths=(8, 16, 32), blocks=1, size=32, batch=4,
               classes=10):
    jparams = jcnn.init(jax.random.PRNGKey(seed), num_classes=classes,
                        widths=widths, blocks_per_stage=blocks)
    tparams = image_cnn_params_from_jax(jax.device_get(jparams),
                                        device='cpu')
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, classes, batch).astype(np.int32)
    return jparams, tparams, images, labels


def _jax_leaves(params):
    leaves = [params['stem'], params['stem_scale'], params['stem_bias']]
    for stage in params['stages']:
        for block in stage:
            leaves.extend(block[name] for name in sorted(block))
    leaves.extend([params['head_w'], params['head_b']])
    return [np.asarray(x) for x in leaves]


@pytest.mark.parametrize('size', [32, 29])
def test_cnn_logits_match_float32(size):
    """atol = rtol = 1e-4 (float32 sums in other orders). 29 is odd, so
    every stride-2 layer pads unevenly."""
    jp, tp, images, _ = _cnn_setup(0, size=size)
    x = images.astype(np.float32) / 255.0
    ref = np.asarray(jcnn.forward(jp, jnp.asarray(x), jnp.float32))
    got = tcnn.forward(tp, torch.from_numpy(x), torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4,
                               rtol=1e-4)


def test_cnn_full_width_forward_matches_float32():
    """Widths (64, 128, 256), 2 blocks, 224 x 224, batch 1: a one-pixel
    shift of any 'SAME' pad shows here. atol = rtol = 1e-4."""
    jp, tp, images, _ = _cnn_setup(1, widths=(64, 128, 256), blocks=2,
                                   size=224, batch=1, classes=16)
    x = images.astype(np.float32) / 255.0
    ref = np.asarray(jcnn.forward(jp, jnp.asarray(x), jnp.float32))
    with torch.no_grad():
        got = tcnn.forward(tp, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_cnn_sgd_step_matches_float32():
    """One float32 SGD step: loss within 1e-5, each parameter leaf within
    1e-4 relative norm of JAX's."""
    jp, tp, images, labels = _cnn_setup(2)
    jstep = jcnn.make_train_step(lr=0.1, dtype=jnp.float32)
    jp2, jloss = jstep(jp, jnp.asarray(images), jnp.asarray(labels))
    step = tcnn.make_train_step(tp, lr=0.1, dtype=torch.float32)
    loss = step(torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    after = _jax_leaves(jp2)
    got = [p.detach().numpy() for p in tcnn.parameters(tp)]
    assert len(got) == len(after)
    for i, (g, a) in enumerate(zip(got, after)):
        rel = np.linalg.norm(g - a) / (np.linalg.norm(a) + 1e-12)
        assert rel < 1e-4, 'leaf %d: relative error %.3g' % (i, rel)


def test_cnn_bfloat16_step_loss_matches():
    """The bf16 step (the path's dtype): loss within 1e-2 of JAX's."""
    jp, tp, images, labels = _cnn_setup(3)
    jstep = jcnn.make_train_step(lr=1e-3)
    _, jloss = jstep(jp, jnp.asarray(images), jnp.asarray(labels))
    step = tcnn.make_train_step(tp, lr=1e-3)
    loss = step(torch.from_numpy(images), torch.from_numpy(labels))
    assert abs(float(loss) - float(jloss)) < 1e-2


@pytest.mark.parametrize('size,k,stride,pad', [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (28, 3, 2, (0, 1)), (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)),
    (32, 7, 2, (2, 3)), (16, 3, 2, (0, 1))])
def test_same_padding_is_xla_s(size, k, stride, pad):
    assert tcnn._same_pad(size, k, stride) == pad


def test_cnn_params_loader_checks_shapes():
    jp = jax.device_get(jcnn.init(jax.random.PRNGKey(0), num_classes=4,
                                  widths=(8, 16), blocks_per_stage=1))
    tp = image_cnn_params_from_jax(jp, device='cpu')
    assert 'proj' in tp['stages'][1][0] and 'proj' not in tp['stages'][0][0]
    bad = dict(jp, head_w=np.zeros((8, 4), np.float32))
    with pytest.raises(ValueError, match='head_w'):
        image_cnn_params_from_jax(bad, device='cpu')
    gen = torch.Generator().manual_seed(0)
    own = tcnn.init(gen, num_classes=4, widths=(8, 16), blocks_per_stage=1,
                    device='cpu')
    assert [p.shape for p in tcnn.parameters(own)] == \
        [p.shape for p in tcnn.parameters(tp)]


# ---------------------------------------------------------------------------
# codecs, columnar reader, batched loader
# ---------------------------------------------------------------------------

ROWS = 14
SIZE = 16


def _write_images(package, url):
    gen = jgen if package == 'jax' else tgen
    rows = gen.synthetic_rows(ROWS, classes=4, seed=5, base_hw=(30, 40))
    gen.generate(url, rows, row_group_size_mb=0.01)


def _read_columnar(package, url, batch_size=None):
    if package == 'jax':
        reader = petastorm_tpu.make_columnar_reader(
            url, workers_count=1, shuffle_row_groups=False, num_epochs=1,
            transform_spec=jresize(SIZE))
    else:
        reader = make_columnar_reader(url, workers_count=1,
                                      shuffle_row_groups=False, num_epochs=1,
                                      transform_spec=tresize(SIZE))
    with reader:
        if batch_size is None:
            return [(np.asarray(b.image), np.asarray(b.label))
                    for b in reader]
        loader = (JaxDataLoader(reader, batch_size=batch_size)
                  if package == 'jax' else
                  TorchDataLoader(reader, batch_size=batch_size,
                                  device='cpu'))
        return [(np.asarray(b['image']), np.asarray(b['label']))
                for b in loader]


def test_synthetic_rows_match():
    ref = list(jgen.synthetic_rows(3, seed=2, base_hw=(30, 40)))
    got = list(tgen.synthetic_rows(3, seed=2, base_hw=(30, 40)))
    for a, b in zip(ref, got):
        assert a['noun_id'] == b['noun_id'] and a['label'] == b['label']
        np.testing.assert_array_equal(a['image'], b['image'])


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_columnar_reader_resized_images_match(tmp_path, writer):
    """A png store written by either package, read with the resize
    transform on one worker: the port's row groups equal JAX's bit for
    bit, in the same order."""
    url = 'file://' + str(tmp_path / 'images')
    _write_images(writer, url)
    ref = _read_columnar('jax', url)
    got = _read_columnar('torch', url)
    assert len(got) == len(ref) > 1
    for (gi, gl), (ri, rl) in zip(got, ref):
        assert gi.dtype == np.uint8 and gi.shape[1:] == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)
    assert sum(len(g[1]) for g in got) == ROWS


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_batched_loader_matches_jax(tmp_path, writer):
    url = 'file://' + str(tmp_path / 'images')
    _write_images(writer, url)
    ref = _read_columnar('jax', url, batch_size=4)
    got = _read_columnar('torch', url, batch_size=4)
    assert [len(b[1]) for b in got] == [len(b[1]) for b in ref] == \
        [4, 4, 4, 2]
    for (gi, gl), (ri, rl) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)


def test_columnar_reader_without_transform_keeps_ragged_images(tmp_path):
    url = 'file://' + str(tmp_path / 'images')
    _write_images('jax', url)
    with petastorm_tpu.make_columnar_reader(
            url, workers_count=1, shuffle_row_groups=False) as reader:
        ref = [b._asdict() for b in reader]
    with make_columnar_reader(url, workers_count=1, shuffle_row_groups=False,
                              schema_fields=['image', 'noun_id']) as reader:
        assert set(reader.schema.fields) == {'image', 'noun_id'}
        got = [b._asdict() for b in reader]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g['image'].dtype == object
        assert list(g['noun_id']) == list(r['noun_id'])
        for a, b in zip(g['image'], r['image']):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('image_codec', ['png', 'jpeg'])
def test_image_codec_cells_cross_decode(image_codec):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    jfield = JField('image', np.uint8, (None, None, 3),
                    JImageCodec(image_codec), False)
    tfield = UnischemaField('image', np.uint8, (None, None, 3),
                            CompressedImageCodec(image_codec), False)
    jbytes = jfield.codec.encode(jfield, img)
    tbytes = tfield.codec.encode(tfield, img)
    assert jbytes == tbytes
    np.testing.assert_array_equal(tfield.codec.decode(tfield, jbytes),
                                  jfield.codec.decode(jfield, tbytes))
    assert tfield.codec.to_json_dict() == jfield.codec.to_json_dict()
    assert codec_from_json_dict(jfield.codec.to_json_dict()) == tfield.codec


def test_image_codec_dense_column_equals_cells():
    """A fixed-shape column decodes to one dense RGB array, through
    decode_column and make_column_decoder alike, equal to what the per-cell
    decoder gives and to the JAX codec's column decode."""
    import pyarrow as pa
    codec = CompressedImageCodec('png')
    field = UnischemaField('image', np.uint8, (6, 5, 3), codec, False)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (4, 6, 5, 3), dtype=np.uint8)
    chunk = pa.array([codec.encode(field, x) for x in imgs], pa.binary())
    dense = codec.decode_column(field, chunk)
    assert dense.shape == (4, 6, 5, 3) and dense.dtype == np.uint8
    np.testing.assert_array_equal(dense, imgs)
    np.testing.assert_array_equal(codec.make_column_decoder(field)(chunk),
                                  dense)
    cells = [codec.make_cell_decoder(field)(memoryview(b).tobytes())
             for b in chunk.to_pylist()]
    np.testing.assert_array_equal(np.stack(cells), dense)
    jfield = JField('image', np.uint8, (6, 5, 3), JImageCodec('png'), False)
    np.testing.assert_array_equal(
        jfield.codec.make_column_decoder(jfield)(chunk), dense)


def test_compressed_ndarray_round_trip_between_packages(tmp_path):
    rng = np.random.default_rng(2)
    value = rng.standard_normal((3, 4)).astype(np.float32)
    jfield = JField('x', np.float32, (3, 4), JCNdarrayCodec(), False)
    tfield = UnischemaField('x', np.float32, (3, 4),
                            CompressedNdarrayCodec(), False)
    np.testing.assert_array_equal(
        tfield.codec.decode(tfield, jfield.codec.encode(jfield, value)), value)
    np.testing.assert_array_equal(
        jfield.codec.decode(jfield, tfield.codec.encode(tfield, value)), value)
    from petastorm_tpu.codecs import ScalarCodec as JScalar
    from petastorm_tpu.unischema import Unischema as JUnischema
    url = 'file://' + str(tmp_path / 'arrays')
    values = rng.standard_normal((6, 3, 4)).astype(np.float32)
    schema = JUnischema('Arrays', [JField('i', np.int64, (), JScalar(),
                                          False), jfield])
    with petastorm_tpu.materialize_dataset(url, schema) as w:
        w.write_rows({'i': np.int64(i), 'x': values[i]} for i in range(6))
    with make_columnar_reader(url, workers_count=1,
                              shuffle_row_groups=False) as reader:
        got = [b._asdict() for b in reader]
    order = np.concatenate([g['i'] for g in got])
    np.testing.assert_array_equal(np.concatenate([g['x'] for g in got]),
                                  values[order])


def test_imagenet_example_trains_on_cpu(tmp_path):
    """The example's ``train`` end to end on the CPU at 32 x 32: two
    steps, finite losses, a time per step, and the ``then`` hook running
    one more step on the live pipeline."""
    url = 'file://' + str(tmp_path / 'images')
    _write_images('torch', url)
    kernels.reset_launch_counts()
    lines, extra = [], []

    def then(batches, step):
        batch = next(batches)
        assert tuple(batch['image'].shape) == (4, 32, 32, 3)
        extra.append(float(step(batch['image'], batch['label'])))

    params, losses, times = ttrain(url, batch_size=4, steps=2,
                                   workers_count=2, num_classes=4,
                                   image_size=32, device='cpu', log_every=1,
                                   log=lines.append, then=then)
    assert len(losses) == 2 and all(np.isfinite(losses + extra))
    assert len(extra) == 1 and len(lines) == 2
    assert all(0 <= wait <= total for wait, total in times)
    assert params['head_w'].shape == (256, 4)
    assert kernels.LAUNCHES['normalize'] == 0


def test_make_columnar_reader_rejects_ngram(tmp_path):
    from petastorm_tpu_torch.ngram import NGram
    with pytest.raises(ValueError, match='NGram'):
        make_columnar_reader(str(tmp_path), schema_fields=NGram(
            {0: ['a']}, 1, 'a'))


def test_columnar_item_encoding_is_plain_bytes():
    """Sanity of the store format: an encoded png cell is a png file."""
    codec = CompressedImageCodec('png')
    field = UnischemaField('image', np.uint8, (2, 2, 3), codec, False)
    data = codec.encode(field, np.zeros((2, 2, 3), np.uint8))
    assert io.BytesIO(data).read(8) == b'\x89PNG\r\n\x1a\n'
