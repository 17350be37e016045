"""The port's device decode against the JAX package's, on the CPU.

The same numpy inputs go through ``petastorm_tpu.ops.decode`` and
``petastorm_tpu_torch.ops.decode``: every plan and every decline reason
is the same (JAX's ``TestPlanning`` and ``TestPlanDecliners`` cases);
``raw_column_view``, ``repack_to_raw`` and ``decode_raw_host`` agree byte
for byte, and ``decode_raw_torch`` with ``decode_raw_jax`` (CPU jax) bit
for bit, over int8 to float32, bool and multi-chunk columns, and over
8-byte dtypes against JAX under x64 (a subprocess: the flag is
process-wide); the fused decode with a device ``TransformSpec``; an
epoch of ``make_columnar_reader`` + loader in both packages with the
claim on, off and with no loader; and a store repacked by ``etl.repack``.
Tolerance everywhere: exact (bytes, or values bit for bit).
"""

import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax  # noqa: F401  (the JAX package's decode imports it lazily)
import petastorm_tpu
from petastorm_tpu import codecs as jcodecs
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.ops import decode as jdecode
from petastorm_tpu.transform import TransformSpec as JTransformSpec
from petastorm_tpu.unischema import (Unischema as JUnischema,
                                     UnischemaField as JField)

from petastorm_tpu_torch import codecs as tcodecs
from petastorm_tpu_torch import (TorchDataLoader, make_batch_reader,
                                 make_columnar_reader, make_reader,
                                 materialize_dataset)
from petastorm_tpu_torch.ops import decode as tdecode
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

REPO = Path(__file__).resolve().parents[1]

_CODECS = {'ndarray': (jcodecs.NdarrayCodec, tcodecs.NdarrayCodec),
           'zlib': (jcodecs.CompressedNdarrayCodec,
                    tcodecs.CompressedNdarrayCodec),
           'scalar': (jcodecs.ScalarCodec, tcodecs.ScalarCodec),
           'png': (jcodecs.CompressedImageCodec, tcodecs.CompressedImageCodec),
           None: (lambda: None, lambda: None)}


def _pair(name='x', dtype=np.float32, shape=(4, 3), codec='ndarray',
          nullable=False):
    """The same field in both packages: ``(jax field, port field)``."""
    jc, tc = _CODECS[codec]
    return (JField(name, dtype, shape, jc(), nullable),
            UnischemaField(name, dtype, shape, tc(), nullable))


def _schemas(*pairs):
    return (JUnischema('S', [p[0] for p in pairs]),
            Unischema('S', [p[1] for p in pairs]))


def _values(rng, dtype, shape, n):
    dtype = np.dtype(dtype)
    if dtype.kind == 'b':
        return rng.integers(0, 2, size=(n,) + shape).astype(dtype)
    if dtype.kind in 'iu':
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=(n,) + shape,
                            endpoint=True, dtype=dtype)
    return rng.standard_normal((n,) + shape).astype(dtype)


def _column(field, values, chunks=None):
    cells = [field.codec.encode(field, v) for v in values]
    if chunks is None:
        return pa.chunked_array([pa.array(cells, type=pa.binary())])
    parts, at = [], 0
    for size in chunks:
        parts.append(pa.array(cells[at:at + size], type=pa.binary()))
        at += size
    assert at == len(cells)
    return pa.chunked_array(parts, type=pa.binary())


# ---------------------------------------------------------------------------
# planning: JAX's TestPlanning cases, the same plan or the same reason
# ---------------------------------------------------------------------------

PLAN_CASES = [
    ('f32 (4,3)', dict(dtype=np.float32, shape=(4, 3))),
    ('i16 (7,)', dict(dtype=np.int16, shape=(7,))),
    ('u8 (2,2,3)', dict(dtype=np.uint8, shape=(2, 2, 3))),
    ('bool (5,)', dict(dtype=np.bool_, shape=(5,))),
    ('f16 (3,)', dict(dtype=np.float16, shape=(3,))),
    ('i32 (0,)', dict(dtype=np.int32, shape=(0,))),
    ('i8 (6,)', dict(dtype=np.int8, shape=(6,))),
    ('zlib', dict(codec='zlib')),
    ('wildcard shape', dict(shape=(None, 3))),
    ('nullable', dict(nullable=True)),
    ('str', dict(dtype=np.str_, shape=())),
    ('big-endian', dict(dtype=np.dtype('>f4'))),
    ('scalar codec', dict(dtype=np.int64, shape=(), codec='scalar')),
    ('png codec', dict(dtype=np.uint8, shape=(4, 4, 3), codec='png')),
    ('native arrow', dict(dtype=np.int32, shape=(), codec=None)),
]


@pytest.mark.parametrize('label,kw', PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_for_field_as_jax(label, kw):
    jfield, tfield = _pair(**kw)
    jplan, jreason = jdecode.plan_for_field(jfield)
    tplan, treason = tdecode.plan_for_field(tfield)
    assert treason == jreason
    assert tuple(tplan) == tuple(jplan) if jplan is not None else tplan is None


@pytest.mark.parametrize('dtype', [np.float32, np.int16, np.uint8, np.bool_,
                                   np.float16, np.int64, np.float64])
def test_npy_header_bytes_as_jax(dtype):
    header = tdecode.npy_header_bytes(dtype, (4, 3))
    assert header == jdecode.npy_header_bytes(dtype, (4, 3))
    buf = io.BytesIO()
    np.save(buf, np.zeros((4, 3), dtype=dtype))
    assert buf.getvalue().startswith(header) and len(header) % 64 == 0


def test_npy_header_bytes_declines_object_dtype():
    assert tdecode.npy_header_bytes(np.dtype(object), (2,)) is None
    assert jdecode.npy_header_bytes(np.dtype(object), (2,)) is None


_X64_SCRIPT = r'''
import json, sys
import numpy as np
from petastorm_tpu.codecs import NdarrayCodec
from petastorm_tpu.ops.decode import decode_raw_jax, plan_for_field
from petastorm_tpu.unischema import UnischemaField
out = {}
for descr in sys.argv[2:]:
    field = UnischemaField('x', np.dtype(descr), (5,), NdarrayCodec(), False)
    plan, reason = plan_for_field(field)
    raw = np.load(sys.argv[1] + '/' + descr.strip('<>|') + '.npy')
    dec = np.asarray(decode_raw_jax(plan, raw))
    out[descr] = {'reason': reason, 'header': plan.header.hex(),
                  'dtype': dec.dtype.str, 'bytes': dec.tobytes().hex()}
print(json.dumps(out))
'''

_EIGHT_BYTE = ['<i8', '<u8', '<f8']


@pytest.fixture(scope='module')
def x64_jax(tmp_path_factory):
    """Plans and decodes of 8-byte columns by the JAX package under
    ``JAX_ENABLE_X64=1``, in one subprocess, over grids written here."""
    d = tmp_path_factory.mktemp('x64')
    rng = np.random.default_rng(8)
    grids = {}
    for descr in _EIGHT_BYTE:
        _, tfield = _pair(dtype=np.dtype(descr), shape=(5,))
        plan, _ = tdecode.plan_for_field(tfield)
        values = _values(rng, descr, (5,), 6)
        grids[descr] = (plan, values, tdecode.raw_column_view(
            _column(tfield, values, [2, 4]), plan))
        np.save(str(d / (descr.strip('<>|') + '.npy')), grids[descr][2])
    env = dict(os.environ, JAX_ENABLE_X64='1', JAX_PLATFORMS='cpu',
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', _X64_SCRIPT, str(d)]
                         + _EIGHT_BYTE, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return grids, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.timeout(180)
@pytest.mark.parametrize('descr', _EIGHT_BYTE)
def test_eight_byte_dtypes_plan_and_decode_as_jax_under_x64(x64_jax, descr):
    """torch keeps 8-byte dtypes, so the port plans them as JAX does under
    x64; without x64 the JAX package declines them (its cousin would not be
    bit-identical)."""
    grids, jax_out = x64_jax
    plan, values, raw = grids[descr]
    assert jax_out[descr]['reason'] is None
    assert plan.header.hex() == jax_out[descr]['header']
    got = tdecode.decode_raw_torch(plan, torch.from_numpy(raw.copy())).numpy()
    assert got.dtype.str == jax_out[descr]['dtype']
    assert got.tobytes().hex() == jax_out[descr]['bytes']
    assert got.tobytes() == values.tobytes()
    jfield, _ = _pair(dtype=np.dtype(descr), shape=(5,))
    _, reason = jdecode.plan_for_field(jfield)
    assert reason is not None and 'x64' in reason


# ---------------------------------------------------------------------------
# the decline matrix: JAX's TestPlanDecliners cases
# ---------------------------------------------------------------------------

def _decliner_args(case):
    """``(jax schema, jax kwargs), (port schema, port kwargs)``."""
    tokens = _pair('tokens', np.int32, (8,))
    js, ts = _schemas(tokens)
    jkw, tkw = {'enabled': True}, {'enabled': True}
    if case == 'row-granular':
        jkw['batched_output'] = tkw['batched_output'] = False
    elif case == 'unsupported worker':
        jkw['worker_supported'] = tkw['worker_supported'] = False
    elif case == 'predicate':
        jkw['has_predicate'] = tkw['has_predicate'] = True
    elif case == 'ngram':
        jkw['has_ngram'] = tkw['has_ngram'] = True
    elif case == 'host transform spec':
        jkw['transform_spec'] = JTransformSpec(lambda c: c)
        tkw['transform_spec'] = TransformSpec(lambda c: c)
    elif case == 'device spec changing the field set':
        jkw['transform_spec'] = JTransformSpec(lambda c: c, device=True,
                                               removed_fields=['tokens'])
        tkw['transform_spec'] = TransformSpec(lambda c: c, device=True,
                                              removed_fields=['tokens'])
        jkw['transformed_schema'], tkw['transformed_schema'] = _schemas(
            _pair('other', np.int32, (8,)))
    elif case == 'device spec in place':
        jkw['transform_spec'] = JTransformSpec(lambda c: c, device=True)
        tkw['transform_spec'] = TransformSpec(lambda c: c, device=True)
        jkw['transformed_schema'], tkw['transformed_schema'] = js, ts
    elif case == 'decode hint per column':
        js, ts = _schemas(_pair('a', np.int32, (4,)),
                          _pair('b', np.float32, (2,)))
        jkw['decode_hints'] = tkw['decode_hints'] = {'a': {'scale': 2}}
    elif case == 'kill switch':
        jkw['enabled'] = tkw['enabled'] = False
    elif case in ('env off', 'env unset'):
        del jkw['enabled'], tkw['enabled']
    return (js, jkw), (ts, tkw)


DECLINER_CASES = ['row-granular', 'unsupported worker', 'predicate', 'ngram',
                  'host transform spec', 'device spec changing the field set',
                  'device spec in place', 'decode hint per column',
                  'kill switch', 'env off', 'env unset']


@pytest.mark.parametrize('case', DECLINER_CASES)
def test_plan_device_decode_as_jax(case, monkeypatch):
    if case == 'env off':
        monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'off')
    else:
        monkeypatch.delenv(tdecode.DEVICE_DECODE_ENV_VAR, raising=False)
    assert tdecode.DEVICE_DECODE_ENV_VAR == jdecode.DEVICE_DECODE_ENV_VAR
    (js, jkw), (ts, tkw) = _decliner_args(case)
    jplans, jdeclined = jdecode.plan_device_decode(js, **jkw)
    tplans, tdeclined = tdecode.plan_device_decode(ts, **tkw)
    assert tdeclined == jdeclined
    assert {k: tuple(v) for k, v in tplans.items()} == \
        {k: tuple(v) for k, v in jplans.items()}
    assert bool(tplans) == (case in ('device spec in place',
                                     'decode hint per column', 'env unset'))


# ---------------------------------------------------------------------------
# raw views, repack and decode, byte for byte
# ---------------------------------------------------------------------------

BYTE_CASES = [
    (np.int8, (6,), None),
    (np.uint8, (2, 2), None),
    (np.int16, (7,), [2, 6]),
    (np.int32, (5, 2), [3, 0, 5]),            # an empty chunk in the middle
    (np.float16, (3,), None),
    (np.float32, (4, 3), None),
    (np.float32, (4, 3), [3, 0, 5]),
    (np.bool_, (5,), [4, 4]),
    (np.int32, (0,), [3, 5]),                 # zero-size cells
]


@pytest.mark.parametrize('dtype,shape,chunks', BYTE_CASES)
def test_raw_view_repack_and_decode_as_jax(dtype, shape, chunks):
    rng = np.random.default_rng(11)
    jfield, tfield = _pair(dtype=dtype, shape=shape)
    tplan, _ = tdecode.plan_for_field(tfield)
    jplan, _ = jdecode.plan_for_field(jfield)
    values = _values(rng, dtype, shape, 8)
    traw = tdecode.raw_column_view(_column(tfield, values, chunks), tplan)
    jraw = jdecode.raw_column_view(_column(jfield, values, chunks), jplan)
    assert traw.dtype == np.uint8 and traw.shape == (8, tplan.stride)
    assert traw.tobytes() == jraw.tobytes()
    assert (tdecode.repack_to_raw(tplan, values).tobytes()
            == jdecode.repack_to_raw(jplan, values).tobytes()
            == traw.tobytes())
    host = tdecode.decode_raw_host(tplan, traw)
    assert host.flags.writeable
    assert host.tobytes() == jdecode.decode_raw_host(jplan, jraw).tobytes()
    got = tdecode.decode_raw_torch(tplan, torch.from_numpy(traw.copy()))
    want = np.asarray(jdecode.decode_raw_jax(jplan, jraw))
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    assert got.numpy().dtype == want.dtype == np.dtype(dtype)
    assert got.numpy().tobytes() == want.tobytes() == values.tobytes()


@pytest.mark.parametrize('case', ['nulls', 'foreign header', 'stride drift'])
def test_raw_view_declines_as_jax(case):
    """A chunk that does not match the plan gives None in both packages
    (host decode and repack, never an error)."""
    rng = np.random.default_rng(3)
    pairs = _pair(dtype=np.float32, shape=(2,))
    plans = [jdecode.plan_for_field(pairs[0])[0],
             tdecode.plan_for_field(pairs[1])[0]]
    for pkg, field, plan in zip((jdecode, tdecode), pairs, plans):
        cells = [field.codec.encode(field, v)
                 for v in _values(rng, np.float32, (2,), 3)]
        if case == 'nulls':
            column = pa.chunked_array([pa.array(cells[:2] + [None],
                                                type=pa.binary())])
        elif case == 'foreign header':
            other = UnischemaField('x', np.int64, (1,), tcodecs.NdarrayCodec(),
                                   False)
            column = _column(other, _values(rng, np.int64, (1,), 3))
        else:
            cells[1] += b'\x00'
            column = pa.chunked_array([pa.array(cells, type=pa.binary())])
        assert pkg.raw_column_view(column, plan) is None


def test_repack_shape_mismatch_raises_as_jax():
    for pkg, field in zip((jdecode, tdecode), _pair(dtype=np.int16,
                                                    shape=(3, 2))):
        plan, _ = pkg.plan_for_field(field)
        with pytest.raises(ValueError, match='cell shape'):
            pkg.repack_to_raw(plan, np.zeros((5, 2, 3), dtype=np.int16))


def test_decode_raw_torch_copies_out_of_the_grid():
    """The port returns a fresh contiguous tensor, as JAX a fresh array:
    the grid can be freed or reused while the decoded tensor lives."""
    _, tfield = _pair(dtype=np.int32, shape=(4,))
    plan, _ = tdecode.plan_for_field(tfield)
    raw = torch.from_numpy(tdecode.repack_to_raw(
        plan, np.arange(12, dtype=np.int32).reshape(3, 4)))
    out = tdecode.decode_raw_torch(plan, raw)
    raw.zero_()
    assert out.tolist() == np.arange(12).reshape(3, 4).tolist()


# ---------------------------------------------------------------------------
# the fused decode with a device TransformSpec
# ---------------------------------------------------------------------------

def test_fused_decode_with_device_spec_as_jax():
    rng = np.random.default_rng(5)
    jfield, tfield = _pair('tokens', np.int32, (4,))
    values = _values(rng, np.int32, (4,), 6)
    idx = np.arange(6, dtype=np.int64)
    jplan, _ = jdecode.plan_for_field(jfield)
    tplan, _ = tdecode.plan_for_field(tfield)
    raw = tdecode.raw_column_view(_column(tfield, values), tplan)

    def double(cols):   # jnp arrays under JAX, tensors under the port
        return dict(cols, tokens=cols['tokens'] * 2, idx=cols['idx'] + 1)

    jbatch = {'tokens': raw, 'idx': idx,
              'name': np.array(['a'] * 6, dtype=object)}
    jdev, jhost = jdecode.split_device_columns(jbatch, {'tokens': jplan},
                                               include_unplanned=True)
    tdev, thost = tdecode.split_device_columns(
        {'tokens': torch.from_numpy(raw.copy()), 'idx': torch.from_numpy(idx),
         'name': jbatch['name']}, {'tokens': tplan}, include_unplanned=True)
    assert set(tdev) == set(jdev) == {'tokens', 'idx'}
    assert set(thost) == set(jhost) == {'name'}
    jout = jdecode.build_fused_infeed(
        {'tokens': jplan}, JTransformSpec(double, device=True))(jdev)
    tout = tdecode.build_fused_infeed(
        {'tokens': tplan}, TransformSpec(double, device=True))(tdev)
    assert tout['tokens'].numpy().tobytes() == np.asarray(
        jout['tokens']).tobytes()
    # jax without x64 keeps idx as int32: compare its values
    assert tout['idx'].tolist() == np.asarray(jout['idx']).tolist()
    assert tout['tokens'].tolist() == (values * 2).tolist()
    dev, host = tdecode.split_device_columns(jbatch, {'tokens': tplan})
    assert set(dev) == {'tokens'} and set(host) == {'idx', 'name'}


# ---------------------------------------------------------------------------
# end to end: an epoch through both packages' readers and loaders
# ---------------------------------------------------------------------------

ROWS, SEQ = 64, 16


@pytest.fixture(scope='module')
def token_store(tmp_path_factory):
    """``idx`` int64 (ScalarCodec) and ``tokens`` int32 (SEQ,)
    (NdarrayCodec), 64 rows in several row groups."""
    url = 'file://' + str(tmp_path_factory.mktemp('decode') / 'tok')
    schema = Unischema('Tok', [
        UnischemaField('idx', np.int64, (), tcodecs.ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (SEQ,), tcodecs.NdarrayCodec(),
                       False)])
    tokens = np.random.default_rng(4).integers(0, 5000, (ROWS, SEQ),
                                               dtype=np.int32)
    with materialize_dataset(url, schema, row_group_size_mb=0.004) as w:
        w.write_rows({'idx': np.int64(i), 'tokens': tokens[i]}
                     for i in range(ROWS))
    return url, tokens


def _jax_epoch(url, loader=True, **kw):
    with petastorm_tpu.make_columnar_reader(url, workers_count=1,
                                            shuffle_row_groups=False,
                                            **kw) as reader:
        declined = dict(reader.device_decode_declined)
        if loader:
            batches = [{k: np.asarray(v) for k, v in b.items()}
                       for b in JaxDataLoader(reader, batch_size=16)]
        else:
            batches = [b._asdict() for b in reader]
    return batches, declined


def _port_epoch(url, loader=True, device_decode=True, **kw):
    with make_columnar_reader(url, workers_count=1, shuffle_row_groups=False,
                              **kw) as reader:
        declined = dict(reader.device_decode_declined)
        plans = set(reader.device_decode_plans)
        if loader:
            batches = list(TorchDataLoader(reader, batch_size=16,
                                           device='cpu',
                                           device_decode=device_decode))
        else:
            batches = [b._asdict() for b in reader]
    return batches, declined, plans


def _concat(batches, name):
    return np.concatenate([np.asarray(b[name]) for b in batches])


@pytest.mark.parametrize('mode', ['claim on', 'claim off', 'no loader'])
def test_epoch_as_jax(token_store, mode, monkeypatch):
    url, tokens = token_store
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'on')
    jbatches, jdeclined = _jax_epoch(url, loader=mode != 'no loader')
    tbatches, tdeclined, plans = _port_epoch(
        url, loader=mode != 'no loader', device_decode=mode == 'claim on')
    assert plans == {'tokens'} and tdeclined == jdeclined
    assert set(tdeclined) == {'idx'}
    got = _concat(tbatches, 'tokens')
    assert got.dtype == np.int32 and got.tobytes() == _concat(
        jbatches, 'tokens').tobytes() == tokens.tobytes()
    assert _concat(tbatches, 'idx').tolist() == list(range(ROWS))
    if mode == 'no loader':   # the reader's contract: decoded numpy
        assert all(isinstance(b['tokens'], np.ndarray) for b in tbatches)


def test_iter_prefetched_decodes_after_staging_once(token_store,
                                                    monkeypatch):
    """Under ``iter_prefetched`` the loader yields the raw grids and the
    staging decodes them: once a batch, on a uint8 ``(n, stride)`` grid,
    to the same tokens as plain iteration."""
    url, tokens = token_store
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'on')
    seen = []
    with make_columnar_reader(url, workers_count=1,
                              shuffle_row_groups=False) as reader:
        loader = TorchDataLoader(reader, batch_size=16, device='cpu')
        stride = loader._device_plans['tokens'].stride
        fused = loader._fused

        def spy(columns):
            seen.append((columns['tokens'].dtype,
                         tuple(columns['tokens'].shape)))
            return fused(columns)

        loader._fused = spy
        batches = list(loader.iter_prefetched())
    assert seen == [(torch.uint8, (16, stride))] * (ROWS // 16)
    assert _concat(batches, 'tokens').tobytes() == tokens.tobytes()


@pytest.mark.parametrize('claim', [True, False])
def test_device_spec_and_pad_as_jax(token_store, claim, monkeypatch):
    """A device spec in place (tokens doubled) with ``pad_spec`` on the
    planned column, through the claim or, with the claim off, on the
    reader's host path (CPU tensors in, numpy out)."""
    url, tokens = token_store
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'on')

    def double(cols):
        return dict(cols, tokens=cols['tokens'] * 2)

    pad = {'tokens': {'max_len': SEQ + 4, 'pad_value': -1}}
    with petastorm_tpu.make_columnar_reader(
            url, workers_count=1, shuffle_row_groups=False,
            transform_spec=JTransformSpec(double, device=True)) as reader:
        jbatches = [{k: np.asarray(v) for k, v in b.items()}
                    for b in JaxDataLoader(reader, batch_size=16,
                                           pad_spec=pad,
                                           device_decode=claim)]
    with make_columnar_reader(url, workers_count=1, shuffle_row_groups=False,
                              transform_spec=TransformSpec(
                                  double, device=True)) as reader:
        assert set(reader.device_decode_plans) == {'tokens'}
        tbatches = list(TorchDataLoader(reader, batch_size=16, pad_spec=pad,
                                        device='cpu', device_decode=claim))
    for name in ('tokens', 'tokens_len', 'idx'):
        assert _concat(tbatches, name).tolist() == \
            _concat(jbatches, name).tolist()
    assert _concat(tbatches, 'tokens')[:, :SEQ].tolist() == \
        (tokens * 2).tolist()


def test_device_spec_off_the_device_path_as_jax(token_store, monkeypatch):
    """Device decode off: JAX runs the device spec on the workers over
    numpy; the port runs it on the workers too, over CPU tensors, and keeps
    yielding numpy. The same values."""
    url, tokens = token_store
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'off')

    def double(cols):
        if isinstance(cols['tokens'], np.ndarray):    # JAX's: numpy
            return dict(cols, tokens=cols['tokens'] * 2)
        assert threading.current_thread().name.startswith('petastorm-')
        assert torch.is_tensor(cols['tokens'])
        return dict(cols, tokens=cols['tokens'] * 2)

    jbatches, _ = _jax_epoch(url, loader=False,
                             transform_spec=JTransformSpec(double,
                                                           device=True))
    tbatches, declined, plans = _port_epoch(
        url, loader=False, transform_spec=TransformSpec(double, device=True))
    assert plans == set() and '*' in declined
    assert all(isinstance(b['tokens'], np.ndarray) for b in tbatches)
    assert _concat(tbatches, 'tokens').tolist() == \
        _concat(jbatches, 'tokens').tolist() == (tokens * 2).tolist()


def test_field_set_changing_device_spec_declines_the_reader(token_store,
                                                             monkeypatch):
    url, tokens = token_store
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'on')
    spec = TransformSpec(lambda c: {'tokens': c['tokens']}, device=True,
                         removed_fields=['idx'])
    batches, declined, plans = _port_epoch(url, transform_spec=spec)
    assert plans == set() and 'field set' in declined['*']
    assert set(batches[0]) == {'tokens', '_provenance'}
    assert _concat(batches, 'tokens').tobytes() == tokens.tobytes()


def test_row_readers_decline_and_refuse_device_specs(token_store):
    """The row reader plans nothing and runs a device spec on the workers,
    as JAX's does: JAX's over a numpy row, the port's over CPU tensors,
    the rows back as numpy, alike."""
    url, tokens = token_store
    with make_reader(url, workers_count=1) as reader:
        assert reader.device_decode_plans == {}
        assert 'row-granular' in reader.device_decode_declined['*']
    jrows = _row_epoch(petastorm_tpu.make_reader, url, JTransformSpec(
        _row_spec_func(np.ndarray), device=True))
    trows = _row_epoch(make_reader, url, TransformSpec(
        _row_spec_func(torch.Tensor), device=True))
    _assert_rows_alike(trows, jrows, tokens)


def _row_spec_func(kind):
    def func(row):
        assert isinstance(row['tokens'], kind)
        return dict(row, tokens=row['tokens'] * 3 + 1)
    return func


def _row_epoch(factory, url, spec, **kw):
    with factory(url, workers_count=2, shuffle_row_groups=False,
                 transform_spec=spec, **kw) as reader:
        return sorted((r._asdict() for r in reader),
                      key=lambda r: int(r['idx']))


def _assert_rows_alike(trows, jrows, tokens):
    assert [int(r['idx']) for r in trows] == \
        [int(r['idx']) for r in jrows] == list(range(ROWS))
    for t, j, want in zip(trows, jrows, tokens):
        assert isinstance(t['tokens'], np.ndarray)
        assert isinstance(t['idx'], type(j['idx']))
        assert t['tokens'].dtype == j['tokens'].dtype == np.int32
        assert t['tokens'].tolist() == j['tokens'].tolist() == \
            (want * 3 + 1).tolist()


@pytest.mark.parametrize('pool', ['thread', 'dummy'])
def test_row_reader_device_spec_on_each_pool_as_jax(token_store, pool):
    url, tokens = token_store
    jrows = _row_epoch(petastorm_tpu.make_reader, url, JTransformSpec(
        _row_spec_func(np.ndarray), device=True))
    trows = _row_epoch(make_reader, url, TransformSpec(
        _row_spec_func(torch.Tensor), device=True), reader_pool_type=pool)
    _assert_rows_alike(trows, jrows, tokens)


def test_batch_reader_hands_a_device_spec_a_frame_as_jax(token_store):
    """``make_batch_reader`` hands any spec, ``device=True`` too, a pandas
    DataFrame, as JAX's does."""
    url, _ = token_store

    def func(df):
        assert type(df).__name__ == 'DataFrame'
        return df.assign(idx=df['idx'] * 3)

    def read(factory, spec_cls):
        with factory(url, workers_count=1, shuffle_row_groups=False,
                     transform_spec=spec_cls(func, device=True)) as reader:
            return np.concatenate([np.asarray(b.idx) for b in reader])

    assert read(make_batch_reader, TransformSpec).tolist() == \
        read(petastorm_tpu.make_batch_reader, JTransformSpec).tolist() == \
        [3 * i for i in range(ROWS)]


def test_run_on_cpu_tensors_wraps_and_unwraps():
    """Numeric arrays and scalars go in as CPU tensors (a read-only array
    copied), tensors come back as numpy, and a value the function returns
    as it got it comes back as given; other values pass through."""
    from petastorm_tpu_torch.transform import run_on_cpu_tensors
    frozen = np.arange(6, dtype=np.float32).reshape(2, 3)
    frozen.flags.writeable = False
    writable = np.arange(4, dtype=np.int16)
    values = {'a': frozen, 'b': writable, 'c': np.int64(7), 'd': 'text',
              'e': np.array(['x'], dtype=object)}
    seen = {}

    def func(v):
        seen.update(v)
        return dict(v, b=v['b'] * 2)

    out = run_on_cpu_tensors(func, values)
    assert all(torch.is_tensor(seen[k]) for k in 'abc')
    assert seen['d'] is values['d'] and seen['e'] is values['e']
    assert np.shares_memory(seen['b'].numpy(), writable)
    assert not np.shares_memory(seen['a'].numpy(), frozen)
    assert all(out[k] is values[k] for k in 'acde')
    assert isinstance(out['b'], np.ndarray) and out['b'].dtype == np.int16
    assert out['b'].tolist() == [0, 2, 4, 6]


# ---------------------------------------------------------------------------
# etl/repack: a zlib store made device-eligible, read alike by both packages
# ---------------------------------------------------------------------------

def test_repacked_store_reads_as_jax(tmp_path, monkeypatch, caplog):
    from petastorm_tpu.etl.repack import repack_to_ndarray_codec as jrepack
    from petastorm_tpu_torch.etl.dataset_metadata import get_schema
    from petastorm_tpu_torch.etl.repack import (repack_schema,
                                                repack_to_ndarray_codec)
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'on')
    src = 'file://' + str(tmp_path / 'zlib')
    schema = Unischema('Z', [
        UnischemaField('emb', np.float32, (4, 3),
                       tcodecs.CompressedNdarrayCodec(), False),
        UnischemaField('tag', np.int32, (2,), tcodecs.NdarrayCodec(), False),
        UnischemaField('mask', np.uint8, (3,),
                       tcodecs.CompressedNdarrayCodec(), True)])
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((12, 4, 3)).astype(np.float32)
    with materialize_dataset(src, schema, row_group_size_mb=0.002) as w:
        w.write_rows({'emb': emb[i], 'tag': np.array([i, i + 1], np.int32),
                      'mask': np.full(3, i, np.uint8)} for i in range(12))
    out, repacked = repack_schema(get_schema(str(tmp_path / 'zlib')))
    assert repacked == ['emb', 'mask']
    assert 'nullable' in caplog.text
    summary = repack_to_ndarray_codec(src, 'file://' + str(tmp_path / 'a'))
    jsummary = jrepack(src, 'file://' + str(tmp_path / 'b'))
    assert summary['rows'] == jsummary['rows'] == 12
    assert summary['repacked_fields'] == jsummary['repacked_fields']
    assert summary['still_ineligible'] == jsummary['still_ineligible']
    reads = []
    for store in ('a', 'b'):
        url = 'file://' + str(tmp_path / store)
        for loader in (True, False):
            tb, _, plans = _port_epoch(url, loader=loader)
            assert plans == {'emb', 'tag'}
            jb, _ = _jax_epoch(url, loader=loader)
            reads += [tb, jb]
    for batches in reads:
        # the repack reads with several workers: rows in any order
        order = np.argsort(_concat(batches, 'tag')[:, 0])
        assert _concat(batches, 'tag')[order, 0].tolist() == list(range(12))
        assert _concat(batches, 'emb')[order].tobytes() == emb.tobytes()
        assert [int(m[0]) for m in _concat(batches, 'mask')[order]] == \
            list(range(12))
