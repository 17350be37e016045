"""Ragged padding: ``pad_spec`` validation and the padding of a batch's
ragged columns into dense bucketed arrays.

The port's copy of ``petastorm_tpu/jax_utils.py``'s
``validate_pad_spec`` (:138), ``check_pad_spec_fields`` (:178) and
``pad_ragged_batch`` (:214). Numpy only: the torch loader pads its
batches with it, and so do the indexed loaders, which import no torch. A
torch tensor (a column the loader decoded on its device) pads with
``Tensor.new_full``; torch is never imported here.
"""

from __future__ import annotations

import sys

import numpy as np


def _is_tensor(value) -> bool:
    """True for a torch tensor; False without importing torch."""
    torch = sys.modules.get('torch')
    return torch is not None and isinstance(value, torch.Tensor)


def validate_pad_spec(pad_spec):
    """Normalize and validate a ragged-padding spec.

    ``pad_spec`` maps a field name to ``{'buckets': [n1, n2, ...]}`` or
    ``{'max_len': n}``, with optional ``'pad_value'`` (default 0),
    ``'length_field'`` (default ``'<name>_len'``), ``'dtype'`` and
    ``'trailing_shape'``. The last two only shape a batch of zero rows,
    where neither can be inferred (without them it takes ``pad_value``'s
    dtype and no trailing dims)."""
    if not pad_spec:
        return None
    normalized = {}
    for name, spec in pad_spec.items():
        spec = dict(spec)
        buckets = spec.pop('buckets', None)
        max_len = spec.pop('max_len', None)
        pad_value = spec.pop('pad_value', 0)
        length_field = spec.pop('length_field', name + '_len')
        dtype = spec.pop('dtype', None)
        trailing_shape = spec.pop('trailing_shape', ())
        if spec:
            raise ValueError('pad_spec for {!r} has unknown keys {}'.format(
                name, sorted(spec)))
        if (buckets is None) == (max_len is None):
            raise ValueError("pad_spec for {!r} needs exactly one of "
                             "'buckets' or 'max_len'".format(name))
        if buckets is None:
            buckets = [max_len]
        buckets = sorted(int(b) for b in buckets)
        if not buckets or buckets[0] <= 0:
            raise ValueError('pad_spec buckets for {!r} must be positive '
                             'ints, got {!r}'.format(name, buckets))
        normalized[name] = {'buckets': buckets, 'pad_value': pad_value,
                            'length_field': length_field,
                            'dtype': None if dtype is None else np.dtype(dtype),
                            'trailing_shape': tuple(trailing_shape)}
    return normalized


def check_pad_spec_fields(pad_spec, field_names, who: str) -> None:
    """Check a normalized pad_spec against a schema's field names: every
    padded field must exist, and no ``length_field`` may collide with a
    column (padding would overwrite it)."""
    if not pad_spec:
        return
    names = set(field_names)
    unknown = set(pad_spec) - names
    if unknown:
        raise ValueError('{}: pad_spec names unknown fields {} (schema has '
                         '{})'.format(who, sorted(unknown), sorted(names)))
    for name, spec in pad_spec.items():
        if spec['length_field'] in names:
            raise ValueError(
                "{}: pad_spec length_field {!r} for {!r} collides with an "
                'existing column; pick another via length_field='.format(
                    who, spec['length_field'], name))


def pad_ragged_batch(batch, pad_spec):
    """Pad the ragged (object-dtype) numpy columns of a collated batch into
    dense arrays of a bucket's width.

    For each field of the spec, rows pad along their first dimension to the
    smallest bucket that holds the batch's longest row, and the true lengths
    come out as an int32 ``length_field`` column. A column that arrives
    dense (rows of one length, always so at ``batch_size=1``) still pads to
    a bucket, with a constant length column."""
    out = dict(batch)
    for name, spec in pad_spec.items():
        col = out.get(name)
        if col is None:
            continue
        if _is_tensor(col) or not (isinstance(col, np.ndarray)
                                   and col.dtype == object):
            if not _is_tensor(col):     # a device-decoded column stays
                col = np.asarray(col)
            if col.ndim < 2:
                raise ValueError('pad_spec field {!r} has scalar rows; '
                                 'padding needs at least one dimension'
                                 .format(name))
            width = col.shape[1]
            bucket = next((b for b in spec['buckets'] if b >= width), None)
            if bucket is None:
                raise ValueError(
                    'pad_spec field {!r}: row length {} exceeds largest '
                    'bucket {}'.format(name, width, spec['buckets'][-1]))
            if bucket != width:
                shape = (len(col), bucket) + tuple(col.shape[2:])
                padded = (col.new_full(shape, spec['pad_value'])
                          if _is_tensor(col) else
                          np.full(shape, spec['pad_value'], dtype=col.dtype))
                padded[:, :width] = col
                col = padded
            out[name] = col
            out[spec['length_field']] = np.full(len(col), width, np.int32)
            continue
        rows = [np.asarray(v) for v in col]
        if not rows:
            # zero rows: the smallest bucket, dtype and trailing dims from
            # the spec
            bucket = spec['buckets'][0]
            dtype = spec['dtype']
            if dtype is None:
                dtype = np.asarray(spec['pad_value']).dtype
            shape = (0, bucket) + spec['trailing_shape']
            out[name] = np.empty(shape, dtype=dtype)
            out[spec['length_field']] = np.empty((0,), np.int32)
            continue
        if any(r.ndim < 1 for r in rows):
            raise ValueError('pad_spec field {!r} has scalar rows; padding '
                             'needs at least one dimension'.format(name))
        lengths = np.asarray([len(r) for r in rows], np.int32)
        longest = int(lengths.max())
        bucket = next((b for b in spec['buckets'] if b >= longest), None)
        if bucket is None:
            raise ValueError(
                'pad_spec field {!r}: row length {} exceeds largest bucket {}'
                .format(name, longest, spec['buckets'][-1]))
        first = rows[0]
        dense = np.full((len(rows), bucket) + first.shape[1:],
                        spec['pad_value'], dtype=first.dtype)
        for i, r in enumerate(rows):
            dense[i, :len(r)] = r
        out[name] = dense
        out[spec['length_field']] = lengths
    return out


def require_single_bucket_pad_spec(pad_spec, loader_name: str) -> None:
    """Sharded loaders pad each rank's LOCAL batch: with several buckets
    the ranks could disagree on the padded width of one global step. Shared
    by the streaming and indexed sharded loaders (JAX
    ``jax_utils.py:199-210``)."""
    if not pad_spec:
        return
    multi = {n for n, s in pad_spec.items() if len(s['buckets']) > 1}
    if multi:
        raise ValueError(
            "{} needs a single-bucket pad_spec (use 'max_len'); fields "
            'with multiple buckets: {}'.format(loader_name, sorted(multi)))
