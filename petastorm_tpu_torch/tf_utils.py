"""TensorFlow adapter of the port: ``make_petastorm_dataset(reader)`` ->
``tf.data.Dataset``, and the graph-mode ``tf_tensors``.

A copy of ``petastorm_tpu/tf_utils.py``: ``from_generator`` with the
static shapes set, the casts TensorFlow needs (uint16 -> int32, uint32 ->
int64, Decimal -> string, datetime64 -> int64 ns), the NGram dataset
(windows flattened across the generator and rebuilt as ``{offset:
namedtuple}``), and ``tf_tensors`` (:181), the TF1 graph-mode API
(``py_func`` and an optional ``RandomShuffleQueue``) for session code.
TensorFlow is imported only when one of these is called; the port needs
it nowhere else.
"""

from __future__ import annotations

import datetime
from decimal import Decimal

import numpy as np


def _tf():
    import tensorflow as tf
    return tf


def _field_tf_dtype(field):
    """numpy dtype -> tf dtype incl. promotions (petastorm ``tf_utils.py:27-44``):
    uint16→int32, uint32→int64, Decimal→string, datetime→int64 ns."""
    tf = _tf()
    np_dtype = field.numpy_dtype
    if np_dtype in (str, bytes, Decimal, np.str_, np.bytes_):
        return tf.string
    if np_dtype in (np.datetime64, datetime.date, datetime.datetime):
        return tf.int64
    dt = np.dtype(np_dtype)
    if dt == np.uint16:
        return tf.int32
    if dt == np.uint32:
        return tf.int64
    if dt.kind == 'M':
        return tf.int64
    return tf.as_dtype(dt)


def _sanitize_field_tf_types(value):
    """Make one field value feedable to TF (petastorm ``tf_utils.py:58-97``)."""
    if value is None:
        raise RuntimeError('Null values are not supported by the TF adapter; '
                           'use a TransformSpec to fill nulls')
    if isinstance(value, Decimal):
        return str(value)
    arr = np.asarray(value)
    if arr.dtype.kind == 'M':
        return arr.astype('datetime64[ns]').astype(np.int64)
    if arr.dtype == np.uint16:
        return arr.astype(np.int32)
    if arr.dtype == np.uint32:
        return arr.astype(np.int64)
    if arr.dtype.kind == 'O':
        if arr.size and isinstance(arr.flat[0], Decimal):
            return arr.astype(str)
        return arr.astype(str) if arr.size and isinstance(arr.flat[0], str) else arr
    return arr


def _sanitize_row(row_dict):
    return {k: _sanitize_field_tf_types(v) for k, v in row_dict.items()}


def make_petastorm_dataset(reader):
    """Build a ``tf.data.Dataset`` over a row or batch reader
    (petastorm ``tf_utils.py:329-399``).

    Elements are namedtuples of tensors (one row each for ``make_reader``, one
    row-group batch each for ``make_batch_reader``; apply
    ``.unbatch()``/``.flat_map`` + ``.batch()`` for fixed-size training
    batches). The dataset is single-pass per reader epoch set: use
    ``num_epochs=None`` in the reader instead of ``.repeat()``
    (original petastorm refuses re-iteration the same way, ``tf_utils.py:366-374``).
    """
    tf = _tf()
    schema = reader.schema
    if getattr(reader, 'ngram', None) is not None:
        return _make_ngram_dataset(reader)

    fields = list(schema.fields.values())
    names = [f.name for f in fields]
    output_types = tuple(_field_tf_dtype(f) for f in fields)

    def generator():
        for item in reader:
            row = item._asdict() if hasattr(item, '_asdict') else dict(item)
            sane = _sanitize_row(row)
            yield tuple(sane[n] for n in names)

    dataset = tf.data.Dataset.from_generator(generator, output_types)

    batched = reader.batched_output

    def set_shape_and_name(*row):
        out = [_set_static_shape(value, field, batched)
               for value, field in zip(row, fields)]
        # namedtuple row type with tensor values (same type the raw reader
        # yields for decoded rows)
        return schema.make_batch_namedtuple(**dict(zip(names, out)))

    return dataset.map(set_shape_and_name)


def _make_ngram_dataset(reader):
    """NGram rows are {offset: namedtuple}; flatten across the generator
    boundary and rebuild the dict of namedtuples (petastorm
    ``tf_utils.py:141-183,402-433``)."""
    tf = _tf()
    ngram = reader.ngram
    timesteps = sorted(ngram.fields.keys())
    flat_fields = []
    for ts in timesteps:
        schema_at_ts = ngram.get_schema_at_timestep(reader.schema, ts)
        for f in schema_at_ts.fields.values():
            flat_fields.append((ts, f))
    output_types = tuple(_field_tf_dtype(f) for _, f in flat_fields)

    def generator():
        for item in reader:
            out = []
            for ts, f in flat_fields:
                value = getattr(item[ts], f.name)
                out.append(_sanitize_field_tf_types(value))
            yield tuple(out)

    dataset = tf.data.Dataset.from_generator(generator, output_types)

    def unflatten(*flat):
        result = {}
        idx = 0
        for ts in timesteps:
            schema_at_ts = ngram.get_schema_at_timestep(reader.schema, ts)
            names = list(schema_at_ts.fields.keys())
            result[ts] = dict(zip(names, flat[idx:idx + len(names)]))
            idx += len(names)
        return result

    return dataset.map(unflatten)


def _set_static_shape(tensor, field, batched):
    shape = tuple(field.shape or ())
    static = tuple(s if s is not None else None for s in shape)
    if batched:
        static = (None,) + static
    try:
        tensor.set_shape(static)
    except ValueError:
        pass  # ragged/opaque: leave dynamic
    return tensor


def _maybe_shuffle_queue(tensors, dtypes, capacity, min_after_dequeue):
    """Normalize py_func output to a list and optionally route it through a
    RandomShuffleQueue, exposing the named ``random_shuffling_queue_size``
    monitoring op (petastorm ``tf_utils.py:46-48,208-210``)."""
    tf = _tf()
    v1 = tf.compat.v1
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]       # single-dtype py_func returns a bare tensor
    if capacity > 0:
        queue = tf.queue.RandomShuffleQueue(
            capacity, min_after_dequeue, dtypes,
            name='petastorm_tpu_shuffling_queue')
        v1.train.add_queue_runner(
            v1.train.QueueRunner(queue, [queue.enqueue(tensors)]))
        v1.identity(tf.cast(queue.size(), tf.int32),
                    name='random_shuffling_queue_size')
        tensors = queue.dequeue()
        if not isinstance(tensors, (list, tuple)):
            tensors = [tensors]   # single-component dequeue, same deal
    return tensors


def tf_tensors(reader, shuffling_queue_capacity=0, min_after_dequeue=0):
    """Graph-mode tensors: each ``session.run`` pulls the next row (or
    row-group batch) from the reader (petastorm ``tf_utils.py:270-327``; queue
    variant ``:202-252``).

    TF1-compat API for legacy graph/session code — build under
    ``tf.compat.v1.Graph`` and evaluate with a ``tf.compat.v1.Session``.
    Reader exhaustion surfaces as ``tf.errors.OutOfRangeError``, the standard
    end-of-input signal graph training loops already handle. With
    ``shuffling_queue_capacity > 0`` rows pass through a
    ``RandomShuffleQueue`` (start it with
    ``tf.compat.v1.train.start_queue_runners``); the queue is refused for
    batched readers exactly as original petastorm refuses it
    (``tf_utils.py:308-312``). New TF2 code should prefer
    :func:`make_petastorm_dataset`.
    """
    tf = _tf()
    v1 = tf.compat.v1
    schema = reader.schema
    batched = bool(getattr(reader, 'batched_output', False))
    if batched and shuffling_queue_capacity > 0:
        raise ValueError('shuffling_queue_capacity is not supported with '
                         'batched readers (reference tf_utils.py:308-312); '
                         'shuffle in the reader instead')
    ngram = getattr(reader, 'ngram', None)
    if ngram is not None:
        return _tf_tensors_ngram(reader, shuffling_queue_capacity,
                                 min_after_dequeue)

    fields = list(schema.fields.values())
    names = [f.name for f in fields]
    dtypes = [_field_tf_dtype(f) for f in fields]

    def next_row():
        # StopIteration propagates: py_func surfaces it to session.run as
        # tf.errors.OutOfRangeError, the standard end-of-input signal
        item = next(reader)
        row = item._asdict() if hasattr(item, '_asdict') else dict(item)
        sane = _sanitize_row(row)
        return [np.asarray(sane[n]) for n in names]

    tensors = v1.py_func(next_row, [], dtypes, name='petastorm_tpu_row')
    tensors = _maybe_shuffle_queue(tensors, dtypes, shuffling_queue_capacity,
                                   min_after_dequeue)
    out = [_set_static_shape(t, f, batched) for t, f in zip(tensors, fields)]
    make = schema.make_batch_namedtuple if batched else schema.make_namedtuple
    return make(**dict(zip(names, out)))


def _tf_tensors_ngram(reader, shuffling_queue_capacity, min_after_dequeue):
    """NGram variant: windows flattened across the py_func boundary and
    rebuilt as {offset: namedtuple} of tensors (petastorm
    ``tf_utils.py:255-267,402-433``)."""
    tf = _tf()
    v1 = tf.compat.v1
    ngram = reader.ngram
    timesteps = sorted(ngram.fields.keys())
    flat_fields = []
    for ts in timesteps:
        schema_at_ts = ngram.get_schema_at_timestep(reader.schema, ts)
        for f in schema_at_ts.fields.values():
            flat_fields.append((ts, f))
    dtypes = [_field_tf_dtype(f) for _, f in flat_fields]

    def next_window():
        item = next(reader)   # StopIteration -> OutOfRangeError via py_func
        return [np.asarray(_sanitize_field_tf_types(getattr(item[ts], f.name)))
                for ts, f in flat_fields]

    tensors = v1.py_func(next_window, [], dtypes, name='petastorm_tpu_ngram')
    tensors = _maybe_shuffle_queue(tensors, dtypes, shuffling_queue_capacity,
                                   min_after_dequeue)
    result = {}
    idx = 0
    for ts in timesteps:
        view = ngram.get_schema_at_timestep(reader.schema, ts)
        names = list(view.fields.keys())
        step = [_set_static_shape(t, f, False)
                for t, f in zip(tensors[idx:idx + len(names)],
                                view.fields.values())]
        result[ts] = view.make_namedtuple(**dict(zip(names, step)))
        idx += len(names)
    return result
