"""Payload serializers of the process pool's transport.

A copy of ``petastorm_tpu/workers/serializers.py``. The pool moves each
payload as ZMQ multipart frames; every serializer has
``serialize_multipart(data) -> [frame0, ...]`` (buffer-protocol objects)
and ``deserialize_multipart(frames) -> data`` (any buffer-protocol
objects: ``bytes`` under ``zmq_copy_buffers=True``, memoryviews over
the ZMQ frames under ``False``). :class:`ZeroCopySerializer` is pickle
protocol 5 with out-of-band buffers: each large ndarray or arrow buffer is
a frame of its own, never copied into the pickle stream, and comes back as
a read-only view over its frame. :class:`ArrowTableSerializer` sends a
``pa.Table`` as one Arrow IPC stream (the batch reader's items).

Each instance counts ``copies`` (whole-payload copies it made) and
``bytes_moved``.
"""

from __future__ import annotations

import pickle

import pyarrow as pa

#: Buffers smaller than this stay in-band: a ZMQ frame per 100-byte array
#: would cost more in framing overhead than one memcpy saves.
_INBAND_THRESHOLD_BYTES = 64 * 1024


class PickleSerializer:
    """Monolithic-blob pickling: one full-payload memcpy on each side."""

    def __init__(self):
        self.copies = 0
        self.bytes_moved = 0

    def serialize(self, data) -> bytes:
        blob = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        self.copies += 1
        self.bytes_moved += len(blob)
        return blob

    def deserialize(self, payload):
        self.copies += 1
        return pickle.loads(payload)

    def serialize_multipart(self, data):
        return [self.serialize(data)]

    def deserialize_multipart(self, frames):
        return self.deserialize(frames[0])


class ZeroCopySerializer:
    """Pickle protocol 5 with out-of-band buffers.

    Frame 0 is the pickle metadata stream (object structure + small scalars);
    frames 1..N are the raw payload buffers, handed to ZMQ without ever being
    copied into the pickle blob. On deserialize the buffers are passed to
    ``pickle.loads(..., buffers=...)`` and ndarrays reconstruct as views over
    the received frames — zero payload memcpys on either side. Note the
    received arrays are **read-only** when the transport hands us read-only
    frames; consumers that mutate in place must copy first.

    Fallbacks (all still correct, just not zero-copy): non-contiguous
    ndarrays and unicode/object columns pickle in-band, as do buffers under
    ``_INBAND_THRESHOLD_BYTES`` (per-frame overhead would exceed the memcpy).
    """

    def __init__(self):
        self.copies = 0
        self.bytes_moved = 0

    def serialize_multipart(self, data):
        frames = [None]  # placeholder for the metadata frame

        def keep_out_of_band(pickle_buffer):
            try:
                raw = pickle_buffer.raw()
            except BufferError:      # non-contiguous exporter: in-band copy
                self.copies += 1
                return True
            if raw.nbytes < _INBAND_THRESHOLD_BYTES:
                return True          # in-band (returns true => not out-of-band)
            frames.append(raw)
            self.bytes_moved += raw.nbytes
            return False

        meta = pickle.dumps(data, protocol=5, buffer_callback=keep_out_of_band)
        frames[0] = meta
        self.bytes_moved += len(meta)
        return frames

    def deserialize_multipart(self, frames):
        return pickle.loads(frames[0], buffers=list(frames[1:]))


class ArrowTableSerializer:
    """Zero-copy-friendly serializer for ``pa.Table`` payloads using the Arrow
    IPC stream format.

    ``serialize`` returns the ``pa.Buffer`` from the IPC sink directly (one
    write into the sink; no ``to_pybytes`` re-copy), and ``deserialize``
    accepts any buffer-protocol object — ``bytes``, ``memoryview`` over a ZMQ
    frame, or ``pa.Buffer`` — and reads the table zero-copy over it.
    """

    def __init__(self):
        self.copies = 0
        self.bytes_moved = 0

    def serialize(self, table):
        if table is None:
            return b''
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            for batch in table.to_batches():
                writer.write_batch(batch)
        buf = sink.getvalue()
        self.copies += 1            # the one IPC write into the sink
        self.bytes_moved += buf.size
        return buf

    def deserialize(self, payload):
        buf = payload if isinstance(payload, pa.Buffer) else pa.py_buffer(payload)
        if buf.size == 0:
            return None
        with pa.ipc.open_stream(buf) as reader:
            return reader.read_all()

    def serialize_multipart(self, table):
        return [self.serialize(table)]

    def deserialize_multipart(self, frames):
        return self.deserialize(frames[0])


def as_multipart(serializer):
    """Adapt a legacy single-frame serializer (``serialize``/``deserialize``
    only) to the multipart transport contract; passthrough otherwise."""
    if hasattr(serializer, 'serialize_multipart'):
        return serializer
    return _SingleFrameAdapter(serializer)


class _SingleFrameAdapter:
    def __init__(self, serializer):
        self._serializer = serializer
        self.copies = 0
        self.bytes_moved = 0

    def serialize_multipart(self, data):
        return [self._serializer.serialize(data)]

    def deserialize_multipart(self, frames):
        return self._serializer.deserialize(frames[0])
