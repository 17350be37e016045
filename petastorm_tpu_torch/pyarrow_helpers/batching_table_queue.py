"""A FIFO of arrow tables re-chunked into tables of exactly ``batch_size``
rows: put tables or record batches of any size in, take fixed-size tables
out (zero-copy slices and concatenations).

A copy of ``petastorm_tpu/pyarrow_helpers/batching_table_queue.py``.
"""

from __future__ import annotations

import collections

import pyarrow as pa


class BatchingTableQueue:
    def __init__(self, batch_size: int):
        if batch_size < 1:
            raise ValueError('batch_size must be positive')
        self._batch_size = batch_size
        self._chunks = collections.deque()
        self._rows = 0

    def put(self, table) -> None:
        if isinstance(table, pa.RecordBatch):
            table = pa.Table.from_batches([table])
        if table.num_rows:
            self._chunks.append(table)
            self._rows += table.num_rows

    def empty(self) -> bool:
        """True while fewer than ``batch_size`` rows are buffered."""
        return self._rows < self._batch_size

    def get(self) -> pa.Table:
        """The next ``batch_size`` rows as one table."""
        if self.empty():
            raise IndexError('Not enough rows buffered; check empty() first')
        need = self._batch_size
        parts = []
        while need > 0:
            chunk = self._chunks[0]
            if chunk.num_rows <= need:
                parts.append(self._chunks.popleft())
                need -= chunk.num_rows
            else:
                parts.append(chunk.slice(0, need))
                self._chunks[0] = chunk.slice(need)
                need = 0
        self._rows -= self._batch_size
        return pa.concat_tables(parts) if len(parts) > 1 else parts[0]
