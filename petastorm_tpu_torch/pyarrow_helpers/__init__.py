"""pyarrow helpers of the port (``petastorm_tpu/pyarrow_helpers/``)."""

from petastorm_tpu_torch.pyarrow_helpers.batching_table_queue import \
    BatchingTableQueue

__all__ = ['BatchingTableQueue']
