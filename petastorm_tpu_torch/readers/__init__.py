"""Row-group workers and shuffling buffers of the port."""
