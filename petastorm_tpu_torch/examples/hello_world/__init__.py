"""Hello world of the port: write a store, read it row-wise, through the
torch loader, and a plain Parquet store through ``make_batch_reader``."""
