"""Dataset writing and metadata of the port."""
