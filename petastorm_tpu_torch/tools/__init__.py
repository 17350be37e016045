"""Console tools of the port (``petastorm_tpu/tools/``)."""
