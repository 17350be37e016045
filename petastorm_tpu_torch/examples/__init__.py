"""Example lines of the port: the twins of ``examples/hello_world``,
``examples/imagenet``, ``examples/mnist`` and ``examples/transformer_lm``."""
