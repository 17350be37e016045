"""Example lines of the port: the twins of ``examples/hello_world``,
``examples/imagenet`` and ``examples/mnist``."""
