"""Example lines of the port: the twins of ``examples/imagenet`` and
``examples/mnist``."""
