"""MNIST-style row line: row reader → torch loader → MLP SGD steps."""
