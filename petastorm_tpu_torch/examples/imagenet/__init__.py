"""ImageNet-style image line: png store → columnar reader with a resize on
the workers → torch loader → image CNN SGD steps."""
