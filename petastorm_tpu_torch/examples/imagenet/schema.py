"""ImageNet dataset schema on the port's codecs: noun id, text, label and a
variable-shape compressed RGB image (``examples/imagenet/schema.py``)."""

import numpy as np

from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


def make_imagenet_schema(image_codec: str = 'png') -> Unischema:
    """The schema with the image stored as ``image_codec`` ('png' or
    'jpeg')."""
    return Unischema('ImagenetSchema', [
        UnischemaField('noun_id', str, (), ScalarCodec(), False),
        UnischemaField('text', str, (), ScalarCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (None, None, 3),
                       CompressedImageCodec(image_codec), False),
    ])
