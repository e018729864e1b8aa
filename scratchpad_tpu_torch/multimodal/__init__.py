"""Image and video decoding for the vision models' requests: ``image``
(PIL) and ``video`` (OpenCV, or PIL for animated images). Neither library
is imported until a payload is decoded, so the package serves without
them; a missing one raises ``MissingDecoder``, which the HTTP server answers
with 400 and the library's name."""

from scratchpad_tpu_torch.multimodal.image import (  # noqa: F401
    MissingDecoder,
    decode_image,
    preprocess_clip,
)
