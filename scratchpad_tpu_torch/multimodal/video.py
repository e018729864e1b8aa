"""Video decoding and uniform frame sampling for VLM requests.

Counterpart of ``scratchpad_tpu/multimodal/video.py``: decode a video
payload (a local path, a ``data:`` URL, raw base64 or bytes) and sample
``num_frames`` frames uniformly. mp4, webm and avi go through OpenCV's
``VideoCapture``; animated GIF, WEBP and APNG through PIL. A remote URL is
refused. Both libraries are imported inside the functions that decode; a
payload spilled for OpenCV goes to a temporary file that is removed after.
"""

from __future__ import annotations

import base64
import io
import os
import tempfile

from scratchpad_tpu_torch.multimodal.image import require


def _pil_frames(data: bytes) -> list:
    """An animated image's frames, RGB PIL images."""
    Image = require("PIL.Image", "pillow")
    ImageSequence = require("PIL.ImageSequence", "pillow")
    img = Image.open(io.BytesIO(data))
    return [f.convert("RGB") for f in ImageSequence.Iterator(img)]


def _cv2_frames(path: str) -> list:
    cv2 = require("cv2", "opencv-python")
    Image = require("PIL.Image", "pillow")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cv2 cannot open video {path!r}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(Image.fromarray(frame[:, :, ::-1]))  # BGR -> RGB
    cap.release()
    if not frames:
        raise ValueError("video decoded to zero frames")
    return frames


def _sample(frames: list, num_frames: int) -> list:
    """Uniform temporal sampling: the first and the last frame and evenly
    between."""
    n = len(frames)
    if n <= num_frames:
        return list(frames)
    idx = [round(i * (n - 1) / (num_frames - 1)) for i in range(num_frames)]
    return [frames[i] for i in idx]


def decode_video(src, num_frames: int = 8) -> list:
    """A video source -> ``num_frames`` uniformly sampled RGB PIL frames."""
    data = path = None
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    elif isinstance(src, str):
        if src.startswith("data:"):
            data = base64.b64decode(src.split(",", 1)[1])
        elif src.startswith(("http://", "https://")):
            raise ValueError(
                "remote video URLs are not fetched (no egress); send a data: URL or base64 payload"
            )
        elif os.path.exists(src):
            path = src
        else:
            data = base64.b64decode(src)
    else:
        raise TypeError(f"unsupported video source {type(src)}")
    if data is not None and (
        data[:3] == b"GIF" or data[:4] == b"\x89PNG" or (data[:4] == b"RIFF" and data[8:12] == b"WEBP")
    ):
        return _sample(_pil_frames(data), num_frames)
    if data is not None:  # OpenCV reads files: spill the payload
        with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
            f.write(data)
            path = f.name
        try:
            return _sample(_cv2_frames(path), num_frames)
        finally:
            os.unlink(path)
    if path.lower().endswith((".gif", ".webp", ".apng", ".png")):
        with open(path, "rb") as f:
            return _sample(_pil_frames(f.read()), num_frames)
    return _sample(_cv2_frames(path), num_frames)
