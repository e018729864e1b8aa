"""Image and video chat parts over the port's HTTP server, on the CPU.

A tiny LLaVA server and a tiny Qwen2-VL server (random weights, f32) with
the char tokenizer, whose ``mm_image_token`` and ``mm_video_token`` are the
one character that encodes to the model's image or video id. An image sent
as a ``data:`` URL, as raw base64 and as a local path answers 200 with the
tokens ``Engine.generate`` gives for the same prompt and pixels; a GIF
video (``video_url``) likewise on Qwen2-VL. A remote URL, images and a
video together, a video for LLaVA and a payload that does not decode
answer 400; ``decode_video`` samples frames uniformly.
"""

import base64
import io

import numpy as np
import pytest

from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.multimodal import decode_image
from scratchpad_tpu_torch.multimodal.video import decode_video
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread
from scratchpad_tpu_torch.server.openai_api.conversation import get_template
from test_torch_server import CharTokenizer, _free_port, request
from test_torch_vision import LLAVA_IMG, QWEN_IMG, QWEN_VID, model_kw
import torch_threads  # noqa: F401  (one torch thread a test process)


def png(w=40, h=30, color=(200, 30, 60)) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (w, h), color).save(buf, format="PNG")
    return buf.getvalue()


def gif(n=5) -> bytes:
    from PIL import Image

    frames = [Image.new("RGB", (20, 20), (40 * i, 10, 200 - 30 * i)) for i in range(n)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:])
    return buf.getvalue()


def _serve(family: str, **mm):
    args = ServerArgs(device="cpu", random_weights=True, dtype="float32", page_size=4,
                      max_total_tokens=1024, port=_free_port(), **mm)
    eng = Engine(args, model_config=ModelConfig(**model_kw(family), dtype="float32"),
                 tokenizer=CharTokenizer())
    srv = ServerThread(ServerApp(eng, eng.args))
    return eng, srv, f"http://127.0.0.1:{args.port}"


@pytest.fixture(scope="module")
def llava():
    eng, srv, url = _serve("llava", mm_image_token=chr(LLAVA_IMG - 1))
    yield eng, url
    srv.stop()


@pytest.fixture(scope="module")
def qwen():
    eng, srv, url = _serve("qwen2vl", mm_image_token=chr(QWEN_IMG - 1),
                           mm_video_token=chr(QWEN_VID - 1), video_frames=4)
    yield eng, url
    srv.stop()


def _chat(url, parts, n=5):
    body = {"model": "m", "max_tokens": n, "temperature": 0.0, "ignore_eos": True,
            "messages": [{"role": "user", "content": [{"type": "text", "text": "see: "}, *parts]}]}
    return request(url, "/v1/chat/completions", body)


def _expected(eng, token: str, **media) -> str:
    prompt = get_template(None, "m").render([{"role": "user", "content": "see: " + token}])
    out = eng.generate(input_ids=CharTokenizer().encode(prompt), **media,
                       sampling_params=SamplingParams(temperature=0.0, max_new_tokens=5,
                                                      ignore_eos=True))
    return out.text


@pytest.mark.parametrize("form", ["data_url", "raw_base64", "local_path", "image_part"])
def test_image_part_serves(llava, form, tmp_path):
    eng, url = llava
    raw = png()
    b64 = base64.b64encode(raw).decode()
    if form == "data_url":
        part = {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}}
    elif form == "raw_base64":
        part = {"type": "image_url", "image_url": {"url": b64}}
    elif form == "local_path":
        path = tmp_path / "x.png"
        path.write_bytes(raw)
        part = {"type": "image_url", "image_url": {"url": str(path)}}
    else:
        part = {"type": "image", "image": b64}
    status, out = _chat(url, [part])
    assert status == 200, out
    px = eng.preprocess_image(decode_image(raw))
    assert out["choices"][0]["message"]["content"] == _expected(eng, chr(LLAVA_IMG - 1), image_data=px)


def test_video_part_serves(qwen):
    eng, url = qwen
    data = gif(6)
    part = {"type": "video_url", "video_url": {"url": "data:image/gif;base64," + base64.b64encode(data).decode()}}
    status, out = _chat(url, [part])
    assert status == 200, out
    frames = np.stack([eng.preprocess_image(f) for f in decode_video(data, num_frames=4)])
    assert out["choices"][0]["message"]["content"] == _expected(eng, chr(QWEN_VID - 1), video_data=frames)


@pytest.mark.parametrize("case", ["remote_url", "undecodable", "images_and_video", "video_for_llava"])
def test_bad_media_answers_400(llava, qwen, case):
    b64 = base64.b64encode(png()).decode()
    img = {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}}
    vid = {"type": "video_url", "video_url": {"url": "data:image/gif;base64," + base64.b64encode(gif()).decode()}}
    url, parts, why = {
        "remote_url": (llava[1], [{"type": "image_url", "image_url": {"url": "https://example.com/a.png"}}],
                       "egress"),
        "undecodable": (llava[1], [{"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}],
                        "undecodable"),
        "images_and_video": (qwen[1], [img, vid], "not both"),
        "video_for_llava": (llava[1], [vid], "does not accept video"),
    }[case]
    status, out = _chat(url, parts)
    assert status == 400 and why in out.get("message", ""), out


def test_decode_video_samples_uniformly():
    frames = decode_video(gif(9), num_frames=4)
    assert len(frames) == 4
    reds = [f.getpixel((0, 0))[0] for f in frames]
    assert reds[0] == 0 and reds == sorted(reds)  # the first frame, then later ones in order
    assert len(decode_video(gif(3), num_frames=4)) == 3
    with pytest.raises(ValueError, match="egress"):
        decode_video("https://example.com/v.mp4")
