"""The port stands alone: it never imports JAX or the JAX package.

A subprocess imports every module of ``scratchpad_tpu_torch`` (the Qwen,
Gemma, Mixtral, GPT-OSS, Llama-4, Apertus and DeepSeek models, the latent
attention, the custom logit processors and the ``constrained`` modules
among them) and ``chip_smoke``, and serves tiny CPU engines of Llama,
Gemma 2, Qwen3, GPT-OSS, Qwen3-MoE, Llama-4, Apertus and DeepSeek-V3, a
custom logit processor and a regex and a recursive EBNF grammar, then
lists what it loaded;
a source scan checks every import statement of the package. A second
subprocess blocks ``jax``, the JAX package and the serving packages that the
card's machine lacks (``aiohttp``, ``pydantic``, ``prometheus_client``,
``requests``), then imports every module, ``server.http_server`` and
``cli.sp`` among them, and answers a completion over HTTP.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "scratchpad_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import scratchpad_tpu_torch
names = [m.name for m in pkgutil.walk_packages(scratchpad_tpu_torch.__path__, "scratchpad_tpu_torch.")]
assert {"scratchpad_tpu_torch.models.gemma", "scratchpad_tpu_torch.models.qwen",
        "scratchpad_tpu_torch.models.mixtral", "scratchpad_tpu_torch.models.gpt_oss",
        "scratchpad_tpu_torch.models.llama4", "scratchpad_tpu_torch.models.apertus",
        "scratchpad_tpu_torch.models.deepseek", "scratchpad_tpu_torch.ops.attention.mla_backend",
        "scratchpad_tpu_torch.sampling.custom_logit_processor"} <= set(names)
assert {"scratchpad_tpu_torch.constrained." + m for m in (
    "backend", "ebnf", "json_schema", "leftrec", "pda", "regex_fsm", "structural_tag")} <= set(names)
for n in names:
    importlib.import_module(n)
import chip_smoke
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
for cfg in (get_preset("tiny-debug"), get_preset("tiny-gemma2"),
            get_preset("tiny-debug", architecture="Qwen3ForCausalLM"), get_preset("tiny-gpt-oss"),
            get_preset("tiny-debug", architecture="Qwen3MoeForCausalLM", num_experts=4,
                       num_experts_per_tok=2),
            get_preset("tiny-debug", architecture="Llama4ForCausalLM", num_experts=4,
                       num_experts_per_tok=1, interleave_moe_layer_step=2, use_qk_norm=True,
                       attention_chunk_size=4, floor_scale=4),
            get_preset("tiny-debug", architecture="ApertusForCausalLM"),
            get_preset("tiny-debug", architecture="DeepseekV3ForCausalLM", kv_lora_rank=32,
                       qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=32, num_experts=4,
                       num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
                       moe_intermediate_size=64, n_group=2, topk_group=1)):
    eng = Engine(ServerArgs(random_weights=True, dtype="float32", device="cpu", page_size=4,
                            max_total_tokens=512), model_config=cfg)
    out = eng.generate(input_ids=[1, 2, 3, 4, 5],
                       sampling_params=SamplingParams(temperature=0.0, max_new_tokens=4))
    assert len(out.output_ids) == 4
# a custom logit processor beside a free row
from scratchpad_tpu_torch.sampling.custom_logit_processor import BannedTokensProcessor
free = eng.generate(input_ids=[1, 2, 3], sampling_params=SamplingParams(temperature=0.0, max_new_tokens=4))
outs = eng.generate(input_ids=[[1, 2, 3]] * 2, sampling_params=[
    SamplingParams(temperature=0.0, max_new_tokens=4,
                   custom_logit_processor=BannedTokensProcessor(free.output_ids)),
    SamplingParams(temperature=0.0, max_new_tokens=4)])
assert not set(outs[0].output_ids) & set(free.output_ids) and outs[1].output_ids == free.output_ids
# constrained decoding: a regex and a recursive EBNF grammar (pushdown)
eng = Engine(ServerArgs(preset="tiny-debug", random_weights=True, dtype="float32", device="cpu",
                        page_size=4, max_total_tokens=512, tokenizer_path="chars"))
outs = eng.generate(input_ids=[[1, 2, 3]] * 2, sampling_params=[
    SamplingParams(temperature=0.0, max_new_tokens=8, regex="(yes|no)!"),
    SamplingParams(temperature=0.0, max_new_tokens=8, ebnf='root ::= "(" root ")" | "x"',
                   logit_bias={ord("x") + 1: 100.0})])
assert outs[0].text in ("yes!", "no!") and outs[1].text == "x", [o.text for o in outs]
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "scratchpad_tpu"))))
"""


def test_import_and_serve_leave_jax_out():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert loaded == [], loaded


BLOCKED = ("jax", "jaxlib", "scratchpad_tpu", "aiohttp", "pydantic", "prometheus_client", "requests")

_BLOCKED_PROBE = """
import importlib, json, pkgutil, sys, urllib.request

BLOCKED = %r


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
import scratchpad_tpu_torch
names = [m.name for m in pkgutil.walk_packages(scratchpad_tpu_torch.__path__, "scratchpad_tpu_torch.")]
assert "scratchpad_tpu_torch.server.http_server" in names and "scratchpad_tpu_torch.cli.sp" in names
for n in names:
    importlib.import_module(n)
import chip_smoke
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.server.engine import Engine
from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread
from scratchpad_tpu_torch.utils.client import post_json
args = ServerArgs(preset="tiny-debug", random_weights=True, dtype="float32", device="cpu",
                  page_size=4, max_total_tokens=512, port=int(sys.argv[1]))
srv = ServerThread(ServerApp(Engine(args), args))
out = post_json(f"http://127.0.0.1:{args.port}/v1/completions",
                {"model": "m", "prompt": [1, 2, 3], "max_tokens": 3, "temperature": 0.0,
                 "ignore_eos": True, "logprobs": 1})
assert len(out["choices"][0]["logprobs"]["tokens"]) == 3
with urllib.request.urlopen(f"http://127.0.0.1:{args.port}/metrics") as r:
    assert b"scratchpad_tpu:time_to_first_token_seconds_count 1.0" in r.read()
srv.stop()
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)))
""" % (BLOCKED,)


def test_import_and_serve_with_serving_packages_blocked():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_PROBE, str(port)],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            names.append(str(node.args[0].value))
    return names


def test_source_imports_no_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files
        for name in _imported_modules(f)
        if name.split(".")[0] in BLOCKED
    ]
    assert bad == []



_NO_DECODERS_PROBE = """
import base64, importlib, json, pkgutil, sys, urllib.error, urllib.request

DECODERS = ("PIL", "cv2")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in DECODERS:
            raise ModuleNotFoundError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
import scratchpad_tpu_torch
for m in pkgutil.walk_packages(scratchpad_tpu_torch.__path__, "scratchpad_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
import numpy as np
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread


class Chars:
    eos_token_id = 0
    chat_template = None

    def encode(self, text):
        return [ord(c) + 1 for c in text]

    def decode(self, ids, **kw):
        return "".join(chr(i - 1) for i in ids if 0 < i <= 256)


cfg = ModelConfig(**json.loads(sys.argv[2]), dtype="float32")
args = ServerArgs(random_weights=True, dtype="float32", device="cpu", page_size=4,
                  max_total_tokens=512, port=int(sys.argv[1]), mm_image_token=chr(499))
eng = Engine(args, model_config=cfg, tokenizer=Chars())
px = np.zeros((1, 3, 24, 24), np.float32)
out = eng.generate(input_ids=[3, 500, 4], image_data=px,
                   sampling_params=SamplingParams(temperature=0.0, max_new_tokens=3))
assert len(out.output_ids) == 3
srv = ServerThread(ServerApp(eng, args))
body = {"model": "m", "max_tokens": 2, "messages": [{"role": "user", "content": [
    {"type": "image_url", "image_url": {"url": "data:image/png;base64," + base64.b64encode(b"x").decode()}}]}]}
req = urllib.request.Request(f"http://127.0.0.1:{args.port}/v1/chat/completions",
                             data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
try:
    urllib.request.urlopen(req)
    raise AssertionError("an image without pillow was served")
except urllib.error.HTTPError as e:
    assert e.code == 400 and "pillow" in json.loads(e.read())["message"]
srv.stop()
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in DECODERS)))
"""


def test_import_and_serve_images_without_decoders():
    """With PIL and OpenCV blocked, every module and ``chip_smoke`` import,
    a LLaVA engine serves pixels handed to it, and an image part over HTTP
    answers 400 naming pillow: the decoders load only inside the functions
    that decode."""
    import socket

    from test_torch_vision import model_kw

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-c", _NO_DECODERS_PROBE, str(port), json.dumps(model_kw("llava"))],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
