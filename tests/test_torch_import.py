"""The port stands alone: it never imports JAX or the JAX package.

A subprocess imports every module of ``scratchpad_tpu_torch`` (and
``chip_smoke``) and serves a tiny CPU Engine, then lists what it loaded;
a source scan checks every import statement of the package.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "scratchpad_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import scratchpad_tpu_torch
for m in pkgutil.walk_packages(scratchpad_tpu_torch.__path__, "scratchpad_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
eng = Engine(ServerArgs(preset="tiny-debug", random_weights=True, dtype="float32",
                        device="cpu", page_size=4, max_total_tokens=512))
out = eng.generate(input_ids=[1, 2, 3, 4, 5],
                   sampling_params=SamplingParams(temperature=0.0, max_new_tokens=4))
assert len(out.output_ids) == 4
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
        if name.split(".")[0] in ("jax", "jaxlib", "scratchpad_tpu")
    ]
    assert bad == []

