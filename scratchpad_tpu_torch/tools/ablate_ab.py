#!/usr/bin/env python3
"""Time the decode ablation probe of two checkouts in turns, on one card.

    python3 scratchpad_tpu_torch/tools/ablate_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout of the repository. For each, in the
order given, ``tools/decode_ablate.py`` of that checkout runs in a process
of its own (mode table only, ``--stages`` with none) at two shapes, so that
two versions of ``csrc/decode_ablate.cu`` are compared within one call on
one card (A, B, B, A):

- ``probe``: the JAX probe's shape (the tool's defaults: B 64, ctx 192, Hkv
  8, Hq 32, Dp 128, page 16, 16-page chunks, 16 layers chained);
- ``ctx4096``: B 64 at ctx 4096 (16 chunks: the cross-chunk rescale), G 4,
  Dp 128, a 256-entry table, 4 layers of 16,384 pages each (4 GiB), so that
  no layer reads another's pages.

Each process prints its rows; this script prints, per root, one JSON line
``{"root": ..., "card": ..., "ms": {"<shape> <mode>": ms a call}, "bound_ms":
{...}, "bound_chunk_ms": {...}}`` and at the end the mean of each root's
runs.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SHAPES = {
    "probe": [],
    "ctx4096": ["--ctx", "4096", "--table-width", "256", "--pages-per-layer", "16384",
                "--layers", "4", "--iters", "10"],
}


def time_root(root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    res = {"root": root, "card": None, "ms": {}, "bound_ms": {}, "bound_chunk_ms": {},
           "plain_ms": {}}
    for label, extra in SHAPES.items():
        proc = subprocess.run(
            [sys.executable, "-m", "scratchpad_tpu_torch.tools.decode_ablate", "--stages", *extra],
            cwd=os.path.abspath(root), env=env, capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{root} {label}: rc {proc.returncode}\n{proc.stderr[-4000:]}")
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        res["card"] = lines[0]
        for r in lines[1:]:
            key = f"{label} {r['mode']}"
            res["ms"][key] = r["ms_per_call"]
            res["bound_ms"][key] = r["bound_ms"]
            res["bound_chunk_ms"][key] = r["bound_chunk_ms"]
            res["plain_ms"][key] = r["plain_ms"]
    return res


def main() -> None:
    roots = sys.argv[1:]
    if not roots:
        sys.exit(__doc__)
    runs = []
    for root in roots:
        r = time_root(root)
        print(json.dumps(r), flush=True)
        runs.append(r)
    means = {}
    for root in dict.fromkeys(roots):
        mine = [r["ms"] for r in runs if r["root"] == root]
        means[root] = {k: statistics.mean(m[k] for m in mine) for k in mine[0]}
    print(json.dumps({"mean_ms": means}), flush=True)


if __name__ == "__main__":
    main()
