#!/usr/bin/env python3
"""Time the engines' extend forwards on checkouts in turns, on one card.

    python3 scratchpad_tpu_torch/tools/prefill_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout of the repository and runs in a process
of its own, in the order given, so that two versions are compared within
one call on one card. A process builds its checkout's kernels, then serves
through ``Engine.generate`` with random weights from seed 0 and one new
token a request, under ``PrefillTimer``: Llama-3.2-1B in
bf16 prefills ``chip_smoke.py``'s bench batch (64 prompts of 128 tokens),
then Mistral-7B-v0.1 (``MISTRAL_7B``, window 4096) prefills a 6,000-token
and a 4,090-token prompt (three and two 2048-token chunks). Each engine is
warmed by one short request first. One JSON line a process: ``{"root":
..., "device": ..., "1b_bs64": {...}, "mistral_long": {...}}`` with the
extend forwards, their device ms (CUDA-event spans) and wall ms.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# Mistral-7B-v0.1's published config.json
# (huggingface.co/mistralai/Mistral-7B-v0.1, config.json), read through
# ModelConfig.from_hf_config; the weights are random, drawn on the card
MISTRAL_7B = {
    "architectures": ["MistralForCausalLM"],
    "vocab_size": 32000,
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
    "sliding_window": 4096,
    "tie_word_embeddings": False,
    "hidden_act": "silu",
    "model_type": "mistral",
}
BENCH = (64, 128)  # prompts x tokens, chip_smoke.py's decode bench batch
LONG_PROMPTS = (6000, 4090)


class PrefillTimer:
    """While active, times each extend (prefill) forward of ``model``: CUDA
    events around the call give its span on the card's timeline
    (``device_ms``, summed), and the host clock from the call to the end of
    its work on the card gives ``wall_ms`` (a synchronize follows each
    forward, so a run timed for its rates should not be the one under this
    timer)."""

    def __init__(self, model):
        self.model = model
        self.forwards = 0
        self.wall_ms = 0.0
        self._spans = []

    def __enter__(self):
        import torch

        from scratchpad_tpu_torch.executor.forward_meta import ForwardMode

        inner = self._inner = self.model.forward

        def forward(meta, kv):
            if meta.mode != ForwardMode.EXTEND:
                return inner(meta, kv)
            t = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(meta, kv)
            end.record()
            torch.cuda.synchronize()
            self.wall_ms += (time.perf_counter() - t) * 1e3
            self._spans.append((start, end))
            self.forwards += 1
            return out

        self.model.forward = forward
        return self

    def __exit__(self, *exc):
        self.model.forward = self._inner

    @property
    def device_ms(self) -> float:
        return sum(start.elapsed_time(end) for start, end in self._spans)


def prefill(engine, prompts) -> dict:
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    sp = SamplingParams(temperature=0.0, max_new_tokens=1, ignore_eos=True)
    engine.flush_cache()
    engine.generate(input_ids=[prompts[0][:16]], sampling_params=[sp])  # warm
    engine.flush_cache()
    with PrefillTimer(engine.scheduler.runner.model) as timer:
        engine.generate(input_ids=prompts, sampling_params=[sp] * len(prompts))
    return {"prompts": [len(p) for p in prompts], "extend_forwards": timer.forwards,
            "device_ms": timer.device_ms, "wall_ms": timer.wall_ms}


def time_root(root: str) -> dict:
    sys.path.insert(0, root)
    import gc

    import numpy as np
    import torch

    from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
    from scratchpad_tpu_torch.server.engine import Engine
    from scratchpad_tpu_torch.utils import native

    assert Path(native.__file__).resolve().is_relative_to(Path(root).resolve()), native.__file__
    native.build()
    rng = np.random.default_rng(1)
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    args = dict(random_weights=True, dtype="bfloat16", device="cuda")
    engine = Engine(ServerArgs(preset="llama-3.2-1b", **args))
    V = engine.scheduler.runner.model_config.vocab_size
    out["1b_bs64"] = prefill(engine, [rng.integers(1, V, BENCH[1]).tolist()
                                      for _ in range(BENCH[0])])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = Engine(ServerArgs(preset=None, **args),
                    model_config=ModelConfig.from_hf_config(MISTRAL_7B))
    out["mistral_long"] = prefill(engine, [rng.integers(1, 32000, n).tolist()
                                           for n in LONG_PROMPTS])
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_root(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True, timeout=900)


if __name__ == "__main__":
    main()
