"""Quantized weights under tensor parallelism, the Llama family: the port's
engine at tp 2 (two gloo processes on the CPU) with W4A8, W4A16 and fp8
weights against the JAX package's engine at tp 2 and against the port at
tp 1, and the pieces beneath.

- The JAX ``Engine(args, mesh=Mesh(devices[:2].reshape(1, 2), ("dp",
  "tp")), model_config=...)`` quantizes its random f32 init on the mesh
  (gate and up apart, the head left in f32: the JAX runner's mesh rules),
  its norms and biases moved at random; the port takes those codes through
  ``params_from_jax`` (gate and up fused) and each rank cuts its shard.
  The request set of ``test_torch_tp_engine.py``: the same greedy ids up
  to a near tie (``MARGIN``), the chosen logprobs within 1e-4 (2e-4 on int8
  KV). On every rank: 4 collectives a layer and forward under W4A8 (o's
  and down's row maxima and sums), 2 under W4A16 and fp8, plus the
  lookup's and the head's; the leader's forwards and sampled ids.
- W4A8 against the JAX engine, through the int8 ties: the two packages'
  activations part at f32 rounding from the first norm on (a few 1e-7 of
  the row's maximum), so an element that lies at a half of a code step
  takes codes a step apart (Llama, the JAX engine at tp 2: -36.500004 in
  JAX against -36.499996 in the port, and one more; the gap in a chosen
  logprob is 4.38e-4 downstream). ``JaxQuantizerInputs`` records the JAX
  engine's quantizer inputs call by call; ``jax_codes_at_ties`` holds the
  port's quantizer to them: the inputs within ``ALIGN`` of the row's
  maximum, every code that parts within ``TIE`` of a half on both sides
  and one step apart, where the port takes the JAX engine's code. With
  those codes the port at tp 1 holds the JAX engine at tp 2 within 1e-4;
  the port at tp 2 holds the port at tp 1 within 1e-4.
- A rank's streamed load (each whole tensor drawn on the meta twin's
  stream, quantized, cut: ``place_whole``) equals the cut of the tp 1
  engine's codes, buffer for buffer, at widths whose stored columns are
  padded (q 192 of 256 at tp 1; the fused gate|up 320 a rank, stored 384),
  and the ranks' buffers join back to the tp 1 codes.
- The activation quantizer with a given row maximum: each rank's slice
  quantizes to the whole row's codes at the slice.
- The refusals and rules: a rank share that splits a group, the 4-bit
  head, ``kv_cache_dtype`` auto at tp 1 and tp 2.
"""

import contextlib
import itertools
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import scratchpad_tpu.ops.quant as jax_quant

import torch_threads  # noqa: F401  (one torch thread a test process)
from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.model_runner import resolve_kv_cache_dtype
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax, shard_state, w4_real_widths
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.ops.quant import w4_matmul
from scratchpad_tpu_torch.ops.quant.w4_matmul import quantize_activations_plain, quantize_rows_int8, row_amax
from scratchpad_tpu_torch.parallel import W4_PAD, TPGroup, check_tp_model
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS
from test_torch_tp_engine import _compare, _serve
from test_torch_tp_families import LLAMA_LIKE, LP_TOL, TP, configs, perturbed, rank_reports

# W4A8 against the JAX engine (the module's docstring): the two packages'
# quantizer inputs within ALIGN of the row's maximum, and a code that parts
# within TIE of a half (in code steps) on both sides
ALIGN, TIE = 1e-5, 1e-4
QWEN2 = dict(LLAMA_LIKE, architectures=["Qwen2ForCausalLM"])  # q, k, v biases
QWEN3 = dict(LLAMA_LIKE, architectures=["Qwen3ForCausalLM"], head_dim=32)  # qk-norm
# collectives a layer and forward: W4A8 adds o's and down's row maxima
PER_LAYER = {"w4a8": 4, "w4a16": 2, "fp8": 2}


def jax_tp2_quant_engine(hf: dict, quantization: str, kv: str = "auto"):
    """The JAX engine of ``hf`` on a two-device CPU mesh with
    ``quantization``, its norms and biases perturbed and placed again on the
    mesh by their own shardings (the codes as it quantized them); and the
    port's state of the same weights."""
    jcfg, cfg = configs(hf)
    mesh = Mesh(np.array(jax.devices()[:TP]).reshape(1, TP), ("dp", "tp"))
    jeng = JaxEngine(JaxServerArgs(**ARGS, quantization=quantization, kv_cache_dtype=kv, warmup_capture=False),
                     mesh=mesh, model_config=jcfg)
    runner = jeng.scheduler.runner
    host = jax.tree.map(np.asarray, runner.params)
    assert "lm_head_q" not in host and "gate_up_f" not in host["layers_q"]  # the mesh rules
    codes = host.pop("layers_q")
    host = dict(perturbed(host, seed=2), layers_q=codes)
    runner.params = jax.tree.map(lambda new, old: jax.device_put(jnp.asarray(new, old.dtype), old.sharding),
                                 host, runner.params)
    return jeng, cfg, params_from_jax(host, cfg, transposed=getattr(runner.model, "weights_transposed", False))


class JaxQuantizerInputs:
    """The inputs of the JAX engine's W4A8 matmul (``w4a8_matmul_xla``,
    which its models take on the CPU), call by call. Made before the engine
    is: each call hands its input to the host with its call site
    (unordered, as a mesh needs), and ``calls`` puts them in order."""

    def __init__(self, monkeypatch):
        self.raw = []
        site, reference = itertools.count(), jax_quant.w4a8_matmul_xla

        def traced(x, ql):
            idx = next(site)
            jax.debug.callback(lambda v: self.raw.append((idx, np.asarray(v))), x)
            return reference(x, ql)

        monkeypatch.setattr(jax_quant, "w4a8_matmul_xla", traced)

    def serve(self, jeng) -> list:
        """``jeng``'s outputs of the request set, its inputs recorded anew."""
        self.raw.clear()
        return _serve(jeng, JaxSamplingParams)[1]

    def calls(self, per_layer: int, layers: int, skip=()) -> list:
        """The inputs in call order, a forward (``per_layer`` calls a
        layer) at a time, without the calls at ``skip`` within a layer."""
        per_forward = per_layer * layers
        assert self.raw and len(self.raw) % per_forward == 0, len(self.raw)
        out = []
        for i in range(0, len(self.raw), per_forward):
            forward = sorted(self.raw[i : i + per_forward], key=lambda t: t[0])
            sites = [idx for idx, _ in forward]
            assert sites == list(range(sites[0], sites[0] + per_forward)), sites  # one forward's call sites
            out += [x for n, (_, x) in enumerate(forward) if n % per_layer not in skip]
        return out


@contextlib.contextmanager
def jax_codes_at_ties(jax_inputs: list):
    """The port's quantizer (its plain version, on the CPU) held to the JAX
    engine's inputs, call by call: the first rows, as many as both have (the
    two engines pad and end their decode batches differently), within
    ``ALIGN`` of the row's maximum, and every code that parts from
    the JAX engine's one step apart at a half, both values within ``TIE``
    of it; the port takes the JAX engine's code there. Yields the list of
    ties: (call, row, column, the JAX value, the port's)."""
    ties, calls = [], iter(enumerate(jax_inputs))
    plain = w4_matmul.quantize_activations_plain

    def held(x, group_size, amax=None):
        x8, ax, gsum = plain(x, group_size, amax)
        k, j = next(calls)
        rows, In = min(x.shape[0], j.shape[0]), x.shape[1]
        j, xp = j[:rows].astype(np.float32), x[:rows].numpy()
        jmax = np.abs(j).max(axis=1, keepdims=True)
        assert j.shape[1] == In and (np.abs(xp - j) <= ALIGN * jmax).all(), k
        jv = j / np.where(jmax == 0, np.float32(1), jmax / np.float32(127))
        jcodes = np.clip(np.rint(jv), -127, 127).astype(np.int8)
        pv = (x[:rows] / ax[:rows]).numpy()
        for r, c in np.argwhere(x8[:rows, :In].numpy() != jcodes):
            half = min(int(x8[r, c]), int(jcodes[r, c])) + 0.5
            assert abs(int(x8[r, c]) - int(jcodes[r, c])) == 1, (k, r, c)
            assert abs(jv[r, c] - half) <= TIE and abs(pv[r, c] - half) <= TIE, (k, r, c, jv[r, c], pv[r, c])
            ties.append((k, int(r), int(c), float(jv[r, c]), float(pv[r, c])))
            x8[r, c] = int(jcodes[r, c])
        if ties and ties[-1][0] == k:
            gsum = x8[:, :In].reshape(x.shape[0], -1, group_size).sum(2, dtype=torch.int32).float()
        return x8, ax, gsum

    w4_matmul.quantize_activations_plain = held
    try:
        yield ties
    finally:
        w4_matmul.quantize_activations_plain = plain
    assert next(calls, None) is None  # every JAX call met


def held_at_ties(hf: dict, state: dict, jouts, jax_inputs: list) -> list:
    """The port at tp 1 on ``state``, its quantizer held to ``jax_inputs``
    (``jax_codes_at_ties``), against the JAX engine's outputs ``jouts``: the
    same greedy ids up to a near tie, the chosen logprobs within 1e-4.
    Returns the ties."""
    eng = Engine(ServerArgs(device="cpu", quantization="w4a8", quantize_lm_head=False, **ARGS),
                 model_config=configs(hf)[1], params=state)
    with jax_codes_at_ties(jax_inputs) as ties:
        prompts, outs = _serve(eng, SamplingParams)
    assert _compare(prompts, outs, jouts, eng, stop_at_tie=True, lp_tol=LP_TOL["auto"]) >= 30  # of 47
    return ties


@pytest.mark.parametrize(
    "hf, quantization, kv",
    [(dict(LLAMA_LIKE, architectures=["LlamaForCausalLM"]), "w4a8", "auto"), (QWEN2, "w4a16", "int8"),
     (QWEN3, "fp8", "auto")],
    ids=["llama-w4a8", "qwen2-w4a16-int8kv", "qwen3-fp8"],
)
def test_tp2_matches_the_jax_engine_at_tp2(hf, quantization, kv, monkeypatch):
    jax_inputs = JaxQuantizerInputs(monkeypatch)
    jeng, cfg, state = jax_tp2_quant_engine(hf, quantization, kv)
    # an explicit 4-bit head is ignored under tp (a logged warning), as the
    # JAX runner ignores it on a mesh
    eng = Engine(ServerArgs(device="cpu", tp_size=TP, quantization=quantization, quantize_lm_head=True,
                            kv_cache_dtype=kv, **ARGS), model_config=cfg, params=state)
    try:
        model = eng.scheduler.runner.model
        assert model.lm_head_q is None and model.lm_head.weight.shape[0] == cfg.vocab_size // TP
        eng.scheduler.runner.reset_counts()
        prompts, outs = _serve(eng, SamplingParams)
        reports = rank_reports(eng, PER_LAYER[quantization])
        assert all(rep["kv_heads"] == cfg.num_kv_heads // TP for rep in reports)
        jouts = jax_inputs.serve(jeng)
        if quantization == "w4a8":
            # the port at tp 1 on the same codes, then at the JAX engine's
            # ties; the JAX engine runs gate and up apart (its mesh rule),
            # the port fused: its up call (the fifth of seven) goes
            ref = Engine(ServerArgs(device="cpu", quantization=quantization, quantize_lm_head=False, **ARGS),
                         model_config=configs(hf)[1], params=state)
            _, ref_outs = _serve(ref, SamplingParams)
            assert _compare(prompts, outs, ref_outs, eng, stop_at_tie=True) >= 30
            held_at_ties(hf, state, jouts, jax_inputs.calls(7, cfg.num_hidden_layers, skip=(5,)))
        else:
            assert _compare(prompts, outs, jouts, eng, stop_at_tie=True, lp_tol=LP_TOL[kv]) >= 30  # of 47
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()


# padded stored widths: q 6 heads x 32 = 192 (stored 256 at tp 1, 96 a
# rank); the fused gate|up 640 (320 a rank, stored 384); o's input 192 and
# down's 320 split into whole groups (96 and 80) of whole 32-row steps
PADDED = dict(num_attention_heads=6, num_key_value_heads=2, head_dim=32, intermediate_size=320)


def _rank_model(cfg, quantization, rank):
    """Rank ``rank``'s model at tp 2, loaded as ``_load_quantized_tp``
    loads it: a meta twin draws the tp 1 stream of seed 0, each whole
    tensor placed (``place_whole``)."""
    group = TPGroup(rank=rank, size=TP, device=torch.device("cpu"), backend="gloo", ranks_on_device=TP)
    model = LlamaForCausalLM(cfg, "cpu", torch.float32, quantization=quantization, tp=group)
    model.reset_constants_()
    pending = {}
    twin = LlamaForCausalLM(cfg, torch.device("meta"), torch.float32)
    twin.init_random_(torch.Generator().manual_seed(0),
                      place=lambda name, whole, e=None: model.place_whole(name, whole, pending, e))
    assert not pending
    return model


@pytest.mark.parametrize("quantization", ["w4a8", "fp8"])
def test_streamed_rank_load_is_the_cut_of_the_tp1_codes(quantization):
    cfg = get_preset("tiny-debug", dtype="float32", **PADDED)
    dense = LlamaForCausalLM(cfg, "cpu", torch.float32)
    dense.init_random_(torch.Generator().manual_seed(0))
    one = LlamaForCausalLM(cfg, "cpu", torch.float32, quantization=quantization).quantize_state(dense.state_dict())
    ranks = [_rank_model(cfg, quantization, r).state_dict() for r in range(TP)]
    for r, got in enumerate(ranks):
        widths = w4_real_widths(_rank_model(cfg, quantization, r), TP) if quantization == "w4a8" else {}
        want = shard_state(one, r, TP, "llama", widths)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k].view(torch.uint8) if got[k].dtype ==
                                                                   torch.float8_e4m3fn else got[k],
                                                                   want[k].view(torch.uint8) if want[k].dtype ==
                                                                   torch.float8_e4m3fn else want[k]), k
    # the ranks' buffers join back to the tp 1 codes
    if quantization == "w4a8":
        q = [s["layers.1.wq.q"] for s in ranks]  # column, padded: 96 real rows a rank
        assert one["layers.1.wq.q"].shape[0] == 256 and q[0].shape[0] == 96
        assert torch.equal(torch.cat(q), one["layers.1.wq.q"][:192])
        assert torch.equal(torch.cat([s["layers.1.wq.s"] for s in ranks], 1), one["layers.1.wq.s"][:, :192])
        gu = [s["layers.0.gate_up.q"] for s in ranks]  # halves: [gate_r | up_r | pad], 384 stored
        assert gu[0].shape[0] == 384 and (gu[0][320:] == W4_PAD["q"]).all()
        halves = [torch.cat([g[h * 160 : (h + 1) * 160] for g in gu]) for h in (0, 1)]
        assert torch.equal(torch.cat(halves), one["layers.0.gate_up.q"])
        for part in "qsz":  # row: o's bytes and groups, the stored width whole
            dim = 1 if part == "q" else 0
            assert torch.equal(torch.cat([s[f"layers.0.wo.{part}"] for s in ranks], dim), one[f"layers.0.wo.{part}"])
    else:
        assert torch.equal(torch.cat([s["layers.0.down.w8"] for s in ranks]).view(torch.uint8),
                           one["layers.0.down.w8"].view(torch.uint8))
        assert all(torch.equal(s["layers.0.down.s"], one["layers.0.down.s"]) for s in ranks)  # whole columns'
        assert torch.equal(torch.cat([s["layers.0.gate.s"] for s in ranks]), one["layers.0.gate.s"])


def test_a_given_row_maximum_quantizes_each_slice_as_the_whole_row():
    """Two ranks' slices of o's input: with the group's maximum each slice's
    codes, scale and group sums are the whole row's at the slice; with its
    own they are not."""
    g, In = 64, 256
    x = torch.randn(7, In, generator=torch.Generator().manual_seed(3))
    x[2] = 0.0  # a row of zeros: scale 1
    x[4, 200] = 9.0  # the row's maximum on rank 1's slice
    whole = quantize_activations_plain(x, g)
    slices = x.chunk(TP, dim=1)
    amax = torch.maximum(*(row_amax(s) for s in slices))
    own_differs = False
    for r, part in enumerate(slices):
        x8, ax, gsum = quantize_rows_int8(part, g, amax)  # the plain version on the CPU
        cols = slice(r * In // TP, (r + 1) * In // TP)
        assert torch.equal(x8, whole[0][:, cols]) and torch.equal(ax, whole[1])
        assert torch.equal(gsum, whole[2][:, r * In // TP // g : (r + 1) * In // TP // g])
        own_differs |= not torch.equal(quantize_activations_plain(part, g)[0], whole[0][:, cols])
    assert own_differs


def test_a_rank_share_that_splits_a_group_is_refused_before_any_rank_starts():
    bad = get_preset("tiny-debug", intermediate_size=96)  # down's 96 / 2 = 48: groups of 48, not of 32
    with pytest.raises(ValueError, match=r"down's input \(intermediate_size\) 96 / 2 = 48 is not whole "
                                         r"groups of 48 and of 32"):
        check_tp_model(bad, TP, "w4a8")
    check_tp_model(bad, TP, "fp8")  # fp8's scales are per column, over the whole input
    with pytest.raises(NotImplementedError, match="serves no quantized weights"):
        check_tp_model(get_preset("tiny-gemma2"), TP, "w4a16")
    with pytest.raises(ValueError, match="not whole groups"):
        Engine(ServerArgs(device="cpu", tp_size=TP, quantization="gptq", **ARGS), model_config=bad)
    assert not mp.active_children()  # refused before a follower started


def test_the_head_and_kv_auto_rules_follow_the_jax_runner():
    """The 4-bit head: on by the auto rule at tp 1 for W4, off when set
    off, on a bf16 engine when set on; under tp never (the engines above).
    ``kv_cache_dtype`` auto: int8 for W4 at 3B and up on the card at tp 1,
    the model dtype at tp 2 (the JAX rule's ``mesh is None``)."""
    import argparse

    heads = {}
    for q, qlm in (("w4a8", None), ("w4a8", False), (None, True)):
        eng = Engine(ServerArgs(device="cpu", quantization=q, quantize_lm_head=qlm, **ARGS))
        heads[(q, qlm)] = eng.scheduler.runner.model.lm_head_q is not None
    assert heads == {("w4a8", None): True, ("w4a8", False): False, (None, True): True}
    cfg, cuda = get_preset("llama-3.2-3b"), torch.device("cuda")
    for tp, want in ((1, "int8"), (2, "bfloat16")):
        args = ServerArgs(preset="llama-3.2-3b", quantization="w4a8", device="cpu", tp_size=tp).resolve()
        assert resolve_kv_cache_dtype(args, cfg, cuda) == want
    parser = argparse.ArgumentParser()
    ServerArgs.add_cli_args(parser)
    assert parser.parse_args([]).quantize_lm_head is None
    assert parser.parse_args(["--quantize-lm-head", "false"]).quantize_lm_head is False
