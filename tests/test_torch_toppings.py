"""Toppings in the port against the JAX package, on the CPU in f32.

- The grouped delta function (``delta_matmul_grouped``, its plain version
  on CPU tensors) against the sum over slots of the JAX ``delta_matmul``
  (interpret mode) and ``delta_matmul_xla``, at the JAX test's 1e-5; rows
  outside a delta slot come out bit-equal to the input.
- ``lora_grouped`` (2e-4, the JAX test's own) and ``apply_topping`` (1e-5)
  against their JAX counterparts.
- The manager's host pools bit for bit against the JAX manager's, and
  ``toppings_from_jax`` against the port's own device pools.
- Model logits with adapters within 1e-4 (bf16 layout in f32, W4A16 and
  W4A8, the fused gate|up split included), and engine greedy tokens equal
  to the JAX engine's for no-adapter, LoRA, delta and mixed batches.

Adapters are numpy state dicts made from a seed, as ``tests/test_toppings.py``
makes them; deltas are crafted exactly int8-representable (each output
channel's largest code is 127), so that a merged-weight engine serves the
same function.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.ops import ldmm as jax_ldmm
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu.toppings import manager as jax_toppings
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax, toppings_from_jax
from scratchpad_tpu_torch.models import llama
from scratchpad_tpu_torch.ops.ldmm import delta_matmul_grouped, lora_grouped
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from scratchpad_tpu_torch.toppings.manager import MAX_ACTIVE_TOPPINGS, ToppingsManager, apply_topping
from test_torch_engine import ARGS
from test_torch_model import VARIANTS, Pair, _extend_and_decode
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-5)
S = MAX_ACTIVE_TOPPINGS
_MODULES = {
    "q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn", "o_proj": "self_attn",
    "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp",
}


def _dims(cfg):
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    q, kv = cfg.num_attention_heads * D, cfg.num_kv_heads * D
    return {
        "q_proj": (H, q), "k_proj": (H, kv), "v_proj": (H, kv), "o_proj": (q, H),
        "gate_proj": (H, I), "up_proj": (H, I), "down_proj": (I, H),
    }


def lora_state(cfg, rank, seed, targets=tuple(_MODULES)):
    """peft-style LoRA factors for every layer of ``targets``."""
    rng = np.random.default_rng(seed)
    state = {}
    for l in range(cfg.num_hidden_layers):
        for t in targets:
            din, dout = _dims(cfg)[t]
            pre = f"base_model.model.model.layers.{l}.{_MODULES[t]}.{t}"
            state[f"{pre}.lora_A.weight"] = (rng.normal(size=(rank, din)) * 0.3).astype(np.float32)
            state[f"{pre}.lora_B.weight"] = (rng.normal(size=(dout, rank)) * 0.3).astype(np.float32)
    return state


def delta_state(cfg, seed, scale=0.002, targets=("q_proj", "v_proj", "gate_proj", "down_proj")):
    """HF-named [out, in] weight deltas, exactly int8-representable: each
    output channel's largest |code| is 127, so its scale is ``scale``."""
    rng = np.random.default_rng(seed)
    state = {}
    for l in range(cfg.num_hidden_layers):
        for t in targets:
            din, dout = _dims(cfg)[t]
            q = rng.integers(-127, 128, (dout, din)).astype(np.float32)
            q[:, 0] = 127
            state[f"model.layers.{l}.{_MODULES[t]}.{t}.weight"] = q * scale
    return state


ADAPTERS = (
    ("ad1", dict(state="lora", rank=4, seed=10, scaling=0.5)),
    ("ad2", dict(state="lora", rank=8, seed=20, scaling=0.7)),
    ("dl1", dict(state="delta", seed=30, scaling=1.0)),
)


def register_all(register, cfg, names=("ad1", "ad2", "dl1")):
    """Register the named adapters of ADAPTERS through ``register(name,
    kind, state, scaling)``."""
    for name, spec in ADAPTERS:
        if name not in names:
            continue
        if spec["state"] == "lora":
            register(name, "lora", lora_state(cfg, spec["rank"], spec["seed"]), spec["scaling"])
        else:
            register(name, "delta", delta_state(cfg, spec["seed"]), spec["scaling"])


def _both_managers(names=("ad1", "ad2", "dl1")):
    """The JAX manager and the port's, each filled by its own registration."""
    from scratchpad_tpu.config.model_config import get_preset as jax_get_preset
    from scratchpad_tpu_torch.config.model_config import get_preset

    jcfg, cfg = jax_get_preset("tiny-debug"), get_preset("tiny-debug")
    jm = jax_toppings.ToppingsManager(jcfg, dtype=jnp.float32)
    m = ToppingsManager(cfg, dtype=torch.float32, device="cpu")
    for mgr in (jm, m):
        def reg(name, kind, state, scaling, mgr=mgr):
            if kind == "lora":
                mgr.register_state(name, state, scaling)
            else:
                mgr.register_delta(name, state, scaling)

        register_all(reg, cfg, names)
    return jm, m


# ------------------------------------------------------------- the kernel's function

# (active_adapters, the slots tokens may take); pool adapters 3 (and 0) carry
# no delta: 3 is a LoRA-only adapter
LAYOUTS = {
    "one_slot": ([0, 2, 0, 0, 0, 0, 0, 0], [1]),
    "all_eight_mixed": ([0, 1, 2, 3, 4, 5, 6, 7], list(range(8))),
    "slot_with_no_tokens": ([0, 1, 2, 4, 0, 0, 0, 0], [0, 1, 3]),
    "lora_only_slot": ([0, 3, 0, 0, 0, 0, 0, 0], [0, 1]),
    "aid0": ([0] * 8, [0]),
}
HAS_DELTA = np.array([0, 1, 1, 0, 1, 1, 1, 1], np.int32)


def _delta_inputs(layout, T=40, In=128, Out=256, N=8, L=2, seed=0):
    rng = np.random.default_rng(seed)
    active, choices = LAYOUTS[layout]
    x = rng.standard_normal((T, In), np.float32)
    dq = rng.integers(-127, 128, (N, L, In, Out)).astype(np.int8)
    dq[0] = 0  # slot 0: the zero adapter
    ds = (rng.random((N, L, Out), np.float32) * 0.02).astype(np.float32)
    scaling = np.linspace(0.5, 2.0, N).astype(np.float32)
    slots = rng.choice(choices, T).astype(np.int32)
    out = rng.standard_normal((T, Out), np.float32)
    return x, dq, ds, scaling, np.asarray(active, np.int32), slots, out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grouped_delta_matches_jax_per_slot_sum(layout):
    """The port's one grouped call against ``out`` plus the JAX per-slot
    function summed over slots 1..S-1, as ``apply_topping`` sums it: the
    interpret-mode Pallas kernel and ``delta_matmul_xla``, at 1e-5. Rows of
    slot 0, of LoRA-only slots and of aid 0 stay bit-equal to ``out``."""
    x, dq, ds, scaling, active, slots, out = _delta_inputs(layout)
    layer = 1
    got = delta_matmul_grouped(
        torch.from_numpy(out.copy()), torch.from_numpy(x), torch.from_numpy(dq),
        torch.from_numpy(ds), layer, torch.from_numpy(active), torch.from_numpy(HAS_DELTA),
        torch.from_numpy(scaling), torch.from_numpy(slots),
    ).numpy()
    refs = {"pallas_interpret": out.copy(), "xla": out.copy()}
    for j in range(1, S):
        aid = active[j]
        aid_eff = jnp.int32(aid * HAS_DELTA[aid])
        ms = jnp.asarray((slots == j) * scaling[aid], jnp.float32)
        args = (jnp.asarray(x), jnp.asarray(dq), jnp.asarray(ds), aid_eff, jnp.int32(layer), ms)
        if aid * HAS_DELTA[aid]:
            refs["pallas_interpret"] += np.asarray(jax_ldmm.delta_matmul(*args, interpret=True))
        refs["xla"] += np.asarray(jax_ldmm.delta_matmul_xla(*args))
    for name, want in refs.items():
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    touched = (slots > 0) & (HAS_DELTA[active[slots]] > 0)
    assert np.array_equal(got[~touched], out[~touched])
    if layout in ("lora_only_slot", "aid0"):
        assert not touched.any()
    else:
        assert touched.any() and not np.array_equal(got[touched], out[touched])


def test_lora_grouped_matches_jax():
    rng = np.random.default_rng(1)
    T, In, r, Out = 24, 64, 8, 96
    A = rng.standard_normal((S - 1, In, r), np.float32) * 0.1
    B = rng.standard_normal((S - 1, r, Out), np.float32) * 0.1
    scaling = np.linspace(0.0, 2.0, S).astype(np.float32)
    slots = rng.integers(0, S, T)
    x = rng.standard_normal((T, In), np.float32)
    slot_scale = (slots[:, None] == np.arange(1, S)).astype(np.float32) * scaling[1:][None, :]
    want = jax_ldmm.lora_grouped(*(jnp.asarray(a) for a in (x, A, B, slot_scale)))
    got = lora_grouped(*(torch.from_numpy(a) for a in (x, A, B, slot_scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "names,active",
    [
        (("ad1", "ad2"), [0, 1, 2, 0, 0, 0, 0, 0]),  # LoRA pools
        (("dl1",), [0, 1, 0, 0, 0, 0, 0, 0]),  # a delta pool
        (("ad1", "ad2", "dl1"), [0, 3, 1, 2, 0, 0, 0, 0]),  # mixed
    ],
)
def test_apply_topping_matches_jax(names, active):
    jm, m = _both_managers(names)
    jpools, pools = jm.device_pools(), m.device_pools()
    rng = np.random.default_rng(2)
    T = 19
    slots = rng.integers(0, 1 + sum(a > 0 for a in active), T).astype(np.int32)
    act = np.asarray(active, np.int32)
    for target in ("wq", "wv", "gate", "down"):
        din, dout = m._dims[target]
        x = rng.standard_normal((T, din), np.float32)
        base = rng.standard_normal((T, dout), np.float32)
        want = jax_toppings.apply_topping(
            jnp.asarray(x), jnp.asarray(base), jpools, target, 1, jnp.asarray(act), jnp.asarray(slots)
        )
        got = apply_topping(
            torch.from_numpy(x), torch.from_numpy(base), pools, target, 1,
            torch.from_numpy(act), torch.from_numpy(slots),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=target, **TOL)


# ------------------------------------------------------------------ the manager


def _assert_host_pools_equal(jm, m):
    for t in jm._dims:
        assert np.array_equal(m._host_a[t], jm._host_a[t]), t
        assert np.array_equal(m._host_b[t], jm._host_b[t]), t
        if jm._host_dq is not None:
            assert m._host_dq[t].dtype == np.int8 and np.array_equal(m._host_dq[t], jm._host_dq[t]), t
            assert m._host_ds[t].dtype == np.float32 and np.array_equal(m._host_ds[t], jm._host_ds[t]), t
    assert np.array_equal(m._scaling, jm._scaling)
    assert m._delta_slots == jm._delta_slots and m.name_to_idx == jm.name_to_idx


def test_manager_pools_match_jax_bit_for_bit():
    """register_state and register_delta (its per-out-channel int8 codes and
    f32 scales) fill the host pools as the JAX manager does; the device
    pools hold them (f32 here); ``toppings_from_jax`` gives the same device
    pools as the port's own registration."""
    jm, m = _both_managers()
    _assert_host_pools_equal(jm, m)
    # a delta that is not int8-representable: the rounding itself is compared
    from scratchpad_tpu_torch.config.model_config import get_preset

    rough = {k: v * 1.37 + 1e-4 for k, v in delta_state(get_preset("tiny-debug"), seed=31).items()}
    jm.register_delta("dl2", rough, 0.5)
    m.register_delta("dl2", rough, 0.5)
    _assert_host_pools_equal(jm, m)
    assert m.name_to_idx == {"ad1": 1, "ad2": 2, "dl1": 3, "dl2": 4}
    pools = m.device_pools()
    jpools = jm.device_pools()
    for kind in ("a", "b", "dq", "ds"):
        for t, v in pools[kind].items():
            assert np.array_equal(v.numpy(), np.asarray(jpools[kind][t])), (kind, t)
    assert np.array_equal(pools["has_delta"].numpy(), np.asarray(jpools["has_delta"]))
    assert np.array_equal(pools["scaling"].numpy(), np.asarray(jpools["scaling"]))

    ported = toppings_from_jax(jm, "cpu").device_pools()
    for kind in ("a", "b", "dq", "ds"):
        for t, v in pools[kind].items():
            assert torch.equal(ported[kind][t], v), (kind, t)
    for kind in ("scaling", "has_delta"):
        assert torch.equal(ported[kind], pools[kind]), kind


def test_device_pools_are_updated_in_place():
    """A registration writes its slot into the pools allocated before it;
    the delta pools are allocated once, at the first delta."""
    _, m = _both_managers(("ad1",))
    pools = m.device_pools()
    a = pools["a"]["wq"]
    ptr = a.data_ptr()
    from scratchpad_tpu_torch.config.model_config import get_preset

    cfg = get_preset("tiny-debug")
    m.register_state("ad2", lora_state(cfg, 8, 20), 0.7)
    assert m.device_pools() is pools and pools["a"]["wq"].data_ptr() == ptr
    assert pools["a"]["wq"][2].abs().sum() > 0
    m.register_delta("dl1", delta_state(cfg, 30))
    dq_ptr = pools["dq"]["wq"].data_ptr()
    m.register_delta("dl2", delta_state(cfg, 31))
    assert pools["dq"]["wq"].data_ptr() == dq_ptr and pools["has_delta"].tolist()[:5] == [0, 0, 0, 1, 1]


def test_load_path_reads_a_peft_directory_like_jax(tmp_path):
    """A peft-style directory written here (safetensors and
    adapter_config.json): the same state and lora_alpha / r scaling as the
    JAX manager reads, and the same pools after ``register``."""
    from scratchpad_tpu_torch.config.model_config import get_preset

    state = lora_state(get_preset("tiny-debug"), rank=8, seed=40, targets=("q_proj", "up_proj"))
    save_file(state, str(tmp_path / "adapter_model.safetensors"))
    (tmp_path / "adapter_config.json").write_text(json.dumps({"lora_alpha": 32, "r": 8}))
    jm, m = _both_managers(())
    jstate, jscaling = jm.load_path(str(tmp_path))
    pstate, pscaling = m.load_path(str(tmp_path))
    assert pscaling == jscaling == 4.0
    assert pstate.keys() == jstate.keys() == state.keys()
    for k in state:
        assert np.array_equal(pstate[k], np.asarray(jstate[k])), k
    jm.register("peft", str(tmp_path))
    m.register("peft", str(tmp_path))
    _assert_host_pools_equal(jm, m)


# --------------------------------------------------------------------- the model


@pytest.mark.parametrize(
    "quantization,slots",
    [
        (None, [1, 3]),  # LoRA next to delta
        (None, [0, 2]),  # none next to LoRA
        (None, [3, 0]),  # delta next to none
        ("w4a16", [1, 3]),
        ("w4a8", [3, 2]),
    ],
)
def test_model_logits_with_toppings_match_jax(quantization, slots):
    """Extend (two fresh prompts; a chunk after a cached prefix) and
    teacher-forced decode steps with adapters on every projection, the
    quantized layers' fused gate|up split into its own targets: logits
    within 1e-4 of the JAX model's."""
    pair = Pair(VARIANTS["tiny-debug"], quantization=quantization)
    jm, m = _both_managers()
    pair.params = {**pair.params, "toppings": jm.device_pools()}
    pair.model.toppings = m.device_pools()
    active = [0, m.name_to_idx["ad1"], m.name_to_idx["ad2"], m.name_to_idx["dl1"], 0, 0, 0, 0]
    _extend_and_decode(pair, dict(rtol=1e-4, atol=1e-4), adapters=(active, slots))


# -------------------------------------------------------------------- the engine


def _register_both(jeng, eng):
    def reg(name, kind, state, scaling):
        for e in (jeng, eng):
            if kind == "lora":
                e.register_topping(name, state=state, scaling=scaling)
            else:
                e.register_topping(name, delta_state=state, scaling=scaling)

    register_all(reg, eng.model_config)


@pytest.fixture(scope="module", params=[None, "w4a16", "w4a8"])
def engines(request):
    """The JAX and the port engine on one weight state (f32, page 4, chunk
    16), unquantized or with the JAX runner's 4-bit codes, each with the
    same adapters registered."""
    q = request.param
    jeng = JaxEngine(JaxServerArgs(quantization=q, **ARGS))
    eng = Engine(ServerArgs(device="cpu", quantization=q, **ARGS))
    runner = jeng.scheduler.runner
    params = jax.tree.map(np.asarray, runner.params)
    eng.scheduler.runner.model.load_state_dict(
        params_from_jax(params, eng.model_config, transposed=getattr(runner.model, "weights_transposed", False))
    )
    _register_both(jeng, eng)
    return jeng, eng


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 500, n).tolist()


# none, LoRA, delta, LoRA: 5 and 12 tokens, 23 and 40 (over the 16-token
# chunk: chunked prefill)
PROMPTS = [_prompt(n, seed=100 + n) for n in (5, 23, 40, 12)]
TOPPINGS = [None, "ad1", "dl1", "ad2"]
MAX_NEW = [9, 7, 10, 8]


def test_toppings_greedy_tokens_match_jax(engines):
    """One batch mixing none, LoRA and delta requests, through extend and
    decode windows: the port's greedy tokens are the JAX engine's, the
    chosen tokens' logprobs within 1e-4, and each request's tokens are its
    solo run's. W4A8 holds its logprobs to 5e-2: the two engines batch and
    pad differently, so with adapters some activations reach an int8 row
    code one rounding apart, and each such code moves a logit by about
    ax * |w| (readings: 1.4e-3 and 3.6e-2 on two of the four requests, 5e-6
    with W4A16 and 5e-7 with W4A8 and no adapter);
    ``test_model_logits_with_toppings_match_jax`` holds W4A8 to 1e-4 on the
    same rows."""
    jeng, eng = engines
    tol = 5e-2 if eng.args.quantization == "w4a8" else 1e-4
    sps = [SamplingParams(temperature=0.0, max_new_tokens=m) for m in MAX_NEW]
    jsps = [JaxSamplingParams(temperature=0.0, max_new_tokens=m) for m in MAX_NEW]
    outs = eng.generate(input_ids=PROMPTS, sampling_params=sps, topping=TOPPINGS, return_logprob=True)
    jouts = jeng.generate(input_ids=PROMPTS, sampling_params=jsps, topping=TOPPINGS, return_logprob=True)
    for o, j, m in zip(outs, jouts, MAX_NEW):
        assert len(o.output_ids) == m
        assert o.output_ids == j.output_ids
        np.testing.assert_allclose(o.output_token_logprobs, j.output_token_logprobs, rtol=tol, atol=tol)
    eng.flush_cache()
    solo = [
        eng.generate(input_ids=p, sampling_params=sp, topping=t).output_ids
        for p, sp, t in zip(PROMPTS, sps, TOPPINGS)
    ]
    assert solo == [o.output_ids for o in outs]
    assert len({tuple(o.output_ids[:3]) for o in outs}) == len(outs)
    eng.scheduler.check_memory_leak()


@pytest.mark.parametrize("engines", [None], indirect=True)
def test_delta_adapter_matches_merged_weights(engines):
    """The port serving dl1 per request gives the tokens of the port
    serving W + delta merged into its weights (unquantized engine)."""
    jeng, eng = engines
    state = eng.scheduler.runner.model.state_dict()
    merged = {k: v.clone() for k, v in state.items()}
    names = {"q_proj": "wq", "v_proj": "wv", "gate_proj": "gate", "down_proj": "down"}
    for key, w in delta_state(eng.model_config, seed=30).items():
        l = int(key.split(".layers.")[1].split(".")[0])
        t = names[key.split(".")[-2]]
        merged[f"layers.{l}.{t}.weight"] += torch.from_numpy(w)
    ref = Engine(ServerArgs(device="cpu", **ARGS), params=merged)
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    for p in PROMPTS[:3]:
        got = eng.generate(input_ids=p, sampling_params=sp, topping="dl1").output_ids
        base = eng.generate(input_ids=p, sampling_params=sp).output_ids
        assert got == ref.generate(input_ids=p, sampling_params=sp).output_ids
        assert got != base
    eng.scheduler.check_memory_leak()


@pytest.mark.parametrize("engines", [None], indirect=True)
def test_no_adapter_batch_skips_the_toppings_path(engines, monkeypatch):
    """A batch that names no adapter runs no topping op and gives, bit for
    bit, the tokens and logprobs of the same engine with no manager."""
    jeng, eng = engines
    bare = Engine(ServerArgs(device="cpu", **ARGS), params=eng.scheduler.runner.model.state_dict())
    calls = []
    monkeypatch.setattr(llama, "apply_topping", lambda *a: calls.append(1) or apply_topping(*a))
    sps = [SamplingParams(temperature=0.0, max_new_tokens=m) for m in MAX_NEW]
    eng.flush_cache()  # both engines run the same extend chunks
    outs = eng.generate(input_ids=PROMPTS, sampling_params=sps, return_logprob=True)
    assert calls == []
    eng.generate(input_ids=PROMPTS[0], sampling_params=sps[0], topping="ad1")
    assert calls  # the spy sees a batch that names an adapter
    refs = bare.generate(input_ids=PROMPTS, sampling_params=sps, return_logprob=True)
    for o, r in zip(outs, refs):
        assert o.output_ids == r.output_ids
        assert o.output_token_logprobs == r.output_token_logprobs
    eng.scheduler.check_memory_leak()


@pytest.mark.parametrize("engines", [None], indirect=True)
def test_unknown_topping_is_refused(engines):
    _, eng = engines
    with pytest.raises(KeyError):
        eng.generate(input_ids=PROMPTS[0], topping="nope")
