"""Tensor parallelism's parts on the CPU: the shards, the vocabulary-parallel
embedding and head over two gloo ranks, the rank-local attention wrappers,
the rendezvous settings and every refusal.

- ``shard_state``: the ranks' shards, joined again, give back the
  single-device state bit for bit (a tied and an untied head; a vocabulary
  that is and one that is not a multiple of tp).
- The embedding and the head at tp 2 (two spawned gloo processes) against
  the dense model's, on the same state: equal to f32 rounding of the head's
  matmul (1e-5 of max |logit|; the embedding bit for bit), the padded
  vocabulary columns dropped.
- Every text family's layout (``parallel.TP_LAYOUTS``): each rank's shards
  have the shapes of its tp 2 model's tensors and join back to the
  single-device state; Llama-4's fused gate|up stack is cut into each
  rank's gate and up shares, which joined as gate then up give the stack.
- ``attention_backend`` ``auto`` and ``pallas`` on a rank's heads.
- Each option that tp > 1 does not serve yet raises with its ROADMAP item,
  from ``ServerArgs``, from the model check (the vision classes), and from a
  live engine.
- Faults: a follower that raises at load, and one killed while serving,
  make the engine raise within ``FAULT_S``, well before ``DIST_TIMEOUT_S``.
- ``sp serve --tp-size 2`` answers a chat request with ``Engine.generate``'s
  ids.
"""

import json
import multiprocessing as mp
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test process)
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig, get_preset
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.weight_loader import shard_state
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.models.common import row_parallel_sum
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.ops.attention import attention_functions
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.parallel import (
    TPGroup,
    check_tp_model,
    free_port,
    shard_tensor,
    split_of,
    tp_family,
    vocab_rows,
)
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS, MARGIN, _teacher_forced_margins
from test_torch_mllama import model_kw as mllama_kw
from test_torch_vision import model_kw as vlm_kw
from torch_tp_ranks import LayerMoreInFollowers, vocab_rank

ROOT = Path(__file__).resolve().parent.parent
TP = 2
# a fault reaches the leader as a follower's error reply or through the
# process watch, well before DIST_TIMEOUT_S
FAULT_S = 60.0


def _tp_engine(args=None, **kw) -> Engine:
    """A tp 2 engine on the CPU at ``ARGS`` and ``args``; ``kw``: Engine's."""
    return Engine(ServerArgs(device="cpu", tp_size=TP, **ARGS, **(args or {})), **kw)


def _state(tied: bool, vocab: int) -> tuple[ModelConfig, dict]:
    cfg = get_preset("tiny-debug", vocab_size=vocab, tie_word_embeddings=tied,
                     architecture="Qwen2ForCausalLM")  # q, k, v biases
    model = LlamaForCausalLM(cfg, "cpu", torch.float32)
    model.init_random_(torch.Generator().manual_seed(0))
    state = model.state_dict()
    for k in state:  # biases and norms that are not all zeros and ones
        if k.endswith("bias") or k.endswith("norm"):
            state[k] = torch.randn(state[k].shape, generator=torch.Generator().manual_seed(len(k)))
    return cfg, state


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("vocab", [512, 509], ids=["V512", "V509"])
def test_shards_join_to_the_single_device_state(tied, vocab):
    cfg, state = _state(tied, vocab)
    assert ("lm_head.weight" in state) == (not tied)
    shards = [shard_state(state, r, TP) for r in range(TP)]
    dims = {"wq.weight": 0, "wk.weight": 0, "wv.weight": 0, "gate.weight": 0, "up.weight": 0,
            "wq.bias": 0, "wk.bias": 0, "wv.bias": 0, "wo.weight": 1, "down.weight": 1}
    for name, full in state.items():
        parts = [s[name] for s in shards]
        key = name.split(".", 2)[2] if name.startswith("layers.") else name
        if name in ("embed.weight", "lm_head.weight"):
            rows = vocab_rows(vocab, TP)
            assert all(p.shape == (rows, cfg.hidden_size) for p in parts)
            joined = torch.cat(parts)
            assert torch.equal(joined[:vocab], full) and not joined[vocab:].any()
        elif key in dims:
            assert torch.equal(torch.cat(parts, dims[key]), full), name
            assert parts[0].shape[dims[key]] * TP == full.shape[dims[key]]
        else:  # norms: replicated
            assert all(torch.equal(p, full) for p in parts), name
    # whole heads: rank r's q rows are query heads [r Hq/tp, (r + 1) Hq/tp)
    D, Hq = cfg.head_dim, cfg.num_attention_heads
    q0 = shards[1]["layers.0.wq.weight"].view(Hq // TP, D, -1)
    assert torch.equal(q0, state["layers.0.wq.weight"].view(Hq, D, -1)[Hq // TP:])


def test_a_tensor_without_a_layout_or_a_split_is_refused():
    with pytest.raises(KeyError, match="no tensor-parallel layout"):
        shard_tensor("layers.0.gate_up.weight", torch.zeros(4, 4), 0, TP)  # no such tensor in the family
    with pytest.raises(ValueError, match="does not split"):
        shard_tensor("layers.0.wq.weight", torch.zeros(3, 4), 0, TP)
    assert shard_tensor("layers.0.wq.weight", torch.ones(3, 4), 0, 1).shape == (3, 4)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_vocab_parallel_embedding_and_head_match_the_dense_ones(tied):
    """Two gloo ranks on the CPU, each from its shard; V 509 is not a
    multiple of tp, so rank 1 holds 3 padded rows."""
    vocab = 509
    cfg, state = _state(tied, vocab)
    dense = LlamaForCausalLM(cfg, "cpu", torch.float32)
    dense.load_state_dict(state)
    rng = np.random.default_rng(1)
    ids = np.concatenate([[0, 254, 255, 508], rng.integers(0, vocab, 12)]).astype(np.int64)
    h = rng.standard_normal((5, cfg.hidden_size)).astype(np.float32)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    addr = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=vocab_rank, args=(r, TP, addr, cfg, state, ids, h, out)) for r in range(TP)]
    for p in procs:
        p.start()
    try:
        emb, logits, collectives = out.get(timeout=90)
    finally:
        for p in procs:
            p.join(30)
    assert all(p.exitcode == 0 for p in procs)
    with torch.inference_mode():
        want_emb = dense.lookup(torch.as_tensor(ids)).numpy()
        want = dense.head_logits(torch.as_tensor(h)).numpy()
    assert np.array_equal(emb, want_emb)  # one rank holds each row: exact
    assert logits.shape == (5, vocab)  # the padded columns dropped
    np.testing.assert_allclose(logits, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert collectives == 2  # the lookup's sum and the head's gather


def test_row_parallel_sum_without_a_group_is_the_identity():
    y = torch.ones(2, 3)
    assert row_parallel_sum(y) is y


def _pool(heads: int) -> tuple:
    kv = create_kv_cache(KVCacheConfig(num_layers=1, num_pages=4, page_size=4, num_kv_heads=heads,
                                       head_dim=32, dtype=torch.float32), torch.device("cpu"))
    meta = ForwardMeta(
        mode=ForwardMode.DECODE, tokens=torch.zeros(2, dtype=torch.long),
        positions=torch.zeros(2, dtype=torch.long), out_cache_loc=torch.tensor([4, 8]),
        req_indices=torch.arange(2), page_table=torch.tensor([[1], [2]], dtype=torch.int32),
        seq_lens=torch.ones(2, dtype=torch.int32), extend_lens=torch.ones(2, dtype=torch.int32),
        last_token_idx=torch.arange(2), cu_q_lens=torch.tensor([0, 1, 2], dtype=torch.int32),
    )
    return kv, meta


def test_rank_attention_wrappers_take_the_rank_heads_only():
    """A rank of tp 2 over the model's (Hq 4, Hkv 2): q of 2 heads over a
    pool of 1 kv head runs the wrapped kernel (here its plain version);
    the model-wide head counts are refused. ``pallas`` decodes through
    ``decode_attention_pallas`` on the rank's heads, as ``auto`` does
    through ``decode_attention_gqa``."""
    group = TPGroup(rank=1, size=2, device=torch.device("cpu"), backend="gloo", ranks_on_device=2)
    decode, extend = attention_functions("auto", group, (4, 2))
    assert (decode.__name__, extend.__name__) == ("decode_attention_gqa_tp", "attention_ragged_tp")
    pallas, pallas_extend = attention_functions("pallas", group, (4, 2))
    assert (pallas.__name__, pallas_extend.__name__) == ("decode_attention_pallas_tp", "attention_ragged_tp")
    kv, meta = _pool(1)
    q = torch.randn(2, 2, 32)
    assert decode(q, kv, 0, meta, sm_scale=0.2).shape == (2, 2, 32)
    assert extend(q, kv, 0, meta, sm_scale=0.2).shape == (2, 2, 32)
    assert torch.equal(pallas(q, kv, 0, meta, sm_scale=0.2), decode(q, kv, 0, meta, sm_scale=0.2))
    kv_full, _ = _pool(2)
    for fn in (decode, extend, pallas):
        with pytest.raises(ValueError, match="not the rank's 2 and 1"):
            fn(torch.randn(2, 4, 32), kv_full, 0, meta, sm_scale=0.2)


def test_rendezvous_addresses_resolve():
    args = ServerArgs(preset="tiny-debug", device="cpu", tp_size=2).resolve()
    assert args.dist_init_addr.startswith("127.0.0.1:") and args.control_plane_addr.startswith("127.0.0.1:")
    assert args.dist_init_addr != args.control_plane_addr
    again = ServerArgs(preset="tiny-debug", device="cpu", tp_size=2, dist_init_addr="10.0.0.5:4100").resolve()
    assert again.control_plane_addr == "10.0.0.5:4101"  # the JAX default: the port after it
    assert ServerArgs(preset="tiny-debug", device="cpu").resolve().dist_init_addr is None


@pytest.mark.parametrize(
    "setting, item",
    [
        # quantized weights are served since item 10(b): they resolve
        (dict(quantization="w4a8"), None),
        (dict(quantization="fp8"), None),
        (dict(speculative_algorithm="ngram"), r"10\(c\)"),
        (dict(host_kv_cache_tokens=4096), r"10\(c\)"),
        (dict(enable_param_offload=True), r"10\(c\)"),
        (dict(enable_custom_logit_processor=True), r"10\(c\)"),
    ],
    ids=["w4a8", "fp8", "speculation", "host-tier", "offload", "custom-processors"],
)
def test_tp_refuses_what_it_does_not_serve_yet(setting, item):
    """Item 10(c)'s options are refused at tp 2, each naming its item; the
    quantized weights of item 10(b) resolve."""
    if item is None:
        args = ServerArgs(preset="tiny-debug", device="cpu", tp_size=2, **setting).resolve()
        assert (args.tp_size, args.quantization) == (2, setting["quantization"])
        return
    with pytest.raises(NotImplementedError, match=f"tp_size=2 is not ported yet .*item {item}"):
        ServerArgs(preset="tiny-debug", device="cpu", tp_size=2, **setting).resolve()


@pytest.mark.parametrize(
    "setting",
    [dict(dp_size=2), dict(pp_size=2), dict(sp_size=2), dict(num_nodes=2), dict(enable_ep=True),
     dict(enable_dp_attention=True), dict(enable_sp_prefill=True)],
)
def test_other_parallel_modes_stay_refused(setting):
    with pytest.raises(NotImplementedError, match="not ported to scratchpad_tpu_torch yet"):
        ServerArgs(preset="tiny-debug", device="cpu", tp_size=2, **setting).resolve()


TINY_MOE = dict(num_experts=4, num_experts_per_tok=2)
# one tiny config of every text family that tensor parallelism serves
FAMILIES = {
    "gemma2": get_preset("tiny-gemma2"),
    "gemma3": get_preset("tiny-gemma2", architecture="Gemma3ForCausalLM", sliding_window_pattern=2),
    "phi3": get_preset("tiny-debug", architecture="Phi3ForCausalLM"),
    "apertus": get_preset("tiny-debug", architecture="ApertusForCausalLM"),
    "mixtral": get_preset("tiny-debug", architecture="MixtralForCausalLM", **TINY_MOE),
    "qwen3-moe": get_preset("tiny-debug", architecture="Qwen3MoeForCausalLM", moe_intermediate_size=96, **TINY_MOE),
    "gpt-oss": get_preset("tiny-gpt-oss", tie_word_embeddings=False),
    "llama4": get_preset("tiny-debug", architecture="Llama4ForCausalLM", interleave_moe_layer_step=2,
                         intermediate_size_mlp=160, attention_chunk_size=8, **TINY_MOE),
    "deepseek-v2": get_preset("tiny-debug", architecture="DeepseekV2ForCausalLM", kv_lora_rank=32,
                              qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=32, first_k_dense_replace=1,
                              n_shared_experts=1, moe_intermediate_size=32, **TINY_MOE),
    "deepseek-v3": get_preset("tiny-debug", architecture="DeepseekV3ForCausalLM", kv_lora_rank=32, q_lora_rank=24,
                              qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=32, first_k_dense_replace=1,
                              n_shared_experts=1, moe_intermediate_size=32, **TINY_MOE),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_every_family_shards_to_its_tp_model_and_joins_back(name):
    """The family's seeded single-device state, cut by its layout: each
    rank's shard has the shape of its tp 2 model's tensor of that name, and
    the ranks' shards joined along the split give back the state (the
    vocabulary's padding dropped); a replicated tensor is the same on every
    rank."""
    cfg = FAMILIES[name]
    check_tp_model(cfg, TP)
    family = tp_family(cfg)
    cls = get_model_class(cfg.architecture)
    model = cls(cfg, "cpu", torch.float32)
    model.init_random_(torch.Generator().manual_seed(0))
    state = model.state_dict()
    group = TPGroup(rank=0, size=TP, device=torch.device("cpu"), backend="gloo", ranks_on_device=TP)
    want = {k: tuple(t.shape) for k, t in cls(cfg, "cpu", torch.float32, tp=group).state_dict().items()}
    shards = [shard_state(state, r, TP, family) for r in range(TP)]
    assert set(want) == set(state)
    for key, full in state.items():
        parts = [s[key] for s in shards]
        assert all(tuple(p.shape) == want[key] for p in parts), (key, parts[0].shape, want[key])
        split = split_of(key, family)
        if split is None:
            assert all(torch.equal(p, full) for p in parts), key
        elif split == "vocab":
            assert torch.equal(torch.cat(parts)[: cfg.vocab_size], full), key
        elif isinstance(split, tuple):  # Llama-4's gate|up: each rank's gate share, then its up share
            halves = [p.chunk(2, split[1]) for p in parts]
            joined = [torch.cat([h[i] for h in halves], split[1]) for i in (0, 1)]
            assert torch.equal(torch.cat(joined, split[1]), full), key
        else:
            assert torch.equal(torch.cat(parts, split), full), key


@pytest.mark.parametrize("size", [2, 4])
def test_llama4_gate_up_shards_join_as_gate_then_up(size):
    """``shard_tensor`` on Llama-4's fused gate|up stack [E, H, 2I]: rank
    r's shard is [E, H, 2I / size], its first half gate columns [r I / size,
    (r + 1) I / size) and its second half the same up columns; the ranks'
    gate halves, then their up halves, joined give back the stack. A plain
    cut of the fused axis would give rank 0 gate columns only."""
    E, H, I = 3, 8, 16
    gu = torch.randn(E, H, 2 * I, generator=torch.Generator().manual_seed(size))
    gate, up = gu[..., :I], gu[..., I:]
    shards = [shard_tensor("layers.1.gate_up", gu, r, size, "llama4") for r in range(size)]
    w = I // size
    for r, sh in enumerate(shards):
        assert sh.shape == (E, H, 2 * w)
        assert torch.equal(sh[..., :w], gate[..., r * w : (r + 1) * w])
        assert torch.equal(sh[..., w:], up[..., r * w : (r + 1) * w])
    gates, ups = (torch.cat([sh[..., half] for sh in shards], -1) for half in (slice(0, w), slice(w, None)))
    joined = torch.cat([gates, ups], -1)
    assert torch.equal(joined, gu)
    with pytest.raises(ValueError, match="does not split"):
        shard_tensor("layers.1.gate_up", torch.zeros(E, H, 6), 0, 4, "llama4")


@pytest.mark.parametrize(
    "cfg",
    [
        ModelConfig(**vlm_kw("llava"), dtype="float32"),
        ModelConfig(**vlm_kw("qwen2vl"), dtype="float32"),
        ModelConfig(**vlm_kw("gemma3"), dtype="float32"),
        ModelConfig(**mllama_kw(), dtype="float32"),
    ],
    ids=["llava", "qwen2-vl", "gemma3-mm", "mllama"],
)
def test_tp_refuses_the_other_families_before_any_rank_starts(cfg):
    """The vision classes wait for the leader's relay of image encoding
    (ROADMAP Queue 1, item 10(c)): refused by the model check and by the
    engine before it starts a follower."""
    with pytest.raises(NotImplementedError, match=r"vision models .*item 10\(c\)"):
        check_tp_model(cfg, 2)
    with pytest.raises(NotImplementedError, match=r"item 10\(c\)"):
        Engine(ServerArgs(random_weights=True, dtype="float32", device="cpu", page_size=4,
                          max_total_tokens=512, tp_size=2), model_config=cfg)
    assert not mp.active_children()


def test_tp_must_divide_the_kv_heads():
    with pytest.raises(ValueError, match="must divide num_key_value_heads"):
        check_tp_model(get_preset("tiny-debug", num_key_value_heads=1, num_attention_heads=4), 2)
    for arch in ("LlamaForCausalLM", "MistralForCausalLM", "Qwen2ForCausalLM", "Qwen3ForCausalLM"):
        check_tp_model(get_preset("tiny-debug", architecture=arch), 2)


@pytest.mark.parametrize(
    "cfg, match",
    [
        # Gemma 3 1B: one kv head
        (get_preset("tiny-gemma2", architecture="Gemma3ForCausalLM", num_key_value_heads=1),
         r"num_key_value_heads \(1\)"),
        (get_preset("tiny-debug", architecture="MixtralForCausalLM", intermediate_size=97, **TINY_MOE),
         r"moe_intermediate_size \(97\)"),
        # MLA: the query heads, not the kv heads, and the shared experts' width
        (get_preset("tiny-debug", architecture="DeepseekV2ForCausalLM", kv_lora_rank=32, qk_nope_head_dim=16,
                    qk_rope_head_dim=16, v_head_dim=32, num_attention_heads=3, num_key_value_heads=2,
                    moe_intermediate_size=33, n_shared_experts=1, **TINY_MOE),
         r"num_attention_heads \(3\), .*moe_intermediate_size \(33\), shared experts' width \(33\)"),
    ],
    ids=["gemma3-one-kv-head", "mixtral-expert-width", "deepseek-heads-and-widths"],
)
def test_tp_must_divide_each_family_split(cfg, match):
    with pytest.raises(ValueError, match=match):
        check_tp_model(cfg, 2)
    # GPT-OSS's experts stay whole: an odd expert width is no obstacle
    check_tp_model(get_preset("tiny-gpt-oss", intermediate_size=97), 2)


def test_a_follower_that_raises_at_load_makes_the_engine_raise():
    """The follower receives a config of one more layer than the leader's
    weights hold, and raises in ``load_state_dict``; the leader raises its
    error at the barrier after the load, within ``FAULT_S``."""
    ref = Engine(ServerArgs(device="cpu", **ARGS))
    state = ref.scheduler.runner.model.state_dict()
    cfg = LayerMoreInFollowers(**vars(get_preset("tiny-debug", dtype="float32")))
    t = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 failed.*Missing key"):
        _tp_engine(model_config=cfg, params=state)
    assert time.monotonic() - t < FAULT_S
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_a_follower_killed_while_serving_makes_the_engine_raise():
    eng = _tp_engine()
    try:
        eng.generate(input_ids=[1, 2, 3], sampling_params=SamplingParams(temperature=0.0, max_new_tokens=2))
        eng._followers[0].kill()
        eng._followers[0].join(10)
        t = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1"):
            eng.generate(input_ids=[4, 5, 6], sampling_params=SamplingParams(temperature=0.0, max_new_tokens=2))
        assert time.monotonic() - t < FAULT_S
    finally:
        eng._stop_tp(kill=True)


def test_what_tp_does_not_relay_is_refused():
    from scratchpad_tpu_torch.sampling.custom_logit_processor import BannedTokensProcessor

    eng = _tp_engine()
    try:
        with pytest.raises(NotImplementedError, match=r"toppings .*item 10\(c\)"):
            eng.register_topping("ad1", state={}, scaling=1.0)
        with pytest.raises(NotImplementedError, match=r"custom logit processors .*item 10\(c\)"):
            eng.generate(input_ids=[1, 2], sampling_params=SamplingParams(
                max_new_tokens=2, custom_logit_processor=BannedTokensProcessor([3])))
        with pytest.raises(NotImplementedError, match=r"update_weights .*item 10\(c\)"):
            eng.update_weights(state={})
        with pytest.raises(NotImplementedError, match=r"resize_kv_pool .*item 10\(c\)"):
            eng.resize_kv_pool(1024)
        # the engine still serves, every rank in step
        out = eng.generate(input_ids=[1, 2, 3], sampling_params=SamplingParams(temperature=0.0, max_new_tokens=3))
        assert len(out.output_ids) == 3
    finally:
        eng.shutdown()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def test_sp_serve_tp2_answers_a_chat_request():
    from scratchpad_tpu_torch.server.openai_api.conversation import get_template

    port = free_port()
    flags = ["--preset", "tiny-debug", "--random-weights", "--dtype", "float32", "--page-size", "4",
             "--device", "cpu", "--max-total-tokens", "2048", "--tokenizer-path", "chars",
             "--served-model-name", "tiny"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "scratchpad_tpu_torch.cli.sp", "serve", *flags, "--tp-size", "2",
         "--port", str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            try:
                if _get(f"http://127.0.0.1:{port}/health")["status"] == "ok":
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "the server did not come up"
            time.sleep(0.5)
        messages = [{"role": "user", "content": "hello there"}]
        body = dict(model="tiny", messages=messages, max_tokens=8, temperature=0.0, ignore_eos=True)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                     data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
    eng = Engine(ServerArgs(device="cpu", tokenizer_path="chars", served_model_name="tiny",
                            **{k: v for k, v in ARGS.items() if k != "chunked_prefill_size"}))
    prompt = get_template(None, "tiny").render(messages)
    out = eng.generate(prompt=prompt, sampling_params=SamplingParams(temperature=0.0, max_new_tokens=8,
                                                                     ignore_eos=True))
    ids, margins = _teacher_forced_margins(eng, eng.tokenizer.encode(prompt), out.output_ids)
    assert ids == out.output_ids and min(margins) > MARGIN
    assert answer["usage"]["completion_tokens"] == 8
    assert answer["choices"][0]["message"]["content"] == eng.tokenizer.decode(out.output_ids)
