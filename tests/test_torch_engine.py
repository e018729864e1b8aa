"""The port's Engine against the JAX package's on the CPU: same tiny-debug
weights (f32), same requests, the same greedy tokens, through chunked
prefill, radix-cache reuse and fused decode windows of more than one step.

The prompts are fixed. The test asserts that at every generated step the
port's top-2 logit margin exceeds 1e-3, so a near tie (where f32 rounding
could flip the argmax between the two frameworks) fails loudly instead of
flaking.
"""

import jax
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.model_runner import WorkerBatch, resolve_kv_cache_dtype
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
import torch_threads  # noqa: F401  (one torch thread a test process)

ARGS = dict(
    preset="tiny-debug",
    random_weights=True,
    dtype="float32",
    page_size=4,
    max_total_tokens=2048,
    chunked_prefill_size=16,
)
MARGIN = 1e-3
LP_TOL = 1e-4  # chosen logprobs, port against JAX (f32)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JaxServerArgs(**ARGS))
    eng = Engine(ServerArgs(device="cpu", **ARGS))
    runner = jeng.scheduler.runner
    params = jax.tree.map(np.asarray, runner.params)
    eng.scheduler.runner.model.load_state_dict(
        params_from_jax(
            params,
            eng.model_config,
            transposed=getattr(runner.model, "weights_transposed", False),
        )
    )
    return jeng, eng


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 500, n).tolist()


def _teacher_forced_margins(eng, prompt, out_ids):
    """The port's greedy choice and top-2 margin at every generated step,
    replaying the prompt and the outputs on pages borrowed from the idle
    engine."""
    runner = eng.scheduler.runner
    ps, n = runner.page_size, len(prompt)
    toks = np.asarray(list(prompt) + list(out_ids))
    pages = runner.page_allocator.alloc(-(-len(toks) // ps))
    pos = np.arange(len(toks))
    loc = pages[pos // ps] * ps + pos % ps
    sinfo = SamplingBatchInfo.from_reqs([], 1, eng.model_config.vocab_size)

    def wb(mode, lo, hi):
        return WorkerBatch(
            mode=mode, tokens=toks[lo:hi], positions=pos[lo:hi],
            out_cache_loc=loc[lo:hi], req_indices=np.zeros(hi - lo, np.int64),
            page_table=pages[None, :], seq_lens=np.array([hi]),
            extend_lens=np.array([hi - lo]), sampling_info=sinfo,
        )

    try:
        steps = [runner.forward_logits(wb(ForwardMode.EXTEND, 0, n))[0]]
        for i in range(n, len(toks) - 1):
            steps.append(runner.forward_logits(wb(ForwardMode.DECODE, i, i + 1))[0])
    finally:
        runner.page_allocator.free(pages)
    top2 = [torch.topk(l, 2) for l in steps]
    return [int(t.indices[0]) for t in top2], [float(t.values[0] - t.values[1]) for t in top2]


def test_greedy_tokens_match_jax(engines):
    _greedy_tokens_match(*engines)


def _greedy_tokens_match(jeng, eng, stop_at_tie=False):
    # 5 and 23 tokens, and 40 (> chunked_prefill_size 16: three chunks)
    prompts = [_prompt(n, seed=n) for n in (5, 23, 40)]
    max_new = [12, 9, 16]
    outs = eng.generate(
        input_ids=prompts,
        sampling_params=[SamplingParams(temperature=0.0, max_new_tokens=m) for m in max_new],
    )
    jouts = jeng.generate(
        input_ids=prompts,
        sampling_params=[JaxSamplingParams(temperature=0.0, max_new_tokens=m) for m in max_new],
    )
    # radix reuse: 32 of the 40-token prompt's tokens come from the cache
    again = prompts[2][:32] + _prompt(6, seed=99)
    sp = dict(temperature=0.0, max_new_tokens=10)
    out2 = eng.generate(input_ids=again, sampling_params=SamplingParams(**sp))
    jout2 = jeng.generate(input_ids=again, sampling_params=JaxSamplingParams(**sp))
    assert out2.cached_tokens == jout2.cached_tokens == 32

    compared = 0
    for p, o, j, m in zip(prompts + [again], outs + [out2], jouts + [jout2], max_new + [10]):
        assert len(o.output_ids) == m
        ids, margins = _teacher_forced_margins(eng, p, o.output_ids)
        assert ids == o.output_ids
        n = m
        if stop_at_tie:
            n = next((i for i, g in enumerate(margins) if g <= MARGIN), m)
        else:
            assert min(margins) > MARGIN, min(margins)
        assert o.output_ids[:n] == j.output_ids[:n]
        compared += n
    assert compared >= 30, compared  # of the 47 generated tokens
    eng.scheduler.check_memory_leak()


def test_decode_windows_span_several_steps(engines):
    """The engine fuses several decode steps per window (one host fetch
    per window): fewer windows than generated tokens."""
    _, eng = engines
    runner = eng.scheduler.runner
    windows = []
    inner = runner.run_decode_window

    def spy(wb, K):
        windows.append(K)
        return inner(wb, K)

    runner.run_decode_window = spy
    try:
        out = eng.generate(
            input_ids=_prompt(9, seed=5),
            sampling_params=SamplingParams(temperature=0.0, max_new_tokens=20),
        )
    finally:
        runner.run_decode_window = inner
    assert len(out.output_ids) == 20
    assert max(windows) > 1 and sum(windows) == 19  # the first token comes from the extend


def test_generate_stream_matches_generate(engines):
    """Streaming yields progress while the request runs, then a final
    output whose greedy tokens are those of ``generate``."""
    _, eng = engines
    ids = _prompt(11, seed=7)
    sp = SamplingParams(temperature=0.0, max_new_tokens=18, ignore_eos=True)
    chunks = list(eng.generate_stream(input_ids=ids, sampling_params=sp))
    assert [c["finished"] for c in chunks] == [False] * (len(chunks) - 1) + [True]
    assert len(chunks) > 2  # the extend's token and at least one decode window
    streamed = chunks[-1]["output"]
    assert streamed.output_ids == eng.generate(input_ids=ids, sampling_params=sp).output_ids
    assert len(streamed.output_ids) == 18 and streamed.finish_reason == "length"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(ServerArgs(preset="tiny-debug", random_weights=True))  # device defaults to cuda


def test_extend_runs_unpadded_and_decode_pads_to_buckets(engines):
    """An extend batch reaches the model at its real size; a decode batch
    is padded to the next batch-size bucket with zero-length rows that
    write to the dump page."""
    _, eng = engines
    runner = eng.scheduler.runner
    sinfo = SamplingBatchInfo.from_reqs([], 3, eng.model_config.vocab_size)
    pt = np.array([[1, 2], [3, 0], [4, 5]], np.int32)
    ext = WorkerBatch(
        mode=ForwardMode.EXTEND, tokens=np.arange(1, 12), positions=np.arange(11),
        out_cache_loc=np.arange(11) + 4, req_indices=np.repeat([0, 1, 2], [5, 2, 4]),
        page_table=pt, seq_lens=np.array([5, 2, 4]), extend_lens=np.array([5, 2, 4]),
        sampling_info=sinfo,
    )
    meta, _, _ = runner._pad_to_buckets(ext)
    assert meta.tokens.shape == (11,) and meta.page_table.shape == (3, 2)
    assert meta.cu_q_lens.tolist() == [0, 5, 7, 11]
    assert meta.last_token_idx.tolist() == [4, 6, 10]

    dec = WorkerBatch(
        mode=ForwardMode.DECODE, tokens=np.array([7, 8, 9]), positions=np.array([5, 2, 4]),
        out_cache_loc=np.array([21, 14, 20]), req_indices=np.arange(3), page_table=pt,
        seq_lens=np.array([6, 3, 5]), extend_lens=np.ones(3, np.int64), sampling_info=sinfo,
    )
    meta, _, _ = runner._pad_to_buckets(dec)
    assert meta.tokens.shape == (4,) and meta.page_table.shape == (4, 4)
    assert meta.seq_lens.tolist() == [6, 3, 5, 0]
    assert int(meta.out_cache_loc[3]) == 0 and not meta.page_table[3].any()


@pytest.mark.parametrize(
    "setting",
    [
        dict(attention_backend="plain"),
        dict(attention_backend="ragged"),
        dict(attention_backend="xla"),
        dict(enable_pp=True),  # fp8 weights, once here, are served since they were ported
        dict(kv_cache_dtype="int4"),  # not a kv_cache_dtype of the JAX package
    ],
    # the ids these cases had beside the refusals of speculation, the
    # memory extras and quantized weights under tp, which are served now
    ids=["setting0", "setting1", "setting2", "setting4", "setting6"],
)
def test_unported_settings_are_refused(setting):
    """Settings resolve() refuses: the paths the port does not have."""
    with pytest.raises(NotImplementedError):
        ServerArgs(preset="tiny-debug", device="cpu", **setting).resolve()


@pytest.mark.parametrize(
    "setting",
    [dict(enable_overlap=True), dict(enable_overlap=False),
     dict(decode_pipeline_depth=2), dict(enable_overlap=True, decode_pipeline_depth=3)],
)
def test_overlap_settings_resolve(setting):
    args = ServerArgs(preset="tiny-debug", device="cpu", **setting).resolve()
    for k, v in setting.items():
        assert getattr(args, k) == v


@pytest.mark.parametrize("quantization", ["w4a8", "w4a16", "w4", "awq", "gptq", "gptq_v2"])
def test_w4_quantization_names_resolve(quantization):
    args = ServerArgs(preset="tiny-debug", device="cpu", quantization=quantization).resolve()
    assert args.quantization == quantization


@pytest.mark.parametrize(
    "quantization,preset,device,int8",
    [
        ("w4a8", "llama-3.2-3b", "cuda", True),  # hidden x layers 86,016
        ("gptq", "llama-3.2-3b", "cuda", True),
        ("w4a8", "llama-3.2-3b", "cpu", False),  # off the accelerator: bf16
        ("w4a8", "llama-3.2-1b", "cuda", False),  # 32,768 < 50,000
        (None, "llama-3.2-3b", "cuda", False),  # unquantized
        ("w4", "llama-3.2-3b", "cuda", False),  # not in the JAX rule's list
    ],
)
def test_kv_cache_dtype_auto_rule(quantization, preset, device, int8):
    """The JAX runner's kv_cache_dtype=auto picks int8 KV for W4 serving of
    3B and up on an accelerator, and the model dtype otherwise; an explicit
    setting is served as it is. ``args`` is never written back."""
    args = ServerArgs(preset=preset, quantization=quantization, device="cpu").resolve()
    cfg = get_preset(preset)
    dev = torch.device(device)
    assert resolve_kv_cache_dtype(args, cfg, dev) == ("int8" if int8 else "bfloat16")
    assert args.kv_cache_dtype == "auto"
    for explicit in ("bfloat16", "int8", "fp8"):
        args.kv_cache_dtype = explicit
        assert resolve_kv_cache_dtype(args, cfg, dev) == explicit
        assert args.kv_cache_dtype == explicit


def test_n_2_through_the_prefix_warm_up_matches_jax(engines):
    """``Engine.generate`` with ``n=2`` caches the prompt with a zero-token
    warm-up request, then runs two clones. Greedy clones are bit-equal in
    ids and logprobs, and equal the JAX engine's within ``LP_TOL``; a
    sampled pair still gives two full choices."""
    jeng, eng = engines
    p = _prompt(23, seed=12)
    sp = dict(temperature=0.0, max_new_tokens=10, ignore_eos=True, n=2)
    outs = eng.generate(input_ids=p, sampling_params=SamplingParams(**sp), return_logprob=True)
    jouts = jeng.generate(input_ids=p, sampling_params=JaxSamplingParams(**sp), return_logprob=True)
    assert len(outs) == len(jouts) == 2
    assert outs[0].output_ids == outs[1].output_ids == jouts[0].output_ids == jouts[1].output_ids
    assert outs[0].output_token_logprobs == outs[1].output_token_logprobs
    np.testing.assert_allclose(outs[0].output_token_logprobs, jouts[0].output_token_logprobs, atol=LP_TOL, rtol=0)
    assert outs[0].cached_tokens == outs[1].cached_tokens == jouts[0].cached_tokens > 0
    sampled = eng.generate(input_ids=p, sampling_params=SamplingParams(
        temperature=0.9, max_new_tokens=8, ignore_eos=True, n=2))
    assert [len(o.output_ids) for o in sampled] == [8, 8]
    eng.scheduler.check_memory_leak()
