"""Sparse mixture-of-experts decoders: Mixtral and Qwen3-MoE, and the parts
that GPT-OSS (``models/gpt_oss.py``) shares with them, as PyTorch
``nn.Module``s.

Counterpart of ``scratchpad_tpu/models/mixtral.py``. Each layer is the Llama
decoder's attention (q, k, v, o; Qwen3-MoE adds the per-head qk RMSNorm)
followed by a router and E experts. Routing follows HF Mixtral: softmax over
all E router logits, top-k, then renormalised over the k (always for
Mixtral; for Qwen3-MoE only where the checkpoint's ``norm_topk_prob`` says
so).

The experts run as the JAX package runs them, masked and dense
(``mixtral.py:196-245``): every token goes through every expert and each
expert's output is weighted by the token's routing weight, zero for the
experts it did not pick, then summed over the experts. Nothing indexes by
the data (no ``nonzero``, no gather of a token subset), so a decode window
never waits for the host. bf16 stacks run all E experts in one batched
matmul a matrix (``[E, T, ...]``; the JAX package's Python loop over E
would cost the eager port about 13 launches an expert: 221.5 ms of host
time a GPT-OSS-20B decode step on the card, against 41 ms of device time);
4-bit experts, one ``QuantLinear`` each, run in that loop. Every token
through every expert is E / k times the FLOPs the tokens need, the next
cost to cut (``ROADMAP.md``).

Expert weights, per layer, bf16: stacks ``[E, In, Out]`` (the JAX
orientation, ``h @ w[e]``). Quantized (``quantization`` w4a8 or w4a16):
one ``QuantLinear`` an expert and matrix (``w1.{e}``), whose codes are the
JAX package's flat ``layer * E + e`` slice of ``quantize_stacked``'s 4-D
stack (``w4a16.py:102-119``; ``weight_loader.quantized_layer_state`` splits
it). q, k, v and o are ``QuantLinear`` too, each its own (the JAX MoE
classes do not fuse), and the head stays in the model dtype, as the JAX
runner's auto rule leaves it for classes without
``supports_quantized_lm_head``.

Both classes decode and extend through the attention kernels
(``supports_pallas_attention`` True, the JAX runner's default for a class
that does not set it). Toppings are refused (no JAX MoE model applies
them), and so is expert parallelism (``_moe_ep``: ``enable_ep`` is refused
with the rest of distributed serving). ``quantization="fp8"`` (``Fp8Linear``
attention projections, ``Fp8ExpertStack`` experts, the JAX
``quantize_model_params_fp8``) runs the experts as the bf16 stacks do, each
stack upcast to the model dtype in one batched product.

Under tensor parallelism (``tp``) quantized weights are cut as the bf16
ones (``parallel.TP_LAYOUTS``): each rank holds its cut of the whole
tensors' codes (``place_whole``), w1 and w3 by each expert's Out, w2 by
its In. A W4A8 w2 quantizes each expert's slice of its input with the
whole row's scale: every expert's activations first, then one maximum over
the group for all of them ``[E, T]``, then the w2 calls (one collective a
layer, not one an expert); fp8's w2 partial products stay f32 until the
experts' sum over the group.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.models.common import (
    apply_rope,
    compute_inv_freq,
    fill_experts,
    fill_random,
    place_whole,
    quantize_weight,
    rms_norm,
    rope_cos_sin,
    row_parallel,
    row_parallel_sum,
    silu_mul,
    vocab_logits,
    vocab_lookup,
)
from scratchpad_tpu_torch.models.llama import _linear, _quant_linear, projection_maker
from scratchpad_tpu_torch.ops.attention import write_kv
from scratchpad_tpu_torch.ops.quant.fp8 import Fp8ExpertStack
from scratchpad_tpu_torch.ops.quant.w4_matmul import row_amax
from scratchpad_tpu_torch.parallel import vocab_rows

# the router digest's modulus and multiplier (a rolling hash kept on the
# device: no host sync a layer)
DIGEST_MOD = 2**31 - 1
DIGEST_MUL = 1_000_003


def expert_stack(E: int, n_in: int, n_out: int, quantization, device, dtype, tp=None):
    """E experts' ``[In, Out]`` matrices: one ``[E, In, Out]`` parameter,
    with ``fp8`` one ``Fp8ExpertStack`` (codes ``[E, In, Out]``), or with a
    4-bit ``quantization`` one ``QuantLinear`` an expert (``tp``: a
    row-parallel rank's group, ``n_in`` its share)."""
    if quantization is None:
        return nn.Parameter(torch.empty(E, n_in, n_out, device=device, dtype=dtype))
    if quantization == "fp8":
        return Fp8ExpertStack(E, n_in, n_out, device)
    a8 = quantization == "w4a8"
    return nn.ModuleList(_quant_linear(n_in, n_out, a8, False, device, dtype, tp) for _ in range(E))


def weighted_sum(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[T, H]: the experts' outputs ``out [E, T, H]`` weighted by ``w [T, E]``
    and summed over the experts."""
    return (out * w.T[:, :, None]).sum(dim=0)


def routing_weights(topv: torch.Tensor, topi: torch.Tensor, E: int, dtype) -> torch.Tensor:
    """[T, E] weights in ``dtype``: each token's k routing weights at the
    experts it picked, zero elsewhere (the JAX sum of one-hots, exactly)."""
    w = torch.zeros(topv.shape[0], E, dtype=torch.float32, device=topv.device)
    return w.scatter(1, topi, topv).to(dtype)


class MoeDecoderLayer(nn.Module):
    """Norms, the attention projections (biased where ``attn_bias``) and,
    with ``quantization``, their ``QuantLinear``s, and with ``qk_norm`` the
    per-head norms' weights; the subclass's model adds the router and the
    experts. ``tp``: a tensor-parallel rank's group (its heads; o over its
    share of the input)."""

    def __init__(self, cfg: ModelConfig, device, dtype, quantization, attn_bias: bool,
                 qk_norm: bool, tp=None):
        super().__init__()
        tp_size = 1 if tp is None else tp.size
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv = cfg.num_attention_heads // tp_size, cfg.num_kv_heads // tp_size
        self.input_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.post_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        lin = projection_maker(quantization, device, dtype)
        self.wq = lin(H, Hq * D, attn_bias)
        self.wk = lin(H, Hkv * D, attn_bias)
        self.wv = lin(H, Hkv * D, attn_bias)
        self.wo = lin(Hq * D, H, attn_bias, tp)
        if qk_norm:
            self.q_norm = nn.Parameter(torch.empty(D, device=device, dtype=dtype))
            self.k_norm = nn.Parameter(torch.empty(D, device=device, dtype=dtype))


class MoeForCausalLM(nn.Module):
    """The layer loop, weights and head shared by the MoE families:
    ``forward(meta, kv) -> f32 logits [B, V]`` at each row's last token.
    A subclass builds its layers' experts (``_add_experts``; or the whole
    layer, ``_make_layer``), names its expert stacks (``EXPERT_STACKS``) and
    runs them (``_moe``); its ``attention_kwargs`` gives each layer's extra
    attention arguments."""

    supports_pallas_attention = True
    supports_toppings = False
    supports_quantized_lm_head = False
    tp_family = "mixtral"
    ATTN_BIAS = False
    EXPERT_STACKS: tuple = ()
    # the subclass's extra per-layer tensors that are biases (zero at init)
    BIASES: tuple = ()
    # under tensor parallelism: the experts' outputs are a rank's partial
    # sums, added over the group
    MOE_SUM = True

    def __init__(
        self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False, tp=None
    ):
        super().__init__()
        unported = [
            name
            for name, on in (
                ("quantize_lm_head", quantize_lm_head),
                ("multimodal", cfg.multimodal),
                ("quantization", quantization not in (None, "w4a8", "w4a16", "fp8")),
            )
            if on
        ]
        if unported:
            raise NotImplementedError(
                f"{type(self).__name__} options not ported: {', '.join(unported)}"
            )
        self._check_experts(cfg)
        self.cfg = cfg
        self.quantization = quantization
        self.tp = tp
        self.tp_size = 1 if tp is None else tp.size
        H = cfg.hidden_size
        V = vocab_rows(cfg.vocab_size, self.tp_size)  # the rank's vocabulary rows
        self.embed = skip_init(nn.Embedding, V, H, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            self._make_layer(l, device, dtype) for l in range(cfg.num_hidden_layers)
        )
        self.final_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.lm_head = None if cfg.tie_word_embeddings else _linear(H, V, False, device, dtype)
        self.register_buffer(
            "inv_freq", torch.as_tensor(compute_inv_freq(cfg), device=device), persistent=False
        )
        self.sm_scale = float(cfg.head_dim**-0.5)
        self.decode_attention = None  # set by the runner from attention_backend
        self.extend_attention = None
        self.toppings = None
        # tensor parallel: a digest of every router pick (an i64 on the
        # device) and their count
        self.router_digest = torch.zeros((), dtype=torch.int64, device=device)
        self.router_picks = 0

    @staticmethod
    def _check_experts(cfg: ModelConfig) -> None:
        if cfg.num_experts <= 0 or not 0 < cfg.num_experts_per_tok <= cfg.num_experts:
            raise ValueError(
                f"a MoE model needs 0 < num_experts_per_tok <= num_experts, got "
                f"{cfg.num_experts_per_tok} and {cfg.num_experts}"
            )

    @property
    def intermediate_size(self) -> int:
        return self.cfg.moe_intermediate_size or self.cfg.intermediate_size

    def _make_layer(self, l: int, device, dtype) -> MoeDecoderLayer:
        layer = MoeDecoderLayer(self.cfg, device, dtype, self.quantization, self.ATTN_BIAS,
                                self.cfg.use_qk_norm, tp=self.tp)
        self._add_experts(layer, device, dtype)
        return layer

    def _add_experts(self, layer: MoeDecoderLayer, device, dtype) -> None:
        raise NotImplementedError

    def _moe(self, h: torch.Tensor, layer: MoeDecoderLayer) -> torch.Tensor:
        raise NotImplementedError

    def attention_kwargs(self, l: int, layer: MoeDecoderLayer) -> dict:
        return {}

    def top_experts(self, scores: torch.Tensor) -> torch.Tensor:
        """i64 [T, k]: each token's k experts, by its router ``scores`` [T, E]
        (``lax.top_k``'s order: descending). One call a layer and forward, so
        a caller may record and replay a forward's routing. A
        tensor-parallel rank folds the picks into ``router_digest``."""
        topi = torch.topk(scores, self.cfg.num_experts_per_tok, dim=-1).indices
        if self.tp is not None:
            self.fold_picks(topi)
        return topi

    def fold_picks(self, topi: torch.Tensor) -> None:
        """``router_digest`` <- a rolling hash of it and the picks ``topi``,
        on the device (position-weighted, modulo ``DIGEST_MOD``)."""
        n = topi.numel()
        pos = torch.arange(n, device=topi.device, dtype=torch.int64)
        h = ((topi.reshape(-1).long() + 1) * (pos * 40503 % 65521 + 1)).sum() % DIGEST_MOD
        self.router_digest = (self.router_digest * DIGEST_MUL + h) % DIGEST_MOD
        self.router_picks += n

    def o_proj(self, layer, attn: torch.Tensor) -> torch.Tensor:
        """o of the attention output ``attn`` [T, Hq D]; under tensor
        parallelism the ranks' partial products summed, o's bias (GPT-OSS)
        added once, after the sum (``common.row_parallel``)."""
        return row_parallel(layer.wo, attn, self.tp)

    def moe_sum(self, y: torch.Tensor) -> torch.Tensor:
        """The experts' output ``y``: a rank's partial sum, added over the
        group (``MOE_SUM``), or already whole."""
        return row_parallel_sum(y, self.tp) if self.MOE_SUM else y

    # ------------------------------------------------------------- parameters

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator, place=None) -> None:
        """Random weights, the JAX package's scheme: normal / sqrt(fan_in),
        norms at one, biases at zero. An expert stack is drawn one expert at
        a time on its device (``common.fill_experts``; GPT-OSS-20B's stacks
        are 38 GB in bf16: one f32 draw of a layer's would not fit beside
        them). A tensor-parallel rank keeps its shard of each tp 1 draw.
        ``place(name, whole[, e])`` takes each draw instead."""
        family, tp = self.tp_family, self.tp
        fill = lambda w, name: fill_random(w, name, generator, tp, family, self.cfg.vocab_size, place=place)
        self.reset_constants_()
        fill(self.embed.weight, "embed.weight")
        for l, layer in enumerate(self.layers):
            for name, p in layer.named_parameters(recurse=False):
                if name.endswith("norm") or name in self.BIASES:
                    continue
                if name in self.EXPERT_STACKS:
                    fill_experts(p, f"layers.{l}.{name}", generator, tp, family, place)
                else:
                    self._init_extra_(f"layers.{l}.{name}", p, generator, place)
            for name, lin in layer.named_children():
                if isinstance(lin, nn.Linear):
                    fill(lin.weight, f"layers.{l}.{name}.weight")
        if self.lm_head is not None:
            fill(self.lm_head.weight, "lm_head.weight")

    @torch.no_grad()
    def reset_constants_(self) -> None:
        """Norms at one, biases (``BIASES`` too) at zero: the random init's
        constants."""
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name.endswith("bias") or name.rsplit(".", 1)[-1] in self.BIASES:
                p.zero_()

    def _init_extra_(self, name: str, p: torch.Tensor, generator, place=None) -> None:
        raise ValueError(f"no random init for {name}")

    # the attention weights a quantized model quantizes, by layer (and each
    # expert of EXPERT_STACKS); a quantized tensor-parallel rank's load
    QUANT_TARGETS = ("wq", "wk", "wv", "wo")
    place_whole = place_whole

    HF_ATTN_MAP = {
        "self_attn.q_proj.weight": "wq.weight",
        "self_attn.k_proj.weight": "wk.weight",
        "self_attn.v_proj.weight": "wv.weight",
        "self_attn.o_proj.weight": "wo.weight",
        "self_attn.q_norm.weight": "q_norm",
        "self_attn.k_norm.weight": "k_norm",
        "input_layernorm.weight": "input_norm",
        "post_attention_layernorm.weight": "post_norm",
    }

    def _convert_layer(self, l: int, sub: str, t: torch.Tensor, out: dict, experts: dict) -> bool:
        """Map one HF layer tensor into ``out`` (or ``experts[(name, l)][e]``
        for a per-expert matrix); False if ``sub`` is not the family's."""
        if sub in self.HF_ATTN_MAP:
            out[f"layers.{l}.{self.HF_ATTN_MAP[sub]}"] = t
            return True
        return False

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """Map a flat HF state dict (name -> numpy array or tensor) onto this
        module's ``state_dict`` names; per-expert HF matrices are stacked
        into ``[E, In, Out]``."""
        out: dict[str, torch.Tensor] = {}
        experts: dict[tuple, dict] = {}
        for name, w in state.items():
            t = torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w)
            if dtype is not None:
                t = t.to(dtype)
            if name.startswith("model.layers."):
                idx, sub = name[len("model.layers."):].split(".", 1)
                if not self._convert_layer(int(idx), sub, t, out, experts):
                    raise KeyError(f"unmapped HF weight {name}")
            elif name == "model.embed_tokens.weight":
                out["embed.weight"] = t
            elif name == "model.norm.weight":
                out["final_norm"] = t
            elif name == "lm_head.weight":
                if not self.cfg.tie_word_embeddings:
                    out["lm_head.weight"] = t
            elif name.endswith("rotary_emb.inv_freq"):
                pass
            else:
                raise KeyError(f"unmapped HF weight {name}")
        E = self.cfg.num_experts
        for (stack, l), per_expert in experts.items():
            if sorted(per_expert) != list(range(E)):
                raise KeyError(f"layer {l} {stack}: experts {sorted(per_expert)} of {E}")
            out[f"layers.{l}.{stack}"] = torch.stack([per_expert[e] for e in range(E)])
        return out

    def quantize_state(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This quantized model's ``state_dict`` from its unquantized twin's:
        q, k, v and o (``[out, in]``, transposed) and each expert of the
        expert stacks (``[E, In, Out]``) through ``quantize_weight`` on this
        model's device, as the JAX runner quantizes its ``[L, ...]`` stacks
        (expert e of layer l holds the codes of the JAX stack's slice
        ``l * E + e``); an fp8 stack's codes and scales stacked again by
        expert. Biases, norms, sinks, the router and the head stay."""
        device, q = self.final_norm.device, self.quantization
        state = dict(state)
        for l in range(len(self.layers)):
            for t in self.QUANT_TARGETS:
                state.update(quantize_weight(f"layers.{l}.{t}", state.pop(f"layers.{l}.{t}.weight").to(device).T,
                                             q)[0])
            for t in self.EXPERT_STACKS:
                stack = state.pop(f"layers.{l}.{t}").to(device)
                if q == "fp8":
                    experts = [quantize_weight(f"layers.{l}.{t}", w, q)[0] for w in stack]
                    state.update({k: torch.stack([e[k] for e in experts]) for k in experts[0]})
                else:
                    for e, w in enumerate(stack):
                        state.update(quantize_weight(f"layers.{l}.{t}.{e}", w, q)[0])
        return state

    # ---------------------------------------------------------------- forward

    def forward(self, meta: ForwardMeta, kv: KVCache) -> torch.Tensor:
        cfg = self.cfg
        T = meta.num_tokens
        Hq, Hkv = cfg.num_attention_heads // self.tp_size, cfg.num_kv_heads // self.tp_size
        D, eps = cfg.head_dim, cfg.rms_norm_eps
        attend = self.decode_attention if meta.mode == ForwardMode.DECODE else self.extend_attention
        cos, sin = rope_cos_sin(meta.positions, self.inv_freq)
        x = vocab_lookup(self.embed, meta.tokens, self.tp)  # [T, H]
        for l, layer in enumerate(self.layers):
            h = rms_norm(x, layer.input_norm, eps)
            q = layer.wq(h).view(T, Hq, D)
            k = layer.wk(h).view(T, Hkv, D)
            v = layer.wv(h).view(T, Hkv, D)
            if cfg.use_qk_norm:
                q = rms_norm(q, layer.q_norm, eps)
                k = rms_norm(k, layer.k_norm, eps)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            write_kv(kv, k, v, l, meta.out_cache_loc)
            attn = attend(
                q, kv, l, meta, sm_scale=self.sm_scale, logit_cap=None,
                **self.attention_kwargs(l, layer),
            )
            x = x + self.o_proj(layer, attn.reshape(T, Hq * D))
            x = x + self.moe_sum(self._moe(rms_norm(x, layer.post_norm, eps), layer)).to(x.dtype)
        h = rms_norm(x, self.final_norm, eps)
        if meta.capture_all_hidden:
            return h  # [T, H], for sequence scoring
        last = h[meta.last_token_idx]  # [B, H]
        if meta.capture_hidden:
            return last
        return self.head_logits(last)

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits of final-normed hidden rows ``h`` [N, H] (every column,
        gathered under tensor parallelism)."""
        head = self.embed.weight if self.lm_head is None else self.lm_head.weight
        return vocab_logits(h, head, self.cfg.vocab_size, self.tp)


class MixtralForCausalLM(MoeForCausalLM):
    """Mixtral: router ``[E, H]`` (no bias); experts w1 (gate), w3 (up), w2
    (down), SiLU(x w1) * (x w3) then w2; softmax, top-k, renormalise."""

    EXPERT_STACKS = ("w1", "w3", "w2")

    @property
    def norm_topk(self) -> bool:
        return True

    def _add_experts(self, layer, device, dtype) -> None:
        cfg = self.cfg
        H, E, I = cfg.hidden_size, cfg.num_experts, self.intermediate_size // self.tp_size
        layer.router = _linear(H, E, False, device, dtype)
        layer.w1 = expert_stack(E, H, I, self.quantization, device, dtype)
        layer.w3 = expert_stack(E, H, I, self.quantization, device, dtype)
        layer.w2 = expert_stack(E, I, H, self.quantization, device, dtype, self.tp)

    def _moe(self, h: torch.Tensor, layer) -> torch.Tensor:
        """The masked dense experts (``mixtral.py:196-245``). Under tensor
        parallelism a rank's partial sum (fp8's in f32), which ``moe_sum``
        adds over the group."""
        E = self.cfg.num_experts
        probs = torch.softmax(layer.router(h).float(), dim=-1)  # [T, E]
        topi = self.top_experts(probs)
        topv = probs.gather(1, topi)
        if self.norm_topk:
            topv = topv / topv.sum(dim=-1, keepdim=True)
        w = routing_weights(topv, topi, E, h.dtype)
        if isinstance(layer.w1, Fp8ExpertStack):  # fp8 stacks: all experts at once
            act = silu_mul(layer.w1(h), layer.w3(h))
            if self.tp is not None:  # partial products, f32 until the group's sum
                return weighted_sum(layer.w2.partial(act), w.float())
            return weighted_sum(layer.w2(act), w)
        if not isinstance(layer.w1, nn.ModuleList):  # bf16 stacks: all experts at once
            act = silu_mul(torch.matmul(h, layer.w1), torch.matmul(h, layer.w3))  # [E, T, I]
            return weighted_sum(torch.matmul(act, layer.w2), w)
        y = torch.zeros_like(h)  # 4-bit: one GEMM an expert and matrix
        if self.tp is not None and layer.w2[0].a8:
            # a rank's slices of every expert's activations, then the whole
            # rows' maxima [E, T, 1] in one collective, then w2's f32
            # partials, summed in f32 until the group's sum
            acts = [silu_mul(layer.w1[e](h), layer.w3[e](h)) for e in range(E)]
            amax = self.tp.all_reduce(torch.stack([row_amax(a) for a in acts]), op="max")
            y, w = y.float(), w.float()
            for e in range(E):
                y = y + layer.w2[e].partial(acts[e], amax[e]) * w[:, e : e + 1]
            return y
        for e in range(E):
            act = silu_mul(layer.w1[e](h), layer.w3[e](h))
            y = y + layer.w2[e].partial(act) * w[:, e : e + 1]
        return y

    HF_EXPERT_PREFIX = "block_sparse_moe.experts."
    HF_ROUTER = "block_sparse_moe.gate.weight"
    HF_EXPERT_NAMES = {"w1": "w1", "w2": "w2", "w3": "w3"}

    def _convert_layer(self, l, sub, t, out, experts) -> bool:
        if super()._convert_layer(l, sub, t, out, experts):
            return True
        if sub == self.HF_ROUTER:
            out[f"layers.{l}.router.weight"] = t
            return True
        if sub.startswith(self.HF_EXPERT_PREFIX):
            e, name, leaf = sub[len(self.HF_EXPERT_PREFIX):].split(".")
            if leaf != "weight" or name not in self.HF_EXPERT_NAMES:
                return False
            # HF [out, in] -> the stack's [In, Out]
            experts.setdefault((self.HF_EXPERT_NAMES[name], l), {})[int(e)] = t.T.contiguous()
            return True
        return False


class Qwen3MoeForCausalLM(MixtralForCausalLM):
    """Qwen3-MoE: the Mixtral decoder with the per-head qk RMSNorm; top-k
    renormalisation where the checkpoint's ``norm_topk_prob`` is set. Like
    the JAX class, it sets ``use_qk_norm`` on the config it is given."""

    def __init__(self, cfg: ModelConfig, *args, **kwargs):
        cfg.use_qk_norm = True
        super().__init__(cfg, *args, **kwargs)

    @property
    def norm_topk(self) -> bool:
        return bool(self.cfg.norm_topk_prob)

    HF_EXPERT_PREFIX = "mlp.experts."
    HF_ROUTER = "mlp.gate.weight"
    HF_EXPERT_NAMES = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
