"""DeepSeek-V2 and V3: multi-head latent attention and fine-grained MoE, as
PyTorch ``nn.Module``s.

Counterpart of ``scratchpad_tpu/models/deepseek.py``, on the MoE base of
``models/mixtral.py``:

- **Attention (MLA).** q from ``wq``, or from ``wq_a``, ``q_norm`` and
  ``wq_b`` where ``q_lora_rank`` is set; per head its nope part (dn) and its
  rope part (dr). ``wkv_a`` gives the latent ``c_kv`` (r, then ``kv_norm``)
  and one shared ``k_rope`` (dr). Rope is the interleaved-pair rope on the
  dr dims only, its frequencies ``compute_inv_freq`` over dr, its cos and
  sin scaled by DeepSeek's YaRN multiplier (``deepseek_yarn_scale``). The
  pool keeps ``[c_kv | k_rope]`` once a token and layer (a latent pool,
  ``memory/kv_cache.py``), and attention runs in the latent space:
  ``W_UK`` (``w_uk`` [Hq, dn, r]) is absorbed into the query,
  ``ops/attention/mla_backend.py::mla_attention`` returns the weighted
  latent, and ``W_UV`` (``w_uv`` [Hq, r, dv]) expands it before ``wo``, all
  in f32, the output rounded once to the model dtype.
  HF's ``kv_b_proj`` is split into the two (``convert_hf_state``).
- **The softmax scale** follows HF for each version: ``(dn + dr)^-0.5``;
  V3 multiplies it by ``mscale(factor, mscale_all_dim)^2`` where
  ``rope_scaling`` carries ``mscale_all_dim``
  (``modeling_deepseek_v3.py:371-377``). The JAX class uses
  ``(dn + dr)^-0.5`` for both (``deepseek.py:92``): with V3's published
  YaRN (factor 40, ``mscale_all_dim`` 1) its scores are 1/1.874 of HF's.
  That gap is the JAX package's, not copied (``ROADMAP.md`` Queue 3). V2
  keeps ``(dn + dr)^-0.5`` under YaRN, as HF's V2 and the JAX package do,
  and logs a warning at load naming the ``mscale(factor,
  mscale_all_dim)^2`` it leaves out (1.590x at V2-Lite's YaRN).
- **Layers.** The first ``first_k_dense_replace`` layers are dense (SwiGLU,
  ``intermediate_size``); the rest are MoE: the routed experts, masked and
  dense as Mixtral's (bf16 stacks ``[E, In, Out]``, one batched matmul a
  matrix), and the shared experts (``moe_intermediate_size *
  n_shared_experts`` wide) always on beside them.
- **Routers**, each through the base's ``top_experts`` hook on the scores it
  picks by: softmax ``greedy`` (no top-k renormalisation); softmax
  ``group_limited_greedy`` (only the ``topk_group`` groups with the best max
  score); and V3's ``noaux_tc`` (sigmoid scores plus the f32 correction bias
  ``router_bias`` pick the groups, by the sum of each group's top 2, then
  the experts; the combine weights are the unbiased scores, renormalised
  where ``norm_topk_prob``). All scale by ``routed_scaling_factor``.

Refused, each with a message: any ``quantization`` (the JAX DeepSeek reads
``wo`` and the experts from the stacks that ``quantize_model_params`` moves
out, ``ops/quant/w4a16.py:156-161``, so it cannot serve 4-bit weights
either), 8-bit KV (``memory/kv_cache.py``), ``attention_backend="pallas"``
(``supports_pallas_attention`` False) and toppings. The model never calls
the decode or extend attention kernels.

Under tensor parallelism (``tp``), as JAX ``deepseek.py:191-236`` places
it: a rank holds its q heads (``wq`` or ``wq_b`` by column, ``w_uk`` and
``w_uv`` by head), its rows of ``wo``, and its share of the dense MLP, of
the shared experts and of each routed expert's width; the latent path
(``wkv_a``, ``wq_a``, the norms), the router and V3's ``router_bias`` are
replicated. Every rank keeps the whole latent pool (JAX
``kv_cache.py:269``) and writes the same rows into it. A layer's two
collectives are o's sum and one sum of the routed and the shared experts'
partial sums.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.models.common import (
    apply_rope_interleaved,
    compute_inv_freq,
    deepseek_yarn_scale,
    fill_random,
    rms_norm,
    rope_cos_sin,
    row_parallel_sum,
    silu_mul,
    vocab_lookup,
    yarn_mscale,
)
from scratchpad_tpu_torch.models.llama import _linear
from scratchpad_tpu_torch.models.mixtral import (
    MoeForCausalLM,
    expert_stack,
    routing_weights,
    weighted_sum,
)
from scratchpad_tpu_torch.ops.attention.mla_backend import extend_spans, mla_attention, write_latent
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("models.deepseek")


def group_mask(scores: torch.Tensor, group_best: torch.Tensor, topk_group: int) -> torch.Tensor:
    """f32 [T, E]: 1 on the experts of each token's ``topk_group`` groups
    with the best ``group_best`` [T, n_group], 0 elsewhere."""
    T, n_group = group_best.shape
    idx = torch.topk(group_best, topk_group, dim=-1).indices
    keep = torch.zeros_like(group_best).scatter(1, idx, 1.0)
    return keep.repeat_interleave(scores.shape[1] // n_group, dim=-1)


class DeepseekV2ForCausalLM(MoeForCausalLM):
    supports_pallas_attention = False  # MLA attends through its latent backend
    tp_family = "deepseek"
    EXPERT_STACKS = ("w1", "w3", "w2")
    BIASES = ("router_bias",)
    # V3's sigmoid router with the correction bias; a V2 config that names
    # topk_method "noaux_tc" routes so too
    noaux_tc = False

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False, tp=None):
        name = type(self).__name__
        if quantization is not None or quantize_lm_head:
            raise NotImplementedError(
                f"{name} options not ported: quantization={quantization!r} (the JAX DeepSeek "
                "reads wo and the experts from the stacks that quantize_model_params moves "
                "out, so it serves no 4-bit weights either)"
            )
        if not cfg.is_mla:
            raise ValueError(f"{name} needs kv_lora_rank: multi-head latent attention")
        self.noaux_tc = self.noaux_tc or cfg.topk_method == "noaux_tc"
        # without routed experts every layer is dense
        self.n_dense = cfg.first_k_dense_replace if cfg.num_experts else cfg.num_hidden_layers
        super().__init__(cfg, device, dtype, tp=tp)
        rope_cfg = dataclasses.replace(cfg, head_dim=cfg.qk_rope_head_dim)
        self.inv_freq = torch.as_tensor(compute_inv_freq(rope_cfg), device=device)
        self.rope_scale = deepseek_yarn_scale(cfg.rope_scaling)
        self.sm_scale = self.softmax_scale(cfg)
        rs = cfg.rope_scaling or {}
        if (
            type(self).softmax_scale is DeepseekV2ForCausalLM.softmax_scale
            and "yarn" in (rs.get("type"), rs.get("rope_type"))
            and rs.get("mscale_all_dim")
        ):
            logger.warning(
                "%s under YaRN (factor %s, mscale_all_dim %s): the softmax scale stays (dn + dr)^-0.5, "
                "as in HF's DeepseekV2Attention and the JAX package; the mscale(factor, "
                "mscale_all_dim)^2 = %.3fx that V3 applies is not applied (ROADMAP.md Queue 3)",
                name, rs["factor"], rs["mscale_all_dim"], yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2,
            )

    @staticmethod
    def _check_experts(cfg: ModelConfig) -> None:
        if cfg.num_experts and not 0 < cfg.num_experts_per_tok <= cfg.num_experts:
            raise ValueError(
                f"a MoE model needs 0 < num_experts_per_tok <= num_experts, got "
                f"{cfg.num_experts_per_tok} and {cfg.num_experts}"
            )
        if cfg.num_experts and cfg.num_experts % cfg.n_group:
            raise ValueError(f"{cfg.num_experts} experts do not split into {cfg.n_group} groups")

    @staticmethod
    def softmax_scale(cfg: ModelConfig) -> float:
        """V2: ``(dn + dr)^-0.5``, as HF's ``DeepseekV2Attention`` and the JAX
        package."""
        return float(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5

    @property
    def mla_latent_dim(self) -> int:
        return self.cfg.kv_lora_rank + self.cfg.qk_rope_head_dim

    def _make_layer(self, l: int, device, dtype) -> nn.Module:
        """Norms and the MLA projections; then a dense SwiGLU (``gate``,
        ``up``, ``down``) or the router, the routed expert stacks and the
        shared experts (``shared_*``); ``layer.moe`` says which."""
        cfg, n = self.cfg, self.tp_size
        H, Hq, E = cfg.hidden_size, cfg.num_attention_heads // n, cfg.num_experts
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        lin = lambda n_in, n_out: _linear(n_in, n_out, False, device, dtype)
        vec = lambda *shape: nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))
        layer = nn.Module()
        layer.input_norm, layer.post_norm = vec(H), vec(H)
        if qr:
            layer.wq_a, layer.q_norm, layer.wq_b = lin(H, qr), vec(qr), lin(qr, Hq * (dn + dr))
        else:
            layer.wq = lin(H, Hq * (dn + dr))
        layer.wkv_a, layer.kv_norm = lin(H, r + dr), vec(r)
        layer.w_uk, layer.w_uv = vec(Hq, dn, r), vec(Hq, r, dv)
        layer.wo = lin(Hq * dv, H)
        layer.moe = l >= self.n_dense
        if not layer.moe:
            I = cfg.intermediate_size // n
            layer.gate, layer.up, layer.down = lin(H, I), lin(H, I), lin(I, H)
            return layer
        Im = self.intermediate_size // n
        layer.router = lin(H, E)
        if self.noaux_tc:
            # f32, as HF and the JAX package keep it: a bf16 bias can flip a
            # near-tie pick
            layer.router_bias = nn.Parameter(torch.zeros(E, device=device, dtype=torch.float32))
        layer.w1 = expert_stack(E, H, Im, None, device, dtype)
        layer.w3 = expert_stack(E, H, Im, None, device, dtype)
        layer.w2 = expert_stack(E, Im, H, None, device, dtype)
        if cfg.n_shared_experts:
            Is = Im * cfg.n_shared_experts
            layer.shared_gate, layer.shared_up, layer.shared_down = lin(H, Is), lin(H, Is), lin(Is, H)
        return layer

    def _init_extra_(self, name: str, p: torch.Tensor, generator, place=None) -> None:
        if name.rsplit(".", 1)[-1] not in ("w_uk", "w_uv"):
            return super()._init_extra_(name, p, generator, place)
        fill_random(p, name, generator, self.tp, self.tp_family, fan_in_dim=-2, place=place)

    # ---------------------------------------------------------------- routing

    def _moe(self, h: torch.Tensor, layer) -> torch.Tensor:
        """The routed experts, masked and dense, plus the shared experts
        (JAX ``deepseek.py:405-457``); under tensor parallelism a rank's
        partial sum of both."""
        cfg = self.cfg
        E = cfg.num_experts
        T = h.shape[0]
        logits = h.float() @ layer.router.weight.float().T  # [T, E]
        if self.noaux_tc:
            scores = torch.sigmoid(logits)
            biased = scores + layer.router_bias.float()[None, :]
            best = torch.topk(biased.view(T, cfg.n_group, -1), 2, dim=-1).values.sum(dim=-1)
            keep = group_mask(biased, best, cfg.topk_group)
            topi = self.top_experts(torch.where(keep > 0, biased, 0.0))
            topv = scores.gather(1, topi)
            if cfg.norm_topk_prob:
                topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            scores = torch.softmax(logits, dim=-1)
            if cfg.topk_method == "group_limited_greedy":
                best = scores.view(T, cfg.n_group, -1).max(dim=-1).values
                scores = scores * group_mask(scores, best, cfg.topk_group)
            topi = self.top_experts(scores)
            topv = scores.gather(1, topi)  # no renormalisation (HF DeepseekV2MoEGate)
        w = routing_weights(topv * cfg.routed_scaling_factor, topi, E, h.dtype)
        act = silu_mul(torch.matmul(h, layer.w1), torch.matmul(h, layer.w3))  # [E, T, Im]
        y = weighted_sum(torch.matmul(act, layer.w2), w)
        if cfg.n_shared_experts:
            y = y + layer.shared_down(silu_mul(layer.shared_gate(h), layer.shared_up(h)))
        return y

    # ---------------------------------------------------------------- weights

    HF_LAYER_MAP = {
        "self_attn.q_proj.weight": "wq.weight",
        "self_attn.q_a_proj.weight": "wq_a.weight",
        "self_attn.q_a_layernorm.weight": "q_norm",
        "self_attn.q_b_proj.weight": "wq_b.weight",
        "self_attn.kv_a_proj_with_mqa.weight": "wkv_a.weight",
        "self_attn.kv_a_layernorm.weight": "kv_norm",
        "self_attn.o_proj.weight": "wo.weight",
        "input_layernorm.weight": "input_norm",
        "post_attention_layernorm.weight": "post_norm",
        "mlp.gate_proj.weight": "gate.weight",
        "mlp.up_proj.weight": "up.weight",
        "mlp.down_proj.weight": "down.weight",
        "mlp.gate.weight": "router.weight",
        "mlp.gate.e_score_correction_bias": "router_bias",
        "mlp.shared_experts.gate_proj.weight": "shared_gate.weight",
        "mlp.shared_experts.up_proj.weight": "shared_up.weight",
        "mlp.shared_experts.down_proj.weight": "shared_down.weight",
    }
    HF_EXPERT_NAMES = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}

    def _convert_layer(self, l, sub, t, out, experts) -> bool:
        cfg = self.cfg
        if sub in self.HF_LAYER_MAP:
            out[f"layers.{l}.{self.HF_LAYER_MAP[sub]}"] = t
        elif sub == "self_attn.kv_b_proj.weight":
            # [Hq (dn + dv), r]: each head's W_UK rows, then its W_UV rows
            kvb = t.reshape(cfg.num_attention_heads, cfg.qk_nope_head_dim + cfg.v_head_dim, -1)
            out[f"layers.{l}.w_uk"] = kvb[:, : cfg.qk_nope_head_dim].contiguous()
            out[f"layers.{l}.w_uv"] = kvb[:, cfg.qk_nope_head_dim :].transpose(1, 2).contiguous()
        elif sub.startswith("mlp.experts."):
            e, name, leaf = sub[len("mlp.experts."):].split(".")
            if leaf != "weight" or name not in self.HF_EXPERT_NAMES:
                return False
            experts.setdefault((self.HF_EXPERT_NAMES[name], l), {})[int(e)] = t.T.contiguous()
        else:
            return False
        return True

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """HF names onto this module's; ``kv_b_proj`` split into ``w_uk`` and
        ``w_uv``; the correction bias stays f32 whatever ``dtype``."""
        out = super().convert_hf_state(state)
        return {
            k: v.float() if k.endswith("router_bias") else v if dtype is None else v.to(dtype)
            for k, v in out.items()
        }

    # ---------------------------------------------------------------- forward

    def latent_attention(self, l: int, layer, q_nope, q_rope, kv: KVCache, meta: ForwardMeta,
                         spans) -> torch.Tensor:
        """[T, Hq, dv] in the model dtype: W_UK absorbed into the query,
        attention over the latent pool, the weighted latent expanded with
        W_UV. The absorbed query and the weighted latent stay in f32 and the
        output is rounded once, as the attention kernels round only theirs
        (the JAX package rounds both to the model dtype; the same in f32)."""
        q_lat = torch.einsum("thn,hnr->thr", q_nope.float(), layer.w_uk.float())
        lat = mla_attention(q_lat, q_rope, kv, l, meta, sm_scale=self.sm_scale, spans=spans)
        return torch.einsum("thr,hrv->thv", lat, layer.w_uv.float()).to(q_nope.dtype)

    def _attention(self, l, layer, h, meta, kv, cos, sin, spans) -> torch.Tensor:
        cfg = self.cfg
        T, Hq, eps = h.shape[0], cfg.num_attention_heads // self.tp_size, cfg.rms_norm_eps
        dn, dr, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        if cfg.q_lora_rank:
            q = layer.wq_b(rms_norm(layer.wq_a(h), layer.q_norm, eps))
        else:
            q = layer.wq(h)
        q = q.view(T, Hq, dn + dr)
        q_nope, q_rope = q[..., :dn], apply_rope_interleaved(q[..., dn:], cos, sin)
        ckv = layer.wkv_a(h)  # [T, r + dr]
        c = rms_norm(ckv[:, :r], layer.kv_norm, eps)
        k_rope = apply_rope_interleaved(ckv[:, None, r:], cos, sin)[:, 0]
        write_latent(kv, torch.cat([c, k_rope], dim=-1), l, meta.out_cache_loc)
        attn = self.latent_attention(l, layer, q_nope, q_rope, kv, meta, spans)
        return self.o_proj(layer, attn.reshape(T, Hq * cfg.v_head_dim))

    def forward(self, meta: ForwardMeta, kv: KVCache) -> torch.Tensor:
        cfg = self.cfg
        eps = cfg.rms_norm_eps
        cos, sin = rope_cos_sin(meta.positions, self.inv_freq)
        if self.rope_scale != 1.0:
            cos, sin = cos * self.rope_scale, sin * self.rope_scale
        # an extend's sequence bounds come to the host once a forward
        spans = None if meta.mode == ForwardMode.DECODE else extend_spans(meta)
        x = vocab_lookup(self.embed, meta.tokens, self.tp)  # [T, H]
        for l, layer in enumerate(self.layers):
            x = x + self._attention(l, layer, rms_norm(x, layer.input_norm, eps), meta, kv, cos, sin, spans)
            h2 = rms_norm(x, layer.post_norm, eps)
            if layer.moe:
                x = x + self.moe_sum(self._moe(h2, layer))
            else:
                x = x + row_parallel_sum(layer.down(silu_mul(layer.gate(h2), layer.up(h2))), self.tp)
        h = rms_norm(x, self.final_norm, eps)
        if meta.capture_all_hidden:
            return h  # [T, H], for sequence scoring
        last = h[meta.last_token_idx]  # [B, H]
        if meta.capture_hidden:
            return last
        return self.head_logits(last)


class DeepseekV3ForCausalLM(DeepseekV2ForCausalLM):
    """V3 and R1: V2's MLA with the sigmoid ``noaux_tc`` router (HF
    ``DeepseekV3TopkRouter``) and HF V3's softmax scale under YaRN."""

    noaux_tc = True

    @staticmethod
    def softmax_scale(cfg: ModelConfig) -> float:
        """``(dn + dr)^-0.5``, times ``mscale(factor, mscale_all_dim)^2`` where
        ``rope_scaling`` carries ``mscale_all_dim`` (HF
        ``DeepseekV3Attention``)."""
        scale = float(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
        rs = cfg.rope_scaling
        if rs and rs.get("mscale_all_dim"):
            scale *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
        return scale
