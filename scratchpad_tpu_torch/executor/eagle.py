"""EAGLE speculative drafts: a one-layer head conditioned on target features.

Counterpart of ``scratchpad_tpu/executor/eagle.py`` (EAGLE-1 style):

- the head is ``fc`` [2H -> H] plus ONE Llama decoder layer, sharing the
  target's embedding and (bf16) LM head; its input at position i is
  ``fc(concat(embed(x_{i+1}), f_i))``, where f_i is the target's hidden
  state (after the final norm) at position i. The head has no final norm.
- it keeps its own one-layer paged pool with the target's page geometry
  (the same page tables and radix lifetime).
- ``propose`` runs k greedy steps, each a decode forward through the
  decode kernel: the first step takes the TRUE last feature, later steps
  feed the head's own hidden state back. After verification the scheduler
  re-extends the accepted span with the true features (``write_pairs``), so
  the persistent draft K/V never holds pseudo-feature rows.

The JAX head's ``lax.scan`` is a Python loop here; the drafts come to the
host once, after the k steps.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
from torch import nn

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import create_kv_cache
from scratchpad_tpu_torch.models.llama import (
    LlamaDecoderLayer,
    LlamaForCausalLM,
    _linear,
    decoder_layers,
)
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo


class EagleRunner(nn.Module):
    """The EAGLE head (an ``nn.Module``: ``fc`` and ``layers.0``), its pool
    and its steps. It runs the Llama layer loop (``decoder_layers``) with
    the target model's rope tables, softmax scale and attention functions,
    read at each call, and owns no embedding, final norm or head: the
    target's are read too."""

    def __init__(self, target_runner, args):
        super().__init__()
        tmodel = target_runner.model
        if (
            not isinstance(tmodel, LlamaForCausalLM)
            or type(tmodel).forward is not LlamaForCausalLM.forward
            or getattr(tmodel, "is_multimodal", False)
        ):
            raise ValueError(f"eagle needs a Llama-family text target, not {type(tmodel).__name__}")
        if target_runner.model_config.logit_softcap:
            raise ValueError("eagle: soft-capped models are not supported")
        if tmodel.lm_head_q is not None:
            raise ValueError("eagle needs the bf16 LM head; the target's head is quantized")
        self.target = target_runner
        self.args = args
        cfg = copy.copy(target_runner.model_config)
        cfg.num_hidden_layers = 1
        self.cfg = cfg
        dev, dt = target_runner.device, target_runner.dtype
        H = cfg.hidden_size
        state = None
        if args.speculative_draft_model_path:
            from scratchpad_tpu_torch.executor.weight_loader import load_hf_state

            state = load_hf_state(args.speculative_draft_model_path)
        fc_bias = state is not None and any(k in state for k in ("fc.bias", "model.fc.bias"))
        self.fc = _linear(2 * H, H, fc_bias, dev, dt)
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, dev, dt)])
        if state is not None:
            self.load_state_dict(self.convert_hf_state(state, dt))
        else:
            self.init_random_(torch.Generator(device=dev).manual_seed(args.random_seed + 7))
        self.requires_grad_(False)
        self.kv_config = dataclasses.replace(
            target_runner.kv_config, num_layers=1, quantized=False,
            quant_dtype=torch.int8, dtype=dt,
        )
        self.kv_cache = create_kv_cache(self.kv_config, dev)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The layer as the model's random init; ``fc`` normal / sqrt(2H)."""
        layer = self.layers[0]
        layer.input_norm.fill_(1.0)
        layer.post_norm.fill_(1.0)
        if self.cfg.use_qk_norm:
            layer.q_norm.fill_(1.0)
            layer.k_norm.fill_(1.0)
        for lin in (layer.wq, layer.wk, layer.wv, layer.wo, layer.gate, layer.up, layer.down, self.fc):
            r = torch.randn(lin.weight.shape, generator=generator, device=lin.weight.device)
            lin.weight.copy_(r / math.sqrt(lin.in_features))
            if lin.bias is not None:
                lin.bias.zero_()

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """A trained EAGLE-1 head: ``fc.weight`` (and ``fc.bias``) and
        ``layers.0.*`` in Llama naming; the embedding and head are the
        target's and are skipped."""
        out: dict[str, torch.Tensor] = {}
        for name, w in state.items():
            t = torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w)
            if dtype is not None:
                t = t.to(dtype)
            if name in ("fc.weight", "model.fc.weight"):
                out["fc.weight"] = t  # HF [out H, in 2H], nn.Linear's orientation
            elif name in ("fc.bias", "model.fc.bias"):
                out["fc.bias"] = t
            elif ".layers." in name or name.startswith("layers."):
                idx, sub = name.split("layers.", 1)[1].split(".", 1)
                if int(idx) != 0 or sub not in LlamaForCausalLM.HF_LAYER_MAP:
                    raise KeyError(f"unmapped EAGLE weight {name}")
                out[f"layers.0.{LlamaForCausalLM.HF_LAYER_MAP[sub]}"] = t
            elif name.endswith("embed_tokens.weight") or name.endswith("lm_head.weight"):
                pass  # shared with the target
            else:
                raise KeyError(f"unmapped EAGLE weight {name}")
        if "fc.weight" not in out:
            raise KeyError("EAGLE checkpoint missing fc.weight")
        return out

    def resize_pool(self, num_pages: int) -> None:
        """Follow the target pool's new page count."""
        self.kv_cache = None
        self.kv_config = dataclasses.replace(self.kv_config, num_pages=num_pages)
        self.kv_cache = create_kv_cache(self.kv_config, self.target.device)

    # ---------------------------------------------------------------- steps

    def _head(self) -> torch.Tensor:
        tm = self.target.model
        return tm.embed.weight if tm.lm_head is None else tm.lm_head.weight

    def _layers(self, x: torch.Tensor, meta: ForwardMeta) -> torch.Tensor:
        """The head's decoder layer over ``x``, writing and reading its pool."""
        tm = self.target.model
        attend = tm.decode_attention if meta.mode == ForwardMode.DECODE else tm.extend_attention
        cos, sin = tm.rope_tables(meta, tm.inv_freq)
        return decoder_layers(self.layers, self.cfg, x, meta, self.kv_cache, cos, sin, attend, tm.sm_scale)

    def _fuse(self, tokens: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        emb = self.target.model.embed(tokens)
        return self.fc(torch.cat([emb, feats.to(emb.dtype)], dim=-1))

    def _meta(self, mode, tokens, positions, loc, ridx, pt, seq, ext):
        from scratchpad_tpu_torch.executor.model_runner import WorkerBatch

        wb = WorkerBatch(
            mode=mode, tokens=tokens, positions=positions, out_cache_loc=loc,
            req_indices=ridx, page_table=pt, seq_lens=seq, extend_lens=ext,
            sampling_info=SamplingBatchInfo.from_reqs([], len(seq), self.cfg.vocab_size),
        )
        meta, _, _ = self.target._pad_to_buckets(wb)
        return meta

    def write_pairs(self, w: dict) -> None:
        """K/V-only extend of TRUE pairs (x_{i+1}, f_i) at positions i:
        ``w`` holds tokens (the next ids) [M], positions, out_cache_loc,
        req_indices, feats [M, H] f32, and the batch's page_table, seq_lens
        and extend_lens."""
        meta = self._meta(
            ForwardMode.EXTEND, w["tokens"], w["positions"], w["out_cache_loc"],
            w["req_indices"], w["page_table"], w["seq_lens"], w["extend_lens"],
        )
        T = meta.num_tokens
        feats = np.zeros((T, w["feats"].shape[1]), np.float32)
        feats[: len(w["feats"])] = w["feats"]
        with torch.inference_mode():
            x = self._fuse(meta.tokens, self.target._upload(feats))
            self._layers(x, meta)

    def propose(
        self,
        first_tokens: np.ndarray,  # [B] the last accepted token of each request
        first_feats: np.ndarray,  # [B, H] its TRUE feature
        positions: np.ndarray,  # [B] that token's position c
        page_table: np.ndarray,  # [B, P]
        k: int,
    ) -> np.ndarray:
        """k greedy draft steps; returns the drafts [k, B]. Step j writes
        the pair at draft position c - 1 + j."""
        B_real = len(first_tokens)
        dpos0 = positions.astype(np.int64) - 1
        ps = self.target.page_size
        loc = page_table[np.arange(B_real), dpos0 // ps].astype(np.int64) * ps + dpos0 % ps
        meta = self._meta(
            ForwardMode.DECODE, first_tokens, dpos0, loc, np.arange(B_real),
            page_table, (dpos0 + 1).astype(np.int32), np.ones(B_real, np.int32),
        )
        B = meta.batch_size
        feats = np.zeros((B, first_feats.shape[1]), np.float32)
        feats[:B_real] = first_feats
        head = self._head()
        with torch.inference_mode():
            rows = torch.arange(B, device=self.target.device)
            ones = torch.ones(B, dtype=torch.int32, device=self.target.device)
            tokens, dpos, f = meta.tokens, meta.positions, self.target._upload(feats)
            drafts = []
            for _ in range(k):
                step = ForwardMeta(
                    mode=ForwardMode.DECODE, tokens=tokens, positions=dpos,
                    out_cache_loc=meta.page_table[rows, dpos // ps].long() * ps + dpos % ps,
                    req_indices=rows, page_table=meta.page_table,
                    seq_lens=(dpos + 1).to(torch.int32), extend_lens=ones, last_token_idx=rows,
                )
                h = self._layers(self._fuse(tokens, f), step)
                tokens = (h @ head.T).float().argmax(dim=-1)
                drafts.append(tokens)
                f, dpos = h, dpos + 1
            out = torch.stack(drafts).cpu().numpy()
        return out[:, :B_real]
