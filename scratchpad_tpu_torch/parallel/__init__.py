"""Tensor parallelism for the port: one process a rank.

Counterpart of ``scratchpad_tpu/parallel/__init__.py::mesh_from_args``. The
JAX package drives one device mesh from a single controller; here each
tensor-parallel rank is a process of its own (``parallel/multihost.py``:
rank 0 leads, the others replay its runner commands), and ``TPGroup`` is
what a rank knows of the others: its rank and the group's size, its device
(``cuda:{rank % device_count}``, or the CPU where the caller asks for it)
and the ``torch.distributed`` process group. The backend follows from where
the ranks are placed: ``nccl`` when every rank has a device of its own,
``gloo`` when ranks share a device or run on the CPU (NCCL refuses two
ranks on one GPU; gloo stages CUDA tensors through host memory). It is
never chosen by retrying after a failure.

Each family's layout is its JAX ``param_specs``, shard for shard
(``TP_LAYOUTS``, one table a family, named by the model class's
``tp_family``): the projections into the heads and the MLP (q, k, v, gate,
up, their biases; DeepSeek's ``wq``/``wq_b``, ``w_uk`` and ``w_uv`` by q
head) split by output column, whole heads to a rank; o and down split by
input row, their partial products summed over the group
(``TPGroup.row_sum``); an expert stack ``[E, In, Out]`` split by each
expert's width (w1 and w3 by Out, w2 by In), Llama-4's fused gate|up
stack by each half's width (``HALVES``: a rank holds its share of the gate
columns, then its share of the up columns); the embedding and an untied
head split by vocabulary row, the vocabulary padded up to a multiple of
the group's size; the norms, the routers, GPT-OSS's experts and sinks and
DeepSeek's latent path (``wkv_a``, ``wq_a``) replicated. ``shard_tensor``
cuts one tensor of the single-device state into a rank's shard.

Quantized weights (the Llama family, Mixtral, Qwen3-MoE and GPT-OSS, JAX
``quant_param_specs`` and ``fp8_param_specs``) take the layout of the
weight they quantize (``quant_kind``), and are cut in the port's packed
layout (``ops/quant/w4_matmul.py``): a W4 column shard is rows of ``q``
and columns of ``s`` and ``z``, the real columns only, padded again to the
rank's stored width; a row shard is byte columns of ``q`` and group rows of
``s`` and ``z``, the stored width whole (``cut_w4``); Llama's fused 4-bit
gate|up is cut by ``HALVES``. fp8 codes ``w8`` ([In, Out], or [E, In, Out])
split by Out or by In; their f32 scales by Out, or whole on every rank for
a row shard, since each is the whole column's (``cut_fp8``). A quantized
tensor is always the whole tensor's quantization, cut afterwards.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Any, Optional

import torch

# Llama-4's fused gate|up stack [E, H, 2I]: each half split along its
# dimension 2
HALVES = ("halves", 2)
_NORMS = dict.fromkeys(("input_norm", "post_norm", "q_norm", "k_norm"))
# a family's layer tensors, by name past ``layers.{l}.`` -> the dimension
# split across ranks: 0 by output column ([out, in] weights and [out]
# biases), 1 by input row; an expert stack [E, In, Out] 2 by Out, 1 by In;
# None: replicated. Each is its JAX class's ``param_specs``.
TP_LAYOUTS = {
    # Llama, Mistral, Qwen2, Qwen3, Phi-3 (JAX llama.py:116-143)
    "llama": {
        "wq.weight": 0, "wk.weight": 0, "wv.weight": 0, "gate.weight": 0, "up.weight": 0,
        "wq.bias": 0, "wk.bias": 0, "wv.bias": 0, "wo.weight": 1, "down.weight": 1, **_NORMS,
    },
    # JAX apertus.py:87-107
    "apertus": {
        "wq.weight": 0, "wk.weight": 0, "wv.weight": 0, "up.weight": 0, "wo.weight": 1, "down.weight": 1,
        "attn_norm": None, "ffw_norm": None, "q_norm": None, "k_norm": None, "alpha_p": None, "alpha_n": None,
    },
    # Gemma 2 and 3 (JAX gemma.py:139-161)
    "gemma": {
        "wq.weight": 0, "wk.weight": 0, "wv.weight": 0, "gate.weight": 0, "up.weight": 0,
        "wo.weight": 1, "down.weight": 1, "post_attn_norm": None, "pre_ffw_norm": None,
        "post_ffw_norm": None, **_NORMS,
    },
    # Mixtral and Qwen3-MoE without EP (JAX mixtral.py:102-134)
    "mixtral": {
        "wq.weight": 0, "wk.weight": 0, "wv.weight": 0, "wo.weight": 1, "router.weight": None,
        "w1": 2, "w3": 2, "w2": 1, **_NORMS,
    },
    # GPT-OSS: the experts, the router and their biases replicated, o's
    # bias too (JAX gpt_oss.py:140-163)
    "gpt_oss": {
        "wq.weight": 0, "wk.weight": 0, "wv.weight": 0, "wq.bias": 0, "wk.bias": 0, "wv.bias": 0,
        "wo.weight": 1, "wo.bias": None, "sinks": None, "router.weight": None, "router.bias": None,
        "gate_up": None, "gate_up_b": None, "down": None, "down_b": None, **_NORMS,
    },
    # Llama-4 text (JAX llama4.py:122-150)
    "llama4": {
        "wq.weight": 0, "wk.weight": 0, "wv.weight": 0, "wo.weight": 1, "router.weight": None,
        "gate_up": HALVES, "down": 1, "s_gate.weight": 0, "s_up.weight": 0, "s_down.weight": 1,
        "gate.weight": 0, "up.weight": 0, "down_d.weight": 1, **_NORMS,
    },
    # DeepSeek-V2 and V3 (JAX deepseek.py:191-236): q heads, the latent
    # path replicated
    "deepseek": {
        "wq.weight": 0, "wq_b.weight": 0, "wq_a.weight": None, "wkv_a.weight": None, "kv_norm": None,
        "w_uk": 0, "w_uv": 0, "wo.weight": 1, "gate.weight": 0, "up.weight": 0, "down.weight": 1,
        "router.weight": None, "router_bias": None, "w1": 2, "w3": 2, "w2": 1,
        "shared_gate.weight": 0, "shared_up.weight": 0, "shared_down.weight": 1, **_NORMS,
    },
}
# the families whose classes serve quantized weights, and the buffers of a
# quantized module: W4's q, s, z (ops/quant/w4_matmul.py) and fp8's w8, s
QUANT_FAMILIES = ("llama", "mixtral", "gpt_oss")
QUANT_PARTS = ("q", "s", "z", "w8")
# a W4 column past a stored width's real columns: code bytes 0x88 (nibbles
# of 0, as quantize_stacked's padding packs), scale 1, zero 0
W4_PAD = {"q": 0x88, "s": 1.0, "z": 0.0}
VOCAB_SPLITS = ("embed.weight", "lm_head.weight")  # split by vocabulary row, padded
REPLICATED = ("final_norm",)
# seconds a rank waits for another (the rendezvous, a collective, a
# follower's reply, a follower's exit at shutdown) before it raises
DIST_TIMEOUT_S = 300.0


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port that was free on ``host`` a moment ago."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def vocab_rows(vocab_size: int, size: int) -> int:
    """Vocabulary rows a rank holds: V padded up to a multiple of the
    group's size, over the size."""
    return -(-vocab_size // size)


def quant_kind(key: str, layout: dict):
    """How the quantized module ``key`` (``wq``, ``w1``, Llama's fused
    ``gate_up``) splits, from the layout of the weight it quantizes:
    ``"column"``, ``"row"``, ``"halves"`` or None (whole on every rank); a
    key with no such weight raises KeyError."""
    if f"{key}.weight" in layout:  # an [out, in] weight: 0 by column, 1 by row
        return {0: "column", 1: "row", None: None}[layout[f"{key}.weight"]]
    if key in layout:  # an expert stack [E, In, Out]
        return {2: "column", 1: "row", None: None, HALVES: "halves"}[layout[key]]
    if key == "gate_up" and layout.get("gate.weight") == 0:  # Llama's fused 4-bit gate|up
        return "halves"
    raise KeyError(key)


def split_of(name: str, family: str = "llama"):
    """How ``family`` splits the single-device tensor ``name``: ``"vocab"``,
    a dimension, ``HALVES``, None (replicated), or for a quantized module's
    buffer (``QUANT_PARTS``, past an expert's index) ``("quant", kind,
    part)`` with ``quant_kind``'s kind. A name with no layout raises."""
    if name in VOCAB_SPLITS:
        return "vocab"
    if name in REPLICATED:
        return None
    key = name.split(".", 2)[2] if name.startswith("layers.") else name
    layout = TP_LAYOUTS[family]
    if key in layout:
        return layout[key]
    module, _, part = key.rpartition(".")
    if part in QUANT_PARTS and module:
        module_key = module.rsplit(".", 1)[0] if module.rsplit(".", 1)[-1].isdigit() else module
        try:
            return ("quant", quant_kind(module_key, layout), part)
        except KeyError:
            pass
    raise KeyError(f"{name}: no tensor-parallel layout in the {family} family's table")


def _pad_to(t: torch.Tensor, dim: int, width: int, value) -> torch.Tensor:
    """``t`` padded along ``dim`` to ``width`` with ``value``."""
    pad = width - t.shape[dim]
    if pad <= 0:
        return t.contiguous()
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_full(shape, value)], dim).contiguous()


def cut_w4(t: torch.Tensor, part: str, kind, rank: int, size: int, out_true: int = 0,
           name: str = "tensor") -> torch.Tensor:
    """Rank ``rank``'s part of one buffer of a packed W4 weight (``part`` q
    [N, Kp/2], s or z [G, N]) under ``kind`` (``quant_kind``). ``out_true``:
    the real columns of a padded stored width N (0: all N are). Column and
    halves: the real columns' rank share (halves: of each half, joined),
    padded again to the rank's stored width (``stacked_out_width``) with
    ``W4_PAD``; row: the rank's In slice, bytes of q and group rows of s and
    z, the stored width whole. A width the group does not divide, or a row
    share that is not whole groups of whole 32-row steps, raises."""
    from scratchpad_tpu_torch.ops.quant.w4_matmul import K_ALIGN
    from scratchpad_tpu_torch.ops.quant.w4a16 import stacked_out_width

    if kind is None:
        return t.clone()
    col_dim = 0 if part == "q" else 1
    if kind == "row":
        dim = 1 if part == "q" else 0
        n = t.shape[dim]
        if n % size or (part == "q" and (n // size * 2) % K_ALIGN):
            raise ValueError(f"{name}: {tuple(t.shape)} does not split by In into {size} ranks of whole "
                             f"groups and {K_ALIGN}-row steps")
        return t.chunk(size, dim)[rank].contiguous()
    real = out_true or t.shape[col_dim]
    cols = t.narrow(col_dim, 0, real)
    halves = kind == "halves"
    if real % (2 * size if halves else size):
        raise ValueError(f"{name}: {real} real columns do not split into {size}")
    if halves:
        share = torch.cat([h.chunk(size, col_dim)[rank] for h in cols.chunk(2, col_dim)], col_dim)
    else:
        share = cols.chunk(size, col_dim)[rank]
    return _pad_to(share, col_dim, stacked_out_width(real // size)[0], W4_PAD[part])


def cut_fp8(t: torch.Tensor, part: str, kind, rank: int, size: int, name: str = "tensor") -> torch.Tensor:
    """Rank ``rank``'s part of an fp8 weight's codes (``part`` w8: [In, Out],
    an expert stack [E, In, Out]) or f32 scales (s: [Out], [E, Out]) under
    ``kind``: codes by Out (column) or In (row), scales by Out, or whole
    for a row shard (each scale is its whole column's)."""
    if kind is None or (kind == "row" and part == "s"):
        return t.clone()
    if kind not in ("column", "row"):
        raise ValueError(f"{name}: fp8 weights are cut by column or row, not {kind}")
    dim = -2 if kind == "row" else -1
    if t.shape[dim] % size:
        raise ValueError(f"{name}: {tuple(t.shape)} does not split into {size}")
    return t.chunk(size, dim)[rank].contiguous()


def cut(t: torch.Tensor, split, rank: int, size: int, name: str = "tensor", out_true: int = 0) -> torch.Tensor:
    """Rank ``rank``'s part of ``t`` under ``split`` (``split_of``), a tensor
    of its own (never a view of ``t``). A vocabulary shard past V is zero
    rows; ``HALVES`` cuts each half of its dimension and joins the rank's
    two shares, first half first; a quantized buffer goes to ``cut_fp8``
    (codes ``w8``, and f32 scales) or ``cut_w4`` (``out_true``: its real
    columns). A dimension the group does not divide raises."""
    if size == 1:
        return t
    if split is None:
        return t.clone()
    if isinstance(split, tuple) and split[0] == "quant":
        _, kind, part = split
        if part == "w8" or (part == "s" and t.dtype == torch.float32):  # fp8's scales are f32, W4's bf16
            return cut_fp8(t, part, kind, rank, size, name)
        return cut_w4(t, part, kind, rank, size, out_true, name)
    if split == "vocab":
        rows = vocab_rows(t.shape[0], size)
        part = t[rank * rows : (rank + 1) * rows]
        pad = t.new_zeros((rows - part.shape[0],) + tuple(t.shape[1:]))
        return torch.cat([part, pad])
    halves = isinstance(split, tuple)
    dim = split[1] if halves else split
    if t.shape[dim] % (2 * size if halves else size):
        raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} does not split into {size}")
    if halves:
        return torch.cat([h.chunk(size, dim)[rank] for h in t.chunk(2, dim)], dim)
    return t.chunk(size, dim)[rank].clone()


def copy_cut_(dst: torch.Tensor, t: torch.Tensor, split, rank: int, size: int, name: str = "tensor") -> None:
    """``dst.copy_(cut(t, split, rank, size))``, through a view of ``t``
    where the rank's part is one (the whole, a dimension's chunk, a range of
    vocabulary rows): no copy of the part is made, so a rank that loads one
    whole tensor at a time holds ``t`` and its shards, nothing more. ``dst``
    may be of another dtype than ``t``."""
    if size == 1 or split is None:
        dst.copy_(t)
    elif split == "vocab":
        rows = vocab_rows(t.shape[0], size)
        part = t[rank * rows : (rank + 1) * rows]
        dst[part.shape[0] :].zero_()
        dst[: part.shape[0]].copy_(part)
    elif isinstance(split, int):
        if t.shape[split] % size:
            raise ValueError(f"{name}: dimension {split} of {tuple(t.shape)} does not split into {size}")
        dst.copy_(t.chunk(size, split)[rank])
    else:
        dst.copy_(cut(t, split, rank, size, name))


def shard_tensor(name: str, t: torch.Tensor, rank: int, size: int, family: str = "llama",
                 out_true: int = 0) -> torch.Tensor:
    """Rank ``rank``'s shard of ``t``, the single-device state's tensor
    ``name`` (a ``state_dict`` name of ``family``, a key of
    ``TP_LAYOUTS``; ``out_true``: a padded W4 buffer's real columns)."""
    return t if size == 1 else cut(t, split_of(name, family), rank, size, name, out_true)


def full_shape(name: str, shard: tuple, size: int, vocab_size: int, family: str = "llama") -> tuple:
    """The single-device shape of the tensor ``name`` whose rank shard has
    the shape ``shard``."""
    split = split_of(name, family)
    shape = list(shard)
    if split == "vocab":
        shape[0] = vocab_size
    elif split is not None:
        shape[split[1] if isinstance(split, tuple) else split] *= size
    return tuple(shape)


def tp_family(cfg) -> str:
    """The ``TP_LAYOUTS`` key of ``cfg``'s model class; the vision classes
    raise, naming their ROADMAP item."""
    from scratchpad_tpu_torch.models.registry import get_model_class

    cls = get_model_class(cfg.architecture)
    if cfg.multimodal or getattr(cls, "is_multimodal", False):
        raise NotImplementedError(
            f"tensor parallelism for {cfg.architecture}: the vision models need the leader to relay "
            "image encoding to the followers (ROADMAP Queue 1, item 10(c))"
        )
    return cls.tp_family


def split_widths(cfg, family: str) -> dict:
    """The widths a ``family`` model splits over the group, by name: kv
    heads (query heads for MLA, whose pool holds one latent row), the MLP,
    each expert's width and the shared experts'."""
    if family == "deepseek":
        widths = {"num_attention_heads": cfg.num_attention_heads}
        n_dense = cfg.first_k_dense_replace if cfg.num_experts else cfg.num_hidden_layers
        if n_dense:
            widths["intermediate_size"] = cfg.intermediate_size
        if cfg.num_experts:
            Im = cfg.moe_intermediate_size or cfg.intermediate_size
            widths["moe_intermediate_size"] = Im
            if cfg.n_shared_experts:
                widths["shared experts' width"] = Im * cfg.n_shared_experts
        return widths
    widths = {"num_key_value_heads": cfg.num_kv_heads}
    if family == "mixtral":
        widths["moe_intermediate_size"] = cfg.moe_intermediate_size or cfg.intermediate_size
    elif family == "llama4":
        widths["intermediate_size"] = cfg.intermediate_size  # each expert's and the shared expert's
        widths["intermediate_size_mlp"] = cfg.intermediate_size_mlp or cfg.intermediate_size
    elif family != "gpt_oss":  # GPT-OSS's experts stay whole
        widths["intermediate_size"] = cfg.intermediate_size
    return widths


def row_inputs(cfg, family: str) -> dict:
    """The inputs a ``family`` model's row-parallel projections split over
    the group, by name: o's (query heads x head_dim), and down's or the
    experts' w2's (GPT-OSS's experts stay whole)."""
    widths = {"o's input (heads x head_dim)": cfg.num_attention_heads * cfg.head_dim}
    if family == "llama":
        widths["down's input (intermediate_size)"] = cfg.intermediate_size
    elif family == "mixtral":
        widths["w2's input (moe_intermediate_size)"] = cfg.moe_intermediate_size or cfg.intermediate_size
    return widths


def check_tp_model(cfg, size: int, quantization=None) -> None:
    """Refuse a model that tensor parallelism does not serve: the text
    families take it (``tp_family``) over whole kv heads (whole query heads
    for MLA) and split widths the group divides (the JAX gate ``pure_tp``,
    ``model_runner.py:242-246``); the vision classes raise, naming ROADMAP
    Queue 1, item 10(c). Quantized (``quantization``): the families of
    ``QUANT_FAMILIES`` only, and under a 4-bit route each rank's share of a
    row-parallel input (``row_inputs``) whole groups of the layer's group
    size and whole ``K_ALIGN`` steps, so that a rank quantizes and
    multiplies its slice alone. Raises before any rank starts."""
    if size == 1:
        return
    family = tp_family(cfg)
    bad = {k: w for k, w in split_widths(cfg, family).items() if w % size}
    if bad:
        raise ValueError(
            f"tp_size={size} must divide " + ", ".join(f"{k} ({w})" for k, w in bad.items())
            + ": each rank holds whole kv heads and an equal share of each split width"
        )
    if quantization is None:
        return
    if family not in QUANT_FAMILIES:
        raise NotImplementedError(
            f"quantization={quantization!r} for {cfg.architecture}: its class serves no quantized "
            "weights at any tp_size, as its JAX class reads none"
        )
    if quantization == "fp8":  # per-column scales over the whole input, no groups; the rest are W4
        return
    from scratchpad_tpu_torch.ops.quant.w4_matmul import K_ALIGN
    from scratchpad_tpu_torch.ops.quant.w4a16 import stacked_group_size

    split = {}
    for k, w in row_inputs(cfg, family).items():
        g = stacked_group_size(w)
        if (w // size) % g or (w // size) % K_ALIGN:
            split[k] = (w, g)
    if split:
        raise ValueError(
            f"quantization={quantization!r} at tp_size={size}: a rank's share of "
            + ", ".join(f"{k} {w} / {size} = {w // size} is not whole groups of {g} and of {K_ALIGN}"
                        for k, (w, g) in split.items())
            + "; each rank quantizes and multiplies whole groups of its slice"
        )


def placement(device: str, rank: int, size: int) -> tuple[torch.device, str, int]:
    """(the rank's device, the backend, ranks on that device): the CPU for
    ``device="cpu"``, else ``cuda:{rank % device_count}``; ``nccl`` where
    every rank has a device of its own, ``gloo`` otherwise."""
    if device == "cpu":
        return torch.device("cpu"), "gloo", size
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but no CUDA device is available")
    n = torch.cuda.device_count()
    here = sum(1 for r in range(size) if r % n == rank % n)
    return torch.device("cuda", rank % n), "nccl" if size <= n else "gloo", here


@dataclasses.dataclass
class TPGroup:
    """One rank's view of its tensor-parallel group. ``ctrl``: the
    control plane (``multihost.ControlPlane``) whose handshake ``barrier``
    uses, so that a rank that died is reported within its timeout;
    ``collectives`` counts the collectives this rank issued."""

    rank: int
    size: int
    device: torch.device
    backend: str
    ranks_on_device: int
    ctrl: Any = None
    collectives: int = 0

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or its minimum or maximum taken: ``op`` "min",
        "max") over the group, in place."""
        import torch.distributed as dist

        ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
        self.collectives += 1
        dist.all_reduce(t, op=ops[op])
        return t

    def row_sum(self, y: torch.Tensor) -> torch.Tensor:
        """The sum over the group of a row-parallel projection's partial
        products ``y``, summed in f32 and returned in ``y``'s dtype."""
        return self.all_reduce(y.float()).to(y.dtype)

    def gather_vocab(self, local: torch.Tensor, vocab_size: int) -> torch.Tensor:
        """Each rank's vocabulary columns ``local`` f32 [N, rows] joined into
        f32 [N, vocab_size] on every rank, the padded columns dropped. One
        ``all_gather_into_tensor`` into [size * N, rows], rank-major: exact,
        so bit-equal on every rank."""
        import torch.distributed as dist

        N, rows = local.shape
        out = local.new_empty(self.size * N, rows)
        self.collectives += 1
        dist.all_gather_into_tensor(out, local.contiguous())
        return out.view(self.size, N, rows).permute(1, 0, 2).reshape(N, self.size * rows)[:, :vocab_size].contiguous()

    def min_int(self, n: int) -> int:
        """The minimum of ``n`` over the group."""
        t = torch.tensor([n], dtype=torch.int64, device=self.device)
        return int(self.all_reduce(t, op="min")[0])

    def barrier(self, tag: str = "barrier") -> None:
        """Every rank has reached this point: the followers report to the
        leader over the control plane, which raises within its timeout
        where a follower died or raised on the way."""
        if self.ctrl is None:
            self.min_int(0)
        elif self.rank == 0:
            self.ctrl.gather(tag)
        else:
            self.ctrl.send_up((tag, None))

    def close(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def init_tp_group(args, rank: int, ctrl=None) -> Optional[TPGroup]:
    """The rank's ``TPGroup`` from ``ServerArgs`` (``tp_size``,
    ``dist_init_addr``, ``device``), after the process group's rendezvous
    (``DIST_TIMEOUT_S``); None at tp 1. One group a process."""
    size = args.tp_size
    if size == 1:
        return None
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process holds one tensor-parallel engine at a time")
    device, backend, here = placement(args.device, rank, size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{args.dist_init_addr}", world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S),
    )
    return TPGroup(rank, size, device, backend, here, ctrl)


__all__ = [
    "DIST_TIMEOUT_S", "HALVES", "QUANT_FAMILIES", "TPGroup", "TP_LAYOUTS", "check_tp_model", "cut", "cut_fp8",
    "cut_w4", "free_port", "full_shape", "init_tp_group", "placement", "quant_kind", "row_inputs", "shard_tensor",
    "split_of", "split_widths", "tp_family", "vocab_rows",
]
