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


def split_of(name: str, family: str = "llama"):
    """How ``family`` splits the single-device tensor ``name``: ``"vocab"``,
    a dimension, ``HALVES`` or None (replicated). A name with no layout
    raises."""
    if name in VOCAB_SPLITS:
        return "vocab"
    if name in REPLICATED:
        return None
    key = name.split(".", 2)[2] if name.startswith("layers.") else name
    layout = TP_LAYOUTS[family]
    if key not in layout:
        raise KeyError(f"{name}: no tensor-parallel layout in the {family} family's table")
    return layout[key]


def cut(t: torch.Tensor, split, rank: int, size: int, name: str = "tensor") -> torch.Tensor:
    """Rank ``rank``'s part of ``t`` under ``split`` (``split_of``), a tensor
    of its own (never a view of ``t``). A vocabulary shard past V is zero
    rows; ``HALVES`` cuts each half of its dimension and joins the rank's
    two shares, first half first. A dimension the group does not divide
    raises."""
    if size == 1:
        return t
    if split is None:
        return t.clone()
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


def shard_tensor(name: str, t: torch.Tensor, rank: int, size: int, family: str = "llama") -> torch.Tensor:
    """Rank ``rank``'s shard of ``t``, the single-device state's tensor
    ``name`` (a ``state_dict`` name of ``family``, a key of
    ``TP_LAYOUTS``)."""
    return t if size == 1 else cut(t, split_of(name, family), rank, size, name)


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


def check_tp_model(cfg, size: int) -> None:
    """Refuse a model that tensor parallelism does not serve: the text
    families take it (``tp_family``) over whole kv heads (whole query heads
    for MLA) and split widths the group divides (the JAX gate ``pure_tp``,
    ``model_runner.py:242-246``); the vision classes raise, naming ROADMAP
    Queue 1, item 10(c)."""
    if size == 1:
        return
    family = tp_family(cfg)
    bad = {k: w for k, w in split_widths(cfg, family).items() if w % size}
    if bad:
        raise ValueError(
            f"tp_size={size} must divide " + ", ".join(f"{k} ({w})" for k, w in bad.items())
            + ": each rank holds whole kv heads and an equal share of each split width"
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
        """``t`` summed (or its minimum taken) over the group, in place."""
        import torch.distributed as dist

        self.collectives += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MIN)
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
    "DIST_TIMEOUT_S", "HALVES", "TPGroup", "TP_LAYOUTS", "check_tp_model", "cut", "free_port", "full_shape",
    "init_tp_group", "placement", "shard_tensor", "split_of", "split_widths", "tp_family", "vocab_rows",
]
