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

The layout is ``LlamaForCausalLM.param_specs``'s (JAX ``models/llama.py``
:116-143): q, k, v, gate and up (and the q, k, v biases) split by output
column, whole heads to a rank; o and down split by input row, their partial
products summed over the group (``TPGroup.all_reduce``); the embedding and
an untied head split by vocabulary row, the vocabulary padded up to a
multiple of the group's size; the norms replicated. ``shard_tensor`` cuts
one tensor of the single-device state into a rank's shard.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Any, Optional

import torch

# a layer tensor's name past ``layers.{l}.`` -> the dimension split across
# ranks: 0 by output column ([out, in] weights and [out] biases), 1 by
# input row; None: replicated
LAYER_SPLITS = {
    "wq.weight": 0, "wk.weight": 0, "wv.weight": 0, "gate.weight": 0, "up.weight": 0,
    "wq.bias": 0, "wk.bias": 0, "wv.bias": 0,
    "wo.weight": 1, "down.weight": 1,
    "input_norm": None, "post_norm": None, "q_norm": None, "k_norm": None,
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


def shard_tensor(name: str, t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``t``, the single-device state's tensor
    ``name`` (a ``state_dict`` name of the Llama family), as a tensor of
    its own (never a view of ``t``). A vocabulary shard past V is zero rows.
    A name with no layout, or a dimension that the group does not divide,
    raises."""
    if size == 1:
        return t
    if name in VOCAB_SPLITS:
        rows = vocab_rows(t.shape[0], size)
        part = t[rank * rows : (rank + 1) * rows]
        pad = t.new_zeros((rows - part.shape[0],) + tuple(t.shape[1:]))
        return torch.cat([part, pad])
    if name in REPLICATED:
        return t.clone()
    key = name.split(".", 2)[2] if name.startswith("layers.") else name
    if key not in LAYER_SPLITS:
        raise KeyError(f"{name}: no tensor-parallel layout (the Llama family's tensors only)")
    dim = LAYER_SPLITS[key]
    if dim is None:
        return t.clone()
    if t.shape[dim] % size:
        raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} does not split into {size}")
    return t.chunk(size, dim)[rank].clone()


def check_tp_model(cfg, size: int) -> None:
    """Refuse a model that tensor parallelism does not serve yet: the
    classes that run ``models/llama.py::decoder_layers`` (Llama, Mistral,
    Qwen2, Qwen3) take it, over whole kv heads and an MLP width the group
    divides (the JAX gate ``pure_tp``, ``model_runner.py:242-246``)."""
    if size == 1:
        return
    from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
    from scratchpad_tpu_torch.models.qwen import Qwen2ForCausalLM, Qwen3ForCausalLM
    from scratchpad_tpu_torch.models.registry import get_model_class

    cls = get_model_class(cfg.architecture)
    if cls not in (LlamaForCausalLM, Qwen2ForCausalLM, Qwen3ForCausalLM) or cfg.multimodal:
        raise NotImplementedError(
            f"tp_size={size} for {cfg.architecture}: tensor parallelism serves the Llama family "
            "(Llama, Mistral, Qwen2, Qwen3) only so far (ROADMAP Queue 1, item 10(a))"
        )
    if cfg.num_kv_heads % size or cfg.intermediate_size % size:
        raise ValueError(
            f"tp_size={size} must divide num_key_value_heads ({cfg.num_kv_heads}) and "
            f"intermediate_size ({cfg.intermediate_size}): each rank holds whole kv heads"
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
    "DIST_TIMEOUT_S", "TPGroup", "check_tp_model", "free_port", "init_tp_group", "placement", "shard_tensor",
    "vocab_rows",
]
