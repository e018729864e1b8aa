"""What the tensor-parallel tests run inside their spawned ranks.

Spawned processes import this module by name, so it imports the port and
torch only (no JAX), as a follower does.
"""

import numpy as np
import torch

from scratchpad_tpu_torch.config.model_config import ModelConfig


def vocab_rank(rank: int, size: int, addr: str, cfg: ModelConfig, state: dict, ids, h, out) -> None:
    """Rank ``rank`` of a CPU gloo group: the tiny model's vocabulary-parallel
    embedding of ``ids`` and head logits of ``h``, from its shard of
    ``state``; rank 0 puts both on the queue ``out``."""
    import types

    from scratchpad_tpu_torch.executor.weight_loader import shard_state
    from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
    from scratchpad_tpu_torch.parallel import init_tp_group

    torch.set_num_threads(1)
    args = types.SimpleNamespace(tp_size=size, device="cpu", dist_init_addr=addr)
    group = init_tp_group(args, rank)
    try:
        model = LlamaForCausalLM(cfg, "cpu", torch.float32, tp=group)
        model.load_state_dict(shard_state(state, rank, size))
        with torch.inference_mode():
            emb = model.lookup(torch.as_tensor(ids))
            logits = model.head_logits(torch.as_tensor(h))
        if rank == 0:
            out.put((emb.numpy(), logits.numpy(), group.collectives))
    finally:
        group.close()


def _one_more_layer(kw: dict) -> ModelConfig:
    return ModelConfig(**dict(kw, num_hidden_layers=kw["num_hidden_layers"] + 1))


class LayerMoreInFollowers(ModelConfig):
    """A model config that arrives in another process with one more layer,
    so that a follower rank fails to load the leader's weights: a planted
    fault at load, with no hook in the engine."""

    def __reduce__(self):
        kw = {k: v for k, v in vars(self).items()}
        return _one_more_layer, (kw,)


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 500, n).tolist() for n in (9, 25, 14)]
