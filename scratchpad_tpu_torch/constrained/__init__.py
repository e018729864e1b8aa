from scratchpad_tpu_torch.constrained.backend import GrammarBackend, Grammar

__all__ = ["GrammarBackend", "Grammar"]
