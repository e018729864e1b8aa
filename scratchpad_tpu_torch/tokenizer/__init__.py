from scratchpad_tpu_torch.tokenizer.detokenizer import IncrementalDetokenizer

__all__ = ["IncrementalDetokenizer"]
