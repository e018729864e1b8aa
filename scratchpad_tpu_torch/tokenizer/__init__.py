import os

from scratchpad_tpu_torch.tokenizer import chars
from scratchpad_tpu_torch.tokenizer.detokenizer import IncrementalDetokenizer

__all__ = ["IncrementalDetokenizer", "load_tokenizer"]


def load_tokenizer(path: str):
    """The Hugging Face tokenizer at ``path``; ``chars``, where no file or
    directory of that name exists, is the character tokenizer of
    ``chars.py``."""
    if path == chars.NAME and not os.path.exists(path):
        return chars.CharTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)
