"""A character tokenizer for random-weight presets (``tokenizer_path="chars"``).

Token ``ord(c) + 1`` is character ``c`` (the first 256 code points), 0 is
eos, and every other id decodes to nothing. The repository holds no
vocabulary files, so this is what lets a server on random weights show text
and serve grammars (``constrained/``), as the tests' character tokenizers
do.
"""

from __future__ import annotations

NAME = "chars"


class CharTokenizer:
    eos_token_id = 0
    chat_template = None

    def encode(self, text: str) -> list[int]:
        return [ord(c) + 1 for c in text]

    def decode(self, ids, **kw) -> str:
        return "".join(chr(i - 1) for i in ids if 0 < i <= 256)
