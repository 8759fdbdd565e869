"""Tokenizer loading and a deterministic offline tokenizer.

Counterpart of mla_tpu/vla/tokenizer.py, the port's own copy. Real
deployments use the Llama-2 sentencepiece tokenizer through transformers
(`load_llama_tokenizer(path)`), with <PAD>, <BOD> and <EOD> added as the
reference does. `SimpleTokenizer` is a word-hash tokenizer with the same
interface and id layout (BOS prepended, the MLA special ids, action-token
ids that decode and re-encode to themselves) for serving and tests without
tokenizer files; it gives JAX's ids for the same text.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List

BOS_ID = 1
EOS_ID = 2
EMPTY_ID = 29871
PAD_ID = 32000
BOD_ID = 32001
EOD_ID = 32002
ACTION_TOKEN_MIN = 32000 - 256  # 31744


def load_llama_tokenizer(path_or_id: str):
    """HF Llama tokenizer with the MLA special tokens registered. Needs the
    transformers package and the tokenizer's files."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(f"load_llama_tokenizer({path_or_id!r}) needs the transformers package, which is not "
                           f"installed; serve with the default SimpleTokenizer instead") from e

    tok = AutoTokenizer.from_pretrained(path_or_id, model_max_length=2048, padding_side="right")
    tok.add_special_tokens({"pad_token": "<PAD>"})
    tok.add_tokens(["<BOD>", "<EOD>"], special_tokens=True)
    return tok


class SimpleTokenizer:
    """Deterministic word-hash tokenizer on the Llama-2 id contract: BOS=1,
    EOS=2, <BOD>/<EOD> = 32001/32002; ids decoded by `decode` (the
    action-token path) re-encode to themselves through <id:N> glyphs."""

    vocab_size = 32000
    _GLYPH = re.compile(r"<id:(\d+)>")

    def __call__(self, text: str, add_special_tokens: bool = True) -> Dict[str, List[int]]:
        ids: List[int] = [BOS_ID] if add_special_tokens else []
        for piece in self._split(text):
            ids.append(self._piece_to_id(piece))
        return {"input_ids": ids}

    def _split(self, text: str) -> List[str]:
        out: List[str] = []
        for chunk in re.split(r"(<BOD>|<EOD>|<id:\d+>)", text):
            if not chunk:
                continue
            # only exact specials are opaque pieces: other text that starts
            # with '<' still splits into words
            if chunk in ("<BOD>", "<EOD>") or self._GLYPH.fullmatch(chunk):
                out.append(chunk)
            else:
                out.extend(w for w in re.split(r"(\W)", chunk) if w and not w.isspace())
        return out

    def _piece_to_id(self, piece: str) -> int:
        if piece == "<BOD>":
            return BOD_ID
        if piece == "<EOD>":
            return EOD_ID
        m = self._GLYPH.fullmatch(piece)
        if m:
            return int(m.group(1))
        h = int(hashlib.md5(piece.encode()).hexdigest(), 16)
        return 1000 + (h % 28000)

    def decode(self, ids) -> str:
        return "".join(f"<id:{int(i)}>" for i in ids)

    def batch_decode(self, idss) -> List[str]:
        return [self.decode(ids) for ids in idss]
