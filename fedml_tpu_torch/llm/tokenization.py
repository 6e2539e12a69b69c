"""Tokenizer bridge for the FedLLM path (port of
``fedml_tpu.llm.tokenization``).

Any object with ``encode(text) -> ids`` / ``decode(ids) -> text`` plugs into
training and serving; this module adapts HF tokenizers onto that surface and
falls back to the dependency-free byte tokenizer when none is available.
Tokenizer files are read from local paths only, never downloaded.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

log = logging.getLogger(__name__)


class HFTokenizerAdapter:
    """Wrap a HF (fast) tokenizer onto the encode/decode surface the
    serving template and trainers consume."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        self.vocab_size = int(getattr(hf_tokenizer, "vocab_size", None)
                              or len(hf_tokenizer))
        self.bos_id = getattr(hf_tokenizer, "bos_token_id", None)
        self.eos_id = getattr(hf_tokenizer, "eos_token_id", None)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(self.hf.encode(text, add_special_tokens=False))
        if add_bos and self.bos_id is not None:
            ids = [int(self.bos_id)] + ids
        return ids

    def decode(self, ids) -> str:
        keep = [int(i) for i in ids
                if int(i) not in (self.bos_id, self.eos_id)]
        return self.hf.decode(keep, skip_special_tokens=True)


def load_tokenizer(name_or_path: Optional[str] = None):
    """LOCAL-ONLY tokenizer resolution: a path with HF tokenizer files →
    AutoTokenizer (``local_files_only=True``); anything unresolvable →
    the byte tokenizer (never a network download)."""
    if name_or_path and os.path.exists(str(name_or_path)):
        try:
            from transformers import AutoTokenizer
            return HFTokenizerAdapter(AutoTokenizer.from_pretrained(
                str(name_or_path), local_files_only=True))
        except Exception as e:
            log.warning("tokenizer load from %s failed (%s); using byte "
                        "tokenizer", name_or_path, e)
    from ..serving.templates.openai_compat import ByteTokenizer
    return ByteTokenizer()


__all__ = ["HFTokenizerAdapter", "load_tokenizer"]
