"""Tokenizer adapters (a copy of ``dreamllm_tpu/data/tokenization.py``, with
``SpecialTokens`` from the port's ``models/dreamllm.py``).

The reference subclasses the LLaMA sentencepiece tokenizer and adds 7
multimodal control tokens (tokenization_dreamllm.py:67-96). Here the
tokenizer stays a host-side detail behind a 2-method protocol
(encode/decode); adapters:

  * ``HFTokenizer`` — wraps any transformers tokenizer (LlamaTokenizerFast
    needs no sentencepiece binary) and registers the special-token table,
    returning the id mapping as a :class:`SpecialTokens`.
  * ``ToyTokenizer`` — deterministic whitespace/byte tokenizer for tests.
"""

from __future__ import annotations

import dataclasses

from dreamllm_tpu_torch.models.dreamllm import SpecialTokens

SPECIAL_TOKEN_NAMES = (
    "<image>", "<im_patch>", "<im_start>", "<im_end>",
    "<dream>", "<dream_start>", "<dream_end>",
)


class HFTokenizer:
    """transformers wrapper adding DreamLLM special tokens."""

    def __init__(self, name_or_path: str, **kw):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name_or_path, use_fast=True, **kw)
        added = [t for t in SPECIAL_TOKEN_NAMES if t not in self.tok.get_vocab()]
        if added:
            self.tok.add_special_tokens({"additional_special_tokens": added})
        ids = {t: self.tok.convert_tokens_to_ids(t) for t in SPECIAL_TOKEN_NAMES}
        self.special = SpecialTokens(
            image=ids["<image>"],
            im_patch=ids["<im_patch>"],
            im_start=ids["<im_start>"],
            im_end=ids["<im_end>"],
            dream=ids["<dream>"],
            dream_start=ids["<dream_start>"],
            dream_end=ids["<dream_end>"],
            # `or` would remap a legitimate id 0 (falsy) to the fallback
            bos=self.tok.bos_token_id if self.tok.bos_token_id is not None else 1,
            eos=self.tok.eos_token_id if self.tok.eos_token_id is not None else 2,
            pad=self.tok.pad_token_id if self.tok.pad_token_id is not None else 0,
        )

    def __len__(self):
        return len(self.tok)

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def encode_with_offsets(self, text: str) -> tuple[list[int], list[tuple[int, int]]]:
        """(ids, char spans). Enables exact label masking on the FULL rendered
        conversation — the clean replacement for the reference's token-count
        turn-masking hacks (builder_dreamllm.py:383-397), which break when
        SPM merges tokens across turn boundaries."""
        out = self.tok(text, add_special_tokens=False, return_offsets_mapping=True)
        return out["input_ids"], out["offset_mapping"]

    def decode(self, ids) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)


@dataclasses.dataclass
class ToyTokenizer:
    """Hash-bucket word tokenizer for unit tests: deterministic, reversible
    enough (decode returns placeholder words)."""

    vocab_size: int = 32000
    offset: int = 10  # ids < offset reserved

    def encode(self, text: str) -> list[int]:
        import zlib

        # crc32, NOT hash(): str hashes are salted per interpreter process
        # (PYTHONHASHSEED), which silently re-tokenized the same text to
        # different ids across resumes/processes
        return [
            self.offset + (zlib.crc32(w.encode()) % (self.vocab_size - self.offset))
            for w in text.split()
        ]

    def decode(self, ids) -> str:
        return " ".join(f"tok{int(i)}" for i in ids)
