"""The port's copy of ``generation/stopping.py`` against the JAX package's:
the same stop strings for every conversation template, the same device-side
halt ids and the same host-side stop decisions on the same token streams,
with the ToyTokenizer and with a tokenizer that maps each separator to one
id. The module is pure Python, so every decision must be identical.
"""

from __future__ import annotations

import numpy as np
import pytest

import dreamllm_tpu.data.conversation as jconv
import dreamllm_tpu.data.tokenization as jtok
import dreamllm_tpu.generation.stopping as jstop
import dreamllm_tpu_torch.data.conversation as pconv
import dreamllm_tpu_torch.data.tokenization as ptok
import dreamllm_tpu_torch.generation.stopping as pstop

TEMPLATE_NAMES = sorted(jconv.TEMPLATES)


class SeparatorTokenizer:
    """Words hash as the ToyTokenizer's; each separator is one id of its own
    (id 2 for ``</s>``, the EOS), as a real tokenizer's special tokens are;
    ``decode`` renders separators back as text."""

    SPECIAL = {"</s>": 2, "###": 5, "<|im_end|>": 7}

    def __init__(self):
        self.toy = ptok.ToyTokenizer()
        self.back = {v: k for k, v in self.SPECIAL.items()}

    def encode(self, text):
        out = []
        for w in text.split():
            out += [self.SPECIAL[w]] if w in self.SPECIAL else self.toy.encode(w)
        return out

    def decode(self, ids):
        return " ".join(self.back.get(int(i), f"tok{int(i)}") for i in ids)


def test_template_set_is_the_same():
    assert sorted(pconv.TEMPLATES) == TEMPLATE_NAMES


@pytest.mark.parametrize("name", TEMPLATE_NAMES)
@pytest.mark.parametrize("tokenizer", ["toy", "separator"])
def test_stops_for_template_match_jax(name, tokenizer):
    tok = ptok.ToyTokenizer() if tokenizer == "toy" else SeparatorTokenizer()
    jt, pt = jconv.TEMPLATES[name], pconv.TEMPLATES[name]
    assert pstop.stop_str_for(pt) == jstop.stop_str_for(jt)
    for eos in (None, 2, 5, 7):
        assert pstop.stops_for_template(pt, tok, eos) == jstop.stops_for_template(jt, tok, eos)
    strings, _ = pstop.stops_for_template(pt, tok, 2)
    assert pstop.single_token_stop_ids(tok, strings) == jstop.single_token_stop_ids(tok, strings)


def test_toy_tokenizers_agree():
    text = "USER: describe ### the image </s> ASSISTANT:"
    assert ptok.ToyTokenizer().encode(text) == jtok.ToyTokenizer().encode(text)
    ids = ptok.ToyTokenizer().encode(text)
    assert ptok.ToyTokenizer().decode(ids) == jtok.ToyTokenizer().decode(ids)
    assert ptok.SPECIAL_TOKEN_NAMES == jtok.SPECIAL_TOKEN_NAMES


@pytest.mark.parametrize("exclude", [(), (5,), (5, 7)])
def test_stop_fn_decides_as_jax_on_growing_streams(exclude):
    """Both predicates fed the same growing id lists (chunks of 1 to 4 ids,
    a separator somewhere inside, and a shrinking list that resets the
    mark): the same decision after every chunk."""
    tok = SeparatorTokenizer()
    strings = ["###", "<|im_end|>", "tok99"]
    rng = np.random.default_rng(0)
    for trial in range(20):
        stream = [int(x) for x in rng.integers(10, 3000, 30)]
        if trial % 3:
            stream.insert(int(rng.integers(0, 30)), [5, 7][trial % 2])
        jfn = jstop.make_stop_fn(tok, strings, exclude_ids=exclude)
        pfn = pstop.make_stop_fn(tok, strings, exclude_ids=exclude)
        assert (jfn is None) == (pfn is None)
        end = 0
        while end < len(stream):
            end = min(len(stream), end + int(rng.integers(1, 5)))
            assert pfn(stream[:end]) == jfn(stream[:end]), (trial, end)
        assert pfn(stream[:3]) == jfn(stream[:3])  # shrank: full recheck
    # a stop set that the device covers in full needs no host predicate
    assert pstop.make_stop_fn(tok, ["###"], exclude_ids=(5,)) is None
    assert jstop.make_stop_fn(tok, ["###"], exclude_ids=(5,)) is None


@pytest.mark.parametrize("text", [
    "a sunny day ### Human: next", "answer</s>", "  plain text  ", "x <|im_end|> y ### z", ""])
def test_truncate_at_stop_matches_jax(text):
    stops = ["###", "</s>", "<|im_end|>", ""]
    assert pstop.truncate_at_stop(text, stops) == jstop.truncate_at_stop(text, stops)
