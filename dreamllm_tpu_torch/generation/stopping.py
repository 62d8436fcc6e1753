"""Stop-string stopping + post-hoc truncation (a copy of
``dreamllm_tpu/generation/stopping.py``, which imports only ``typing``; the
port imports nothing of that package).

TPU-native counterpart of the reference's ``KeywordsStoppingCriteria``
(omni/utils/conversation.py:16-31, used by omni/eval/vqa/vqa_inference.py:
96-146): generation stops when the conversation separator appears in the
decoded continuation, and the separator is stripped from the returned text
(vqa_inference.py:143-146 ``outputs.endswith(stop_str)`` strip).

Layered design (the reference re-decodes the whole output every step on the
host; a remote-attached TPU cannot afford a per-step host sync):

  * separators that tokenize to a SINGLE id (``</s>``, special tokens) stop
    **device-side**: ``SamplingConfig.halt_tokens`` in the samplers and the
    per-slot halt set in the serving engine — like EOS, the token is never
    emitted, which is exactly the reference's stop+strip semantics.
  * multi-token separators (``###`` of the v0-style templates) are checked
    **host-side at engine chunk boundaries** (``make_stop_fn``) — the lane is
    retired within one chunk of the separator appearing — and the final text
    is cut at the first occurrence (``truncate_at_stop``). Truncating at the
    FIRST occurrence is deliberately stronger than the reference's
    trailing-``endswith`` strip: a decode that overshoots the separator
    mid-chunk still returns a clean turn.
"""

from __future__ import annotations

from typing import Callable, Sequence


def stop_str_for(template) -> str:
    """The stop string of a conversation template — the reference rule
    ``stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else
    conv.sep2`` (vqa_inference.py:96-99). Our ``add_colon_two`` (vicuna
    v1.1) and ``llama2`` styles stop on seps[1]; the ``single`` (###) style
    stops on its one separator (seps[0])."""
    if template.sep_style in ("single", "mpt"):
        return template.seps[0]
    return template.seps[1].strip() or template.seps[0]


def truncate_at_stop(text: str, stop_strings: Sequence[str]) -> str:
    """Cut ``text`` at the FIRST occurrence of any stop string and strip
    whitespace (reference: vqa_inference.py:143-146)."""
    cut = len(text)
    for s in stop_strings:
        if not s:
            continue
        i = text.find(s)
        if i >= 0:
            cut = min(cut, i)
    return text[:cut].strip()


def single_token_stop_ids(tokenizer, stop_strings: Sequence[str]) -> tuple[int, ...]:
    """ids of stop strings that round-trip through the tokenizer as exactly
    ONE token — these can halt device-side (zero host syncs). Strings that
    tokenize to multiple ids (SPM renders ``###`` context-dependently) are
    NOT returned; they need the host-side ``make_stop_fn`` path."""
    ids: list[int] = []
    for s in stop_strings:
        if not s:
            continue
        try:
            enc = tokenizer.encode(s)
        except Exception:
            continue
        if len(enc) == 1:
            ids.append(int(enc[0]))
    return tuple(ids)


def make_stop_fn(
    tokenizer,
    stop_strings: Sequence[str],
    *,
    exclude_ids: Sequence[int] = (),
) -> Callable[[list[int]], bool] | None:
    """Host-side stop predicate over the generated id list, called by the
    engine at chunk boundaries. Decodes the continuation's NEW tail and
    reports whether any stop string appears (the reference decodes the full
    continuation each step, conversation.py:27-30; a full re-decode here
    would be O(n^2) host work per lane on the single-core scheduler thread,
    delaying chunk dispatch — so the predicate tracks a high-water mark and
    decodes only tokens added since the last call, plus an overlap window
    wide enough for a stop string completing across the boundary).

    The returned predicate is stateful and single-consumer: one instance per
    request, fed a monotonically growing id list (the engine's contract). A
    shrinking list resets the mark, so accidental reuse degrades to a full
    decode rather than a miss.

    ``exclude_ids`` lists stops already handled device-side (their token
    never reaches the output), so a stop set that is FULLY single-token
    returns None — no host work at all."""
    strings = [s for s in stop_strings if s]
    if exclude_ids:
        covered = set(single_token_stop_ids(tokenizer, strings))
        if covered and covered.issubset(set(int(i) for i in exclude_ids)):
            strings = [
                s for s in strings
                if (e := _try_encode(tokenizer, s)) is None or len(e) != 1
            ]
    if not strings:
        return None

    # a stop of C characters spans at most C rendered tokens, plus slack for
    # tokens decode() renders as empty (skipped specials)
    overlap = max(len(s) for s in strings) + 8
    checked = 0

    def stop_fn(ids: list[int]) -> bool:
        nonlocal checked
        if not ids:
            return False
        if len(ids) < checked:
            checked = 0  # list shrank: not our producer — recheck everything
        new = len(ids) - checked
        checked = len(ids)
        text = tokenizer.decode(list(ids[-(new + overlap):]))
        return any(s in text for s in strings)

    return stop_fn


def stops_for_template(
    template, tokenizer, eos_id: int | None = None
) -> tuple[list[str], tuple[int, ...]]:
    """(stop_strings, device-side halt ids) for a conversation template —
    the one place the 'is the separator already the EOS token' decision
    lives (callers: generation/chat.py, eval/vqa.py).

    The separator is dropped when it IS the model's EOS token — device EOS
    stopping already covers it, and a redundant host stop_fn would burn
    scheduler-thread decodes for nothing. Identified by encoding (the stop
    round-trips to exactly ``[eos_id]``, which also catches templates whose
    EOS renders differently, e.g. ChatML's <|im_end|>); the ``"</s>"``
    literal is kept as a fallback for test tokenizers whose encode() has no
    special-token awareness."""
    stop_str = stop_str_for(template)
    strings = [stop_str] if stop_str else []
    if strings and eos_id is not None:
        enc = _try_encode(tokenizer, stop_str)
        if enc is not None and len(enc) == 1 and int(enc[0]) == int(eos_id):
            strings = []
    if strings and stop_str == "</s>":
        strings = []
    return strings, single_token_stop_ids(tokenizer, strings)


def _try_encode(tokenizer, s: str):
    try:
        return tokenizer.encode(s)
    except Exception:
        return None
