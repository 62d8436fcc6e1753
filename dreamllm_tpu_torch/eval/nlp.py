"""NLP evaluation (port of ``dreamllm_tpu/eval/nlp.py``): the log-prob of
candidate continuations given a context, the multiple-choice pick that
follows from it (BoolQ/PIQA/HellaSwag/MMLU-style tasks), and perplexity.
Every function runs the decoder once on the padded batch, under
``torch.no_grad``, on the device of the parameters.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dreamllm_tpu_torch.models.llama import LlamaConfig, llama_forward, llama_logits


@torch.no_grad()
def sequence_logprob(
    params,
    cfg: LlamaConfig,
    ids: torch.Tensor,           # [B, S] padded
    target_start: torch.Tensor,  # [B] index where the continuation begins
    lengths: torch.Tensor,       # [B] total real length
    *,
    normalize_by_length: bool = False,
) -> torch.Tensor:
    """Total (or per-token mean) float32 log-prob of ``ids[target_start:
    length]`` given the tokens before it, ``[B]``."""
    b, s = ids.shape
    dev = ids.device
    ar = torch.arange(s, device=dev)[None]
    seg = (ar < lengths.to(dev)[:, None]).to(torch.int32)
    out = llama_forward(params, cfg, input_ids=ids, segment_ids=seg)
    logp = torch.log_softmax(llama_logits(params, cfg, out["last_hidden_state"]), dim=-1)
    # token t is predicted by position t - 1
    tok_lp = torch.gather(logp[:, :-1], -1, ids[:, 1:, None].long())[..., 0]
    pos = ar[:, 1:]
    mask = (pos >= target_start.to(dev)[:, None]) & (pos < lengths.to(dev)[:, None])
    total = (tok_lp * mask).sum(dim=-1)
    if normalize_by_length:
        total = total / mask.sum(dim=-1).clamp_min(1)
    return total


def choice_logprobs(
    params,
    cfg: LlamaConfig,
    tokenizer,
    context: str,
    choices: Sequence[str],
    *,
    bos: int = 1,
    normalize_by_length: bool = False,
) -> np.ndarray:
    """Per-choice continuation log-prob as a numpy vector (summed, or the
    per-token mean with ``normalize_by_length``)."""
    ctx_ids = [bos] + tokenizer.encode(context)
    rows, starts, lengths = [], [], []
    for c in choices:
        cont = tokenizer.encode(c)
        rows.append(ctx_ids + cont)
        starts.append(len(ctx_ids))
        lengths.append(len(ctx_ids) + len(cont))
    ids = torch.zeros((len(rows), max(lengths)), dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r)
    dev = params["embed_tokens"].device
    lp = sequence_logprob(params, cfg, ids.to(dev), torch.tensor(starts, device=dev),
                          torch.tensor(lengths, device=dev),
                          normalize_by_length=normalize_by_length)
    return lp.float().cpu().numpy()


def multiple_choice(
    params,
    cfg: LlamaConfig,
    tokenizer,
    context: str,
    choices: Sequence[str],
    *,
    bos: int = 1,
    normalize_by_length: bool = True,
) -> int:
    """The choice with the largest log-prob (MMLU/HellaSwag-style)."""
    lp = choice_logprobs(params, cfg, tokenizer, context, choices, bos=bos,
                         normalize_by_length=normalize_by_length)
    return int(np.argmax(lp))


def perplexity(params, cfg: LlamaConfig, ids: torch.Tensor, lengths: torch.Tensor) -> float:
    """Corpus perplexity over padded ``[B, S]`` ids."""
    lp = sequence_logprob(params, cfg, ids, torch.ones((ids.shape[0],), dtype=torch.int32,
                                                       device=ids.device), lengths)
    n_tokens = (lengths.to(lp.device) - 1).clamp_min(0).sum()
    return float(torch.exp(-lp.sum() / n_tokens.clamp_min(1)))
