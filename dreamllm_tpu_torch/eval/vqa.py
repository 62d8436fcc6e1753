"""VQA / captioning inference driver (port of ``dreamllm_tpu/eval/vqa.py``).

A prompt is the system text, the image span and the question through a
conversation template; prompts are decoded in batches, greedily or by beam
search, and scored by the task's metric. Data is split across processes by
stride (:func:`shard_for_process`), and the shards' files are merged by
:func:`merge_prediction_shards`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Sequence

import numpy as np
import torch

from dreamllm_tpu_torch.data.conversation import TEMPLATES, render_prompt
from dreamllm_tpu_torch.data.dataset_types import Message
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.eval.metrics import (
    anls,
    cider_d,
    exact_match,
    pope_metrics,
    relaxed_accuracy,
    vqa_accuracy,
)
from dreamllm_tpu_torch.eval.mmbench import extract_option_letter
from dreamllm_tpu_torch.generation.sampler import SamplingConfig, beam_search, generate_text
from dreamllm_tpu_torch.generation.stopping import stops_for_template, truncate_at_stop
from dreamllm_tpu_torch.models.clip import clip_preprocess
from dreamllm_tpu_torch.models.dreamllm import DreamLLMConfig, multimodal_embed


@dataclasses.dataclass
class VQATask:
    name: str
    metric: str           # "vqa_acc" | "anls" | "em" | "relaxed" | "pope" | "cider" | "exact"
    prompt_suffix: str = ""   # e.g. "\nAnswer the question using a single word or phrase."
    fixed_question: str | None = None  # tasks with a constant prompt (OCR)


_WORD = "\nAnswer the question using a single word or phrase."
TASKS = {
    # VQA consensus accuracy
    "vqav2": VQATask("vqav2", "vqa_acc", _WORD),
    "okvqa": VQATask("okvqa", "vqa_acc", _WORD),
    "vizwiz": VQATask("vizwiz", "vqa_acc", "\nWhen the provided information is insufficient, "
                      "respond with 'Unanswerable'.\nAnswer the question using a single word or "
                      "phrase."),
    "textvqa": VQATask("textvqa", "vqa_acc", _WORD),
    # ANLS
    "docvqa": VQATask("docvqa", "anls", _WORD),
    "infovqa": VQATask("infovqa", "anls", _WORD),
    "stvqa": VQATask("stvqa", "anls", _WORD),
    # exact match
    "tallyqa": VQATask("tallyqa", "em", _WORD),
    "ocrvqa": VQATask("ocrvqa", "em", _WORD),
    "ai2d": VQATask("ai2d", "em", _WORD),
    # relaxed accuracy (numbers within 5%)
    "chartqa": VQATask("chartqa", "relaxed", _WORD),
    # OCR transcription (fixed prompt, exact match)
    "ocr": VQATask("ocr", "em", "", fixed_question="what is written in the image?"),
    # POPE hallucination splits
    "pope": VQATask("pope", "pope", _WORD),
    "pope_random": VQATask("pope_random", "pope", _WORD),
    "pope_popular": VQATask("pope_popular", "pope", _WORD),
    "pope_adversarial": VQATask("pope_adversarial", "pope", _WORD),
    # captioning (CIDEr-D)
    "coco_caption": VQATask("coco_caption", "cider", ""),
    "nocaps": VQATask("nocaps", "cider", ""),
    "textcaps": VQATask("textcaps", "cider", ""),
    "vizwiz_caption": VQATask("vizwiz_caption", "cider", ""),
    "screen2words": VQATask("screen2words", "cider", ""),
    "image_paragraph": VQATask("image_paragraph", "cider", ""),
    # multiple-choice letters
    "mmbench": VQATask("mmbench", "exact",
                       "\nAnswer with the option's letter from the given choices directly."),
    "mmvet": VQATask("mmvet", "exact", ""),
}


def _image_tokens(cfg: DreamLLMConfig) -> str:
    return "<im_start>" + "<im_patch>" * cfg.image_embed_len + "<im_end>"


def build_vqa_prompt(cfg: DreamLLMConfig, question: str, template: str = "vicuna_v1.1") -> str:
    """system + ``<im_start>`` + N x ``<im_patch>`` + ``<im_end>`` + question,
    with the special tokens as literal text; :func:`encode_vqa_prompt`
    assembles the ids."""
    return render_prompt(TEMPLATES[template],
                         [Message("user", _image_tokens(cfg) + "\n" + question)])


def encode_vqa_prompt(tokenizer, cfg: DreamLLMConfig, question: str,
                      template: str = "vicuna_v1.1") -> tuple[np.ndarray, int]:
    """-> ``(ids [S] int32, image_position)``. The text is split around the
    image span, so the tokenizer never sees the special tokens."""
    st = cfg.special_tokens
    before, after = build_vqa_prompt(cfg, question, template).split(_image_tokens(cfg))
    ids = [st.bos] + tokenizer.encode(before)
    image_pos = len(ids) + 1
    ids += [st.im_start] + [st.im_patch] * cfg.image_embed_len + [st.im_end]
    ids += tokenizer.encode(after)
    return np.asarray(ids, np.int32), image_pos


def shard_for_process(items: Sequence, index: int | None = None, count: int | None = None):
    """The strided share of ``items`` of process ``index`` of ``count``; by
    default this process's rank and the world size of ``torch.distributed``
    when it is initialised, else 0 of 1."""
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    if index is None:
        index = dist.get_rank() if live else 0
    if count is None:
        count = dist.get_world_size() if live else 1
    return list(items[index::count])


@torch.no_grad()
def run_vqa(
    params,
    cfg: DreamLLMConfig,
    tokenizer,
    samples: Iterable[dict],      # {question, image (HWC [0, 1] float), answers|label, id}
    *,
    task: str = "vqav2",
    max_new_tokens: int = 32,
    batch_size: int = 8,
    num_beams: int = 1,
    template: str = "vicuna_v1.1",
    out_path: str | None = None,
    device="cuda",
) -> dict:
    """Batched inference and the task's metric: ``{"score", "predictions"}``.

    Prompts are padded to a multiple of 64 a batch; each batch's images go
    through ``clip_preprocess`` together, ``multimodal_embed`` splices
    them, and ``generate_text`` (greedy) or ``beam_search`` (``num_beams >
    1``) decodes. The template's separator stops decoding: a one-token
    separator on the card, and every separator is cut from the text. The
    parameters must be on ``device``."""
    dev = resolve_device(device)
    t = TASKS[task]
    samples = list(samples)
    st = cfg.special_tokens
    stop_strings, halt_ids = stops_for_template(TEMPLATES[template], tokenizer, eos_id=st.eos)
    scfg = SamplingConfig(greedy=True, max_new_tokens=max_new_tokens, eos_token_id=st.eos,
                          pad_token_id=st.pad, halt_tokens=halt_ids)
    preds = []
    for i in range(0, len(samples), batch_size):
        chunk = samples[i:i + batch_size]
        encoded = [encode_vqa_prompt(tokenizer, cfg, (t.fixed_question or s["question"])
                                     + t.prompt_suffix, template) for s in chunk]
        maxlen = -(-max(len(e[0]) for e in encoded) // 64) * 64  # bucket to 64
        b = len(chunk)
        ids = np.zeros((b, maxlen), np.int64)
        lens = np.zeros((b,), np.int32)
        img_pos = np.full((b, 1), -1, np.int32)
        for j, (e, pos) in enumerate(encoded):
            ids[j, :len(e)] = e
            lens[j] = len(e)
            img_pos[j, 0] = pos
        ids_t = torch.from_numpy(ids).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        # one preprocessing call a batch (one a size when the sizes differ)
        raws = [torch.as_tensor(np.asarray(s["image"], np.float32)) for s in chunk]
        if len({tuple(r.shape) for r in raws}) == 1:
            pre = clip_preprocess(torch.stack(raws).to(dev), cfg.vision.image_size)
        else:
            pre = torch.cat([clip_preprocess(r[None].to(dev), cfg.vision.image_size)
                             for r in raws])
        embeds = multimodal_embed(params, cfg, ids_t, images=pre[:, None],
                                  image_positions=torch.from_numpy(img_pos).to(dev))
        if num_beams > 1:
            out = beam_search(params["llm"], cfg.llm, ids_t, lens_t, num_beams=num_beams,
                              max_new_tokens=max_new_tokens, eos_token_id=st.eos,
                              pad_token_id=st.pad, halt_tokens=halt_ids, inputs_embeds=embeds,
                              device=dev)
            lengths = (out["tokens"] != st.pad).sum(dim=-1)
        else:
            out = generate_text(params["llm"], cfg.llm, ids_t, lens_t, scfg,
                                inputs_embeds=embeds, device=dev)
            lengths = out["lengths"]
        toks, lengths = out["tokens"].cpu(), lengths.tolist()
        for j, s in enumerate(chunk):
            text = tokenizer.decode(toks[j, :lengths[j]].tolist()).strip()
            if stop_strings:
                text = truncate_at_stop(text, stop_strings)
            preds.append({"id": s.get("id", i + j), "prediction": text,
                          **{k: s[k] for k in ("answers", "label", "references") if k in s}})

    score = score_predictions(preds, t.metric)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"task": task, "score": score, "predictions": preds}, f)
    return {"score": score, "predictions": preds}


def score_predictions(preds: list[dict], metric: str) -> float:
    if metric == "vqa_acc":
        return float(np.mean([vqa_accuracy(p["prediction"], p["answers"]) for p in preds]))
    if metric == "anls":
        return float(np.mean([anls(p["prediction"], p["answers"]) for p in preds]))
    if metric == "pope":
        return pope_metrics([p["prediction"] for p in preds], [p["label"] for p in preds])["f1"]
    if metric == "cider":
        cands = {str(p["id"]): p["prediction"] for p in preds}
        refs = {str(p["id"]): p["references"] for p in preds}
        return cider_d(cands, refs)
    if metric == "em":
        return float(np.mean([exact_match(p["prediction"], p["answers"]) for p in preds]))
    if metric == "relaxed":
        return float(np.mean([relaxed_accuracy(p["prediction"], p["answers"]) for p in preds]))
    if metric == "exact":
        def hit(p):
            label = str(p.get("label", "")).strip()
            pred = p["prediction"].strip()
            if len(label) == 1 and label.upper() in "ABCD":
                # a letter-choice task: 'A.', 'The answer is A' and the
                # option's text all count as the letter
                return extract_option_letter(pred, p.get("options")) == label.upper()
            return pred.lower() == label.lower()

        return float(np.mean([hit(p) for p in preds]))
    raise ValueError(metric)


def merge_prediction_shards(paths: list[str], out_path: str) -> dict:
    """Merge the per-process shard files into one, scored as a whole."""
    if not paths:
        raise ValueError("merge_prediction_shards: no shard files to merge")
    all_preds, task = [], None
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        task = d["task"]
        all_preds += d["predictions"]
    score = score_predictions(all_preds, TASKS[task].metric)
    with open(out_path, "w") as f:
        json.dump({"task": task, "score": score, "predictions": all_preds}, f)
    return {"task": task, "score": score, "n": len(all_preds)}
