"""Multimodal chat (port of ``dreamllm_tpu/generation/chat.py``): a
conversation and images in, text (and optionally images) out.

The dialog is rendered with a conversation template, each ``<image>``
placeholder becomes an image span whose pixels go through CLIP, and the
turn decodes through ``generate_text(inputs_embeds=)`` (text out), or
through ``generate_interleaved(prompt_images=)`` when the SD head is given
(the assistant may answer with images).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from dreamllm_tpu_torch.data.conversation import TEMPLATES, render_prompt
from dreamllm_tpu_torch.data.dataset_types import Message
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.generation.interleaved import InterleavedConfig, generate_interleaved
from dreamllm_tpu_torch.generation.sampler import (
    SamplingConfig,
    generate_text,
    validate_sampling,
)
from dreamllm_tpu_torch.generation.stopping import (
    make_stop_fn,
    stops_for_template,
    truncate_at_stop,
)
from dreamllm_tpu_torch.models.clip import clip_preprocess
from dreamllm_tpu_torch.models.dreamllm import DreamLLMConfig, multimodal_embed
from dreamllm_tpu_torch.utils.errors import ClientError

IMAGE_PLACEHOLDER = "<image>"


def _pixels(image: Any, dev: torch.device) -> torch.Tensor:
    """One ``[H, W, 3]`` image (array or tensor) as float32 on ``dev``,
    scaled to [0, 1] when it holds values above 1.5 (0-255 pixels)."""
    if torch.is_tensor(image):
        raw = image.to(device=dev, dtype=torch.float32)
    else:
        raw = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    if float(raw.max()) > 1.5:
        raw = raw / 255.0
    return raw


def encode_chat_prompt(
    tokenizer,
    cfg: DreamLLMConfig,
    messages: Sequence[Message],
    images: Sequence[Any] = (),
    template: str = "vicuna_v1.1",
    *,
    device="cuda",
):
    """→ ``(input_ids [1, S] int64, images [1, M, H, W, 3] float32 CLIP-
    normalized, image_positions [1, M] int32)`` on ``device``, or
    ``(input_ids, None, None)`` without images. Raises :class:`ClientError`
    when the placeholders and the images disagree in number."""
    dev = resolve_device(device)
    st = cfg.special_tokens
    parts = render_prompt(TEMPLATES[template], list(messages)).split(IMAGE_PLACEHOLDER)
    if len(parts) - 1 != len(images):
        raise ClientError(f"{len(parts) - 1} <image> placeholders but {len(images)} images")
    ids: list[int] = [st.bos]
    positions: list[int] = []
    pix: list[torch.Tensor] = []
    for i, part in enumerate(parts):
        if i > 0:
            positions.append(len(ids) + 1)
            ids += [st.im_start] + [st.im_patch] * cfg.image_embed_len + [st.im_end]
            raw = _pixels(images[i - 1], dev)[None]
            pix.append(clip_preprocess(raw, cfg.vision.image_size)[0])
        if part:
            ids += tokenizer.encode(part)
    arr_ids = torch.tensor([ids], dtype=torch.long, device=dev)
    if pix:
        return (arr_ids, torch.stack(pix)[None],
                torch.tensor([positions], dtype=torch.int32, device=dev))
    return arr_ids, None, None


@torch.no_grad()
def chat(
    params,
    cfg: DreamLLMConfig,
    tokenizer,
    messages: Sequence[Message],
    images: Sequence[Any] = (),
    *,
    sampling: SamplingConfig | None = None,
    template: str = "vicuna_v1.1",
    head_params=None,
    head_cfg=None,
    interleaved: InterleavedConfig | None = None,
    generator: torch.Generator | None = None,
    device="cuda",
) -> dict:
    """One assistant turn: ``{"text": str, "images": [[H, W, 3] tensors]}``.

    Pass ``head_params``/``head_cfg`` (and optionally ``interleaved``) to let
    the assistant emit images through ``<dream_start>``. ``generator`` drives
    sampling and image noise (default: a generator on ``device`` seeded 0,
    as JAX defaults to ``PRNGKey(0)``); the parameters must be on
    ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    ids, pix, pos = encode_chat_prompt(tokenizer, cfg, messages, images, template, device=dev)

    if head_params is not None and head_cfg is not None:
        if interleaved is not None and sampling is not None:
            # the request's sampling replaces the configured one; its token
            # budget is capped by the configured budget (it sizes the cache)
            icfg = dataclasses.replace(
                interleaved, sampling=sampling,
                max_new_tokens=min(sampling.max_new_tokens, interleaved.max_new_tokens))
        else:
            icfg = interleaved or InterleavedConfig(
                sampling=sampling or SamplingConfig(greedy=True,
                                                    eos_token_id=cfg.special_tokens.eos))
        out = generate_interleaved(params, cfg, head_params, head_cfg, ids, icfg, generator,
                                   prompt_images=pix, prompt_image_positions=pos, device=dev)
        text_parts = [tokenizer.decode(t.tolist()) for kind, t in out["segments"]
                      if kind == "text"]
        return {"text": "\n".join(text_parts), "images": out["images"]}

    scfg = sampling or SamplingConfig(greedy=True, eos_token_id=cfg.special_tokens.eos)
    embeds = multimodal_embed(params, cfg, ids, images=pix, image_positions=pos)
    out = generate_text(params["llm"], cfg.llm, ids,
                        torch.tensor([ids.shape[1]], dtype=torch.int32, device=dev), scfg,
                        generator, inputs_embeds=embeds, device=dev)
    n = int(out["lengths"][0])
    return {"text": tokenizer.decode(out["tokens"][0, :n].tolist()), "images": []}


def make_chat_fn(
    params,
    cfg: DreamLLMConfig,
    tokenizer,
    *,
    head_params=None,
    head_cfg=None,
    template: str = "vicuna_v1.1",
    interleaved: InterleavedConfig | None = None,
    max_new_tokens_limit: int = 1024,
    engine=None,
    device="cuda",
):
    """Close over the model → a server's chat function

        (messages: list[dict | Message], images: list[HWC arrays], req: dict)
        → {"text": str, "images": [tensors]}

    ``req`` carries the per-request values of a JSON body
    (``max_new_tokens``, ``greedy``, ``temperature``, ``top_k``, ``top_p``,
    ``seed``, ``template``); they are checked before they reach the sampler
    and raise :class:`ClientError`. Each call runs :func:`chat`, with the
    template's stop strings: a single-token separator halts the decode as
    EOS does, and the text is cut at the first stop string.

    ``engine=`` routes decode through a ``ContinuousBatchingEngine``:
    text-only turns as token prompts (``submit(ids)``, which keeps the
    prefix cache), turns with images through its embeddings lanes
    (``submit(prompt_embeds=)``, the spliced embeddings computed here on
    the card). Concurrent chat requests then decode together instead of one
    at a time under the server's lock: the function is marked
    ``concurrent``. The engine must serve the decoder of ``params["llm"]``
    (an attached or quantized copy of it). It is warmed up here, the
    embeddings prefill included, unless it is already running. Text out
    only: ``head_params`` with ``engine=`` raises."""
    if engine is not None and head_params is not None:
        raise ValueError("engine-routed chat is text-out only; image output (head_params) "
                         "requires the locked interleaved path")
    dev = resolve_device(device)
    if engine is not None and not engine.running:
        engine.warmup(embeds=True)

    def chat_fn(messages, images, req: dict) -> dict:
        msgs = [m if isinstance(m, Message) else Message(m["role"], m.get("content", ""))
                for m in messages]
        explicit = any(k in req for k in ("temperature", "top_k", "top_p"))
        greedy = bool(req.get("greedy", not explicit))
        temperature = float(req.get("temperature", 1.0))
        top_k = int(req.get("top_k", 0))
        top_p = float(req.get("top_p", 1.0))
        validate_sampling(temperature, top_k, top_p)
        # max_new_tokens sizes the KV cache: clamp a client's value to the limit
        mnt = int(req.get("max_new_tokens", 128))
        if not 1 <= mnt <= max_new_tokens_limit:
            raise ClientError(f"max_new_tokens must be in [1, {max_new_tokens_limit}], got {mnt}")
        tmpl = str(req.get("template", template))
        if tmpl not in TEMPLATES:
            raise ClientError(f"unknown template {tmpl!r}; available: {sorted(TEMPLATES)}")
        stop_strings, halt_ids = stops_for_template(TEMPLATES[tmpl], tokenizer,
                                                    eos_id=cfg.special_tokens.eos)
        if engine is not None:
            ids, pix, pos = encode_chat_prompt(tokenizer, cfg, msgs, images, tmpl, device=dev)
            kw = dict(max_new_tokens=mnt, greedy=greedy, temperature=temperature, top_k=top_k,
                      top_p=top_p, seed=int(req["seed"]) if "seed" in req else None,
                      stop_token_ids=halt_ids,
                      stop_fn=make_stop_fn(tokenizer, stop_strings, exclude_ids=halt_ids))
            if pix is None:
                # text-only turns ride the token lanes (and the prefix cache)
                out_ids = engine.submit(ids[0].tolist(), **kw)
            else:
                with torch.no_grad():
                    embeds = multimodal_embed(params, cfg, ids, images=pix, image_positions=pos)
                out_ids = engine.submit(prompt_embeds=embeds[0], **kw)
            text = tokenizer.decode(out_ids)
            if stop_strings:
                text = truncate_at_stop(text, stop_strings)
            return {"text": text, "images": []}
        scfg = SamplingConfig(greedy=greedy, temperature=temperature, top_k=top_k, top_p=top_p,
                              max_new_tokens=mnt, eos_token_id=cfg.special_tokens.eos,
                              halt_tokens=halt_ids)
        out = chat(params, cfg, tokenizer, msgs, images, sampling=scfg, template=tmpl,
                   head_params=head_params, head_cfg=head_cfg, interleaved=interleaved,
                   generator=torch.Generator(device=dev).manual_seed(int(req.get("seed", 0))),
                   device=dev)
        if stop_strings:
            out = dict(out, text=truncate_at_stop(out["text"], stop_strings))
        return out

    # the engine orders device work itself; handler threads may enter together
    chat_fn.concurrent = engine is not None
    return chat_fn
