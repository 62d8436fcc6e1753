"""Free-form interleaved text+image generation (port of
``dreamllm_tpu/generation/interleaved.py``).

decode text → the model emits ``<dream_start>`` → the learned dream
queries (64 for DreamLLM-7B, 196 for DreamLLM-SDXL) go through the KV
cache → their last hidden states condition the diffusion head → image →
``<dream_end>`` (+ optionally the CLIP-encoded image span) → decoding
resumes, until EOS, a stop token or the budget.

The stages are the JAX package's, run eagerly: a prefill, a per-token decode
loop that reads each fed token back to the host to decide whether to stop
(JAX decides on the device inside a ``while_loop``), the dream-query append,
the image pipeline, and the span tail. Segment and stop semantics are the
same. Batch 1.
"""

from __future__ import annotations

import dataclasses

import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.generation.sampler import SamplingConfig, sample_token
from dreamllm_tpu_torch.models.clip import clip_preprocess
from dreamllm_tpu_torch.models.dreamllm import (
    DreamLLMConfig,
    multimodal_embed,
    unconditional_dream_hidden,
)
from dreamllm_tpu_torch.models.llama import init_kv_cache, llama_forward, llama_logits
from dreamllm_tpu_torch.models.sd.head import SDHeadConfig, sd_head_pipeline
from dreamllm_tpu_torch.models.sd.sdxl import SDXLHeadConfig, sdxl_head_pipeline


@dataclasses.dataclass(frozen=True)
class InterleavedConfig:
    max_new_tokens: int = 512           # total token budget (text + spans)
    max_images: int = 4
    num_inference_steps: int = 50
    guidance_scale: float = 3.5
    image_height: int | None = None
    image_width: int | None = None
    sampler: str = "dpm"
    append_image_span: bool = True      # re-encode the generated image via CLIP
    # Scripted image trigger: after exactly N tokens of a text segment, act
    # as if the model had emitted <dream_start> (that token is consumed as
    # the control token). For demos and benchmarks with untrained weights.
    force_image_interval: int | None = None
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)


# stop reasons of a decoded segment
_BUDGET, _EOS, _DREAM, _STOP = 0, 1, 2, 3


def _decode_segment(params, cfg: DreamLLMConfig, icfg: InterleavedConfig, first_tok, cache,
                    start_pos: int, budget: int, generator):
    """Feed ``first_tok`` and the tokens sampled after it until EOS,
    ``<dream_start>``, a stop token or ``budget``. Every fed token goes into
    the cache and into the returned list. Returns ``(tokens, reason)``."""
    scfg = icfg.sampling
    dev = first_tok.device
    ones = torch.ones((1, 1), dtype=torch.int32, device=dev)
    toks: list[int] = []
    tok = first_tok
    reason = _BUDGET
    while len(toks) < budget and reason == _BUDGET:
        i = len(toks)
        pos = torch.full((1, 1), start_pos + i, dtype=torch.int32, device=dev)
        o = llama_forward(params["llm"], cfg.llm, input_ids=tok.reshape(1, 1).long(),
                          segment_ids=ones, positions=pos, kv_cache=cache)
        nxt = sample_token(llama_logits(params["llm"], cfg.llm, o["last_hidden_state"])[:, 0],
                           generator, scfg)
        t = int(tok.reshape(-1)[0])  # host sync: the stop rule reads the fed token
        toks.append(t)
        if t == scfg.eos_token_id:
            reason = _EOS
        elif t == cfg.special_tokens.dream_start or i + 1 == icfg.force_image_interval:
            reason = _DREAM
        elif t in scfg.stop_tokens:
            reason = _STOP
        tok = nxt
    return toks, reason


def generate_interleaved(
    params,
    cfg: DreamLLMConfig,
    head_params,
    head_cfg: SDHeadConfig,
    input_ids: torch.Tensor,            # [1, S] prompt (no padding)
    icfg: InterleavedConfig,
    generator: torch.Generator | None = None,
    *,
    prompt_images: torch.Tensor | None = None,       # [1, M, H, W, 3] CLIP-normalized
    prompt_image_positions: torch.Tensor | None = None,
    pipeline_fn=None,                                # default: by the head config
    device="cuda",
) -> dict:
    """Returns ``{"segments": [("text", ids) | ("image", img)], "images":
    [...]}`` in document order: ids are int64 tensors, images ``[H, W, 3]``
    float32 in [0, 1].

    ``pipeline_fn(head_params, head_cfg, cond, uncond, generator, *,
    height, width, num_inference_steps, guidance_scale, sampler)`` makes
    the image; by default :func:`sdxl_head_pipeline` for an
    :class:`SDXLHeadConfig` (dual conditioning), :func:`sd_head_pipeline`
    for any other head. ``generator`` drives
    sampling and the image noise; it must live on ``device``. The
    parameters must already be on ``device``.
    """
    dev = resolve_device(device)
    if params["llm"]["embed_tokens"].device.type != dev.type:
        raise ValueError(f"parameters are on {params['llm']['embed_tokens'].device}, not {dev}")
    if input_ids.shape[0] != 1:
        raise ValueError("interleaved generation is batch-1")
    if pipeline_fn is None:
        pipeline_fn = (sdxl_head_pipeline if isinstance(head_cfg, SDXLHeadConfig)
                       else sd_head_pipeline)
    llm = cfg.llm
    st = cfg.special_tokens
    scfg = icfg.sampling
    input_ids = input_ids.to(dev).long()
    s0 = int(input_ids.shape[1])

    # the cache holds the prompt, the whole budget and every span: it cannot
    # overflow (a write past its end raises)
    span_len = icfg.max_images * (
        cfg.n_dream_queries + 2 + (cfg.image_embed_len + 2 if icfg.append_image_span else 0))
    cache = init_kv_cache(llm, 1, s0 + icfg.max_new_tokens + span_len, device=dev)

    if icfg.append_image_span:
        tail_list = [st.dream_end, st.im_start] + [st.im_patch] * cfg.image_embed_len + [st.im_end]
    else:
        tail_list = [st.dream_end]
    tail_ids = torch.tensor([tail_list], dtype=torch.long, device=dev)
    tail_len = len(tail_list)

    def last_token(o):
        logits = llama_logits(params["llm"], llm, o["last_hidden_state"][:, -1:])[:, 0]
        return sample_token(logits, generator, scfg)

    def ar(start: int, n: int) -> torch.Tensor:
        return torch.arange(start, start + n, dtype=torch.int32, device=dev)[None]

    # ---- prefill on the (optionally multimodal) prompt ----
    embeds = multimodal_embed(params, cfg, input_ids, images=prompt_images,
                              image_positions=prompt_image_positions)
    first_tok = last_token(llama_forward(params["llm"], llm, inputs_embeds=embeds, kv_cache=cache))
    cur_pos = s0
    uncond = unconditional_dream_hidden(params, cfg)

    segments: list = []
    images: list = []
    budget = icfg.max_new_tokens
    while budget > 0:
        toks, reason = _decode_segment(params, cfg, icfg, first_tok, cache, cur_pos, budget,
                                       generator)
        n = len(toks)
        cur_pos += n
        budget -= n
        # the control token (eos / <dream_start>) is not shown; a user stop
        # token stays, as it is stored-then-halt
        visible = toks[:-1] if reason in (_EOS, _DREAM) else toks
        if visible:
            segments.append(("text", torch.tensor(visible, dtype=torch.long)))
        if reason != _DREAM or len(images) >= icfg.max_images:
            break

        # ---- <dream_start>: append the dream queries ----
        q = params["dream_embedding"]["queries"][None].to(params["llm"]["embed_tokens"].dtype)
        o = llama_forward(params["llm"], llm, inputs_embeds=q,
                          segment_ids=torch.ones((1, cfg.n_dream_queries), dtype=torch.int32,
                                                 device=dev),
                          positions=ar(cur_pos, cfg.n_dream_queries), kv_cache=cache)
        cond = o["last_hidden_state"]  # [1, n_dream_queries, H]
        cur_pos += cfg.n_dream_queries

        img = pipeline_fn(
            head_params, head_cfg, cond, uncond, generator,
            height=icfg.image_height, width=icfg.image_width,
            num_inference_steps=icfg.num_inference_steps,
            guidance_scale=icfg.guidance_scale, sampler=icfg.sampler,
        )[0]  # [H, W, 3] in [0, 1]
        images.append(img)
        segments.append(("image", img))

        # ---- close the span: <dream_end> (+ the CLIP-encoded image span) ----
        if icfg.append_image_span:
            clip_img = clip_preprocess(img[None], cfg.vision.image_size)
            embeds = multimodal_embed(params, cfg, tail_ids, images=clip_img[:, None],
                                      image_positions=torch.tensor([[2]], device=dev))
        else:
            embeds = multimodal_embed(params, cfg, tail_ids)
        o = llama_forward(params["llm"], llm, inputs_embeds=embeds,
                          segment_ids=torch.ones((1, tail_len), dtype=torch.int32, device=dev),
                          positions=ar(cur_pos, tail_len), kv_cache=cache)
        first_tok = last_token(o)
        cur_pos += tail_len

    return {"segments": segments, "images": images}
