"""DreamLLM model core (port of ``dreamllm_tpu/models/dreamllm.py``): the
LLM with its CLIP image plugin and learned dream queries, static-offset span
splicing, dream-span extraction, a text prompt's dream states
(``encode_prompt_embeds``, the conditioning of text-to-image creation), the
CFG-unconditional dream states, and the joint training forward
``dreamllm_forward`` (LM + diffusion loss) with ``param_freeze_mask``.

Span conventions (reference builder): image span ``<im_start> +
256x<im_patch> + <im_end>``, dream span ``<dream_start> + 64x<dream> +
<dream_end>``; ``image_positions``/``dream_positions`` point at the first
patch slot, -1 = absent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.clip import (
    CLIPVisionConfig,
    clip_vision_forward,
    init_clip_vision_params,
)
from dreamllm_tpu_torch.models.llama import (
    LlamaConfig,
    init_llama_params,
    llama_forward,
    llama_logits,
)
from dreamllm_tpu_torch.models.projector import (
    ProjectorConfig,
    init_projector_params,
    projector_forward,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Ids of the added multimodal control tokens."""

    image: int = 32000
    im_patch: int = 32001
    im_start: int = 32002
    im_end: int = 32003
    dream: int = 32004
    dream_start: int = 32005
    dream_end: int = 32006
    bos: int = 1
    eos: int = 2
    pad: int = 0


@dataclasses.dataclass(frozen=True)
class DreamLLMConfig:
    """Assembled model recipe (the JAX config's fields)."""

    llm: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    vision_projector: ProjectorConfig | None = None  # default derived
    special_tokens: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)
    n_dream_queries: int = 64
    vision_select_layer: int = -2
    image_embed_len: int = 256  # (image_size / patch_size) ** 2
    loss_weight_lm: float = 1.0
    loss_weight_vm: float = 1.0
    # "none" | "l1" | "l2": divide the joint loss by the norm of its two weights
    loss_scale: str = "none"
    # log per-decoder-layer activation abs-max into aux
    log_hidden_states: bool = False
    # frozen plugins: slash-separated path prefixes, e.g.
    # ("clip_vision_embedding/clip", "llm"); read by param_freeze_mask
    frozen: tuple[str, ...] = ()
    # Sequence and pipeline parallelism are not ported: dreamllm_forward
    # raises NotImplementedError when either axis is set.
    sequence_parallel_axis: str | None = None
    pipeline_parallel_axis: str | None = None
    pipeline_microbatches: int | None = None
    # NEFTune: during training add U(-mag, +mag) noise to the TOKEN embedding
    # lookup, mag = alpha / sqrt(S * H); spliced image/dream features
    # overwrite it. None/0 = off.
    neftune_noise_alpha: float | None = None

    def projector_cfg(self) -> ProjectorConfig:
        if self.vision_projector is not None:
            return self.vision_projector
        return ProjectorConfig(
            projector_type="linear", in_dim=self.vision.hidden_size, out_dim=self.llm.hidden_size,
        )


def init_dreamllm_params(cfg: DreamLLMConfig, *, generator: torch.Generator | None = None,
                         device="cuda") -> Params:
    dev = resolve_device(device)
    h = cfg.llm.hidden_size
    queries = torch.randn((cfg.n_dream_queries, h), dtype=torch.float32, device=dev,
                          generator=generator) * h ** -0.5
    return {
        "llm": init_llama_params(cfg.llm, generator=generator, device=dev),
        "clip_vision_embedding": {
            "clip": init_clip_vision_params(cfg.vision, generator=generator, device=dev),
            "projector": init_projector_params(cfg.projector_cfg(), generator=generator,
                                               device=dev),
        },
        "dream_embedding": {"queries": queries.to(cfg.llm.dtype)},
    }


# ---------------------------------------------------------------------------
# Multimodal splicing
# ---------------------------------------------------------------------------


def encode_images(params: Params, cfg: DreamLLMConfig, images: torch.Tensor) -> torch.Tensor:
    """CLIP → projector: ``[N, H, W, 3]`` normalized → ``[N, 256, H_llm]``."""
    feats = clip_vision_forward(
        params["clip_vision_embedding"]["clip"], cfg.vision, images,
        select_layer=cfg.vision_select_layer, drop_cls=True,
    )
    return projector_forward(params["clip_vision_embedding"]["projector"],
                             cfg.projector_cfg(), feats)


def _scatter_spans(embeds: torch.Tensor, feats: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Copy of ``embeds`` with ``feats[b, m]`` written at
    ``embeds[b, pos:pos+L]`` for every ``pos >= 0``; slots past the end are
    dropped, as JAX's ``mode="drop"`` scatter drops them."""
    b, s, h = embeds.shape
    _, m, l, _ = feats.shape
    positions = positions.to(embeds.device).long()
    offs = positions[:, :, None] + torch.arange(l, device=embeds.device)[None, None, :]
    keep = (positions[:, :, None] >= 0) & (offs < s)
    rows = torch.arange(b, device=embeds.device)[:, None, None].expand(b, m, l)
    out = embeds.clone()
    out[rows[keep], offs[keep]] = feats[keep].to(embeds.dtype)
    return out


def multimodal_embed(
    params: Params,
    cfg: DreamLLMConfig,
    input_ids: torch.Tensor,                       # [B, S]
    images: torch.Tensor | None = None,            # [B, M_img, H, W, 3] CLIP-normalized
    image_positions: torch.Tensor | None = None,   # [B, M_img]
    dream_positions: torch.Tensor | None = None,   # [B, M_dream]
    neftune_generator: torch.Generator | None = None,
    neftune_noise: torch.Tensor | None = None,     # [B, S, H] in [0, 1): replaces the draw
) -> torch.Tensor:
    """Token embeddings with image features and dream queries spliced in.

    With ``cfg.neftune_noise_alpha`` and either a ``neftune_generator`` or a
    ``neftune_noise`` (uniform [0, 1) numbers, for a replayed draw), uniform
    noise of magnitude ``alpha / sqrt(S * H)`` is added to the token
    embeddings BEFORE splicing, so the spliced spans overwrite it."""
    embeds = params["llm"]["embed_tokens"][input_ids]
    b, s, h = embeds.shape
    if cfg.neftune_noise_alpha and (neftune_generator is not None or neftune_noise is not None):
        mag = cfg.neftune_noise_alpha / math.sqrt(s * h)
        if neftune_noise is None:
            neftune_noise = torch.rand(embeds.shape, dtype=torch.float32, device=embeds.device,
                                       generator=neftune_generator)
        u = neftune_noise.to(device=embeds.device, dtype=torch.float32)
        embeds = embeds + (u * (2.0 * mag) - mag).to(embeds.dtype)
    if images is not None and image_positions is not None:
        n_img = images.shape[1]
        feats = encode_images(params, cfg, images.reshape((b * n_img,) + images.shape[2:]))
        feats = feats.reshape(b, n_img, cfg.image_embed_len, h)
        embeds = _scatter_spans(embeds, feats, image_positions)
    if dream_positions is not None:
        m = dream_positions.shape[1]
        q = params["dream_embedding"]["queries"]
        feats = q[None, None].expand(b, m, cfg.n_dream_queries, h)
        embeds = _scatter_spans(embeds, feats, dream_positions)
    return embeds


def extract_dream_hidden(hidden: torch.Tensor, dream_positions: torch.Tensor,
                         n_queries: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather the dream-query hidden states per span: ``(cond [B, M,
    n_queries, H], valid [B, M])``; absent spans gather position 0."""
    b, s, _ = hidden.shape
    m = dream_positions.shape[1]
    dream_positions = dream_positions.to(hidden.device).long()
    valid = dream_positions >= 0
    pos = torch.where(valid, dream_positions, 0)
    offs = (pos[:, :, None] + torch.arange(n_queries, device=hidden.device)).clamp(0, s - 1)
    rows = torch.arange(b, device=hidden.device)[:, None, None].expand(b, m, n_queries)
    return hidden[rows, offs], valid


def canonical_dream_sequence(cfg: DreamLLMConfig, device=None) -> torch.Tensor:
    """``[[bos, <dream_start>, 64x<dream>, <dream_end>, eos]]`` int64, the
    sequence of the CFG-unconditional dream states."""
    st = cfg.special_tokens
    ids = [st.bos, st.dream_start] + [st.dream] * cfg.n_dream_queries + [st.dream_end, st.eos]
    return torch.tensor([ids], dtype=torch.long, device=device)


def encode_prompt_embeds(params: Params, cfg: DreamLLMConfig, tokenizer,
                         prompt: str) -> torch.Tensor:
    """Text prompt → ``[1, n_queries, H]`` dream-query hidden states, the
    conditioning of text-to-image creation: ``bos`` + the prompt's tokens +
    a dream span, one spliced forward with plain attention (as JAX,
    ``use_flash=False``), the queries' states gathered. ``tokenizer`` has
    ``encode(str) -> list[int]``; the forward runs where the parameters
    are."""
    st = cfg.special_tokens
    dev = params["llm"]["embed_tokens"].device
    ids = [st.bos] + list(tokenizer.encode(prompt))
    dream_pos = torch.tensor([[len(ids) + 1]], device=dev)
    ids += [st.dream_start] + [st.dream] * cfg.n_dream_queries + [st.dream_end]
    arr = torch.tensor([ids], dtype=torch.long, device=dev)
    embeds = multimodal_embed(params, cfg, arr, dream_positions=dream_pos)
    out = llama_forward(params["llm"], cfg.llm, inputs_embeds=embeds, use_flash=False)
    cond, _ = extract_dream_hidden(out["last_hidden_state"], dream_pos, cfg.n_dream_queries)
    return cond[:, 0]


def unconditional_dream_hidden(params: Params, cfg: DreamLLMConfig, *,
                               remat: bool | str | int = False) -> torch.Tensor:
    """LLM forward over the canonical dream sequence → ``[1, 64, H]``.

    Plain attention, as in JAX (``use_flash=False``): the ~68-token
    sequence is below the flash rule anyway. Pass ``remat`` when called
    inside a rematerialized training loss: the sequence is short, but
    without it every layer's activations of this side forward are saved."""
    dev = params["llm"]["embed_tokens"].device
    ids = canonical_dream_sequence(cfg, dev)
    pos = torch.tensor([[2]], device=dev)
    embeds = multimodal_embed(params, cfg, ids, dream_positions=pos)
    out = llama_forward(params["llm"], cfg.llm, inputs_embeds=embeds, use_flash=False,
                        remat=remat)
    cond, _ = extract_dream_hidden(out["last_hidden_state"], pos, cfg.n_dream_queries)
    return cond[:, 0]


# ---------------------------------------------------------------------------
# Forward + joint loss
# ---------------------------------------------------------------------------


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -100) -> torch.Tensor:
    """Shifted masked-mean cross entropy. logits ``[B, S, V]``, labels
    ``[B, S]``; an all-ignored batch gives 0."""
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:].long()
    mask = shift_labels != ignore_index
    safe = torch.where(mask, shift_labels, 0)
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    total = (nll * mask).sum()
    count = mask.sum().clamp_min(1)
    return total / count


HeadLossFn = Callable[..., tuple[torch.Tensor, dict]]


def dreamllm_forward(
    params: Params,
    cfg: DreamLLMConfig,
    batch: dict,
    *,
    head_loss_fn: HeadLossFn | None = None,
    head_params: Params | None = None,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
    use_flash: bool = True,
    remat: bool | str | int = False,
) -> tuple[torch.Tensor, dict]:
    """Joint training forward.

    ``batch`` keys (all optional except ``input_ids``): ``input_ids``
    ``[B, S]``, ``labels`` ``[B, S]`` (-100 ignored), ``segment_ids``,
    ``positions``, ``images`` ``[B, M_img, Hi, Wi, 3]``, ``image_positions``
    ``[B, M_img]``, ``dream_positions`` ``[B, M_dream]``, ``images_dm``
    ``[B, M_dream, Hd, Wd, 3]``, ``latents`` (pre-encoded, sampled, scaled).

    ``head_loss_fn(head_params, images_dm, cond, uncond, valid, generator,
    **extras)`` computes the diffusion ("vm") loss; ``valid`` masks absent
    dream spans. ``generator`` feeds NEFTune and the head's draws; a
    generator (or ``draws``) here means training, as an rng does in JAX.
    ``draws`` replaces them with given numbers: ``neftune`` (uniform [0, 1),
    the embeddings' shape) and the head's keys (see ``sd_head_loss``).

    Returns ``(loss, aux)``; aux carries the ``lm_loss``/``vm_loss`` scalars.
    """
    if cfg.sequence_parallel_axis is not None and cfg.pipeline_parallel_axis is not None:
        raise ValueError("sequence_parallel_axis and pipeline_parallel_axis are mutually exclusive")
    if cfg.sequence_parallel_axis is not None or cfg.pipeline_parallel_axis is not None:
        raise NotImplementedError(
            "the sequence- and pipeline-parallel training forwards are not ported "
            "(ROADMAP Queue 1 #22); clear cfg.sequence_parallel_axis / pipeline_parallel_axis")
    draws = draws or {}
    embeds = multimodal_embed(
        params, cfg, batch["input_ids"],
        images=batch.get("images"),
        image_positions=batch.get("image_positions"),
        dream_positions=batch.get("dream_positions"),
        neftune_generator=generator,
        neftune_noise=draws.get("neftune"),
    )
    out = llama_forward(
        params["llm"], cfg.llm,
        inputs_embeds=embeds,
        segment_ids=batch.get("segment_ids"),
        positions=batch.get("positions"),
        use_flash=use_flash,
        remat=remat,
        output_stats=cfg.log_hidden_states,
    )
    hidden = out["last_hidden_state"]
    dev = hidden.device

    aux: dict = {}
    if cfg.log_hidden_states and "layer_absmax" in out:
        aux["hidden_absmax_max"] = out["layer_absmax"].max()
        aux["hidden_absmax_mean"] = out["layer_absmax"].mean()
    lm_loss = torch.zeros((), dtype=torch.float32, device=dev)
    if batch.get("labels") is not None and cfg.loss_weight_lm != 0.0:
        logits = llama_logits(params["llm"], cfg.llm, hidden)
        lm_loss = masked_cross_entropy(logits, batch["labels"])
    aux["lm_loss"] = lm_loss

    vm_loss = torch.zeros((), dtype=torch.float32, device=dev)
    if (head_loss_fn is not None and batch.get("dream_positions") is not None
            and batch.get("images_dm") is not None and cfg.loss_weight_vm != 0.0):
        cond, valid = extract_dream_hidden(hidden, batch["dream_positions"], cfg.n_dream_queries)
        uncond = unconditional_dream_hidden(params, cfg, remat=remat)  # [1, 64, H]
        extras = {k: batch[k] for k in ("add_time_ids", "latents") if batch.get(k) is not None}
        head_draws = {k: v for k, v in draws.items() if k != "neftune"}
        if head_draws:
            extras["draws"] = head_draws
        vm_loss, head_aux = head_loss_fn(head_params, batch["images_dm"], cond, uncond, valid,
                                         generator, **extras)
        aux.update(head_aux)
    aux["vm_loss"] = vm_loss

    # NaN rerouting between the two terms keeps the forward VALUE finite. It
    # does not scrub the gradient path (0 * NaN = NaN through the bad
    # branch): make_train_step's isfinite(loss) & isfinite(grad_norm) gate
    # drops such an update.
    lm_loss = torch.where(torch.isfinite(lm_loss), lm_loss, torch.zeros_like(lm_loss))
    vm_loss = torch.where(torch.isfinite(vm_loss), vm_loss, torch.zeros_like(vm_loss))
    loss = cfg.loss_weight_lm * lm_loss + cfg.loss_weight_vm * vm_loss
    # loss_scale: divide by the l1/l2 norm of the two constant loss WEIGHTS
    if cfg.loss_scale != "none":
        a, b = cfg.loss_weight_lm, cfg.loss_weight_vm
        denom = (a + b) if cfg.loss_scale == "l1" else math.sqrt(a ** 2 + b ** 2)
        loss = loss / max(denom, 1e-8)
    return loss, aux


def param_freeze_mask(params: Params, cfg: DreamLLMConfig) -> Params:
    """Tree of bools with the parameters' structure: True = trainable.
    ``cfg.frozen`` entries are slash-separated path PREFIXES: ``"llm"``
    freezes the whole decoder, ``"clip_vision_embedding/clip"`` the ViT but
    not its projector."""

    def walk(tree, path: str):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(tree)]
        return not any(path == f or path.startswith(f + "/") for f in cfg.frozen)

    return walk(params, "")
