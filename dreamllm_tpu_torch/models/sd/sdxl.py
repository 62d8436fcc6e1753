"""SDXL diffusion head (port of ``dreamllm_tpu/models/sd/sdxl.py``): dual
conditioning and micro-conditioning time ids.

* A global projector (LLM hidden → 1280) stands in for SDXL's pooled second
  text encoder: the mean of the dream-query states, projected, is the
  UNet's ``text_embeds``.
* ``add_time_ids`` = (original size, crop top-left, target size) per image,
  embedded sinusoidally inside the UNet (its "text_time" addition).
* The fp32-VAE policy: the VAE's parameters and compute stay float32 (SDXL's
  VAE is fragile in bf16) while the UNet runs in the working dtype.

The UNet is ``models/sd/unet.py`` with ``sdxl_unet_config()``. The denoise
loop is a Python loop, as ``sd_head_pipeline``'s: the UNet runs in the
projector output's dtype (bf16 at 7B, so its self-attentions keep the flash
kernel), guidance and the sampler step in float32, the VAE in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.projector import (
    ProjectorConfig,
    init_projector_params,
    projector_forward,
)
from dreamllm_tpu_torch.models.sd.head import (
    SDHeadConfig,
    _denoise,
    _dm_mse,
    _dropped,
    _guided,
    _noised,
    _normal_source,
    _start_latents,
)
from dreamllm_tpu_torch.models.sd.unet import (
    UNetConfig,
    init_unet_params,
    sdxl_unet_config,
    unet_forward,
)
from dreamllm_tpu_torch.models.sd.vae import (
    VAEConfig,
    init_vae_params,
    vae_decode,
    vae_encode,
    vae_sample,
)

Params = dict[str, Any]


def _sdxl_vae_config() -> VAEConfig:
    # SDXL's VAE is trained with scaling_factor 0.13025 (0.18215 for SD 1.x
    # and 2.x): the SD default would mis-scale latents about 1.4x
    return VAEConfig(scaling_factor=0.13025)


@dataclasses.dataclass(frozen=True)
class SDXLHeadConfig(SDHeadConfig):
    unet: UNetConfig = dataclasses.field(default_factory=sdxl_unet_config)
    vae: VAEConfig = dataclasses.field(default_factory=_sdxl_vae_config)
    pooled_dim: int = 1280                # SDXL's pooled text-embedding width
    vae_dtype: torch.dtype = torch.float32  # the fp32-VAE policy

    def global_projector_cfg(self) -> ProjectorConfig:
        """Linear, float32 parameters (the JAX config sets no dtype)."""
        return ProjectorConfig(projector_type="linear", in_dim=self.llm_hidden_size,
                               out_dim=self.pooled_dim)


def make_add_time_ids(original_size: tuple[int, int], crop_top_left: tuple[int, int],
                      target_size: tuple[int, int], batch: int, device=None) -> torch.Tensor:
    """``[B, 6]`` float32 micro-conditioning ids."""
    ids = torch.tensor([list(original_size) + list(crop_top_left) + list(target_size)],
                       dtype=torch.float32, device=device)
    return ids.expand(batch, 6)


def init_sdxl_head_params(cfg: SDXLHeadConfig, *, generator: torch.Generator | None = None,
                          device="cuda") -> Params:
    dev = resolve_device(device)
    vae_cfg = dataclasses.replace(cfg.vae, dtype=cfg.vae_dtype)
    return {
        "projector": init_projector_params(cfg.projector_cfg(), generator=generator, device=dev),
        "global_projector": init_projector_params(cfg.global_projector_cfg(),
                                                  generator=generator, device=dev),
        "unet": init_unet_params(cfg.unet, generator=generator, device=dev),
        "vae": init_vae_params(vae_cfg, generator=generator, device=dev),
    }


def _pooled(params: Params, cfg: SDXLHeadConfig, states: torch.Tensor) -> torch.Tensor:
    """Mean over the token states → global projector → ``[B, pooled_dim]``
    ``text_embeds``, in the states' dtype."""
    pooled = states.mean(dim=1, keepdim=True)
    return projector_forward(params["global_projector"], cfg.global_projector_cfg(), pooled)[:, 0]


def sdxl_head_loss(
    params: Params,
    cfg: SDXLHeadConfig,
    images_dm: torch.Tensor,   # [B, M, H, W, 3] in [-1, 1]
    cond: torch.Tensor,        # [B, M, n_queries, llm_hidden]
    uncond: torch.Tensor,      # [1, n_queries, llm_hidden]
    valid: torch.Tensor,       # [B, M] bool
    generator: torch.Generator | None = None,
    add_time_ids: torch.Tensor | None = None,  # [B, M, 6]
    latents: torch.Tensor | None = None,       # [B, M, h, w, 4] pre-encoded
    remat_unet: bool = False,                  # per-block UNet checkpointing
    draws: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    """The SDXL head's diffusion loss: ``sd_head_loss`` with the VAE encode
    in ``cfg.vae_dtype``, the latents cast to the states' dtype, and the
    UNet conditioned on ``add_time_ids`` (default: the image's own size, no
    crop) and the pooled ``text_embeds`` of the (dropped-out) states.

    ``latents``, when given, are VAE latents already sampled and scaled
    (:func:`encode_latents`), and the VAE encoder is skipped. ``draws``
    replaces the random draws with given numbers, under the keys of
    ``sd_head_loss`` (JAX splits its key the same five ways)."""
    draws = draws or {}
    dev = cond.device
    sched = cfg.schedule(dev)
    b, m = images_dm.shape[:2]
    n = b * m
    cond = cond.reshape(n, cond.shape[2], cond.shape[3])
    valid_f = valid.reshape(n).float()
    if add_time_ids is None:
        hw = tuple(images_dm.shape[2:4])
        add_time_ids = make_add_time_ids(hw, (0, 0), hw, n, device=dev)
    else:
        add_time_ids = add_time_ids.reshape(n, 6).to(dev)
    normal = _normal_source(draws, generator, dev)

    with torch.no_grad():
        if latents is None:
            imgs = images_dm.reshape((n,) + images_dm.shape[2:]).to(cfg.vae_dtype)
            mean, logvar = vae_encode(params["vae"], cfg.vae, imgs)
            latents = vae_sample(mean, logvar, eps=normal("vae_eps", mean.shape, mean.dtype))
            latents = latents * cfg.vae.scaling_factor
        else:
            latents = latents.reshape((n,) + latents.shape[2:])
        latents = latents.detach().to(cond.dtype)

    noise, t, noisy = _noised(cfg, sched, latents, normal, draws, generator)
    states = _dropped(cfg, cond, uncond, draws, generator)
    ctx = projector_forward(params["projector"], cfg.projector_cfg(), states)
    text_embeds = _pooled(params, cfg, states)

    # the UNet in its conditioning's dtype, as in sd_head_loss
    pred = unet_forward(params["unet"], cfg.unet, noisy.to(ctx.dtype), t, ctx,
                        added_cond={"time_ids": add_time_ids, "text_embeds": text_embeds},
                        remat=remat_unet)
    loss = _dm_mse(cfg, sched, pred, latents, noise, t, valid_f)
    return loss, {"dm_mse": loss}


def make_sdxl_head_loss_fn(cfg: SDXLHeadConfig):
    """Adapter matching ``dreamllm_forward``'s ``head_loss_fn`` signature;
    takes the batch's ``add_time_ids`` and ``latents``."""

    def fn(head_params, images_dm, cond, uncond, valid, generator, add_time_ids=None,
           latents=None, draws=None, **_extras):
        return sdxl_head_loss(head_params, cfg, images_dm, cond, uncond, valid, generator,
                              add_time_ids=add_time_ids, latents=latents, draws=draws)

    return fn


def encode_latents(params: Params, cfg: SDXLHeadConfig, images_dm: torch.Tensor,
                   generator: torch.Generator | None = None, *,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, M, H, W, 3]`` → ``[B, M, h, w, 4]`` sampled and scaled VAE
    latents in ``cfg.vae_dtype``, for ``sdxl_head_loss(latents=)``. The
    normal draw is ``eps`` (``[B * M, h, w, 4]``) or comes from
    ``generator``."""
    b, m = images_dm.shape[:2]
    imgs = images_dm.reshape((b * m,) + images_dm.shape[2:]).to(cfg.vae_dtype)
    with torch.no_grad():
        mean, logvar = vae_encode(params["vae"], cfg.vae, imgs)
        lat = vae_sample(mean, logvar, generator, eps=eps) * cfg.vae.scaling_factor
    return lat.reshape((b, m) + lat.shape[1:])


def sdxl_head_pipeline(
    params: Params,
    cfg: SDXLHeadConfig,
    cond_embeds: torch.Tensor,    # [B, n_queries, llm_hidden]
    uncond_embeds: torch.Tensor,  # [B or 1, n_queries, llm_hidden]
    generator: torch.Generator | None = None,
    *,
    height: int | None = None,
    width: int | None = None,
    num_inference_steps: int = 50,
    guidance_scale: float = 5.0,
    guidance_rescale: float = 0.0,
    sampler: str = "ddim",  # "ddim" | "dpm"
    latents: torch.Tensor | None = None,  # start noise override [B, h, w, 4]
) -> torch.Tensor:
    """1024 px-class generation with dual conditioning: images ``[B, H, W,
    3]`` float32 in [0, 1]. The start noise is ``latents``, or float32
    normal noise from ``generator`` on the device of ``cond_embeds``."""
    dev = cond_embeds.device
    sched = cfg.schedule(dev)
    b = cond_embeds.shape[0]
    vae_factor = 2 ** (len(cfg.vae.block_out_channels) - 1)
    full_h = height or cfg.unet.sample_size * vae_factor
    full_w = width or cfg.unet.sample_size * vae_factor
    h, w = full_h // vae_factor, full_w // vae_factor

    pcfg = cfg.projector_cfg()
    cond = projector_forward(params["projector"], pcfg, cond_embeds)
    uncond = projector_forward(params["projector"], pcfg, uncond_embeds)
    pooled_c = _pooled(params, cfg, cond_embeds)
    pooled_u = _pooled(params, cfg, uncond_embeds)
    if uncond.shape[0] == 1 and b > 1:
        uncond = uncond.expand((b,) + uncond.shape[1:])
        pooled_u = pooled_u.expand((b,) + pooled_u.shape[1:])
    ctx = torch.cat([uncond, cond], dim=0)
    added = {"time_ids": make_add_time_ids((full_h, full_w), (0, 0), (full_h, full_w), 2 * b,
                                           device=dev),
             "text_embeds": torch.cat([pooled_u, pooled_c], dim=0)}

    latents = _start_latents(latents, b, h, w, cfg.unet.in_channels, dev, generator)

    def model_out(i, t, latents):
        lat_in = torch.cat([latents, latents], dim=0).to(ctx.dtype)
        tt = torch.full((2 * b,), t, dtype=torch.long, device=dev)
        out = unet_forward(params["unet"], cfg.unet, lat_in, tt, ctx, added_cond=added)
        return _guided(out, guidance_scale, guidance_rescale)

    latents = _denoise(sched, sampler, num_inference_steps, latents, model_out)
    imgs = vae_decode(params["vae"], cfg.vae, (latents / cfg.vae.scaling_factor).to(cfg.vae_dtype))
    return (imgs.float() / 2.0 + 0.5).clamp(0.0, 1.0)
