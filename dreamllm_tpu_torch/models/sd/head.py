"""Stable Diffusion head (port of ``dreamllm_tpu/models/sd/head.py``): the
projector from LLM hidden states to the UNet's cross-attention width,
``sd_head_loss``, the diffusion training loss, and ``sd_head_pipeline``, the
CFG denoise loop (DDIM or DPM-Solver++(2M)) followed by the VAE decode.

The denoise loop is a Python loop (JAX's is a ``fori_loop``): the CFG batch
is ``[uncond, cond]``, the UNet runs in the projector output's dtype, and
guidance, the sampler step and the VAE decode run in float32. With
``deepcache_interval=k > 1`` (DeepCache) the full UNet runs on the steps
``i % k == 0`` and keeps its deep feature, and the steps between run the
shallow UNet on it; the loop chooses on the host (JAX's ``lax.cond`` on the
device). ``controlnet_pipeline`` is the same DDIM loop with a ControlNet's
residuals added to the UNet (``models/sd/controlnet.py``). The SDXL head is
``models/sd/sdxl.py``.
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
from dreamllm_tpu_torch.models.sd.controlnet import ControlNetConfig, controlnet_forward
from dreamllm_tpu_torch.models.sd.schedulers import (
    DiffusionSchedule,
    add_noise,
    classifier_free_guidance,
    ddim_step,
    ddim_timesteps,
    dpm_solver_step,
    dpm_solver_timesteps,
    get_velocity,
    make_schedule,
    rescale_noise_cfg,
    snr,
)
from dreamllm_tpu_torch.models.sd.unet import (
    UNetConfig,
    init_unet_params,
    unet_forward,
    unet_forward_shallow,
)
from dreamllm_tpu_torch.models.sd.vae import (
    VAEConfig,
    init_vae_params,
    vae_decode,
    vae_encode,
    vae_sample,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SDHeadConfig:
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    llm_hidden_size: int = 4096
    projector: ProjectorConfig | None = None  # default: linear llm -> cross-attn
    prediction_type: str = "epsilon"
    num_train_timesteps: int = 1000
    # training knobs
    uncond_prob: float = 0.1          # CFG condition dropout
    noise_offset: float = 0.0
    input_perturbation: float = 0.0
    snr_gamma: float | None = None    # min-SNR-gamma loss weighting
    dtype: torch.dtype = torch.float32  # the projector's dtype

    def projector_cfg(self) -> ProjectorConfig:
        if self.projector is not None:
            return self.projector
        return ProjectorConfig(projector_type="linear", in_dim=self.llm_hidden_size,
                               out_dim=self.unet.cross_attention_dim, dtype=self.dtype)

    def schedule(self, device=None) -> DiffusionSchedule:
        return make_schedule(num_train_timesteps=self.num_train_timesteps,
                             prediction_type=self.prediction_type, device=device)


def init_sd_head_params(cfg: SDHeadConfig, *, generator: torch.Generator | None = None,
                        device="cuda") -> Params:
    dev = resolve_device(device)
    return {
        "projector": init_projector_params(cfg.projector_cfg(), generator=generator, device=dev),
        "unet": init_unet_params(cfg.unet, generator=generator, device=dev),
        "vae": init_vae_params(cfg.vae, generator=generator, device=dev),
    }


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _normal_source(draws: dict, generator, dev):
    """``normal(key, shape, dtype)``: ``draws[key]`` where given, else a
    draw from ``generator`` on ``dev``."""
    def normal(key, shape, dtype):
        if key in draws:
            return draws[key].to(device=dev, dtype=dtype)
        return torch.randn(shape, dtype=dtype, device=dev, generator=generator)

    return normal


def _noised(cfg: SDHeadConfig, sched: DiffusionSchedule, latents: torch.Tensor, normal,
            draws: dict, generator):
    """The training noise (with the offset and perturbation knobs), the
    timesteps and the noised latents: ``(noise, t, noisy)``."""
    n, dev = latents.shape[0], latents.device
    noise = normal("noise", latents.shape, latents.dtype)
    if cfg.noise_offset > 0:  # per-sample channel-wise offset
        noise = noise + cfg.noise_offset * normal("offset", (n, 1, 1, latents.shape[-1]),
                                                  latents.dtype)
    model_input_noise = noise
    if cfg.input_perturbation > 0:
        model_input_noise = noise + cfg.input_perturbation * normal(
            "perturbation", noise.shape, noise.dtype)
    if "t" in draws:
        t = draws["t"].to(dev).long()
    else:
        t = torch.randint(0, sched.num_train_timesteps, (n,), device=dev, generator=generator)
    return noise, t, add_noise(sched, latents, model_input_noise, t)


def _dropped(cfg: SDHeadConfig, cond: torch.Tensor, uncond: torch.Tensor, draws: dict,
             generator) -> torch.Tensor:
    """CFG condition dropout: each sample's states are the unconditional
    ones with probability ``uncond_prob``."""
    n, dev = cond.shape[0], cond.device
    if "drop" in draws:
        drop = draws["drop"].to(dev).bool()
    else:
        drop = torch.rand((n, 1, 1), device=dev, generator=generator) < cfg.uncond_prob
    return torch.where(drop, uncond.to(cond.dtype), cond)


def _dm_mse(cfg: SDHeadConfig, sched: DiffusionSchedule, pred, latents, noise, t,
            valid_f) -> torch.Tensor:
    """The (min-SNR weighted) MSE against the prediction target, averaged
    over the valid samples."""
    if cfg.prediction_type == "epsilon":
        target = noise
    elif cfg.prediction_type == "v_prediction":
        target = get_velocity(sched, latents, noise, t)
    else:
        raise ValueError(cfg.prediction_type)
    per = ((pred.float() - target.float()) ** 2).mean(dim=(1, 2, 3))
    if cfg.snr_gamma is not None:
        s = snr(sched, t)
        w = s.clamp_max(cfg.snr_gamma)
        w = w / s if cfg.prediction_type == "epsilon" else w / (s + 1.0)
        per = per * w
    return (per * valid_f).sum() / valid_f.sum().clamp_min(1.0)


def sd_head_loss(
    params: Params,
    cfg: SDHeadConfig,
    images_dm: torch.Tensor,   # [B, M, H, W, 3] in [-1, 1]
    cond: torch.Tensor,        # [B, M, n_queries, llm_hidden]
    uncond: torch.Tensor,      # [1, n_queries, llm_hidden]
    valid: torch.Tensor,       # [B, M] bool
    generator: torch.Generator | None = None,
    latents: torch.Tensor | None = None,   # [B, M, h, w, 4] pre-encoded
    remat_unet: bool = False,              # per-block UNet checkpointing
    draws: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    """Diffusion ("vm") loss over the valid dream spans.

    ``latents``, when given, are VAE latents ALREADY sampled and scaled by
    ``cfg.vae.scaling_factor``; the frozen VAE encoder is then skipped. The
    VAE runs without gradients either way.

    Random draws come from ``generator`` (on the inputs' device), or from
    ``draws``, a dict that may hold any of ``vae_eps`` (latent shape),
    ``noise`` (latent shape), ``offset`` ``[N, 1, 1, C]``, ``perturbation``
    (latent shape), ``t`` ``[N]`` int and ``drop`` ``[N, 1, 1]`` bool, with
    ``N = B * M``: JAX's and PyTorch's streams differ, so a parity test
    replays the JAX draws through it."""
    draws = draws or {}
    dev = cond.device
    sched = cfg.schedule(dev)
    b, m = images_dm.shape[:2]
    n = b * m
    cond = cond.reshape(n, cond.shape[2], cond.shape[3])
    valid_f = valid.reshape(n).float()
    normal = _normal_source(draws, generator, dev)

    with torch.no_grad():
        if latents is None:
            imgs = images_dm.reshape((n,) + images_dm.shape[2:])
            mean, logvar = vae_encode(params["vae"], cfg.vae, imgs)
            latents = vae_sample(mean, logvar, eps=normal("vae_eps", mean.shape, mean.dtype))
            latents = latents * cfg.vae.scaling_factor
        else:
            latents = latents.reshape((n,) + latents.shape[2:])
        latents = latents.detach()

    noise, t, noisy = _noised(cfg, sched, latents, normal, draws, generator)
    states = _dropped(cfg, cond, uncond, draws, generator)
    states = projector_forward(params["projector"], cfg.projector_cfg(), states)

    # The UNet runs in the dtype of its conditioning, as in the pipeline:
    # add_noise's float32 table promotes bf16 latents to float32, and the
    # flash kernels take bf16 only. With float32 states this changes nothing.
    pred = unet_forward(params["unet"], cfg.unet, noisy.to(states.dtype), t, states,
                        remat=remat_unet)
    loss = _dm_mse(cfg, sched, pred, latents, noise, t, valid_f)
    return loss, {"dm_mse": loss}


def make_head_loss_fn(cfg: SDHeadConfig, *, remat_unet: bool = False):
    """Adapter matching ``dreamllm_forward``'s ``head_loss_fn`` signature.
    Ignores the SDXL head's extras (``add_time_ids``): an SDXL head takes
    ``sdxl.make_sdxl_head_loss_fn``."""

    def fn(head_params, images_dm, cond, uncond, valid, generator, latents=None, draws=None,
           **_extras):
        return sd_head_loss(head_params, cfg, images_dm, cond, uncond, valid, generator,
                            latents=latents, remat_unet=remat_unet, draws=draws)

    return fn


# ---------------------------------------------------------------------------
# Inference pipeline
# ---------------------------------------------------------------------------


def _guided(out: torch.Tensor, guidance_scale: float, guidance_rescale: float) -> torch.Tensor:
    """Classifier-free guidance of a ``[uncond, cond]`` UNet output, in
    float32, with guidance rescale."""
    un, co = out.float().chunk(2, dim=0)
    return rescale_noise_cfg(classifier_free_guidance(co, un, guidance_scale), co,
                             guidance_rescale)


def _denoise(sched: DiffusionSchedule, sampler: str, num_inference_steps: int,
             latents: torch.Tensor, model_out) -> torch.Tensor:
    """The sampler loop from ``latents`` (float32) over its timestep table,
    on the host: ``model_out(i, t, latents)`` gives step ``i``'s guided
    model output at timestep ``t``. DDIM, or DPM-Solver++(2M) (first order
    at step 0, second order after)."""
    if sampler == "ddim":
        ts = ddim_timesteps(sched.num_train_timesteps, num_inference_steps)
    elif sampler == "dpm":
        ts = dpm_solver_timesteps(sched.num_train_timesteps, num_inference_steps)
    else:
        raise ValueError(sampler)
    ts = ts.tolist()
    b, dev = latents.shape[0], latents.device

    def full(t: int) -> torch.Tensor:
        return torch.full((b,), t, dtype=torch.long, device=dev)

    last_x0 = None
    for i, t in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < len(ts) else -1
        out = model_out(i, t, latents)
        if sampler == "ddim":
            latents = ddim_step(sched, out, full(t), full(t_prev), latents)
        else:
            t_last = full(ts[i - 1]) if last_x0 is not None else None
            latents, last_x0 = dpm_solver_step(sched, out, full(t), full(t_prev), latents,
                                               last_x0, t_last)
    return latents


def _start_latents(latents, b: int, h: int, w: int, channels: int, dev, generator):
    """``latents`` on ``dev`` in float32, or float32 normal noise from
    ``generator``."""
    if latents is None:
        latents = torch.randn((b, h, w, channels), dtype=torch.float32, device=dev,
                              generator=generator)
    return latents.to(device=dev, dtype=torch.float32)


def sd_head_pipeline(
    params: Params,
    cfg: SDHeadConfig,
    cond_embeds: torch.Tensor,    # [B, n_queries, llm_hidden]
    uncond_embeds: torch.Tensor,  # [B or 1, n_queries, llm_hidden]
    generator: torch.Generator | None = None,
    *,
    height: int | None = None,
    width: int | None = None,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    guidance_rescale: float = 0.0,
    sampler: str = "ddim",  # "ddim" | "dpm"
    deepcache_interval: int = 1,  # k > 1: full UNet every k-th step, shallow between
    return_latents: bool = False,
    latents: torch.Tensor | None = None,  # start noise override [B, h, w, 4]
) -> torch.Tensor:
    """Images ``[B, H, W, 3]`` in [0, 1] (float32) from dream-query hidden
    states, or with ``return_latents`` the final float32 latents ``[B, h,
    w, 4]`` without the VAE decode. The start noise is ``latents``, or
    float32 normal noise from ``generator`` on the device of
    ``cond_embeds``."""
    dev = cond_embeds.device
    sched = cfg.schedule(dev)
    b = cond_embeds.shape[0]
    vae_factor = 2 ** (len(cfg.vae.block_out_channels) - 1)
    h = (height or cfg.unet.sample_size * vae_factor) // vae_factor
    w = (width or cfg.unet.sample_size * vae_factor) // vae_factor

    pcfg = cfg.projector_cfg()
    cond = projector_forward(params["projector"], pcfg, cond_embeds)
    uncond = projector_forward(params["projector"], pcfg, uncond_embeds)
    if uncond.shape[0] == 1 and b > 1:
        uncond = uncond.expand((b,) + uncond.shape[1:])
    ctx = torch.cat([uncond, cond], dim=0)  # [2B, S, D]
    latents = _start_latents(latents, b, h, w, cfg.unet.in_channels, dev, generator)
    deep = None  # the deep feature of the latest full step

    def model_out(i, t, latents):
        nonlocal deep
        lat_in = torch.cat([latents, latents], dim=0).to(cond.dtype)
        tt = torch.full((2 * b,), t, dtype=torch.long, device=dev)
        if deepcache_interval <= 1 or i % deepcache_interval == 0:
            out, deep = unet_forward(params["unet"], cfg.unet, lat_in, tt, ctx, return_deep=True)
        else:
            out = unet_forward_shallow(params["unet"], cfg.unet, lat_in, tt, ctx, deep)
        return _guided(out, guidance_scale, guidance_rescale)

    latents = _denoise(sched, sampler, num_inference_steps, latents, model_out)
    if return_latents:
        return latents
    imgs = vae_decode(params["vae"], cfg.vae, latents / cfg.vae.scaling_factor)
    return (imgs / 2.0 + 0.5).clamp(0.0, 1.0)


def controlnet_pipeline(
    params: Params,
    cfg: SDHeadConfig,
    controlnet_params: Params,
    controlnet_cfg: ControlNetConfig,
    cond_image: torch.Tensor,     # [B, H, W, C] control image in [0, 1]
    cond_embeds: torch.Tensor,    # [B, n_queries, llm_hidden]
    uncond_embeds: torch.Tensor,  # [B or 1, n_queries, llm_hidden]
    generator: torch.Generator | None = None,
    *,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    guidance_rescale: float = 0.0,
    conditioning_scale: float = 1.0,
    return_latents: bool = False,
    latents: torch.Tensor | None = None,  # start noise override [B, h, w, 4]
) -> torch.Tensor:
    """ControlNet-conditioned generation from dream-query hidden states
    (JAX ``head.py controlnet_pipeline``): DDIM, the control image
    CFG-duplicated like the latents (``[uncond, cond]``), the ControlNet's
    residuals scaled by ``conditioning_scale`` and added to the UNet's skips
    and mid block every step. The image size is the control image's; the
    UNet and the ControlNet run in the projector output's dtype, guidance,
    the step and the VAE decode in float32. Returns ``[B, H, W, 3]`` in
    [0, 1], or the final latents with ``return_latents``."""
    dev = cond_embeds.device
    sched = cfg.schedule(dev)
    b = cond_embeds.shape[0]
    vae_factor = 2 ** (len(cfg.vae.block_out_channels) - 1)
    h = cond_image.shape[1] // vae_factor
    w = cond_image.shape[2] // vae_factor

    pcfg = cfg.projector_cfg()
    cond = projector_forward(params["projector"], pcfg, cond_embeds)
    uncond = projector_forward(params["projector"], pcfg, uncond_embeds)
    if uncond.shape[0] == 1 and b > 1:
        uncond = uncond.expand((b,) + uncond.shape[1:])
    ctx = torch.cat([uncond, cond], dim=0)
    cimg2 = torch.cat([cond_image, cond_image], dim=0).to(dev)
    latents = _start_latents(latents, b, h, w, cfg.unet.in_channels, dev, generator)

    def model_out(i, t, latents):
        lat_in = torch.cat([latents, latents], dim=0).to(ctx.dtype)
        tt = torch.full((2 * b,), t, dtype=torch.long, device=dev)
        down_res, mid_res = controlnet_forward(
            controlnet_params, controlnet_cfg, lat_in, tt, ctx, cimg2,
            conditioning_scale=conditioning_scale)
        out = unet_forward(params["unet"], cfg.unet, lat_in, tt, ctx,
                           down_block_residuals=down_res, mid_block_residual=mid_res)
        return _guided(out, guidance_scale, guidance_rescale)

    latents = _denoise(sched, "ddim", num_inference_steps, latents, model_out)
    if return_latents:
        return latents
    imgs = vae_decode(params["vae"], cfg.vae, latents / cfg.vae.scaling_factor)
    return (imgs / 2.0 + 0.5).clamp(0.0, 1.0)
