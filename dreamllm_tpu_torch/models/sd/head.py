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
device). The SDXL head is not ported yet.
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

    def normal(key, shape, dtype):
        if key in draws:
            return draws[key].to(device=dev, dtype=dtype)
        return torch.randn(shape, dtype=dtype, device=dev, generator=generator)

    with torch.no_grad():
        if latents is None:
            imgs = images_dm.reshape((n,) + images_dm.shape[2:])
            mean, logvar = vae_encode(params["vae"], cfg.vae, imgs)
            latents = vae_sample(mean, logvar, eps=normal("vae_eps", mean.shape, mean.dtype))
            latents = latents * cfg.vae.scaling_factor
        else:
            latents = latents.reshape((n,) + latents.shape[2:])
        latents = latents.detach()

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
    noisy = add_noise(sched, latents, model_input_noise, t)

    # CFG condition dropout: Bernoulli-mix cond/uncond states
    if "drop" in draws:
        drop = draws["drop"].to(dev).bool()
    else:
        drop = torch.rand((n, 1, 1), device=dev, generator=generator) < cfg.uncond_prob
    states = torch.where(drop, uncond.to(cond.dtype), cond)
    states = projector_forward(params["projector"], cfg.projector_cfg(), states)

    # The UNet runs in the dtype of its conditioning, as in the pipeline:
    # add_noise's float32 table promotes bf16 latents to float32, and the
    # flash kernels take bf16 only. With float32 states this changes nothing.
    pred = unet_forward(params["unet"], cfg.unet, noisy.to(states.dtype), t, states,
                        remat=remat_unet)

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
    loss = (per * valid_f).sum() / valid_f.sum().clamp_min(1.0)
    return loss, {"dm_mse": loss}


def make_head_loss_fn(cfg: SDHeadConfig, *, remat_unet: bool = False):
    """Adapter matching ``dreamllm_forward``'s ``head_loss_fn`` signature.
    Ignores SDXL-only extras (``add_time_ids``)."""

    def fn(head_params, images_dm, cond, uncond, valid, generator, latents=None, draws=None,
           **_extras):
        return sd_head_loss(head_params, cfg, images_dm, cond, uncond, valid, generator,
                            latents=latents, remat_unet=remat_unet, draws=draws)

    return fn


# ---------------------------------------------------------------------------
# Inference pipeline
# ---------------------------------------------------------------------------


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

    if latents is None:
        latents = torch.randn((b, h, w, cfg.unet.in_channels), dtype=torch.float32,
                              device=dev, generator=generator)
    latents = latents.to(device=dev, dtype=torch.float32)

    if sampler == "ddim":
        ts = ddim_timesteps(sched.num_train_timesteps, num_inference_steps)
    elif sampler == "dpm":
        ts = dpm_solver_timesteps(sched.num_train_timesteps, num_inference_steps)
    else:
        raise ValueError(sampler)
    ts = ts.tolist()

    def full(t: int, n: int) -> torch.Tensor:
        return torch.full((n,), t, dtype=torch.long, device=dev)

    last_x0 = None
    deep = None  # the deep feature of the latest full step
    for i, t in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < len(ts) else -1
        lat_in = torch.cat([latents, latents], dim=0).to(cond.dtype)
        if deepcache_interval <= 1 or i % deepcache_interval == 0:
            out, deep = unet_forward(params["unet"], cfg.unet, lat_in, full(t, 2 * b), ctx,
                                     return_deep=True)
        else:
            out = unet_forward_shallow(params["unet"], cfg.unet, lat_in, full(t, 2 * b), ctx,
                                       deep)
        out = out.float()
        un, co = out.chunk(2, dim=0)
        model_out = rescale_noise_cfg(classifier_free_guidance(co, un, guidance_scale), co,
                                      guidance_rescale)
        if sampler == "ddim":
            latents = ddim_step(sched, model_out, full(t, b), full(t_prev, b), latents)
        else:  # first order at step 0, second order after
            t_last = full(ts[i - 1], b) if last_x0 is not None else None
            latents, last_x0 = dpm_solver_step(sched, model_out, full(t, b), full(t_prev, b),
                                               latents, last_x0, t_last)

    if return_latents:
        return latents
    imgs = vae_decode(params["vae"], cfg.vae, latents / cfg.vae.scaling_factor)
    return (imgs / 2.0 + 0.5).clamp(0.0, 1.0)
