"""Diffusion noise schedule and the samplers, DDPM (ancestral), DDIM and
DPM-Solver++(2M), with the training-side helpers ``add_noise``,
``get_velocity`` and ``snr`` (port of
``dreamllm_tpu/models/sd/schedulers.py``).

Pure functions over a precomputed :class:`DiffusionSchedule`. The table is
built in float64 with numpy, as in JAX, and kept as a float32 tensor; a
sampler's timesteps are integer tensors (``[B]``) on the table's device.
``t < 0`` as a previous timestep marks the final step. Numerics follow
diffusers' SD defaults: "scaled_linear" betas, "leading" spacing with
``steps_offset=1``, and ``set_alpha_to_one=False`` for DDIM.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor            # [T] float32
    alphas_cumprod: torch.Tensor   # [T] float32
    num_train_timesteps: int
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction"


def make_schedule(num_train_timesteps: int = 1000, prediction_type: str = "epsilon", *,
                  device=None) -> DiffusionSchedule:
    """SD's "scaled_linear" betas (0.00085 to 0.012)."""
    betas = np.linspace(0.00085**0.5, 0.012**0.5, num_train_timesteps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        betas=torch.tensor(betas, dtype=torch.float32, device=device),
        alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32, device=device),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-sample table values, shaped to broadcast against rank ``ndim``."""
    v = table[t.long()].float()
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def add_noise(sched: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor):
    """Forward process q(x_t | x_0) (diffusers ``DDPMScheduler.add_noise``)."""
    acp = _extract(sched.alphas_cumprod, t, x0.ndim)
    return acp.sqrt() * x0 + (1.0 - acp).sqrt() * noise


def get_velocity(sched: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor):
    """v-prediction target: ``v = sqrt(acp) * eps - sqrt(1 - acp) * x0``."""
    acp = _extract(sched.alphas_cumprod, t, x0.ndim)
    return acp.sqrt() * noise - (1.0 - acp).sqrt() * x0


def snr(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio per timestep (min-SNR-gamma weighting)."""
    acp = sched.alphas_cumprod[t.long()].float()
    return acp / (1.0 - acp)


def pred_x0_eps(sched: DiffusionSchedule, model_out, x_t, t):
    """``(x0, eps)`` recovered from the model output."""
    acp = _extract(sched.alphas_cumprod, t, x_t.ndim)
    sqrt_acp, sqrt_1macp = acp.sqrt(), (1.0 - acp).sqrt()
    if sched.prediction_type == "epsilon":
        eps = model_out
        x0 = (x_t - sqrt_1macp * eps) / sqrt_acp
    elif sched.prediction_type == "v_prediction":
        x0 = sqrt_acp * x_t - sqrt_1macp * model_out
        eps = sqrt_acp * model_out + sqrt_1macp * x_t
    else:
        raise ValueError(sched.prediction_type)
    return x0, eps


def ddpm_step(sched: DiffusionSchedule, model_out, t, x_t,
              generator: torch.Generator | None = None):
    """One ancestral DDPM step x_t → x_{t-1} (diffusers ``DDPMScheduler.step``,
    ``variance_type="fixed_small"``, no clipping: SD latents are unbounded).
    The noise is standard normal from ``generator`` on ``x_t``'s device; it
    is not added where ``t == 0``."""
    acp_t = _extract(sched.alphas_cumprod, t, x_t.ndim)
    acp_prev_table = torch.cat([torch.ones_like(sched.alphas_cumprod[:1]),
                                sched.alphas_cumprod[:-1]])
    acp_prev = _extract(acp_prev_table, t, x_t.ndim)
    beta_t = _extract(sched.betas, t, x_t.ndim)
    alpha_t = 1.0 - beta_t

    x0, _ = pred_x0_eps(sched, model_out, x_t, t)
    coef_x0 = acp_prev.sqrt() * beta_t / (1.0 - acp_t)
    coef_xt = alpha_t.sqrt() * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * x0 + coef_xt * x_t
    var = beta_t * (1.0 - acp_prev) / (1.0 - acp_t)
    noise = torch.randn(x_t.shape, dtype=x_t.dtype, device=x_t.device, generator=generator)
    nonzero = (t > 0).float().reshape((-1,) + (1,) * (x_t.ndim - 1))
    return mean + nonzero * var.clamp_min(1e-20).sqrt() * noise


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int) -> torch.Tensor:
    """"leading" spacing + ``steps_offset`` 1, descending, int64 on the CPU."""
    ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.int64) + 1
    return torch.from_numpy(np.clip(ts, 0, num_train_timesteps - 1).copy())


def _acp_prev(sched: DiffusionSchedule, t_prev, final: float | torch.Tensor):
    acp = sched.alphas_cumprod
    final = torch.as_tensor(final, dtype=acp.dtype, device=acp.device)
    return torch.where(t_prev >= 0, acp[t_prev.long().clamp_min(0)], final)


def ddim_step(sched: DiffusionSchedule, model_out, t, t_prev, x_t):
    """Deterministic (eta 0) DDIM step t → t_prev. The final alpha_cumprod
    is ``alphas_cumprod[0]``, as SD's ``set_alpha_to_one=False`` configs
    give it."""
    acp_t = _extract(sched.alphas_cumprod, t, x_t.ndim)
    acp_prev = _acp_prev(sched, t_prev, sched.alphas_cumprod[0]).reshape(acp_t.shape)
    x0, eps = pred_x0_eps(sched, model_out, x_t, t)
    return acp_prev.sqrt() * x0 + (1.0 - acp_prev).clamp_min(0.0).sqrt() * eps


def dpm_solver_timesteps(num_train_timesteps: int, num_inference_steps: int) -> torch.Tensor:
    """Same leading spacing as DDIM."""
    return ddim_timesteps(num_train_timesteps, num_inference_steps)


def _lambda(acp: torch.Tensor, tt: torch.Tensor) -> torch.Tensor:
    # final boundary (tt < 0): alpha 1, sigma 0; the 1e-10 sigma floor makes
    # lambda ~ +23, so expm1(-h) saturates at -1 and the last update lands
    # exactly on x0
    a = torch.where(tt >= 0, acp[tt.long().clamp_min(0)], torch.ones_like(acp[:1]))
    return a.sqrt().log() - (1.0 - a).sqrt().clamp_min(1e-10).log()


def dpm_solver_step(sched: DiffusionSchedule, model_out, t, t_prev, x_t, last_x0, t_last):
    """One DPM-Solver++(2M) step in x0 form; first order when ``last_x0``
    or ``t_last`` is None. Returns ``(x_prev, x0)``."""
    acp = sched.alphas_cumprod
    x0, _ = pred_x0_eps(sched, model_out, x_t, t)
    lam_t, lam_prev = _lambda(acp, t), _lambda(acp, t_prev)
    h = lam_prev - lam_t
    shape = (-1,) + (1,) * (x_t.ndim - 1)
    a_prev = _acp_prev(sched, t_prev, 1.0)
    alpha_prev = a_prev.sqrt().reshape(shape)
    sigma_prev = (1.0 - a_prev).sqrt().reshape(shape)
    sigma_t = (1.0 - acp[t.long()]).sqrt().reshape(shape)
    phi = torch.expm1(-h).reshape(shape)
    if last_x0 is None or t_last is None:
        d = x0
    else:
        r = (lam_t - _lambda(acp, t_last)) / h.clamp_min(1e-10)
        d = (1.0 + 1.0 / (2.0 * r)).reshape(shape) * x0 - (1.0 / (2.0 * r)).reshape(shape) * last_x0
    x_prev = (sigma_prev / sigma_t.clamp_min(1e-10)) * x_t - alpha_prev * phi * d
    return x_prev, x0


def classifier_free_guidance(cond_out, uncond_out, scale):
    return uncond_out + scale * (cond_out - uncond_out)


def rescale_noise_cfg(noise_cfg, noise_cond, guidance_rescale: float = 0.0):
    """Rescale the guided prediction's std to the conditional one's."""
    if guidance_rescale == 0.0:
        return noise_cfg
    dims = tuple(range(1, noise_cfg.ndim))
    std_cond = noise_cond.std(dim=dims, keepdim=True, unbiased=False)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_cond / std_cfg.clamp_min(1e-8))
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg
