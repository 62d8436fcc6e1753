"""Plain Stable Diffusion / SDXL fine-tuning (port of
``projects/stable_diffusion/train.py``): the UNet trains on image/caption
pairs with a fixed conditioning encoder (captions embedded by a hashed
random draw), DDPM loss, an EMA of the UNet, and a validation sample at the
end.

``head_type: "sdxl"`` in the recipe (or the ``train_sdxl`` entry point)
switches to the SDXL head: dual conditioning, ``add_time_ids`` and the
float32-VAE policy.

    python -m dreamllm_tpu_torch.projects.stable_diffusion.train \\
        --config_file projects/stable_diffusion/configs/smoke.py device=cpu
    python -m dreamllm_tpu_torch.projects.stable_diffusion.train_sdxl \\
        --config_file projects/stable_diffusion/configs/smoke_xl.py device=cpu
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

import dreamllm_tpu_torch.data.catalog  # noqa: F401 — registers datasets
from dreamllm_tpu_torch.config import LazyArgumentParser, default_setup, instantiate
from dreamllm_tpu_torch.data import DataManager
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.sd.head import SDHeadConfig, sd_head_loss, sd_head_pipeline
from dreamllm_tpu_torch.projects.dreamllm.train import seeded, torch_dtypes
from dreamllm_tpu_torch.train.optim import (
    OptimizerConfig,
    apply_updates,
    ema_decay_schedule,
    ema_update,
    make_optimizer,
)
from dreamllm_tpu_torch.train.step import TrainState, init_train_state
from dreamllm_tpu_torch.train.trainer import Trainer, TrainerConfig
from dreamllm_tpu_torch.train.tree import tree_leaves, tree_map
from dreamllm_tpu_torch.utils.logging import get_logger
from dreamllm_tpu_torch.utils.metrics_logger import MetricsLogger

logger = get_logger("projects.stable_diffusion.train")


def init_sd_params(head_cfg: SDHeadConfig, generator: torch.Generator, dev) -> dict:
    """The SD-2.1 head's projector, UNet and VAE (the sample entry's too)."""
    from dreamllm_tpu_torch.models.projector import init_projector_params
    from dreamllm_tpu_torch.models.sd.unet import init_unet_params
    from dreamllm_tpu_torch.models.sd.vae import init_vae_params

    return {
        "projector": init_projector_params(head_cfg.projector_cfg(), generator=generator,
                                           device=dev),
        "unet": init_unet_params(head_cfg.unet, generator=generator, device=dev),
        "vae": init_vae_params(head_cfg.vae, generator=generator, device=dev),
    }


def _or_zeros(p: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


def make_step_fn(loss_fn, tx):
    """``(state, batch, generator) -> (state, aux)``: every parameter takes
    a gradient (the VAE's are zeros: the loss encodes without gradients)."""

    def step_fn(state: TrainState, batch: dict, generator):
        live = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        loss, aux = loss_fn(live, batch, generator)
        leaves = list(tree_leaves(live))
        got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = tree_map(lambda p: _or_zeros(p, next(got)), live)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return TrainState(state.step + 1, params, opt_state), aux

    return step_fn


def main(argv=None, force_head_type: str | None = None):
    """Train, then sample once with the (EMA) weights. Returns the final
    ``TrainState``; its ``ema`` attribute holds the UNet's EMA (None
    without ``use_ema``)."""
    args, config = LazyArgumentParser().parse(argv)
    dev = resolve_device(args.device)
    run_dir = default_setup(args, config)

    h = instantiate(torch_dtypes(config["sd_head"]))
    head_type = force_head_type or config.get("head_type", "sd")
    gen = seeded(dev, config.get("seed", 0))
    if head_type == "sdxl":
        from dreamllm_tpu_torch.models.sd.sdxl import (
            SDXLHeadConfig,
            init_sdxl_head_params,
            sdxl_head_loss,
            sdxl_head_pipeline,
        )

        head_cfg = SDXLHeadConfig(**h)
        loss_fn_impl, pipeline_impl = sdxl_head_loss, sdxl_head_pipeline
        params = init_sdxl_head_params(head_cfg, generator=gen, device=dev)
    else:
        head_cfg = SDHeadConfig(**h)
        loss_fn_impl, pipeline_impl = sd_head_loss, sd_head_pipeline
        params = init_sd_params(head_cfg, gen, dev)

    cond_dim = config.get("cond_dim", head_cfg.llm_hidden_size)
    cond_len = config.get("cond_len", 16)
    # the UNet runs in its conditioning's dtype: the caption embeddings take
    # the projector's (bf16 when the recipe asks for it)
    cond_dtype = head_cfg.projector_cfg().dtype
    use_ema = config.get("use_ema", True)
    ema_state = {"ema": tree_map(torch.clone, params["unet"]) if use_ema else None}

    ocfg = OptimizerConfig(**config["optimizer"])
    tx = make_optimizer(ocfg)
    state = init_train_state(params, tx, device=dev)
    del params

    def loss_fn(p, batch, generator):
        kw = {}
        if head_type == "sdxl" and "add_time_ids" in batch:
            kw["add_time_ids"] = batch["add_time_ids"]
        return loss_fn_impl(p, head_cfg, batch["images_dm"], batch["cond"], batch["uncond"],
                            batch["valid"], generator, **kw)

    step_fn = make_step_fn(loss_fn, tx)

    # toy caption-conditioned stream: hashed random caption embeddings
    d = config["data"]
    mixed = DataManager()(d["datasets"], size_list=d.get("size_list"),
                          ratios=d.get("ratios"), total_size=d.get("total_size"))
    bs = d["batch_size"]
    size_dm = d.get("image_size_dm", 32)

    def embed_caption(text: str) -> np.ndarray:
        # crc32, not builtin hash(): stable across processes and resumes
        g = np.random.default_rng(zlib.crc32(text.encode()) % 2**31)
        return g.standard_normal((cond_len, cond_dim)).astype(np.float32)

    def stream():
        i = 0
        while True:
            imgs, conds = [], []
            for _ in range(bs):
                s = mixed[i % len(mixed)]
                i += 1
                arr = np.asarray(s.image, np.float32)
                if arr.max() > 1.5:
                    arr = arr / 255.0
                yi = (np.arange(size_dm) * arr.shape[0] / size_dm).astype(int)
                xi = (np.arange(size_dm) * arr.shape[1] / size_dm).astype(int)
                imgs.append(arr[yi][:, xi] * 2 - 1)
                conds.append(embed_caption(s.text))
            yield {
                "images_dm": torch.from_numpy(np.stack(imgs))[:, None].to(dev),
                "cond": torch.from_numpy(np.stack(conds))[:, None].to(dev, cond_dtype),
                "uncond": torch.zeros((1, cond_len, cond_dim), dtype=cond_dtype, device=dev),
                "valid": torch.ones((bs, 1), dtype=torch.bool, device=dev),
            }

    tcfg = TrainerConfig(**config["trainer"])
    mlog = MetricsLogger(run_dir, project="sd_tpu_torch")

    class EMACallback:
        def on_step(self, trainer, step, aux):
            if use_ema:
                decay = ema_decay_schedule(torch.tensor(step, dtype=torch.float32, device=dev))
                ema_state["ema"] = ema_update(ema_state["ema"], trainer.state.params["unet"],
                                              decay)

    trainer = Trainer(tcfg, step_fn, stream(), state, callbacks=[mlog, EMACallback()],
                      device=dev)
    final = trainer.train()

    # validation sample with the (EMA) weights
    val_params = dict(final.params)
    if use_ema:
        val_params["unet"] = ema_state["ema"]
    with torch.no_grad():
        img = pipeline_impl(
            val_params, head_cfg,
            torch.from_numpy(embed_caption("validation sample"))[None].to(dev, cond_dtype),
            torch.zeros((1, cond_len, cond_dim), dtype=cond_dtype, device=dev),
            seeded(dev, 1),
            num_inference_steps=config.get("num_inference_steps", 20),
            guidance_scale=config.get("guidance_scale", 3.0),
        )
    mlog.log_images({"validation": img[0]}, int(final.step))
    mlog.finish()
    final.ema = ema_state["ema"]
    return final


if __name__ == "__main__":
    main()
