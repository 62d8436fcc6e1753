"""DreamLLM training entry point (port of ``projects/dreamllm/train.py``):

    python -m dreamllm_tpu_torch.projects.dreamllm.train \\
        --config_file projects/dreamllm/configs/smoke.py device=cpu

Wires: lazy config -> tokenizer -> model and head init -> HF/diffusers
weights converted in place (``pretrained.llm``, ``.clip``, ``.sd``) ->
checkpoint restore with stage mixing -> mixed datasets -> builder/collator
stream -> train step -> Trainer loop. It runs on one card (``device=cuda``,
the default: the flash and fused-AdamW kernels) or on the CPU
(``device=cpu``: their plain versions).

What the JAX entry does and one card cannot, this one refuses with an
error naming the way round: a mesh over more than one device or the
sequence-/pipeline-parallel axes (ROADMAP #22).

Recipes may set any ``dtype`` (or the SDXL head's ``vae_dtype``) to a
name, ``+model.llm.dtype=bfloat16``: the port maps it to the torch dtype.
The flash kernels take bfloat16 only, so a run on the card whose
attention passes the flash rule asks for bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import dreamllm_tpu_torch.data.catalog  # noqa: F401 — registers datasets
from dreamllm_tpu_torch.bridge import from_jax
from dreamllm_tpu_torch.config import LazyArgumentParser, default_setup, instantiate
from dreamllm_tpu_torch.data import BuilderConfig, DataManager, DreamLLMBuilder
from dreamllm_tpu_torch.data.stream import BatchStream, MappedStream, PrefetchStream
from dreamllm_tpu_torch.data.tokenization import HFTokenizer, ToyTokenizer
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.dreamllm import (
    DreamLLMConfig,
    init_dreamllm_params,
    param_freeze_mask,
)
from dreamllm_tpu_torch.models.sd.head import (
    SDHeadConfig,
    init_sd_head_params,
    make_head_loss_fn,
)
from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params
from dreamllm_tpu_torch.train.optim import OptimizerConfig, make_optimizer
from dreamllm_tpu_torch.train.step import init_train_state, make_train_step
from dreamllm_tpu_torch.train.trainer import Trainer, TrainerConfig
from dreamllm_tpu_torch.train.tree import tree_leaves
from dreamllm_tpu_torch.utils.logging import get_logger
from dreamllm_tpu_torch.utils.metrics_logger import MetricsLogger

logger = get_logger("projects.dreamllm.train")

_DTYPE_KEYS = ("dtype", "vae_dtype")


def torch_dtypes(node):
    """A copy of a recipe subtree with every ``dtype``/``vae_dtype`` given
    by name (``"bfloat16"``, ``"float32"``) replaced by the torch dtype."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k in _DTYPE_KEYS and isinstance(v, str):
                dt = getattr(torch, v, None)
                if not isinstance(dt, torch.dtype):
                    raise ValueError(f"{k}={v!r} names no torch dtype")
                v = dt
            out[k] = torch_dtypes(v)
        return out
    if isinstance(node, (list, tuple)):
        return type(node)(torch_dtypes(v) for v in node)
    return node


def build_model_cfg(config) -> tuple[DreamLLMConfig, SDHeadConfig]:
    m = instantiate(torch_dtypes(config["model"]))
    frozen = tuple(m.pop("frozen", ()))
    cfg = DreamLLMConfig(**m, frozen=frozen)
    h = instantiate(torch_dtypes(config["sd_head"]))
    if config.get("head_type", "sd") == "sdxl":
        from dreamllm_tpu_torch.models.sd.sdxl import SDXLHeadConfig

        head_cfg = SDXLHeadConfig(**h)
    else:
        head_cfg = SDHeadConfig(**h)
    return cfg, head_cfg


def head_init_and_loss(config, head_cfg):
    """(init_fn, loss_fn_factory) for the configured head type."""
    if config.get("head_type", "sd") == "sdxl":
        from dreamllm_tpu_torch.models.sd.sdxl import (
            init_sdxl_head_params,
            make_sdxl_head_loss_fn,
        )

        return init_sdxl_head_params, make_sdxl_head_loss_fn
    return init_sd_head_params, make_head_loss_fn


def make_tokenizer(config, cfg: DreamLLMConfig):
    name = config.get("tokenizer", "toy")
    if name == "toy":
        return ToyTokenizer(vocab_size=cfg.llm.vocab_size)
    return HFTokenizer(name)


def seeded(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(int(seed))


def init_params(config, cfg: DreamLLMConfig, head_cfg, dev: torch.device) -> dict:
    """Random decoder, CLIP tower and dream queries from ``seed``, the head
    (by ``head_type``) from ``seed + 1``, all on ``dev``. The draws differ
    from the JAX entry's: parity tests start both from one saved state."""
    init_head, _ = head_init_and_loss(config, head_cfg)
    seed = config.get("seed", 0)
    params = init_dreamllm_params(cfg, generator=seeded(dev, seed), device=dev)
    params["sd_head"] = init_head(head_cfg, generator=seeded(dev, seed + 1), device=dev)
    return params


def check_one_card(config) -> None:
    """Refuse what the JAX entry runs and one card cannot, before anything
    is built."""
    mesh = dict(config.get("mesh", {}) or {})
    sizes = [mesh.get(k, d) for k, d in (("data", 1), ("fsdp", -1), ("tp", 1))]
    if sum(s == -1 for s in sizes) > 1 or math.prod(s for s in sizes if s != -1) > 1:
        raise NotImplementedError(
            f"mesh {mesh} needs more than one device; the port trains on one card "
            "(parallelism is ROADMAP #22)")
    model = config.get("model", {}) or {}
    for axis in ("sequence_parallel_axis", "pipeline_parallel_axis"):
        if model.get(axis):
            raise NotImplementedError(
                f"model.{axis}={model[axis]!r}: sequence and pipeline parallelism are not "
                "ported (ROADMAP #22); this recipe needs a mesh of several devices")


def _merge_checked(tree, like, where: str):
    """A converted tree (the JAX layout, on the CPU) carried into the port's
    layout on the device of ``like``, which it replaces; any difference of
    tree or shape raises ``ValueError``, as the JAX entry's check does."""
    try:
        return from_jax(tree, like, device=next(iter(tree_leaves(like))).device)
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(
            f"pretrained weights at {where} do not match the configured "
            f"model (tree/shape mismatch); check the model config: {e}") from e


def load_pretrained(params: dict, pre: dict, cfg: DreamLLMConfig, head_cfg) -> dict:
    """HF/diffusers checkpoint dirs (``pretrained.llm/clip/sd``), the
    cold-start path: converted on the host, the decoder's vocabulary resized
    to the config (reference ``from_pretrained`` +
    ``resize_token_embeddings``, modeling_dreamllm.py:1310-1322), checked
    against the initialised tree and put in its place."""
    if pre.get("llm"):
        from dreamllm_tpu_torch.convert.cli import convert_llama_dir

        _, p = convert_llama_dir(pre["llm"], dtype=cfg.llm.dtype, vocab_size=cfg.llm.vocab_size)
        params["llm"] = _merge_checked(p, params["llm"], pre["llm"])
        logger.info("loaded pretrained LLM from %s", pre["llm"])
    if pre.get("clip"):
        from dreamllm_tpu_torch.convert.cli import convert_clip_dir

        _, p = convert_clip_dir(pre["clip"], dtype=cfg.vision.dtype)
        params["clip_vision_embedding"]["clip"] = _merge_checked(
            p, params["clip_vision_embedding"]["clip"], pre["clip"])
        logger.info("loaded pretrained CLIP from %s", pre["clip"])
    if pre.get("sd"):
        from dreamllm_tpu_torch.convert.cli import convert_sd_dir

        _, p = convert_sd_dir(pre["sd"], dtype=head_cfg.unet.dtype)
        for k in ("unet", "vae"):
            params["sd_head"][k] = _merge_checked(p[k], params["sd_head"][k],
                                                  f"{pre['sd']}/{k}")
        logger.info("loaded pretrained SD UNet+VAE from %s", pre["sd"])
    return params


def restore(params: dict, pre: dict) -> dict:
    """``pretrained.resume_from`` (whole model) and ``resume_plugins`` (stage
    mixing: plugin -> another run's latest checkpoint)."""
    if pre.get("resume_from"):
        ck = latest_checkpoint(pre["resume_from"])
        if ck:
            params = load_params(ck, like=params)
            logger.info("loaded params from %s", ck)
    if pre.get("resume_plugins"):
        overrides = {}
        base = None
        for plugin, root in pre["resume_plugins"].items():
            ck = latest_checkpoint(root)
            if ck:
                overrides[plugin] = ck
                base = base or ck
        if base:
            loaded = load_params(base, like=params, overrides=overrides)
            for k in overrides:
                params[k] = loaded[k]
            logger.info("stage-mixed plugins: %s", overrides)
    return params


def data_stream(config, cfg: DreamLLMConfig, tokenizer):
    """The recipe's mixed datasets -> builder -> collated batches, as CPU
    tensors. Stateful: ``state_dict``/``load_state_dict`` pass through the
    wrapper, so the Trainer checkpoints the exact stream position."""
    d = config["data"]
    dm = DataManager()
    mixed = dm(
        d["datasets"],
        size_list=d.get("size_list"),
        ratios=d.get("ratios"),
        total_size=d.get("total_size"),
    )
    bcfg = BuilderConfig(
        max_seq_len=d.get("max_seq_len", cfg.llm.max_position_embeddings),
        image_embed_len=cfg.image_embed_len,
        n_dream_queries=cfg.n_dream_queries,
        special=cfg.special_tokens,
        max_images=d.get("max_images", 6),
        max_dreams=d.get("max_dreams", 5),
        i2t_probability=d.get("i2t_probability", 0.5),
        image_size=d.get("image_size", cfg.vision.image_size),
        image_size_dm=d.get("image_size_dm", 256),
    )
    builder = DreamLLMBuilder(tokenizer, bcfg, seed=config.get("seed", 0))
    bs = d["batch_size"]
    pack = bool(d.get("pack", False))
    # with pack=True, build pack_block x more raw samples per round and
    # first-fit them into seq_len rows (segment-isolated attention)
    pack_block = int(d.get("pack_block", 4))
    collate_kw = dict(
        pad_token_id=cfg.special_tokens.pad,
        max_images=bcfg.max_images,
        max_dreams=bcfg.max_dreams,
        seq_len=bcfg.max_seq_len,
        image_size=bcfg.image_size,
        image_size_dm=bcfg.image_size_dm,
        image_embed_len=bcfg.image_embed_len,
        n_dream_queries=bcfg.n_dream_queries,
    )
    batches = BatchStream(
        mixed, builder, bs, collate_kw,
        pack=pack, pack_block=pack_block,
        image_embed_len=bcfg.image_embed_len,
        n_dream_queries=bcfg.n_dream_queries,
    )
    return MappedStream(batches, lambda b: {k: torch.from_numpy(v) for k, v in b.items()})


def to_device(dev: torch.device):
    """The batch copy the prefetch thread runs. The copy is enqueued on
    that thread's current stream, which is the card's default stream: no
    thread of the port sets another. The train step's kernels, enqueued by
    the main thread after it has taken the batch from the prefetch buffer,
    go to the same stream, and a stream runs its work in order, so every
    copy has finished before a kernel of the step reads it."""
    def move(batch: dict) -> dict:
        return {k: v.to(dev) for k, v in batch.items()}

    return move


def prefetched(stream, config, dev: torch.device):
    """``stream`` moved to ``dev`` by a ``PrefetchStream`` of the recipe's
    depth (``data.prefetch``, default 2; 0 moves the batches in the loop)."""
    stream = MappedStream(stream, to_device(dev))
    depth = int(config["data"].get("prefetch", 2))
    return PrefetchStream(stream, depth=depth) if depth > 0 else stream


def main(argv=None):
    args, config = LazyArgumentParser().parse(argv)
    dev = resolve_device(args.device)
    check_one_card(config)
    run_dir = default_setup(args, config)

    cfg, head_cfg = build_model_cfg(config)
    tokenizer = make_tokenizer(config, cfg)
    _, make_loss = head_init_and_loss(config, head_cfg)
    pre = config.get("pretrained", {}) or {}
    params = restore(load_pretrained(init_params(config, cfg, head_cfg, dev), pre, cfg, head_cfg),
                     pre)

    # ---- optimizer + step ----
    ocfg = OptimizerConfig(**config["optimizer"])
    mask = param_freeze_mask(params, cfg)
    tx = make_optimizer(ocfg, trainable_mask=mask)
    state = init_train_state(params, tx, device=dev)
    del params
    step = make_train_step(
        cfg, tx,
        head_loss_fn=make_loss(head_cfg),
        grad_accum=config.get("grad_accum", 1),
        remat=True,
        use_flash=True,  # the kernels on the card, their plain versions on the CPU
        trainable_mask=mask,
        device=dev,
    )

    # ---- data: host batch building and the copy overlap the step ----
    stream = prefetched(data_stream(config, cfg, tokenizer), config, dev)

    # ---- loop ----
    tcfg = TrainerConfig(**config["trainer"])
    d = config["data"]
    tcfg.tokens_per_batch = d["batch_size"] * d.get("max_seq_len", cfg.llm.max_position_embeddings)
    mlog = MetricsLogger(run_dir, run_name=config.get("run_name"))

    # mid-training validation: an image for fixed prompts, logged
    val_prompts = config.get("validation_prompts", ["a photo of a dog"])
    val_fn = None
    if tcfg.val_steps:
        from dreamllm_tpu_torch.models.dreamllm import (
            encode_prompt_embeds,
            unconditional_dream_hidden,
        )
        from dreamllm_tpu_torch.models.sd.head import sd_head_pipeline
        from dreamllm_tpu_torch.models.sd.sdxl import sdxl_head_pipeline

        pipeline = (
            sdxl_head_pipeline if config.get("head_type", "sd") == "sdxl" else sd_head_pipeline
        )

        @torch.no_grad()
        def val_fn(params, step_num):
            logs = {}
            uncond = unconditional_dream_hidden(params, cfg)
            for i, prompt in enumerate(val_prompts):
                cond = encode_prompt_embeds(params, cfg, tokenizer, prompt)
                img = pipeline(
                    params["sd_head"], head_cfg, cond, uncond, seeded(dev, step_num),
                    num_inference_steps=config.get("val_inference_steps", 10),
                    guidance_scale=config.get("guidance_scale", 3.5),
                )
                logs[f"sample_{i}"] = np.asarray(img[0].float().cpu())
            return logs

    trainer = Trainer(tcfg, step, stream, state, callbacks=[mlog], val_fn=val_fn, device=dev)
    try:
        final = trainer.train()
    finally:
        if isinstance(stream, PrefetchStream):
            stream.close()
        mlog.finish()
    logger.info("done at step %d", int(final.step))
    return final


if __name__ == "__main__":
    main()
