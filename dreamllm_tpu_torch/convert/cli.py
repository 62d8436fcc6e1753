"""Checkpoint conversion CLI: HF/diffusers directories -> one checkpoint of
the port (port of ``dreamllm_tpu/convert/cli.py``).

The switching-user path (reference users have HF LLaMA/Vicuna, CLIP and
diffusers SD checkpoints on disk): convert them into the port's
plugin-split layout (``train/checkpoints.py``) in one command, on the CPU:

    python -m dreamllm_tpu_torch.convert.cli \\
        --llm /path/vicuna-7b --clip /path/clip-vit-large-patch14 \\
        --sd /path/stable-diffusion-2-1-base --out ./ckpts/assembled \\
        --vocab_size 32064

Any component may be omitted. Reads ``.safetensors`` shards (bf16, fp16 and
float32) or ``.bin``/``.pth`` shards without instantiating torch models.
``--quantize int4|int8`` quantizes the decoder's projections and head on the
host, so that the card never holds the bf16 copy. The LLM is converted leaf
by leaf, each source tensor freed once its leaf is built: the host holds
about one copy of the weights at a time.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any

import torch

from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("dreamllm_tpu_torch.convert")


def load_state_dict_dir(path: str) -> dict[str, torch.Tensor]:
    """All ``.safetensors`` (else ``.bin``/``.pth``) weight shards under
    ``path`` as CPU tensors in their stored dtypes."""
    sd: dict[str, Any] = {}
    sts = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if sts:
        from safetensors import safe_open

        for f in sts:
            # copies out of the file's map, which is released with the
            # handle: tensors that viewed the map would keep every shard's
            # pages resident until their last tensor went, and a converter
            # that frees each source once its leaf is built would hold two
            # copies of the weights
            with safe_open(f, framework="pt") as h:
                sd.update({k: h.get_tensor(k).clone() for k in h.keys()})
        return sd
    bins = sorted(glob.glob(os.path.join(path, "*.bin"))) + sorted(
        glob.glob(os.path.join(path, "*.pth"))
    )
    if bins:
        for f in bins:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
        return sd
    raise FileNotFoundError(f"no .safetensors/.bin under {path}")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class _Attr:
    """dict -> attribute access (duck-types an HF config object)."""

    def __init__(self, d: dict):
        self.__dict__.update(d)

    def __getattr__(self, k):
        raise AttributeError(k)


def convert_llama_dir(path: str, dtype=None, vocab_size: int | None = None):
    """``(LlamaConfig, stacked-layer tree)`` of an HF LLaMA dir.
    ``vocab_size``: grow the embedding/lm_head to this size with
    mean-of-existing-rows init (stock 32,000-vocab Vicuna -> 32,064-vocab
    DreamLLM configs; reference modeling_dreamllm.py:1310-1322 +
    projects/dreamllm/train.py:142-147)."""
    from dreamllm_tpu_torch.convert.hf_llama import (
        convert_llama_state_dict,
        llama_config_from_hf,
        resize_vocab_with_mean_init,
    )

    raw = _load_json(os.path.join(path, "config.json"))
    raw.setdefault("num_key_value_heads", raw.get("num_attention_heads"))
    raw.setdefault("rope_theta", 10000.0)
    raw.setdefault("rms_norm_eps", raw.get("layer_norm_eps", 1e-6))
    raw.setdefault("tie_word_embeddings", False)
    raw.setdefault("rope_scaling", None)
    cfg = llama_config_from_hf(_Attr(raw), dtype=dtype or torch.bfloat16)
    sd = load_state_dict_dir(path)
    params = convert_llama_state_dict(sd, cfg, consume=True)
    del sd
    if vocab_size is not None and vocab_size != cfg.vocab_size:
        params, cfg = resize_vocab_with_mean_init(params, cfg, vocab_size)
        logger.info("resized vocab to %d with mean-init rows", vocab_size)
    return cfg, params


def convert_clip_dir(path: str, dtype=None):
    from dreamllm_tpu_torch.convert.hf_clip import (
        clip_config_from_hf,
        convert_clip_vision_state_dict,
    )

    raw = _load_json(os.path.join(path, "config.json"))
    if "vision_config" in raw:  # full CLIPModel config
        raw = raw["vision_config"]
        raw.setdefault("hidden_size", 1024)
    cfg = clip_config_from_hf(_Attr(raw), dtype=dtype or torch.bfloat16)
    sd = load_state_dict_dir(path)
    # CLIPVisionModel checkpoints prefix "vision_model."; CLIPModel adds nothing extra
    prefix = "vision_model."
    if not any(k.startswith(prefix) for k in sd):
        prefix = ""
    return cfg, convert_clip_vision_state_dict(sd, cfg, prefix=prefix)


def convert_sd_dir(path: str, dtype=None):
    """diffusers pipeline dir: ``unet/`` + ``vae/`` subfolders."""
    from dreamllm_tpu_torch.convert.hf_sd import convert_unet_state_dict, convert_vae_state_dict
    from dreamllm_tpu_torch.models.sd.unet import UNetConfig
    from dreamllm_tpu_torch.models.sd.vae import VAEConfig

    dtype = dtype or torch.bfloat16
    ucfg_raw = _load_json(os.path.join(path, "unet", "config.json"))
    n_levels = len(ucfg_raw["block_out_channels"])
    tl = ucfg_raw.get("transformer_layers_per_block", 1)
    heads = ucfg_raw.get("attention_head_dim", 8)
    ucfg = UNetConfig(
        sample_size=ucfg_raw.get("sample_size", 64),
        in_channels=ucfg_raw.get("in_channels", 4),
        out_channels=ucfg_raw.get("out_channels", 4),
        block_out_channels=tuple(ucfg_raw["block_out_channels"]),
        down_block_types=tuple(ucfg_raw["down_block_types"]),
        up_block_types=tuple(ucfg_raw["up_block_types"]),
        layers_per_block=ucfg_raw.get("layers_per_block", 2),
        transformer_layers_per_block=tuple(tl if isinstance(tl, list) else [tl] * n_levels),
        num_attention_heads=tuple(heads if isinstance(heads, list) else [heads] * n_levels),
        cross_attention_dim=ucfg_raw.get("cross_attention_dim", 1024),
        addition_embed_type=ucfg_raw.get("addition_embed_type"),
        addition_time_embed_dim=ucfg_raw.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=ucfg_raw.get(
            "projection_class_embeddings_input_dim", 2816
        ) or 2816,
        dtype=dtype,
    )
    vcfg_raw = _load_json(os.path.join(path, "vae", "config.json"))
    vcfg = VAEConfig(
        block_out_channels=tuple(vcfg_raw.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=vcfg_raw.get("layers_per_block", 2),
        latent_channels=vcfg_raw.get("latent_channels", 4),
        scaling_factor=vcfg_raw.get("scaling_factor", 0.18215),
        dtype=dtype,
    )
    unet = convert_unet_state_dict(load_state_dict_dir(os.path.join(path, "unet")), ucfg)
    vae = convert_vae_state_dict(load_state_dict_dir(os.path.join(path, "vae")), vcfg)
    return (ucfg, vcfg), {"unet": unet, "vae": vae}


def _quantize_llm_host(p: dict, mode: str) -> dict:
    """Serving quantization on the host CPU, layer by layer, of the port's
    decoder tree: a 13B bf16 tree is 26 GB, and quantizing at conversion
    time means the card only ever sees the packed weights.

    The port's ``quantize_int4``/``quantize_int8`` multiply amax by the
    float32 reciprocal of 7 or 127, as the JAX package's compiled
    quantization does; the JAX CLI quantizes eagerly, which divides, so its
    scales may differ from these by an ulp (ROADMAP, reference faults)."""
    from dreamllm_tpu_torch.ops.quant import quantize_int8
    from dreamllm_tpu_torch.ops.quant4 import QUANTIZED_KEYS, quantize_int4

    quant = quantize_int4 if mode == "int4" else quantize_int8
    skipped: set = set()

    def q(name, w):
        if mode == "int4" and w.shape[-2] % 256 != 0:
            # int4 groups need K % 256 (two 128-row halves); leave odd
            # shapes (tiny models, unusual projections) unquantized
            if name not in skipped:
                skipped.add(name)
                logger.warning("skipping int4 for K=%d weight", w.shape[-2])
            return w
        return quant(w.cpu())

    out = dict(p, layers=[{k: q(k, v) if k in QUANTIZED_KEYS else v for k, v in layer.items()}
                          for layer in p["layers"]])
    if "lm_head" in p:
        out["lm_head"] = q("lm_head", p["lm_head"])
    return out


def _port(tree, like):
    from dreamllm_tpu_torch.bridge import from_jax

    return from_jax(tree, like, device="cpu")


def assemble(out_dir: str, llm: str | None, clip: str | None, sd: str | None,
             dtype=None, vocab_size: int | None = None,
             quantize: str | None = None) -> str:
    """Convert on the CPU and save as ``checkpoint-000000`` under ``out_dir``
    (groups ``llm``, ``clip_vision_embedding`` with ``clip``, ``sd_head``
    with ``unet`` and ``vae``)."""
    from dreamllm_tpu_torch.models.clip import init_clip_vision_params
    from dreamllm_tpu_torch.models.llama import init_llama_params
    from dreamllm_tpu_torch.models.sd.unet import init_unet_params
    from dreamllm_tpu_torch.models.sd.vae import init_vae_params
    from dreamllm_tpu_torch.train.checkpoints import save_checkpoint
    from dreamllm_tpu_torch.train.tree import tree_leaves

    params: dict = {}
    if llm:
        cfg, tree = convert_llama_dir(llm, dtype, vocab_size=vocab_size)
        p = _port(tree, init_llama_params(cfg, device="meta"))
        del tree
        if quantize:
            p = _quantize_llm_host(p, quantize)
            logger.info("quantized LLM weights to %s", quantize)
        params["llm"] = p
        logger.info("converted LLM from %s (%d tensors)", llm, len(list(tree_leaves(p))))
    if clip:
        cfg, tree = convert_clip_dir(clip, dtype)
        params["clip_vision_embedding"] = {
            "clip": _port(tree, init_clip_vision_params(cfg, device="meta"))}
        logger.info("converted CLIP from %s", clip)
    if sd:
        (ucfg, vcfg), tree = convert_sd_dir(sd, dtype)
        params["sd_head"] = {"unet": _port(tree["unet"], init_unet_params(ucfg, device="meta")),
                             "vae": _port(tree["vae"], init_vae_params(vcfg, device="meta"))}
        logger.info("converted SD from %s", sd)
    path = save_checkpoint(out_dir, 0, params, extra_meta={"source": {
        "llm": llm, "clip": clip, "sd": sd}})
    logger.info("assembled checkpoint at %s", path)
    return path


def main(argv=None):
    from dreamllm_tpu_torch.utils.logging import setup_logger

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--llm", default=None, help="HF LLaMA/Vicuna dir")
    p.add_argument("--clip", default=None, help="HF CLIP(Vision)Model dir")
    p.add_argument("--sd", default=None, help="diffusers pipeline dir (unet/ vae/)")
    p.add_argument("--out", required=True)
    p.add_argument("--vocab_size", type=int, default=None,
                   help="grow LLM vocab to this size with mean-init rows "
                        "(e.g. 32064 for the DreamLLM special tokens)")
    p.add_argument("--quantize", choices=("int8", "int4"), default=None,
                   help="quantize LLM matmul weights at conversion time "
                        "(on the host; the card never holds the bf16 copy)")
    args = p.parse_args(argv)
    setup_logger()
    return assemble(args.out, args.llm, args.clip, args.sd,
                    vocab_size=args.vocab_size, quantize=args.quantize)


if __name__ == "__main__":
    main()
