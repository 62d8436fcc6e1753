"""COCO zero-shot FID evaluation entry point (port of
``projects/dreamllm/eval_t2i.py``):

    python -m dreamllm_tpu_torch.projects.dreamllm.eval_t2i \\
        --config_file projects/dreamllm/configs/sft.py \\
        +captions_json=/path/captions.json \\
        +fid_reference=/path/fid_stats_mscoco256_val.npz \\
        +num_seeds=8 +num_inference_steps=150 +guidance_scale=2.0

Phases (the reference's omni/eval/text2img/ddp_sample_coco.py +
eval_coco_zero_shot_clip8_select.sh): sample ``num_seeds`` images per
caption through the dream pipeline, CLIP best-of-N re-rank, InceptionV3 FID
against the reference statistics. Work is sharded across processes by rank
(``torch.distributed`` when initialised).

The head is initialised and sampled by ``head_type``
(``sdxl_head_pipeline`` on a DreamLLM-SDXL recipe), as the port's
inference entry does; the JAX entry uses the SD-2.1 head whatever the
recipe says and cannot evaluate an SDXL run. The Inception weights are
random (seeded), as in the JAX entry, so the FID is not the protocol's
number: ``fid_rank{r}.json`` says so with ``"inception": "random"``
(ROADMAP, reference faults).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dreamllm_tpu_torch.config import LazyArgumentParser, default_setup
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.eval.fid import init_inception_params
from dreamllm_tpu_torch.eval.text2img import T2IProtocol, lncoco_protocol, run_protocol
from dreamllm_tpu_torch.models.clip import (
    clip_pooled_output,
    clip_preprocess,
    clip_vision_forward,
)
from dreamllm_tpu_torch.models.clip_text import (
    CLIPTextConfig,
    clip_similarity,
    clip_text_forward,
    init_clip_text_params,
)
from dreamllm_tpu_torch.models.dreamllm import encode_prompt_embeds, unconditional_dream_hidden
from dreamllm_tpu_torch.models.sd.head import sd_head_pipeline
from dreamllm_tpu_torch.models.sd.sdxl import sdxl_head_pipeline
from dreamllm_tpu_torch.projects.dreamllm.train import (
    build_model_cfg,
    init_params,
    make_tokenizer,
    seeded,
)
from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params
from dreamllm_tpu_torch.utils.comm import get_rank
from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("projects.dreamllm.eval_t2i")


def load_captions(config) -> list[str]:
    if config.get("captions_jsonl"):
        # LN-COCO jsonl ({image_id, caption} rows, one random caption/image)
        from dreamllm_tpu_torch.eval.text2img import load_lncoco_captions

        return load_lncoco_captions(
            config["captions_jsonl"], seed=config.get("caption_seed", 0),
            max_images=config.get("max_captions", 30000),
        )
    with open(config["captions_json"]) as f:
        captions = json.load(f)  # list[str] or [{"caption": ...}]
    if captions and isinstance(captions[0], dict):
        captions = [c["caption"] for c in captions]
    return captions[: config.get("max_captions", 30000)]


def make_protocol(config) -> T2IProtocol:
    # protocol=lncoco -> 100 steps / guidance 3.0 / 1 seed (ddp_sample_lncoco.py)
    lncoco = config.get("protocol", "coco") == "lncoco"
    base = lncoco_protocol() if lncoco else T2IProtocol()
    return T2IProtocol(
        num_seeds=config.get("num_seeds", base.num_seeds),
        num_inference_steps=config.get("num_inference_steps", base.num_inference_steps),
        guidance_scale=config.get("guidance_scale", base.guidance_scale),
        image_size=config.get("fid_image_size", 256),
        batch_size=config.get("sample_batch_size", 4),
    )


def make_clip_score_fn(config, params, cfg, tokenizer, dev):
    """The CLIP scorer for best-of-N selection. Preferred: a full HF
    CLIPModel dir (``clip_model_dir``: vision and text towers, projections,
    logit_scale), the reference's CLIP-L/14 re-ranker. Otherwise a random
    text tower over the model's own vision tower (``use_random_clip_text``,
    plumbing tests), or no re-rank (seed 0 kept)."""
    if config.get("clip_model_dir"):
        from dreamllm_tpu_torch.bridge import from_jax
        from dreamllm_tpu_torch.convert.hf_clip import convert_clip_model_dir
        from dreamllm_tpu_torch.models.clip import init_clip_vision_params

        (vcfg, vtree), (tcfg, ttree), vproj, tproj, logit_scale = (
            convert_clip_model_dir(config["clip_model_dir"]))
        vparams = from_jax(vtree, init_clip_vision_params(vcfg, device="meta"), device=dev)
        tparams = from_jax(ttree, init_clip_text_params(tcfg, device="meta"), device=dev)
        vproj, tproj, logit_scale = vproj.to(dev), tproj.to(dev), logit_scale.to(dev)
        # The text tower needs CLIP's own BPE tokenizer (BOS=49406/EOT=49407,
        # EOT-argmax pooling): the LLM tokenizer's ids would be garbage here.
        try:
            from transformers import AutoTokenizer

            clip_tok = AutoTokenizer.from_pretrained(config["clip_model_dir"])
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(
                f"clip_model_dir={config['clip_model_dir']} has no loadable CLIP "
                "tokenizer (tokenizer.json / vocab+merges); the re-ranker cannot "
                "score captions with the LLM tokenizer. Add the tokenizer files "
                "or use use_random_clip_text=True for plumbing tests."
            ) from e

        def clip_score_fn(images, caps):
            pix = clip_preprocess(torch.as_tensor(images, device=dev), vcfg.image_size)
            last = clip_vision_forward(vparams, vcfg, pix.to(vcfg.dtype))
            img_emb = clip_pooled_output(vparams, vcfg, last)
            enc = clip_tok(list(caps), padding="max_length", truncation=True,
                           max_length=tcfg.max_position_embeddings)
            ids = torch.as_tensor(np.asarray(enc["input_ids"], np.int64), device=dev)
            _, txt_emb = clip_text_forward(tparams, tcfg, ids)
            sims = clip_similarity(img_emb.to(vproj.dtype), txt_emb.to(tproj.dtype),
                                   vproj, tproj, logit_scale)
            return torch.diagonal(sims).float().cpu().numpy()
        return clip_score_fn

    if config.get("use_random_clip_text"):
        tcfg = CLIPTextConfig(**config.get("clip_text_config", {}))
        tparams = init_clip_text_params(tcfg, generator=seeded(dev, 1), device=dev)
        vproj = torch.eye(cfg.vision.hidden_size, tcfg.projection_dim, device=dev)
        tproj = torch.eye(tcfg.hidden_size, tcfg.projection_dim, device=dev)
        vparams = params["clip_vision_embedding"]["clip"]

        def clip_score_fn(images, caps):
            pix = clip_preprocess(torch.as_tensor(images, device=dev), cfg.vision.image_size)
            last = clip_vision_forward(vparams, cfg.vision, pix.to(cfg.vision.dtype))
            img_emb = clip_pooled_output(vparams, cfg.vision, last)
            ids = np.zeros((len(caps), 32), np.int64)
            for i, c in enumerate(caps):
                t = tokenizer.encode(c)[:32]
                ids[i, : len(t)] = t
            ids = torch.as_tensor(ids % tcfg.vocab_size, device=dev)
            _, txt_emb = clip_text_forward(tparams, tcfg, ids)
            sims = clip_similarity(img_emb.float(), txt_emb.float(), vproj, tproj)
            return torch.diagonal(sims).float().cpu().numpy()
        return clip_score_fn

    def clip_score_fn(images, caps):  # no re-ranker: keep seed 0
        n = len(images)
        return np.arange(n) % 1 - np.arange(n)  # monotone-decreasing -> argmax = first
    return clip_score_fn


@torch.no_grad()
def main(argv=None):
    args, config = LazyArgumentParser().parse(argv)
    dev = resolve_device(args.device)
    run_dir = default_setup(args, config)
    cfg, head_cfg = build_model_cfg(config)
    tokenizer = make_tokenizer(config, cfg)

    params = init_params(config, cfg, head_cfg, dev)
    ck = latest_checkpoint(config.get("checkpoint", config["trainer"]["output_dir"]))
    if ck:
        params = load_params(ck, like=params)
        logger.info("loaded %s", ck)

    captions = load_captions(config)
    protocol = make_protocol(config)
    uncond = unconditional_dream_hidden(params, cfg)
    sdxl = config.get("head_type", "sd") == "sdxl"
    deepcache = config.get("deepcache_interval", 1)
    if sdxl and deepcache != 1:
        raise ValueError(f"deepcache_interval={deepcache}: the SDXL head's pipeline has no "
                         "DeepCache; leave it at 1")
    extra = {} if sdxl else {"deepcache_interval": deepcache}
    pipeline = sdxl_head_pipeline if sdxl else sd_head_pipeline

    def pipeline_fn(caps, seed: int):
        conds = torch.cat([encode_prompt_embeds(params, cfg, tokenizer, c) for c in caps])
        return pipeline(
            params["sd_head"], head_cfg, conds, uncond.expand_as(conds), seeded(dev, seed),
            height=protocol.image_size, width=protocol.image_size,
            num_inference_steps=protocol.num_inference_steps,
            guidance_scale=protocol.guidance_scale, **extra,
        )

    clip_score_fn = make_clip_score_fn(config, params, cfg, tokenizer, dev)
    inception = init_inception_params(generator=seeded(dev, 2), device=dev)
    out = run_protocol(pipeline_fn, clip_score_fn, inception, captions,
                       config["fid_reference"], protocol, save_dir=run_dir)
    rank = get_rank()
    logger.info("FID: %.4f over %d captions (rank %d)", out["fid"], out["n"], rank)
    out = {**out, "inception": "random"}
    with open(f"{run_dir}/fid_rank{rank}.json", "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
