"""Text-to-image evaluation protocol: multi-seed sampling, CLIP best-of-N
re-ranking and FID (port of ``dreamllm_tpu/eval/text2img.py``).

The reference's COCO/LN-COCO drivers (omni/eval/text2img/ddp_sample_coco.py
:85-169 "dreamllm" phase, :351-386 "select" phase;
scripts/eval/text2img/eval_coco_zero_shot_clip8_select.sh: 30k captions x 8
seeds, 150 steps, guidance 2.0, CLIP-L/14 argmax re-rank, FID vs
fid_stats_mscoco256_val.npz at 256 px). Work is sharded across processes by
rank striding (``utils/comm.py``, ``torch.distributed`` when initialised).

``pipeline_fn(captions, seed)`` takes the chunk's seed as an integer,
``base_seed + s * 100003 + i`` as in the JAX package (which makes a
``PRNGKey`` of it); the port's pipelines seed a ``torch.Generator`` with it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch

from dreamllm_tpu_torch.eval.fid import (
    activation_statistics,
    compute_fid,
    frechet_distance,
    inception_pool3,
)


@dataclasses.dataclass
class T2IProtocol:
    num_seeds: int = 8
    num_inference_steps: int = 150
    guidance_scale: float = 2.0
    image_size: int = 256     # FID resolution
    batch_size: int = 4


def lncoco_protocol(**kw) -> T2IProtocol:
    """LN-COCO defaults (ddp_sample_lncoco.py:29-42 launch recipe: 100 steps,
    guidance 3.0; single seed per caption: the reference LN-COCO driver has
    no CLIP re-rank phase)."""
    defaults = dict(num_seeds=1, num_inference_steps=100, guidance_scale=3.0)
    defaults.update(kw)
    return T2IProtocol(**defaults)


def load_lncoco_captions(jsonl_path: str, seed: int = 0, max_images: int | None = None) -> list[str]:
    """LN-COCO (Localized Narratives) caption loader: one caption per image.

    Mirrors ddp_sample_lncoco.py:46-68 + :173-183: the jsonl carries
    ``{"image_id": ..., "caption": ...}`` rows; captions group by image and
    one is drawn per image at random (``random.choice(captions)``).
    """
    import json
    import random

    per_image: dict[int, list[str]] = {}
    order: list[int] = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            iid = int(obj["image_id"])
            if iid not in per_image:
                per_image[iid] = []
                order.append(iid)
            per_image[iid].append(str(obj["caption"]))
    rng = random.Random(seed)
    caps = [rng.choice(per_image[i]) for i in order]
    return caps[:max_images] if max_images else caps


def _chunk_seed(base_seed: int, s: int, i: int) -> int:
    return base_seed + s * 100003 + i


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def sample_candidates(
    pipeline_fn: Callable[[Sequence[str], int], torch.Tensor],
    captions: Sequence[str],
    protocol: T2IProtocol,
    base_seed: int = 0,
) -> np.ndarray:
    """[N, num_seeds, H, W, 3] in [0,1]. ``pipeline_fn(captions, seed)`` is the
    model-specific prompt->images function (e.g. LLM encode +
    sd_head_pipeline).

    NOTE: materializes every candidate: fine for smokes/LN-COCO-scale runs;
    the 30k x 8-seed COCO protocol must use :func:`sample_and_select`
    (running best-of-S, one image per caption resident)."""
    n = len(captions)
    out = None
    for s in range(protocol.num_seeds):
        imgs_seed = []
        for i in range(0, n, protocol.batch_size):
            chunk = list(captions[i : i + protocol.batch_size])
            imgs_seed.append(_host(pipeline_fn(chunk, _chunk_seed(base_seed, s, i))))
        imgs_seed = np.concatenate(imgs_seed, axis=0)
        if out is None:
            out = np.zeros((n, protocol.num_seeds) + imgs_seed.shape[1:], np.float32)
        out[:, s] = imgs_seed
    return out


def sample_and_select(
    pipeline_fn: Callable[[Sequence[str], int], torch.Tensor],
    captions: Sequence[str],
    clip_score_fn: Callable[[np.ndarray, Sequence[str]], np.ndarray],
    protocol: T2IProtocol,
    base_seed: int = 0,
) -> np.ndarray:
    """CLIP-select best-of-num_seeds with a RUNNING argmax: each seed's batch
    is scored as it is generated and only the best image per caption stays
    resident. At the documented COCO scale (30k captions x 8 seeds x 256px)
    the all-candidates buffer is ~189 GB fp32; this keeps ~24 GB worst case
    (one best image per caption) and scales with N, not N x S."""
    n = len(captions)
    best_imgs: np.ndarray | None = None
    best_scores = np.full((n,), -np.inf, np.float32)
    for s in range(protocol.num_seeds):
        for i in range(0, n, protocol.batch_size):
            chunk = list(captions[i : i + protocol.batch_size])
            imgs = _host(pipeline_fn(chunk, _chunk_seed(base_seed, s, i)))
            scores = _host(clip_score_fn(imgs, chunk))
            if best_imgs is None:
                best_imgs = np.zeros((n,) + imgs.shape[1:], np.float32)
            sl = slice(i, i + len(chunk))
            improve = scores > best_scores[sl]
            best_scores[sl] = np.where(improve, scores, best_scores[sl])
            best_imgs[sl][improve] = imgs[improve]
    return best_imgs


def clip_select(
    candidates: np.ndarray,      # [N, S, H, W, 3] in [0,1]
    captions: Sequence[str],
    clip_score_fn: Callable[[np.ndarray, Sequence[str]], np.ndarray],
) -> np.ndarray:
    """Best-of-S by CLIP image-text score (ddp_sample_coco.py:351-386).
    ``clip_score_fn(images [M,H,W,3], captions [M]) -> [M] scores`` (diagonal
    of logits_per_image)."""
    n, s = candidates.shape[:2]
    flat = candidates.reshape((n * s,) + candidates.shape[2:])
    caps = [c for c in captions for _ in range(s)]
    scores = _host(clip_score_fn(flat, caps)).reshape(n, s)
    best = scores.argmax(axis=1)
    return candidates[np.arange(n), best]


def extract_inception_features(inception_params, images: np.ndarray,
                               batch_size: int = 32) -> np.ndarray:
    """pool3 features ``[N, 2048]`` of ``images`` ``[N, H, W, 3]`` in [0, 1],
    ``batch_size`` at a time on the device of ``inception_params``; a ragged
    tail is padded to the batch (as the JAX package pads it to its compiled
    shape), and the padding rows dropped."""
    feats = []
    for i in range(0, len(images), batch_size):
        x = torch.as_tensor(np.asarray(images[i : i + batch_size], np.float32))
        n = x.shape[0]
        if n != batch_size and len(images) > batch_size:
            x = torch.cat([x, x.new_zeros((batch_size - n,) + tuple(x.shape[1:]))])
        feats.append(inception_pool3(inception_params, x)[:n].cpu().numpy())
    return np.concatenate(feats, axis=0)


def fid_from_images(
    inception_params,
    images: np.ndarray,           # [N, H, W, 3] in [0,1]
    reference: np.ndarray | str,  # [M, H, W, 3] images or stats .npz path
    batch_size: int = 32,
) -> float:
    feats = extract_inception_features(inception_params, images, batch_size)
    if isinstance(reference, str):
        d = np.load(reference)
        mu1, s1 = activation_statistics(feats)
        return frechet_distance(mu1, s1, d["mu"], d["sigma"])
    ref_feats = extract_inception_features(inception_params, reference, batch_size)
    return compute_fid(feats, ref_feats)


def run_protocol(
    pipeline_fn,
    clip_score_fn,
    inception_params,
    captions: Sequence[str],
    reference,
    protocol: T2IProtocol = T2IProtocol(),
    *,
    shard: bool = True,
    save_dir: str | None = None,
) -> dict:
    """Full COCO-style protocol; multi-process runs pool features before FID.

    Sampling + CLIP-select run as a running best-of-S
    (:func:`sample_and_select`). With more than one process each scores its
    caption shard, then the pool-3 FEATURES are gathered across processes so
    that the Frechet statistics cover the full caption set: per-shard FID
    is biased by its smaller N and is not the protocol number.
    """
    from dreamllm_tpu_torch.utils.comm import all_gather_objects, get_rank, get_world_size

    rank, world = get_rank(), get_world_size()
    if shard:
        captions = list(captions[rank::world])
    best = sample_and_select(pipeline_fn, captions, clip_score_fn, protocol)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.save(os.path.join(save_dir, f"images_rank{rank}.npy"), best)
    feats = extract_inception_features(inception_params, best)
    if shard and world > 1:
        feats = np.concatenate(all_gather_objects(feats), axis=0)
    mu, sigma = activation_statistics(feats)
    if isinstance(reference, str):
        d = np.load(reference)
        fid = frechet_distance(mu, sigma, d["mu"], d["sigma"])
    else:
        ref_feats = extract_inception_features(inception_params, reference)
        mu2, s2 = activation_statistics(ref_feats)
        fid = frechet_distance(mu, sigma, mu2, s2)
    return {"fid": fid, "n": len(feats)}
