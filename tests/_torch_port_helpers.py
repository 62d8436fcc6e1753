"""Shared pieces of the PyTorch port's parity tests (``test_torch_*.py``).

Every tiny configuration is built twice from one set of keyword arguments,
once for the JAX package and once for the port. Weights come from the JAX
``init_*`` functions and reach the port through ``bridge.from_jax``; inputs
and noise come from numpy with a seed. Everything is float32 and stays on
the CPU. The parameter builders are cached (eager JAX init takes seconds);
tests must not modify what they return.
"""

from __future__ import annotations

import functools
import os

import jax
import numpy as np
import torch

import dreamllm_tpu.models.clip as jclip
import dreamllm_tpu.models.dreamllm as jdl
import dreamllm_tpu.models.llama as jllama
import dreamllm_tpu.models.sd.head as jhead
import dreamllm_tpu.models.sd.unet as junet
import dreamllm_tpu.models.sd.vae as jvae
import dreamllm_tpu_torch.models.clip as pclip
import dreamllm_tpu_torch.models.dreamllm as pdl
import dreamllm_tpu_torch.models.llama as pllama
import dreamllm_tpu_torch.models.sd.head as phead
import dreamllm_tpu_torch.models.sd.unet as punet
import dreamllm_tpu_torch.models.sd.vae as pvae
from dreamllm_tpu_torch.bridge import from_jax

# Under pytest-xdist several workers share one machine. PyTorch would give
# each of them one OpenMP thread per core, and those threads spin against
# each other and against JAX's: the same tests then run three to five times
# slower. Two threads a worker keep the cores busy without that.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

LLAMA = dict(vocab_size=32008, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
CLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
            image_size=32, patch_size=16)
DREAM = dict(image_embed_len=4, n_dream_queries=8)
# 32x32 latents with 64 channels and one head: the first level's spatial
# self-attention (S 1024, D 64) passes the flash rule
UNET = dict(sample_size=32, block_out_channels=(64, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1, transformer_layers_per_block=(1, 1),
            num_attention_heads=(1, 2), cross_attention_dim=24, norm_num_groups=8)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)


def config_fields(cfg) -> dict:
    """A config's fields as nested dicts and lists, without its dtypes (the
    packages' dtype types differ) and without JAX's ``dream_projector_dim``,
    which the port's ``DreamLLMConfig`` lacks (only an SD head sets it;
    asserted None)."""
    import dataclasses

    def drop(d):
        if isinstance(d, dict):
            return {k: drop(v) for k, v in d.items() if not k.endswith("dtype")}
        return list(d) if isinstance(d, tuple) else d

    fields = drop(dataclasses.asdict(cfg))
    assert fields.pop("dream_projector_dim", None) is None
    return fields


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(jax_params, like):
    return from_jax(np_tree(jax_params), like, device="cpu")


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def llama_cfgs(**kw):
    args = {**LLAMA, **kw}
    return jllama.LlamaConfig(**args), pllama.LlamaConfig(**args)


@functools.lru_cache(maxsize=None)
def llama_params(seed=0, **kw):
    jc, pc = llama_cfgs(**kw)
    jp = jllama.init_llama_params(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_port(jp, pllama.init_llama_params(pc, device="meta"))


@functools.lru_cache(maxsize=None)
def clip_params(seed=0):
    jc, pc = jclip.CLIPVisionConfig(**CLIP), pclip.CLIPVisionConfig(**CLIP)
    jp = jclip.init_clip_vision_params(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_port(jp, pclip.init_clip_vision_params(pc, device="meta"))


def dreamllm_cfgs():
    jl, pl = llama_cfgs()
    jc = jdl.DreamLLMConfig(llm=jl, vision=jclip.CLIPVisionConfig(**CLIP), **DREAM)
    pc = pdl.DreamLLMConfig(llm=pl, vision=pclip.CLIPVisionConfig(**CLIP), **DREAM)
    return jc, pc


@functools.lru_cache(maxsize=None)
def dreamllm_params(seed=0):
    jc, pc = dreamllm_cfgs()
    jp = jdl.init_dreamllm_params(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_port(jp, pdl.init_dreamllm_params(pc, device="meta"))


def head_cfgs():
    jc = jhead.SDHeadConfig(unet=junet.UNetConfig(**UNET), vae=jvae.VAEConfig(**VAE),
                            llm_hidden_size=LLAMA["hidden_size"])
    pc = phead.SDHeadConfig(unet=punet.UNetConfig(**UNET), vae=pvae.VAEConfig(**VAE),
                            llm_hidden_size=LLAMA["hidden_size"])
    return jc, pc


@functools.lru_cache(maxsize=None)
def head_params(seed=1):
    jc, pc = head_cfgs()
    jp = jhead.init_sd_head_params(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_port(jp, phead.init_sd_head_params(pc, device="meta"))


# ---------------------------------------------------------------------------
# Model variants: the SDXL head, ControlNet, the CLIP text tower, LLaVA
# ---------------------------------------------------------------------------

# SDXL's layout (a DownBlock2D first, the text-time addition) at 32x32
# latents; the second level's self-attention (16x16 = S 256, one head of
# D 128) passes the flash rule
SDXL_UNET = dict(sample_size=32, block_out_channels=(16, 128),
                 down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                 up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                 layers_per_block=1, transformer_layers_per_block=(1, 2),
                 num_attention_heads=(1, 1), cross_attention_dim=24, norm_num_groups=8,
                 addition_embed_type="text_time", addition_time_embed_dim=8,
                 projection_class_embeddings_input_dim=16 + 6 * 8)
SDXL_HEAD = dict(llm_hidden_size=LLAMA["hidden_size"], pooled_dim=16)
# one stride-2 block: the control image is at the 2-level VAE's factor, 2
CONTROLNET = dict(conditioning_embedding_out_channels=(8, 16))
CLIP_TEXT = dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=2, max_position_embeddings=16, projection_dim=24)


def _fan_in(shape_hwio, seed):
    kh, kw, cin, _ = shape_hwio
    w = np.random.default_rng(seed).standard_normal(shape_hwio).astype(np.float32)
    return w * (kh * kw * cin) ** -0.5


@functools.lru_cache(maxsize=None)
def live_head_params():
    """``head_params()`` with the UNet's ``conv_out`` redrawn at its fan-in
    scale (as ``sdxl_params`` does), so that an absolute check sees the
    UNet."""
    jc, pc, jp, _ = head_params()
    conv = jp["unet"]["conv_out"]
    w = jax.numpy.asarray(_fan_in(np.shape(conv["w"]), 13))
    jp = {**jp, "unet": {**jp["unet"], "conv_out": {**conv, "w": w}}}
    return jc, pc, jp, to_port(jp, phead.init_sd_head_params(pc, device="meta"))


def sdxl_cfgs():
    import dreamllm_tpu.models.sd.sdxl as jsdxl
    import dreamllm_tpu_torch.models.sd.sdxl as psdxl

    jc = jsdxl.SDXLHeadConfig(unet=junet.UNetConfig(**SDXL_UNET), vae=jvae.VAEConfig(**VAE),
                              **SDXL_HEAD)
    pc = psdxl.SDXLHeadConfig(unet=punet.UNetConfig(**SDXL_UNET), vae=pvae.VAEConfig(**VAE),
                              **SDXL_HEAD)
    return jc, pc


@functools.lru_cache(maxsize=None)
def sdxl_params(seed=2):
    """The tiny SDXL head, JAX-initialised, with the UNet's ``conv_out``
    redrawn at its fan-in scale (its std 1e-5 would leave the UNet's output
    near 1e-4, below what an absolute 1e-4 check sees)."""
    import dreamllm_tpu.models.sd.sdxl as jsdxl
    import dreamllm_tpu_torch.models.sd.sdxl as psdxl

    jc, pc = sdxl_cfgs()
    jp = jsdxl.init_sdxl_head_params(jax.random.PRNGKey(seed), jc)
    conv = jp["unet"]["conv_out"]
    jp["unet"]["conv_out"] = {**conv, "w": jax.numpy.asarray(_fan_in(np.shape(conv["w"]), 12))}
    return jc, pc, jp, to_port(jp, psdxl.init_sdxl_head_params(pc, device="meta"))


def controlnet_cfgs():
    import dreamllm_tpu.models.sd.controlnet as jcn
    import dreamllm_tpu_torch.models.sd.controlnet as pcn

    return (jcn.ControlNetConfig(unet=junet.UNetConfig(**UNET), **CONTROLNET),
            pcn.ControlNetConfig(unet=punet.UNetConfig(**UNET), **CONTROLNET))


@functools.lru_cache(maxsize=None)
def controlnet_params(seed=3, live=True):
    """A tiny ControlNet over ``head_params()``'s UNet, JAX-initialised.
    ``live``: the embedder's ``conv_out`` and every zero conv redrawn at
    their fan-in scale (zero-initialised, nothing downstream of them would
    be seen); otherwise as ``init_controlnet_params`` leaves them."""
    import dreamllm_tpu.models.sd.controlnet as jcn
    import dreamllm_tpu_torch.models.sd.controlnet as pcn

    jc, pc = controlnet_cfgs()
    jp = jcn.init_controlnet_params(jax.random.PRNGKey(seed), jc)
    if live:
        def redraw(conv, s):
            return {**conv, "w": jax.numpy.asarray(_fan_in(np.shape(conv["w"]), s))}

        emb = jp["cond_embedding"]
        jp = {**jp, "cond_embedding": {**emb, "conv_out": redraw(emb["conv_out"], 20)},
              "zero_convs": [redraw(z, 21 + i) for i, z in enumerate(jp["zero_convs"])],
              "mid_zero_conv": redraw(jp["mid_zero_conv"], 40)}
    return jc, pc, jp, to_port(jp, pcn.init_controlnet_params(pc, device="meta"))


@functools.lru_cache(maxsize=None)
def clip_text_params(seed=4):
    import dreamllm_tpu.models.clip_text as jct
    import dreamllm_tpu_torch.models.clip_text as pct

    jc, pc = jct.CLIPTextConfig(**CLIP_TEXT), pct.CLIPTextConfig(**CLIP_TEXT)
    jp = jct.init_clip_text_params(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_port(jp, pct.init_clip_text_params(pc, device="meta"))


def llava_cfgs(pretrain=True):
    import dreamllm_tpu.models.llava as jllava
    import dreamllm_tpu_torch.models.llava as pllava

    jl, pl = llama_cfgs()
    jf = jllava.llava_pretrain_config if pretrain else jllava.llava_config
    pf = pllava.llava_pretrain_config if pretrain else pllava.llava_config
    return (jf(llm=jl, vision=jclip.CLIPVisionConfig(**CLIP)),
            pf(llm=pl, vision=pclip.CLIPVisionConfig(**CLIP)))


@functools.lru_cache(maxsize=None)
def llava_params(seed=5):
    import dreamllm_tpu.models.llava as jllava
    import dreamllm_tpu_torch.models.llava as pllava

    jc, pc = llava_cfgs()
    jp = jllava.init_llava_params(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_port(jp, pllava.init_llava_params(pc, device="meta"))


# ---------------------------------------------------------------------------
# Training: configurations, batches and replayed random draws
# ---------------------------------------------------------------------------

FROZEN = ("clip_vision_embedding/clip", "sd_head/unet", "sd_head/vae")


def train_cfgs(model_kw=None, head_kw=None):
    """(JAX model cfg, port model cfg, JAX head cfg, port head cfg), frozen
    as the SFT recipe freezes them."""
    import dataclasses

    jc, pc = dreamllm_cfgs()
    jh, ph = head_cfgs()
    model_kw = {"frozen": FROZEN, **(model_kw or {})}
    jc, pc = dataclasses.replace(jc, **model_kw), dataclasses.replace(pc, **model_kw)
    if head_kw:
        jh, ph = dataclasses.replace(jh, **head_kw), dataclasses.replace(ph, **head_kw)
    return jc, pc, jh, ph


@functools.lru_cache(maxsize=None)
def train_params():
    """JAX and port parameter dicts with the SD head under ``"sd_head"``."""
    _, _, jp, pp = dreamllm_params()
    _, _, jhp, php = head_params()
    return {**jp, "sd_head": jhp}, {**pp, "sd_head": php}


def train_batch(seed=0, b=2, s=40, px=64):
    """A tiny joint batch as numpy: each row one input image (4-token span),
    one dream span (8 queries) with a ``px`` image, labels on the text, row 1
    packed from two segments with a padding tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 31000, (b, s)).astype(np.int32)
    labels = ids.copy()
    seg = np.ones((b, s), np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    image_positions = np.full((b, 1), 3, np.int32)
    dream_positions = np.full((b, 1), 14, np.int32)
    labels[:, 2:8] = -100     # image span and its brackets
    labels[:, 13:23] = -100   # dream span and its brackets
    if b > 1:
        seg[1, 26:36] = 2
        seg[1, 36:] = 0
        pos[1, 26:36] = np.arange(10)
        labels[1, 36:] = -100
    return {
        "input_ids": ids, "labels": labels, "segment_ids": seg, "positions": pos,
        "images": rng.standard_normal((b, 1, 32, 32, 3)).astype(np.float32),
        "image_positions": image_positions, "dream_positions": dream_positions,
        "images_dm": rng.uniform(-1, 1, (b, 1, px, px, 3)).astype(np.float32),
    }


def jax_batch(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def replay_draws(rng, *, n_samples, latent_shape, num_train_timesteps=1000, uncond_prob=0.1,
                 neftune_shape=None):
    """The numbers ``dreamllm_forward`` + ``sd_head_loss`` of the JAX package
    draw from ``rng``, as the port's ``draws`` dict: the NEFTune split first
    (only when ``neftune_shape`` is given, as JAX splits only then), then the
    head's 5-way split."""
    out = {}
    if neftune_shape is not None:
        rng, r_nef = jax.random.split(rng)
        out["neftune"] = t(jax.random.uniform(r_nef, neftune_shape, np.float32))
    r_lat, r_noise, r_t, r_drop, r_pert = jax.random.split(rng, 5)
    lat = (n_samples,) + tuple(latent_shape)
    out["vae_eps"] = t(jax.random.normal(r_lat, lat, np.float32))
    out["noise"] = t(jax.random.normal(r_noise, lat, np.float32))
    out["offset"] = t(jax.random.normal(r_pert, (n_samples, 1, 1, lat[-1]), np.float32))
    out["perturbation"] = t(jax.random.normal(jax.random.fold_in(r_pert, 1), lat, np.float32))
    out["t"] = t(jax.random.randint(r_t, (n_samples,), 0, num_train_timesteps))
    out["drop"] = t(jax.random.bernoulli(r_drop, uncond_prob, (n_samples, 1, 1)))
    return out


def jax_leaf(tree, path):
    """The JAX leaf (numpy) for a path of the port's tree: a list index
    selects a layer of the stacked leaf, a 4-D conv kernel goes HWIO -> OIHW."""
    layer = None
    for key in path:
        if isinstance(key, int) and isinstance(tree, dict):
            layer = key
        else:
            tree = tree[key]
    a = np.asarray(tree)
    if layer is not None:
        a = a[layer]
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


# ---------------------------------------------------------------------------
# FID Inception and published checkpoint layouts (converters, eval_t2i)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def inception_params(seed=2):
    """A random FID Inception in the JAX package's layout (numpy), and the
    port's tree of the same numbers. The tree's shapes come from
    ``jax.eval_shape`` of JAX's ``init_inception_params`` (no eager init);
    conv kernels are drawn ``N(0, 1/fan_in)`` as JAX draws them, BN scales
    ``1 + 0.1 N`` and biases ``0.1 N``, so the folded BN is exercised."""
    from dreamllm_tpu.eval.fid import init_inception_params
    import dreamllm_tpu_torch.eval.fid as pfid

    shapes = jax.eval_shape(init_inception_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['w']"):
            kh, kw, cin, _ = s.shape
            return (rng.standard_normal(s.shape) * (kh * kw * cin) ** -0.5).astype(np.float32)
        if "bn_scale" in name:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "bn_bias" in name:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    jp = jax.tree_util.tree_map_with_path(fill, shapes)
    return jp, to_port(jp, pfid.init_inception_params(device="meta"))


@functools.lru_cache(maxsize=None)
def _jax_pool3_fn():
    from dreamllm_tpu.eval.fid import inception_pool3

    return jax.jit(inception_pool3)


def jax_pool3(params, images) -> np.ndarray:
    """JAX's ``inception_pool3`` under one ``jax.jit`` per worker (one
    compile per input shape)."""
    return np.asarray(_jax_pool3_fn()(params, np.asarray(images, np.float32)))


@functools.lru_cache(maxsize=None)
def jax_init(init_fn, cfg, seed=0):
    """A JAX init function of ``(rng, cfg)`` called eagerly, as numpy
    (cached; eager op compiles are shared across configurations, where
    ``jax.jit`` would compile each configuration's whole graph)."""
    return np_tree(init_fn(jax.random.PRNGKey(seed), cfg))


def save_safetensors_dir(path, state_dict: dict, config: dict | None = None) -> str:
    """``state_dict`` (numpy or torch) as one ``model.safetensors`` under
    ``path``, with ``config.json`` when given: a published layout."""
    import json

    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    save_file({k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))).contiguous()
               for k, v in state_dict.items()}, os.path.join(path, "model.safetensors"))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
    return str(path)


def unet_diffusers_config(kw: dict) -> dict:
    """A diffusers ``unet/config.json`` for the UNetConfig keywords ``kw``
    (diffusers names the SD-2.x head counts ``attention_head_dim``)."""
    out = {"sample_size": kw["sample_size"], "in_channels": 4, "out_channels": 4,
           "block_out_channels": list(kw["block_out_channels"]),
           "down_block_types": list(kw["down_block_types"]),
           "up_block_types": list(kw["up_block_types"]),
           "layers_per_block": kw["layers_per_block"],
           "transformer_layers_per_block": list(kw["transformer_layers_per_block"]),
           "attention_head_dim": list(kw["num_attention_heads"]),
           "cross_attention_dim": kw["cross_attention_dim"],
           "norm_num_groups": kw.get("norm_num_groups", 32)}
    for k in ("addition_embed_type", "addition_time_embed_dim",
              "projection_class_embeddings_input_dim"):
        if k in kw:
            out[k] = kw[k]
    return out


def write_diffusers_dir(path, unet_kw: dict, vae_kw: dict, seed=0) -> tuple[str, dict]:
    """A diffusers pipeline dir (``unet/`` and ``vae/``) of JAX-initialised
    random weights, written through JAX's ``export_*_state_dict``. Returns
    the dir and the JAX trees (numpy)."""
    from dreamllm_tpu.convert.hf_sd import export_unet_state_dict, export_vae_state_dict

    unet = jax_init(junet.init_unet_params, junet.UNetConfig(**unet_kw), seed)
    vae = jax_init(jvae.init_vae_params, jvae.VAEConfig(**vae_kw), seed + 1)
    save_safetensors_dir(os.path.join(path, "unet"), export_unet_state_dict(unet),
                         unet_diffusers_config(unet_kw))
    save_safetensors_dir(os.path.join(path, "vae"), export_vae_state_dict(vae),
                         {"block_out_channels": list(vae_kw["block_out_channels"]),
                          "layers_per_block": vae_kw["layers_per_block"],
                          "latent_channels": 4, "scaling_factor": 0.18215})
    return str(path), {"unet": unet, "vae": vae}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
            and torch.equal(a.detach().cpu().reshape(-1).view(torch.uint8),
                            b.detach().cpu().reshape(-1).view(torch.uint8)))


def assert_trees_bit_equal(got, want, where: str = "") -> None:
    """Port trees (tensors, ``Q4Tensor``/``QTensor`` leaves) equal bit for
    bit, structure included."""
    import dataclasses

    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, sorted(want))
        for k in want:
            assert_trees_bit_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_bit_equal(g, w, f"{where}/{i}")
    elif dataclasses.is_dataclass(want):
        assert type(got) is type(want), (where, type(got), type(want))
        for f in dataclasses.fields(want):
            assert_trees_bit_equal(getattr(got, f.name), getattr(want, f.name),
                                   f"{where}/{f.name}")
    else:
        assert same_bits(got, want), (where, got.dtype, want.dtype, tuple(got.shape),
                                      tuple(want.shape))
