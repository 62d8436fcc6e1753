"""CLIP ViT vision encoder (port of ``dreamllm_tpu/models/clip.py``).

Images are NHWC; the patch conv weight is OIHW (the bridge transposes the
JAX HWIO kernel). ``select_layer`` follows HF's ``hidden_states`` indexing:
``-2`` is the input of the last block, and only the blocks before the tap
run.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.llama import dense_init
from dreamllm_tpu_torch.ops.activations import quick_gelu
from dreamllm_tpu_torch.ops.attention import dot_product_attention
from dreamllm_tpu_torch.ops.norms import layer_norm

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS


def init_clip_vision_params(cfg: CLIPVisionConfig, *, generator: torch.Generator | None = None,
                            device="cuda") -> Params:
    dev = resolve_device(device)
    h, i, d, p = cfg.hidden_size, cfg.intermediate_size, cfg.dtype, cfg.patch_size

    def dense(shape, scale=None):
        return dense_init(shape, d, dev, generator, scale)

    def zeros(n):
        return torch.zeros((n,), dtype=d, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=d, device=dev)

    layers = [
        {
            "ln1_w": ones(h), "ln1_b": zeros(h), "ln2_w": ones(h), "ln2_b": zeros(h),
            "wq": dense((h, h)), "bq": zeros(h),
            "wk": dense((h, h)), "bk": zeros(h),
            "wv": dense((h, h)), "bv": zeros(h),
            "wo": dense((h, h)), "bo": zeros(h),
            "fc1_w": dense((h, i)), "fc1_b": zeros(i),
            "fc2_w": dense((i, h)), "fc2_b": zeros(h),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    patch = dense((h, 3, p, p), scale=0.02).contiguous(memory_format=torch.channels_last)
    return {
        "class_embedding": dense((h,), scale=0.02),
        "patch_embedding": patch,  # OIHW
        "position_embedding": dense((cfg.seq_len, h), scale=0.02),
        "pre_ln_w": ones(h), "pre_ln_b": zeros(h),
        "post_ln_w": ones(h), "post_ln_b": zeros(h),
        "layers": layers,
    }


def _clip_block(layer: Params, x: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    b, s, h = x.shape
    nh = cfg.num_attention_heads
    hd = h // nh
    eps = cfg.layer_norm_eps
    y = layer_norm(x, layer["ln1_w"], layer["ln1_b"], eps)
    q = (y @ layer["wq"] + layer["bq"]).reshape(b, s, nh, hd)
    k = (y @ layer["wk"] + layer["bk"]).reshape(b, s, nh, hd)
    v = (y @ layer["wv"] + layer["bv"]).reshape(b, s, nh, hd)
    a = dot_product_attention(q, k, v, causal=False)
    x = x + (a.reshape(b, s, h) @ layer["wo"] + layer["bo"])
    y = layer_norm(x, layer["ln2_w"], layer["ln2_b"], eps)
    y = quick_gelu(y @ layer["fc1_w"] + layer["fc1_b"]) @ layer["fc2_w"] + layer["fc2_b"]
    return x + y


def clip_vision_forward(
    params: Params,
    cfg: CLIPVisionConfig,
    pixel_values: torch.Tensor,
    *,
    select_layer: int | None = None,
    drop_cls: bool = False,
) -> torch.Tensor:
    """``[B, H, W, 3]`` CLIP-normalized NHWC images → ``[B, S(-1), hidden]``."""
    b = pixel_values.shape[0]
    h = cfg.hidden_size
    w = params["patch_embedding"]
    x = pixel_values.to(w.dtype).permute(0, 3, 1, 2)
    patches = F.conv2d(x, w, stride=cfg.patch_size).permute(0, 2, 3, 1).reshape(b, -1, h)
    cls = params["class_embedding"][None, None].expand(b, 1, h).to(patches.dtype)
    x = torch.cat([cls, patches], dim=1)
    x = x + params["position_embedding"][None].to(x.dtype)
    x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"], cfg.layer_norm_eps)

    n_run = cfg.num_hidden_layers
    if select_layer is not None:
        idx = select_layer if select_layer >= 0 else cfg.num_hidden_layers + 1 + select_layer
        if not 0 <= idx <= cfg.num_hidden_layers:
            raise ValueError(f"select_layer {select_layer} out of range")
        n_run = idx
    for layer in params["layers"][:n_run]:
        x = _clip_block(layer, x, cfg)
    return x[:, 1:] if drop_cls else x


def clip_pooled_output(params: Params, cfg: CLIPVisionConfig,
                       last_hidden: torch.Tensor) -> torch.Tensor:
    """The post-layernormed CLS embedding ``[B, hidden]`` (HF
    ``pooler_output``) of the tower's last hidden state ``[B, S, hidden]``."""
    return layer_norm(last_hidden[:, 0], params["post_ln_w"], params["post_ln_b"],
                      cfg.layer_norm_eps)


# CLIP image normalization constants (openai/clip-vit-large-patch14 processor)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def bicubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """``[in_size, out_size]`` float32 weights of ``jax.image.resize(...,
    "bicubic")`` along one axis: the Keys a=-0.5 kernel, widened by the
    scale when downsampling (antialias), columns normalized to sum 1, and
    samples outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)  # JAX's order of operations
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bicubic(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC bicubic resize with ``jax.image.resize``'s weights (see
    :func:`bicubic_weights`); ``F.interpolate`` uses a = -0.75 and no
    antialias, so it is not used."""
    x = images
    if x.shape[1] != height:
        wh = bicubic_weights(x.shape[1], height, x.device).to(x.dtype)
        x = torch.einsum("bhwc,hi->biwc", x, wh)
    if x.shape[2] != width:
        ww = bicubic_weights(x.shape[2], width, x.device).to(x.dtype)
        x = torch.einsum("bhwc,wj->bhjc", x, ww)
    return x


def clip_preprocess(images: torch.Tensor, image_size: int) -> torch.Tensor:
    """Resize (bicubic) + CLIP normalize ``[B, H, W, 3]`` images in [0, 1]."""
    if images.shape[1] != image_size or images.shape[2] != image_size:
        images = resize_bicubic(images, image_size, image_size).clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std
