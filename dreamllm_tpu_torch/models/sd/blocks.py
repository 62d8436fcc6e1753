"""Conv/attention building blocks of the SD VAE and UNet (port of
``dreamllm_tpu/models/sd/blocks.py``).

Activations are NHWC at every function boundary, as in JAX. A conv sees
them through ``permute(0, 3, 1, 2)``, a channels-last view of the same
memory, and its OIHW weight is stored channels-last too, so the NHWC <->
NCHW change costs no copy. As in JAX, a block casts its parameters to the
activation dtype.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from dreamllm_tpu_torch.models.llama import dense_init
from dreamllm_tpu_torch.ops.attention import dot_product_attention
from dreamllm_tpu_torch.ops.norms import group_norm

Params = dict[str, Any]


def init_conv(kh, kw, cin, cout, dtype, device, generator, scale=None) -> Params:
    scale = scale if scale is not None else (kh * kw * cin) ** -0.5
    w = torch.randn((cout, cin, kh, kw), dtype=torch.float32, device=device, generator=generator)
    return {"w": (w * scale).to(dtype).contiguous(memory_format=torch.channels_last),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def init_dense(din, dout, dtype, device, generator, scale=None) -> Params:
    return {"w": dense_init((din, dout), dtype, device, generator, scale),
            "b": torch.zeros((dout,), dtype=dtype, device=device)}


def init_norm(c, dtype, device) -> Params:
    return {"w": torch.ones((c,), dtype=dtype, device=device),
            "b": torch.zeros((c,), dtype=dtype, device=device)}


def conv2d(x: torch.Tensor, p: Params, stride: int = 1,
           padding: int | None = None) -> torch.Tensor:
    """NHWC conv with an OIHW weight, padded by ``padding``, default
    ``(k - 1) // 2``, on every side: JAX's "SAME" at stride 1, and the
    UNet's downsample padding at stride 2.

    A float32 conv on the card follows ``torch.backends.cudnn.allow_tf32``,
    which this package leaves to the caller: PyTorch's default (True) runs
    it in TF32; set it False to match the JAX package's "highest"
    precision, as ``chip_smoke.py`` does. bf16 convs are unaffected."""
    w = p["w"].to(x.dtype)
    if padding is None:
        padding = (w.shape[2] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, stride, padding)
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# ResNet block (diffusers ResnetBlock2D)
# ---------------------------------------------------------------------------


def init_resnet_block(cin, cout, temb_dim, dtype, device, generator) -> Params:
    p = {
        "norm1": init_norm(cin, dtype, device),
        "conv1": init_conv(3, 3, cin, cout, dtype, device, generator),
        "norm2": init_norm(cout, dtype, device),
        "conv2": init_conv(3, 3, cout, cout, dtype, device, generator),
    }
    if temb_dim is not None:
        p["time_emb_proj"] = init_dense(temb_dim, cout, dtype, device, generator)
    if cin != cout:
        p["shortcut"] = init_conv(1, 1, cin, cout, dtype, device, generator)
    return p


def resnet_block(p: Params, x: torch.Tensor, temb: torch.Tensor | None = None,
                 groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """norm→silu→conv→(+temb)→norm→silu→conv + shortcut."""
    h = F.silu(group_norm(x, p["norm1"]["w"], p["norm1"]["b"], num_groups=groups, eps=eps))
    h = conv2d(h, p["conv1"])
    if temb is not None and "time_emb_proj" in p:
        t = dense(F.silu(temb), p["time_emb_proj"])
        h = h + t[:, None, None, :].to(h.dtype)
    h = F.silu(group_norm(h, p["norm2"]["w"], p["norm2"]["b"], num_groups=groups, eps=eps))
    h = conv2d(h, p["conv2"])
    if "shortcut" in p:
        x = conv2d(x, p["shortcut"])
    return x + h


# ---------------------------------------------------------------------------
# Spatial self-attention block (VAE mid block)
# ---------------------------------------------------------------------------


def init_attn_block(c, dtype, device, generator) -> Params:
    return {
        "norm": init_norm(c, dtype, device),
        "q": init_dense(c, c, dtype, device, generator),
        "k": init_dense(c, c, dtype, device, generator),
        "v": init_dense(c, c, dtype, device, generator),
        "out": init_dense(c, c, dtype, device, generator),
    }


def attn_block(p: Params, x: torch.Tensor, num_heads: int = 1, groups: int = 32) -> torch.Tensor:
    """Plain attention, as in JAX (the VAE mid block never took the flash
    kernel there)."""
    b, h, w, c = x.shape
    y = group_norm(x, p["norm"]["w"], p["norm"]["b"], num_groups=groups).reshape(b, h * w, c)
    hd = c // num_heads
    q = dense(y, p["q"]).reshape(b, h * w, num_heads, hd)
    k = dense(y, p["k"]).reshape(b, h * w, num_heads, hd)
    v = dense(y, p["v"]).reshape(b, h * w, num_heads, hd)
    a = dot_product_attention(q, k, v, causal=False).reshape(b, h * w, c)
    return x + dense(a, p["out"]).reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# Resampling (diffusers Downsample2D / Upsample2D)
# ---------------------------------------------------------------------------


def downsample(p: Params, x: torch.Tensor, *, symmetric: bool = True) -> torch.Tensor:
    """Stride-2 conv. diffusers has two padding conventions that differ
    numerically: the UNet pads 1 on every side (``symmetric=True``, the
    default here), the VAE encoder pads (0, 1) per spatial dim."""
    if symmetric:
        return conv2d(x, p, stride=2)
    return conv2d(F.pad(x, (0, 0, 0, 1, 0, 1)), p, stride=2, padding=0)


def upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x, then a 3x3 conv."""
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return conv2d(x, p)


# ---------------------------------------------------------------------------
# Timestep embedding (diffusers get_timestep_embedding, SD settings)
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding in ``[cos | sin]`` order (flip_sin_to_cos=True,
    downscale_freq_shift=0). ``t``: ``[B]`` → ``[B, dim]`` float32."""
    half = dim // 2
    freqs = torch.exp(-torch.log(torch.tensor(max_period, dtype=torch.float32))
                      * torch.arange(half, dtype=torch.float32) / half).to(t.device)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
