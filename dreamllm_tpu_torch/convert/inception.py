"""torchvision/pytorch-fid InceptionV3 state dict <-> the port's FID
Inception tree (port of ``dreamllm_tpu/convert/inception.py``).

Weights source: pytorch-fid's ``pt_inception-2015-12-05`` checkpoint (or
torchvision ``inception_v3``), the reference's FID backbone
(third_party/pytorch-fid/src/pytorch_fid/inception.py). BatchNorms are
folded into (scale, bias) at conversion time, since FID inference never
trains, in float32 numpy as the JAX package folds them:

    scale = gamma / sqrt(var + eps),  bias = beta - mean * scale

The converter returns the JAX package's layout (HWIO conv kernels) as CPU
tensors; ``bridge.from_jax(tree, init_inception_params(device="meta"))``
carries it into the port's. ``export_inception_state_dict`` takes the
port's tree (OIHW kernels).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from dreamllm_tpu_torch.convert._tensors import cast, hwio, to_numpy32

_EPS = 1e-3  # torchvision BasicConv2d BatchNorm eps


def _bn_conv(sd: Mapping, prefix: str, dtype) -> dict:
    w = sd[prefix + ".conv.weight"]  # [out,in,kh,kw]
    gamma = to_numpy32(sd[prefix + ".bn.weight"])
    beta = to_numpy32(sd[prefix + ".bn.bias"])
    mean = to_numpy32(sd[prefix + ".bn.running_mean"])
    var = to_numpy32(sd[prefix + ".bn.running_var"])
    scale = gamma / np.sqrt(var + _EPS)
    bias = beta - mean * scale
    cout = np.shape(w)[0]
    return {
        "conv": {"w": hwio(w, dtype), "b": torch.zeros((cout,), dtype=dtype)},
        "bn_scale": cast(scale, dtype),
        "bn_bias": cast(bias, dtype),
    }


# the tree's block families -> (torchvision branch names by the tree's keys)
_BRANCHES = {
    "a": {"b1x1": "branch1x1", "b5x5_1": "branch5x5_1", "b5x5_2": "branch5x5_2",
          "b3x3_1": "branch3x3dbl_1", "b3x3_2": "branch3x3dbl_2",
          "b3x3_3": "branch3x3dbl_3", "pool": "branch_pool"},
    "b": {"b3x3": "branch3x3", "b3x3dbl_1": "branch3x3dbl_1",
          "b3x3dbl_2": "branch3x3dbl_2", "b3x3dbl_3": "branch3x3dbl_3"},
    "c": {"b1x1": "branch1x1", "b7_1": "branch7x7_1", "b7_2": "branch7x7_2",
          "b7_3": "branch7x7_3", "b7d_1": "branch7x7dbl_1", "b7d_2": "branch7x7dbl_2",
          "b7d_3": "branch7x7dbl_3", "b7d_4": "branch7x7dbl_4",
          "b7d_5": "branch7x7dbl_5", "pool": "branch_pool"},
    "d": {"b3x3_1": "branch3x3_1", "b3x3_2": "branch3x3_2",
          "b7x7_1": "branch7x7x3_1", "b7x7_2": "branch7x7x3_2",
          "b7x7_3": "branch7x7x3_3", "b7x7_4": "branch7x7x3_4"},
    "e": {"b1x1": "branch1x1", "b3_1": "branch3x3_1", "b3_2a": "branch3x3_2a",
          "b3_2b": "branch3x3_2b", "b3d_1": "branch3x3dbl_1", "b3d_2": "branch3x3dbl_2",
          "b3d_3a": "branch3x3dbl_3a", "b3d_3b": "branch3x3dbl_3b",
          "pool": "branch_pool"},
}
_STEMS = {"stem1": "Conv2d_1a_3x3", "stem2": "Conv2d_2a_3x3", "stem3": "Conv2d_2b_3x3",
          "stem4": "Conv2d_3b_1x1", "stem5": "Conv2d_4a_3x3"}
_FAMILIES = {
    "mixed_5b": "a", "mixed_5c": "a", "mixed_5d": "a",
    "mixed_6a": "b",
    "mixed_6b": "c", "mixed_6c": "c", "mixed_6d": "c", "mixed_6e": "c",
    "mixed_7a": "d",
    "mixed_7b": "e", "mixed_7c": "e",
}


def convert_inception_state_dict(state_dict: Mapping[str, Any], dtype=torch.float32) -> dict:
    sd = state_dict
    out = {ours: _bn_conv(sd, theirs, dtype) for ours, theirs in _STEMS.items()}
    for ours, fam in _FAMILIES.items():
        theirs = ours.replace("mixed_", "Mixed_")
        out[ours] = {k: _bn_conv(sd, f"{theirs}.{b}", dtype) for k, b in _BRANCHES[fam].items()}
    return out


def export_inception_state_dict(params: dict) -> dict:
    """Inverse (for round-trip tests): torchvision names with
    identity-equivalent BN stats (mean=0, var=1-eps, gamma=scale,
    beta=bias), float32 CPU tensors."""
    out: dict = {}

    def put(prefix, p):
        w = p["conv"]["w"].detach().float().cpu().contiguous()  # OIHW
        cout = w.shape[0]
        out[prefix + ".conv.weight"] = w
        out[prefix + ".bn.weight"] = p["bn_scale"].detach().float().cpu()
        out[prefix + ".bn.bias"] = p["bn_bias"].detach().float().cpu()
        out[prefix + ".bn.running_mean"] = torch.zeros((cout,), dtype=torch.float32)
        out[prefix + ".bn.running_var"] = torch.full((cout,), 1.0 - _EPS, dtype=torch.float32)

    for ours, theirs in _STEMS.items():
        put(theirs, params[ours])
    for ours, fam in _FAMILIES.items():
        theirs = ours.replace("mixed_", "Mixed_")
        for bk, bv in _BRANCHES[fam].items():
            put(f"{theirs}.{bv}", params[ours][bk])
    return out
