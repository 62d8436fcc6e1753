"""Leaf helpers shared by the converters.

The converters build trees in the JAX package's layout (layers stacked on a
leading ``[L, ...]`` axis, conv kernels HWIO, dense weights ``[in, out]``)
out of CPU tensors of the target dtype; ``bridge.from_jax`` carries such a
tree into the port's layout. A source leaf keeps its own dtype until the
cast: widening bf16 or fp16 to float32 and narrowing again is exact, so the
bits are those of the JAX package's float32 numpy path.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(x) -> torch.Tensor:
    """A CPU tensor of a torch tensor, a numpy array or anything array-like,
    in its own dtype (a numpy ``bfloat16`` array keeps its bits)."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy32(x) -> np.ndarray:
    """float32 numpy of a leaf: the JAX package's ``_to_np``."""
    return to_tensor(x).float().numpy()


def cast(x, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a contiguous CPU tensor of ``dtype`` (round to nearest even,
    as ``jnp.asarray(x, dtype)`` rounds a float32 array)."""
    return to_tensor(x).to(dtype).contiguous()


def hwio(x, dtype: torch.dtype) -> torch.Tensor:
    """A torch conv kernel ``[out, in, kh, kw]`` as HWIO ``[kh, kw, in, out]``."""
    return cast(to_tensor(x).permute(2, 3, 1, 0), dtype)


def transposed(x, dtype: torch.dtype) -> torch.Tensor:
    """A torch linear weight ``[out, in]`` as ``[in, out]``."""
    return cast(to_tensor(x).t(), dtype)
