"""Process-level communication helpers (the part of
``dreamllm_tpu/utils/comm.py`` that ``eval/text2img.run_protocol`` needs).

Over ``torch.distributed`` when a process group is initialised; a single
process otherwise (rank 0 of 1). The reference's ``omni/utils/comm.py``
gathers picklable objects the same way (:71-120).
"""

from __future__ import annotations

from typing import Any


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def get_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def get_world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier across the processes; nothing with one."""
    dist = _dist()
    if dist and dist.get_world_size() > 1:
        dist.barrier()


def all_gather_objects(obj: Any) -> list[Any]:
    """``obj`` of every process, in rank order (picklable objects)."""
    dist = _dist()
    if not dist or dist.get_world_size() == 1:
        return [obj]
    out: list[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
