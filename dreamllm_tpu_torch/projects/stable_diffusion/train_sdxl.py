"""Plain SDXL fine-tuning entry point (port of
``projects/stable_diffusion/train_sdxl.py``): ``train.py`` with the SDXL head
forced on.

    python -m dreamllm_tpu_torch.projects.stable_diffusion.train_sdxl \\
        --config_file projects/stable_diffusion/configs/smoke_xl.py device=cpu
"""

from __future__ import annotations

from dreamllm_tpu_torch.projects.stable_diffusion.train import main as _main


def main(argv=None):
    return _main(argv, force_head_type="sdxl")


if __name__ == "__main__":
    main()
