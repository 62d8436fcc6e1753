"""DreamLLM-SDXL training entry point (port of
``projects/dreamllm_sdxl/train.py``): the DreamLLM entry, with the SDXL head
chosen by the recipe's ``head_type="sdxl"``.

    python -m dreamllm_tpu_torch.projects.dreamllm_sdxl.train \\
        --config_file projects/dreamllm_sdxl/configs/smoke.py device=cpu
"""

from dreamllm_tpu_torch.projects.dreamllm.train import main

if __name__ == "__main__":
    main()
