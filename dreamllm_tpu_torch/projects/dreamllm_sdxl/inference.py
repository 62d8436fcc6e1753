"""DreamLLM-SDXL inference entry point (port of
``projects/dreamllm_sdxl/inference.py``): the DreamLLM entry, with the SDXL
head chosen by the recipe's ``head_type="sdxl"``.

    python -m dreamllm_tpu_torch.projects.dreamllm_sdxl.inference \\
        --config_file projects/dreamllm_sdxl/configs/smoke.py device=cpu \\
        prompt="a photo of a corgi" +mode=t2i
"""

from dreamllm_tpu_torch.projects.dreamllm.inference import main

if __name__ == "__main__":
    main()
