"""The port's command-line entry points, mirroring the repo's ``projects/``:

    python -m dreamllm_tpu_torch.projects.<project>.<entry> \\
        --config_file projects/<project>/configs/<recipe>.py key=value ...

They read the ``projects/*/configs`` recipes through the port's
``LazyConfig`` (the JAX package is never imported) with the JAX entry
points' override grammar, and run on the card unless ``device=cpu``."""
