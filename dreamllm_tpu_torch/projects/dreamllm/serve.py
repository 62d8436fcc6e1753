"""Serving entry point: a ModelServer from a recipe and a checkpoint (port of
``projects/dreamllm/serve.py``).

    # random params unless checkpoint= resolves
    python -m dreamllm_tpu_torch.projects.dreamllm.serve \\
        --config_file projects/dreamllm/configs/smoke.py device=cpu +port=8300

    # a trained run, int4 weights, 8 lanes, prefix cache for 2 system prompts
    python -m dreamllm_tpu_torch.projects.dreamllm.serve --config_file <cfg> \\
        +checkpoint=runs/stage2 +quantize=int4 +slots=8 +prefix_cache_entries=2

Endpoints (``serve/server.py``): POST /generate (stream=true -> SSE) through
the continuous-batching engine over the quantized (or bf16) decoder; POST
/logprob and POST /chat over the full-precision tree, one request at a
time under the server's lock, as in the JAX entry: its quantized and fused
decode weights need not agree with the embedding weights that chat splices
images into. GET /health. SIGTERM stops the server and the engine; the
last log line gives the engine's decode forwards and the kernels' launches
over the process's life.
"""

from __future__ import annotations

import json
import signal

import torch

from dreamllm_tpu_torch.config import LazyArgumentParser, default_setup
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.generation.sampler import SamplingConfig
from dreamllm_tpu_torch.models.dreamllm import init_dreamllm_params
from dreamllm_tpu_torch.ops import kernel_launches
from dreamllm_tpu_torch.projects.dreamllm.train import (
    build_model_cfg,
    head_init_and_loss,
    make_tokenizer,
    seeded,
)
from dreamllm_tpu_torch.serve import ContinuousBatchingEngine, EngineConfig, ModelServer
from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params
from dreamllm_tpu_torch.train.tree import tree_map
from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("projects.dreamllm.serve")


def build_server(config, *, device="cuda") -> ModelServer:
    """Recipe -> ready-to-start ModelServer (exposed for tests); everything
    on ``device``."""
    dev = resolve_device(device)
    cfg, head_cfg = build_model_cfg(config)
    tokenizer = make_tokenizer(config, cfg)
    params = init_dreamllm_params(cfg, generator=seeded(dev, 0), device=dev)
    # +chat_images=1: /chat with image OUTPUT through the interleaved
    # <dream_start> path. The head is initialised BEFORE the checkpoint
    # overlay so a trained sd_head item loads into it.
    chat_images = bool(config.get("chat_images", False)) and config.get("chat", True)
    if chat_images:
        init_head, _ = head_init_and_loss(config, head_cfg)
        params["sd_head"] = init_head(head_cfg, generator=seeded(dev, 1), device=dev)
    ck = latest_checkpoint(config.get("checkpoint", config["trainer"]["output_dir"]))
    if ck:
        loaded = load_params(ck)
        for k in params:
            if k in loaded:
                params[k] = tree_map(lambda t: t if t is None else t.to(dev), loaded[k])
        logger.info("serving %s", ck)
        if chat_images and "sd_head" not in loaded:
            logger.warning(
                "chat_images=1 but checkpoint %s has no 'sd_head' item: image output "
                "will use RANDOM diffusion-head params", ck)
    else:
        logger.warning("no checkpoint found: serving random params")

    llm_params = params["llm"]
    quant = config.get("quantize")
    if quant == "int8":
        from dreamllm_tpu_torch.models.llama import fuse_llama_params
        from dreamllm_tpu_torch.ops.quant import quantize_llama_params

        llm_params = quantize_llama_params(fuse_llama_params(llm_params))
    elif quant == "int4":
        from dreamllm_tpu_torch.ops.quant4 import quantize_llama_params_int4

        llm_params = quantize_llama_params_int4(llm_params)
    elif quant:
        raise ValueError(f"quantize must be int8 or int4, got {quant!r}")

    st = cfg.special_tokens
    scfg = SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=st.eos, pad_token_id=0)
    ecfg = EngineConfig(
        slots=config.get("slots", 8),
        prefill_len=config.get("prefill_len", 512),
        max_len=config.get("max_len", 1024),
        chunk_steps=config.get("chunk_steps", 16),
        cache_dtype=config.get("cache_dtype", "bfloat16"),
        prefix_cache_entries=config.get("prefix_cache_entries", 0),
        bos_token_id=st.bos,
    )
    # quantized/fused decode weights serve the engine; the FULL tree (vision
    # tower, original embeddings) backs multimodal chat and /logprob
    engine = ContinuousBatchingEngine(llm_params, cfg.llm, scfg, ecfg, device=dev)

    chat_fn = None
    if config.get("chat", True):
        from dreamllm_tpu_torch.generation.chat import make_chat_fn

        chat_params = dict(params, llm=dict(params["llm"]))
        icfg = None
        if chat_images:
            from dreamllm_tpu_torch.generation.interleaved import InterleavedConfig

            icfg = InterleavedConfig(
                max_new_tokens=config.get("max_new_tokens_limit", 1024),
                max_images=config.get("chat_max_images", 2),
                num_inference_steps=config.get("image_steps", 50),
                guidance_scale=config.get("guidance_scale", 3.5),
            )
        chat_fn = make_chat_fn(
            chat_params, cfg, tokenizer,
            head_params=params.get("sd_head") if chat_images else None,
            head_cfg=head_cfg if chat_images else None,
            interleaved=icfg,
            max_new_tokens_limit=config.get("max_new_tokens_limit", 1024),
            device=dev,
        )

    from dreamllm_tpu_torch.eval.nlp import choice_logprobs

    def logprob_fn(context, continuations):
        with torch.no_grad():
            return choice_logprobs(params["llm"], cfg.llm, tokenizer, context,
                                   list(continuations))

    engine.warmup()
    return ModelServer(
        logprob_fn=logprob_fn,
        host=config.get("host", "127.0.0.1"),
        port=config.get("port", 8300),
        engine=engine,
        tokenizer=tokenizer,
        chat_fn=chat_fn,
    )


def _stop_on_sigterm(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    args, config = LazyArgumentParser().parse(argv)
    resolve_device(args.device)
    default_setup(args, config)
    server = build_server(config, device=args.device)
    logger.info("listening on %s:%d", server.host, server.port)
    signal.signal(signal.SIGTERM, _stop_on_sigterm)
    try:
        server.start(background=False)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        logger.info("stopped after %d engine decode forwards; kernel launches %s",
                    server._engine.decode_steps, json.dumps(kernel_launches()))


if __name__ == "__main__":
    main()
