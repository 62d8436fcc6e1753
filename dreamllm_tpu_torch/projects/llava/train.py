"""LLaVA training entry point (port of ``projects/llava/train.py``): the
comprehension-only variant, the DreamLLM pipeline with the creation path
off and the LLaVA freeze presets.

    python -m dreamllm_tpu_torch.projects.llava.train \\
        --config_file projects/llava/configs/pretrain_smoke.py device=cpu
"""

from __future__ import annotations

import dreamllm_tpu_torch.data.catalog  # noqa: F401 — registers datasets
from dreamllm_tpu_torch.config import LazyArgumentParser, default_setup, instantiate
from dreamllm_tpu_torch.data.stream import MappedStream, PrefetchStream
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.dreamllm import DreamLLMConfig, param_freeze_mask
from dreamllm_tpu_torch.models.llava import init_llava_params
from dreamllm_tpu_torch.projects.dreamllm.train import (
    check_one_card,
    data_stream,
    make_tokenizer,
    prefetched,
    seeded,
    torch_dtypes,
)
from dreamllm_tpu_torch.train.optim import OptimizerConfig, make_optimizer
from dreamllm_tpu_torch.train.step import init_train_state, make_train_step
from dreamllm_tpu_torch.train.trainer import Trainer, TrainerConfig
from dreamllm_tpu_torch.utils.logging import get_logger
from dreamllm_tpu_torch.utils.metrics_logger import MetricsLogger

logger = get_logger("projects.llava.train")


def _text_and_images(batch: dict) -> dict:
    for k in ("images_dm", "dream_positions", "add_time_ids"):
        batch.pop(k, None)
    return batch


def main(argv=None):
    args, config = LazyArgumentParser().parse(argv)
    dev = resolve_device(args.device)
    check_one_card(config)
    run_dir = default_setup(args, config)

    m = instantiate(torch_dtypes(config["model"]))
    frozen = tuple(m.pop("frozen", ()))
    cfg = DreamLLMConfig(**m, frozen=frozen, loss_weight_vm=0.0)
    tokenizer = make_tokenizer(config, cfg)
    params = init_llava_params(cfg, generator=seeded(dev, config.get("seed", 0)), device=dev)

    ocfg = OptimizerConfig(**config["optimizer"])
    mask = param_freeze_mask(params, cfg)
    tx = make_optimizer(ocfg, trainable_mask=mask)
    state = init_train_state(params, tx, device=dev)
    del params
    step = make_train_step(
        cfg, tx, head_in_params=False,
        grad_accum=config.get("grad_accum", 1), remat=True,
        use_flash=True,  # the kernels on the card, their plain versions on the CPU
        trainable_mask=mask, device=dev,
    )

    stream = prefetched(MappedStream(data_stream(config, cfg, tokenizer), _text_and_images),
                        config, dev)
    tcfg = TrainerConfig(**config["trainer"])
    mlog = MetricsLogger(run_dir, project="llava_tpu_torch")
    trainer = Trainer(tcfg, step, stream, state, callbacks=[mlog], device=dev)
    try:
        final = trainer.train()
    finally:
        if isinstance(stream, PrefetchStream):
            stream.close()
        mlog.finish()
    return final


if __name__ == "__main__":
    main()
