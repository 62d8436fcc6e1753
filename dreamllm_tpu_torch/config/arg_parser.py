"""CLI entry-point plumbing: --config_file + overrides -> hydrated dataclass
(port of ``dreamllm_tpu/config/arg_parser.py``).

Load the Python config, apply hydra-style overrides, set up the run dir,
logging and seeds, snapshot the resolved config, then hydrate a typed
dataclass. ``from_dict`` and :class:`LazyArgumentParser` are copies.
:class:`LazyArguments` gains ``device`` ("cuda" by default, "cpu" when the
caller asks for it): the port's counterpart of the JAX package's
``DREAMLLM_PLATFORM`` switch.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import logging
import os
import random
import types
import typing
from typing import Any, Type, TypeVar

import numpy as np
import torch

from dreamllm_tpu_torch.config.lazy import LazyConfig, _parse_value
from dreamllm_tpu_torch.utils.logging import _process_index, setup_logger

T = TypeVar("T")
logger = logging.getLogger("dreamllm_tpu_torch")


def from_dict(cls: Type[T], data: dict) -> T:
    """Strict dict → dataclass hydration (dacite replacement): unknown keys
    raise; nested dataclasses recurse; extra containers pass through."""
    if not dataclasses.is_dataclass(cls):
        return data  # type: ignore[return-value]
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for name, value in data.items():
        t = hints.get(name, fields[name].type)
        origin = typing.get_origin(t)
        if dataclasses.is_dataclass(t) and isinstance(value, dict):
            value = from_dict(t, value)
        elif origin is typing.Union or isinstance(t, types.UnionType):
            # typing.Optional[X] AND PEP 604 "X | None"
            args = [a for a in typing.get_args(t) if a is not type(None)]
            if len(args) == 1 and dataclasses.is_dataclass(args[0]) and isinstance(value, dict):
                value = from_dict(args[0], value)
        kwargs[name] = value
    return cls(**kwargs)


@dataclasses.dataclass
class LazyArguments:
    """Common flags every entry point takes (reference arg_parser.py:31-44),
    and ``device``: where the entry point runs ("cuda" raises without a
    card; "cpu" runs the kernels' plain versions)."""

    config_file: str = ""
    run_dir: str = "./runs"
    seed: int = 42
    use_profiler: bool = False
    logger_rank: str = "main"  # "main" | "all"
    device: str = "cuda"


def default_setup(args: Any, config: Any) -> str:
    """run_dir timestamping, logging, seeds, config snapshot (reference
    arg_parser.py:110-157). Returns the run dir.

    ``random``, numpy and torch are seeded with ``seed + rank``, the rank
    being ``torch.distributed``'s when a process group is initialised and 0
    otherwise. One process needs no broadcast of the run dir's stamp."""
    if getattr(args, "use_profiler", False):
        raise NotImplementedError(
            "use_profiler=True: the sampling profiler (dreamllm_tpu/utils/profiler.py) "
            "is not ported yet (ROADMAP #21)")
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    run_dir = os.path.join(args.run_dir, stamp)
    os.makedirs(run_dir, exist_ok=True)
    setup_logger(run_dir=run_dir, rank_policy=getattr(args, "logger_rank", "main"))

    seed = getattr(args, "seed", 42) + _process_index()  # per-rank decorrelation
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)

    try:
        LazyConfig.save(config, os.path.join(run_dir, "config_snapshot.py"))
    except Exception as e:
        logger.warning("config snapshot failed: %s", e)

    # the resolved config, with the CLI-overridden keys called out
    overrides = getattr(args, "cli_overrides", None)
    try:
        logger.info("command line arguments: %s", args)
        if overrides:
            logger.info("CLI-overridden keys: %s", ", ".join(overrides))
        logger.info("full config:\n%s", json.dumps(config, indent=2, default=repr))
    except Exception as e:  # config logging must never kill a run
        logger.warning("config logging failed: %s", e)
    return run_dir


class LazyArgumentParser:
    """``prog --config_file cfg.py key=value ...`` → (args, config).

    Keys present in the arguments dataclass are hydrated into it; everything
    else is applied to the loaded config as an override
    (reference arg_parser.py:164-193).
    """

    def __init__(self, args_cls: Type[T] = LazyArguments):
        self.args_cls = args_cls

    def parse(self, argv: list[str] | None = None) -> tuple[Any, Any]:
        p = argparse.ArgumentParser()
        p.add_argument("--config_file", required=True)
        p.add_argument("overrides", nargs="*")
        ns = p.parse_args(argv)

        config = LazyConfig.load(ns.config_file)
        field_names = {f.name for f in dataclasses.fields(self.args_cls)}
        cfg_overrides, arg_overrides = [], {}
        for ov in ns.overrides:
            key = ov.split("=", 1)[0].lstrip("+")
            root = key.split(".", 1)[0]
            if root in field_names and "." not in key:
                arg_overrides[key] = _parse_value(ov.split("=", 1)[1])
            else:
                cfg_overrides.append(ov)
        LazyConfig.apply_overrides(config, cfg_overrides)

        data = dict(config) if isinstance(config, dict) else {}
        args_data = {
            k: v for k, v in data.items()
            if k in field_names and not isinstance(v, dict)
        }
        args_data.update(arg_overrides)
        args_data.setdefault("config_file", ns.config_file)
        args = from_dict(self.args_cls, args_data)
        # exact override provenance for default_setup's config logging
        try:
            args.cli_overrides = [ov.split("=", 1)[0].lstrip("+") for ov in ns.overrides]
        except Exception:
            pass  # frozen args dataclasses just skip the extra attribute
        return args, config
