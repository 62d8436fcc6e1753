"""The port's config system against the JAX package's: ``LazyCall``,
``instantiate``, ``_parse_value``, ``apply_overrides``, ``from_dict`` and
the argument parser give JAX's results on the same inputs; every recipe
under ``projects/`` loads through the port to the dict JAX's loader gives,
with the ``dreamllm_tpu.`` target prefix renamed; and a fresh interpreter
that loads every recipe and builds its configs through the port holds
neither JAX nor the JAX package."""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from dreamllm_tpu.config import arg_parser as jax_arg_parser
from dreamllm_tpu.config import lazy as jax_lazy
from dreamllm_tpu_torch.config import arg_parser as port_arg_parser
from dreamllm_tpu_torch.config import lazy as port_lazy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "projects/*/configs/*.py"))
    + glob.glob(os.path.join(ROOT, "projects/dreamllm/configs/e2e/*.py"))
    if not p.endswith("__init__.py"))


def _outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("raises", exception type)``."""
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return "raises", type(e)


# ---------------------------------------------------------------------------
# lazy.py
# ---------------------------------------------------------------------------

PARSE_CASES = ["true", "False", "TRUE", "null", "None", "none", "3", "-2", "3.5", "1e-3",
               "[1, 2]", "['synthetic_pairs']", "[synthetic_pairs]", "(1, 2)", "{'a': 1}",
               "abc", "'quoted'", "a b", ""]


@pytest.mark.parametrize("raw", PARSE_CASES)
def test_parse_value_matches_jax(raw):
    got, want = port_lazy._parse_value(raw), jax_lazy._parse_value(raw)
    assert got == want and type(got) is type(want)


def test_unquoted_list_of_names_stays_a_string():
    """The override grammar's trap: ``data.datasets=[synthetic_pairs]`` is
    the string "[synthetic_pairs]" in both packages; the strings inside a
    list must be quoted."""
    assert port_lazy._parse_value("[synthetic_pairs]") == "[synthetic_pairs]"
    assert port_lazy._parse_value("['synthetic_pairs']") == ["synthetic_pairs"]


def _base_cfg():
    return {"a": {"b": 1, "c": False, "l": [1, 2, 3]}, "d": "x", "e": None}


OVERRIDE_CASES = {
    "assign": ["a.b=3"],
    "assign-string": ["d=hello"],
    "bool-false": ["a.c=false"],
    "bool-true": ["a.c=True"],
    "null": ["d=null"],
    "list": ["a.l=[4, 5]"],
    "list-index": ["a.l.1=7"],
    "new-leaf": ["+a.new=1"],
    "new-nested": ["+f.g.h=2.5"],
    "new-over-existing": ["+a.b=9"],
    "several": ["a.b=2", "+x=[1]", "d='q'"],
    "absent-leaf": ["a.zz=1"],
    "absent-parent": ["zz.b=1"],
    "no-equals": ["a.b"],
    "index-past-end": ["a.l.9=1"],
}


@pytest.mark.parametrize("name", sorted(OVERRIDE_CASES))
def test_apply_overrides_matches_jax(name):
    ovs = OVERRIDE_CASES[name]
    got = _outcome(port_lazy.LazyConfig.apply_overrides, _base_cfg(), ovs)
    want = _outcome(jax_lazy.LazyConfig.apply_overrides, _base_cfg(), ovs)
    assert got == want
    if name.startswith("absent"):
        assert got == ("raises", KeyError)  # an absent key needs "+"


def test_lazycall_matches_jax():
    for target in ("dreamllm_tpu_torch.models.llama.LlamaConfig", dict, collections_counter()):
        assert port_lazy.LazyCall(target)(a=1, b=[2]) == jax_lazy.LazyCall(target)(a=1, b=[2])
    with pytest.raises(TypeError):
        port_lazy.LazyCall(3)


def collections_counter():
    import collections

    return collections.Counter


INSTANTIATE_CASES = {
    "flat": {"_target_": "builtins.dict", "a": 1},
    "nested": {"_target_": "builtins.dict", "inner": {"_target_": "builtins.list"}, "k": [1]},
    "plain-mapping": {"x": {"_target_": "builtins.tuple"}, "y": ({"_target_": "builtins.dict"},)},
    "list": [{"_target_": "builtins.dict", "z": 2}, 3],
    "attribute": {"_target_": "collections.OrderedDict.fromkeys", "iterable": "ab"},
    "callable-target": {"_target_": dict, "q": 1},
    "missing": {"_target_": "no_such_module_xyz.thing"},
}


@pytest.mark.parametrize("name", sorted(INSTANTIATE_CASES))
def test_instantiate_matches_jax(name):
    cfg = INSTANTIATE_CASES[name]
    assert (_outcome(port_lazy.instantiate, copy.deepcopy(cfg))
            == _outcome(jax_lazy.instantiate, copy.deepcopy(cfg)))


def test_jax_named_targets_resolve_in_the_port():
    """A ``dreamllm_tpu.`` target resolves to the port's object, never to
    the JAX package's (``locate`` renames the prefix)."""
    from dreamllm_tpu_torch.models.llama import LlamaConfig

    assert port_lazy.locate("dreamllm_tpu.models.llama.LlamaConfig") is LlamaConfig
    built = port_lazy.instantiate({"_target_": "dreamllm_tpu.models.llama.LlamaConfig",
                                   "hidden_size": 8})
    assert isinstance(built, LlamaConfig) and built.hidden_size == 8
    assert port_lazy.port_name("dreamllm_tpu_torch.x") == "dreamllm_tpu_torch.x"
    assert port_lazy.port_name("dreamllm_tpuX.y") == "dreamllm_tpuX.y"
    assert port_lazy.port_name("builtins.dict") == "builtins.dict"


# ---------------------------------------------------------------------------
# arg_parser.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Inner:
    x: int = 1


@dataclasses.dataclass
class _Outer:
    name: str = "a"
    inner: _Inner = dataclasses.field(default_factory=_Inner)
    maybe: _Inner | None = None
    extra: dict | None = None


FROM_DICT_CASES = {
    "empty": {},
    "scalar": {"name": "b"},
    "nested": {"inner": {"x": 5}},
    "optional-nested": {"maybe": {"x": 7}, "extra": {"k": 1}},
    "unknown-key": {"nope": 1},
    "unknown-nested-key": {"inner": {"nope": 1}},
}


@pytest.mark.parametrize("name", sorted(FROM_DICT_CASES))
def test_from_dict_matches_jax(name):
    data = FROM_DICT_CASES[name]
    got = _outcome(port_arg_parser.from_dict, _Outer, copy.deepcopy(data))
    want = _outcome(jax_arg_parser.from_dict, _Outer, copy.deepcopy(data))
    assert got == want
    if "unknown" in name:
        assert got == ("raises", ValueError)


PARSE_ARGV = [
    ["seed=7", "run_dir=/tmp/x", "trainer.max_steps=2", "+mode=t2i",
     "data.datasets=['synthetic_pairs', 'synthetic_interleaved']", "data.size_list=[8, 8]",
     "model.frozen=null", "+pretrained.resume_from=/tmp/y"],
    ["logger_rank=all", "optimizer.learning_rate=0.5", "+new.deep.key=true"],
]


@pytest.mark.parametrize("i", range(len(PARSE_ARGV)))
def test_argument_parser_matches_jax(i):
    """Same recipe, same overrides: the same config (targets renamed) and the
    same argument fields; the port's arguments add ``device``."""
    argv = ["--config_file", "projects/dreamllm/configs/smoke.py", *PARSE_ARGV[i]]
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        p_args, p_cfg = port_arg_parser.LazyArgumentParser().parse(argv + ["device=cpu"])
        j_args, j_cfg = jax_arg_parser.LazyArgumentParser().parse(argv)
    finally:
        os.chdir(cwd)
    assert p_cfg == port_lazy.rename_targets(copy.deepcopy(j_cfg))
    j_fields = dataclasses.asdict(j_args)
    assert {k: v for k, v in dataclasses.asdict(p_args).items() if k != "device"} == j_fields
    assert p_args.device == "cpu" and p_args.cli_overrides[-1] == "device"


def test_absent_key_without_plus_raises_like_jax():
    argv = ["--config_file", os.path.join(ROOT, "projects/dreamllm/configs/smoke.py"), "mode=t2i"]
    with pytest.raises(KeyError):
        port_arg_parser.LazyArgumentParser().parse(argv)
    with pytest.raises(KeyError):
        jax_arg_parser.LazyArgumentParser().parse(argv)


def test_default_setup_run_dir_snapshot_and_seeds(tmp_path):
    """A timestamped run dir with the log and a config snapshot that reloads
    through the port to the same config; random, numpy and torch seeded with
    ``seed`` (rank 0)."""
    argv = ["--config_file", os.path.join(ROOT, "projects/dreamllm/configs/smoke.py"),
            f"run_dir={tmp_path}", "seed=5", "trainer.max_steps=2", "device=cpu"]
    args, config = port_arg_parser.LazyArgumentParser().parse(argv)
    run_dir = port_arg_parser.default_setup(args, config)
    assert os.path.dirname(run_dir) == str(tmp_path)
    draws = (random.random(), float(np.random.random()), float(torch.rand(())))
    random.seed(5)
    np.random.seed(5)
    torch.manual_seed(5)
    assert draws == (random.random(), float(np.random.random()), float(torch.rand(())))
    assert os.path.exists(os.path.join(run_dir, "log_rank0.txt"))
    snap = port_lazy.LazyConfig.load(os.path.join(run_dir, "config_snapshot.py"))
    assert snap == config
    assert snap["model"]["llm"]["_target_"] == "dreamllm_tpu_torch.models.llama.LlamaConfig"
    with open(os.path.join(run_dir, "log_rank0.txt")) as f:
        assert "CLI-overridden keys: run_dir, seed, trainer.max_steps, device" in f.read()


def test_use_profiler_raises_naming_the_roadmap_item(tmp_path):
    args = port_arg_parser.LazyArguments(run_dir=str(tmp_path), use_profiler=True)
    with pytest.raises(NotImplementedError, match="#21"):
        port_arg_parser.default_setup(args, {})


def test_metrics_logger_takes_tensors(tmp_path):
    from dreamllm_tpu_torch.utils.metrics_logger import MetricsLogger, _to_py

    assert _to_py(torch.tensor(1.5)) == 1.5
    assert _to_py(torch.tensor([1.0, 2.0], dtype=torch.bfloat16)) == [1.0, 2.0]
    assert _to_py(torch.tensor([3, 4])) == [3, 4]
    log = MetricsLogger(str(tmp_path), use_wandb=False)
    log.on_log(None, 3, {"loss": torch.tensor(0.25), "val_acc": 1, "eval_x": [1, 2]})
    log.on_validate(None, 3, {"score": torch.tensor(2.0), "img": torch.zeros(4, 4, 3)})
    log.finish()
    rows = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert rows[0]["step"] == 3 and rows[0]["train/loss"] == 0.25
    assert rows[0]["val/acc"] == 1 and rows[0]["eval/x"] == [1, 2]
    assert rows[1]["val/score"] == 2.0
    assert (tmp_path / "val_images" / "000003_img.png").exists()


# ---------------------------------------------------------------------------
# The recipes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_loads_to_jax_dict(recipe):
    """Each file under ``projects/*/configs/`` loads through the port to the
    dict JAX's ``LazyConfig.load`` gives, targets renamed; a file without a
    ``config`` (the shared ``common.py`` modules) raises in both."""
    path = os.path.join(ROOT, recipe)
    got = _outcome(port_lazy.LazyConfig.load, path)
    want = _outcome(jax_lazy.LazyConfig.load, path)
    if want[0] == "raises":
        assert recipe.endswith("common.py") and got == want == ("raises", ValueError)
        return
    # JAX's recipes share the imported ``common`` dicts: compare a copy
    assert got[0] == "ok" and got[1] == port_lazy.rename_targets(copy.deepcopy(want[1]))
    targets = json.dumps(got[1], default=repr)
    assert '"dreamllm_tpu.' not in targets


def test_recipe_overrides_do_not_leak_between_loads():
    """Each load runs the recipe and its ``common`` afresh: an override of
    one loaded config never reaches the next load."""
    path = os.path.join(ROOT, "projects/dreamllm/configs/sft.py")
    first = port_lazy.LazyConfig.load(path)
    port_lazy.LazyConfig.apply_overrides(first, ["model.llm.num_hidden_layers=4"])
    assert port_lazy.LazyConfig.load(path)["model"]["llm"]["num_hidden_layers"] == 32


def test_recipes_load_without_jax_in_a_fresh_interpreter():
    """A subprocess that blocks JAX and the JAX package, loads every recipe
    through the port and instantiates its model and head configs (as the
    entry points build them); neither ``jax`` nor ``dreamllm_tpu`` is then
    in ``sys.modules``."""
    code = f"""
import sys
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dreamllm_tpu')
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('the port imported ' + name)
sys.meta_path.insert(0, Block())
for m in [m for m in sys.modules if m.split('.')[0] in BLOCKED]:
    del sys.modules[m]
from dreamllm_tpu_torch.config import LazyConfig, instantiate
from dreamllm_tpu_torch.models.sd.head import SDHeadConfig
from dreamllm_tpu_torch.models.sd.sdxl import SDXLHeadConfig
from dreamllm_tpu_torch.models.dreamllm import DreamLLMConfig
from dreamllm_tpu_torch.projects.dreamllm.train import build_model_cfg
built = 0
for path in {RECIPES!r}:
    try:
        cfg = LazyConfig.load(path)
    except ValueError:
        assert path.endswith('common.py'), path
        continue
    if 'model' in cfg and 'sd_head' in cfg:
        model, head = build_model_cfg(cfg)
        assert isinstance(model, DreamLLMConfig) and isinstance(head, SDHeadConfig)
    elif 'model' in cfg:
        m = instantiate(cfg['model'])
        m.pop('frozen', None)
        DreamLLMConfig(**m)
    else:
        h = instantiate(cfg['sd_head'])
        (SDXLHeadConfig if cfg.get('head_type') == 'sdxl' else SDHeadConfig)(**h)
    built += 1
bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]
assert not bad, bad
print(built)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) == sum(not r.endswith("common.py") for r in RECIPES)
