"""Lazy config system: executable-Python configs + ``LazyCall`` recipes +
dotted-path overrides + recursive instantiation.

A copy of ``dreamllm_tpu/config/lazy.py`` with one change to loading, which
keeps the JAX package out of the process: the recipes under ``projects/``
import ``dreamllm_tpu.config`` (for ``LazyCall``) and one another
(``from projects.dreamllm.configs.common import model, sd_head``), and name
their targets ``"dreamllm_tpu.models.llama.LlamaConfig"`` and the like.
:meth:`LazyConfig.load` therefore

  * rewrites, before compiling a recipe, every import of ``dreamllm_tpu``
    or a module under it into the same import of ``dreamllm_tpu_torch``;
  * loads every ``from projects.<...> import name`` from the recipe's own
    tree through this same loader, as a fresh module per ``load`` call
    (nothing is put into ``sys.modules``, so both packages can load recipes
    in one process, and an override of one load never reaches another);
  * renames the ``dreamllm_tpu.`` prefix of every ``_target_`` string to
    ``dreamllm_tpu_torch.`` (a target outside that prefix is left alone),
    so the config snapshot a run writes reloads through the port too.

Semantics otherwise as in the JAX package (reference omni/config/lazy.py,
instantiate.py, registry.py, with the omegaconf dependency removed):
  * configs are Python files that define a ``config`` object;
  * ``LazyCall(fn)(**kw)`` freezes a call without executing it;
  * CLI overrides use dotted paths ``a.b.c=value`` with literal parsing
    (hydra-grammar subset: assignment, ``+new.key=value``);
  * ``instantiate`` recursively builds ``_target_`` recipes and also
    descends plain mappings.
"""

from __future__ import annotations

import ast
import importlib
import os
import pydoc
import types
from typing import Any, Callable


TARGET_KEY = "_target_"


def locate(name: str) -> Any:
    """Resolve a dotted name to an object (reference registry.py locate).
    A name under ``dreamllm_tpu`` resolves in ``dreamllm_tpu_torch``
    (:func:`port_name`): a target never imports the JAX package."""
    name = port_name(name)
    obj = pydoc.locate(name)
    if obj is None:
        # pydoc.locate can fail on nested attributes; walk manually
        parts = name.split(".")
        for i in range(len(parts) - 1, 0, -1):
            try:
                mod = importlib.import_module(".".join(parts[:i]))
            except ImportError:
                continue
            obj = mod
            try:
                for attr in parts[i:]:
                    obj = getattr(obj, attr)
                return obj
            except AttributeError:
                continue
        raise ImportError(f"cannot locate {name!r}")
    return obj


def _target_to_string(t: Callable) -> str:
    module = getattr(t, "__module__", None)
    qualname = getattr(t, "__qualname__", None) or getattr(t, "__name__", None)
    if not module or not qualname:
        raise ValueError(f"cannot serialize target {t!r}")
    return f"{module}.{qualname}"


class LazyCall:
    """``LazyCall(fn)(a=1)`` → ``{"_target_": "mod.fn", "a": 1}``."""

    def __init__(self, target: Callable | str):
        if not (callable(target) or isinstance(target, str)):
            raise TypeError(f"LazyCall target must be callable or str, got {target!r}")
        self.target = target

    def __call__(self, **kwargs) -> dict:
        t = self.target if isinstance(self.target, str) else _target_to_string(self.target)
        return {TARGET_KEY: t, **kwargs}


def instantiate(cfg: Any) -> Any:
    """Recursively build ``_target_`` recipes (reference instantiate.py:35)."""
    if isinstance(cfg, dict):
        if TARGET_KEY in cfg:
            kwargs = {k: instantiate(v) for k, v in cfg.items() if k != TARGET_KEY}
            target = cfg[TARGET_KEY]
            fn = locate(target) if isinstance(target, str) else target
            return fn(**kwargs)
        return {k: instantiate(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(instantiate(v) for v in cfg)
    return cfg


# descending plain mappings is instantiate's default here; the reference's
# deep_instantiate distinction (instantiate.py:86) collapses away
deep_instantiate = instantiate


def _parse_value(s: str) -> Any:
    # hydra-grammar spellings first: a truthy string 'false' silently turns
    # boolean flags ON
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s  # bare string


def _set_dotted(cfg: Any, path: str, value: Any, *, create: bool = False):
    keys = path.split(".")
    cur = cfg
    for k in keys[:-1]:
        if isinstance(cur, dict):
            if k not in cur:
                if not create:
                    raise KeyError(f"override path {path!r}: missing key {k!r}")
                cur[k] = {}
            cur = cur[k]
        elif isinstance(cur, (list, tuple)):
            cur = cur[int(k)]
        else:
            cur = getattr(cur, k)
    last = keys[-1]
    if isinstance(cur, dict):
        if last not in cur and not create:
            raise KeyError(f"override path {path!r}: missing key {last!r}")
        cur[last] = value
    elif isinstance(cur, list):
        cur[int(last)] = value
    else:
        setattr(cur, last, value)


def _get_dotted(cfg: Any, path: str) -> Any:
    cur = cfg
    for k in path.split("."):
        if isinstance(cur, dict):
            cur = cur[k]
        elif isinstance(cur, (list, tuple)):
            cur = cur[int(k)]
        else:
            cur = getattr(cur, k)
    return cur


JAX_PACKAGE = "dreamllm_tpu"
PORT_PACKAGE = "dreamllm_tpu_torch"


def port_name(name: str) -> str:
    """``dreamllm_tpu`` or ``dreamllm_tpu.x.y`` -> the same path under
    ``dreamllm_tpu_torch``; any other dotted name is returned as it is."""
    if name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + "."):
        return PORT_PACKAGE + name[len(JAX_PACKAGE):]
    return name


def rename_targets(cfg: Any) -> Any:
    """``cfg`` with every string ``_target_`` passed through
    :func:`port_name`; dicts are changed in place, tuples rebuilt."""
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            if k == TARGET_KEY and isinstance(v, str):
                cfg[k] = port_name(v)
            else:
                cfg[k] = rename_targets(v)
        return cfg
    if isinstance(cfg, list):
        cfg[:] = [rename_targets(v) for v in cfg]
        return cfg
    if isinstance(cfg, tuple):
        return type(cfg)(rename_targets(v) for v in cfg)
    return cfg


def _module_file(name: str, near: str) -> str | None:
    """The file of recipe module ``name`` (``projects.a.b``): looked up from
    the directory of the recipe that imports it upwards, then in the
    working directory."""
    rel = os.path.join(*name.split(".")) + ".py"
    d = os.path.dirname(near)
    while True:
        cand = os.path.join(d, rel)
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    cand = os.path.abspath(rel)
    return cand if os.path.isfile(cand) else None


class _PortImports(ast.NodeTransformer):
    """Rewrites a recipe's imports: ``dreamllm_tpu`` -> ``dreamllm_tpu_torch``;
    ``from projects.<...> import a, b`` -> ``a = __recipe_module__("projects.<...>").a``."""

    def __init__(self, path: str):
        self.path = path

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = port_name(alias.name)
        return node

    def visit_ImportFrom(self, node):
        if node.level == 0 and node.module:
            if node.module.split(".")[0] == "projects" and _module_file(node.module, self.path):
                if any(a.name == "*" for a in node.names):
                    raise ImportError(f"{self.path}: 'from {node.module} import *' in a recipe")
                load = ast.Call(ast.Name("__recipe_module__", ast.Load()),
                                [ast.Constant(node.module)], [])
                return [ast.copy_location(
                    ast.Assign([ast.Name(a.asname or a.name, ast.Store())],
                               ast.Attribute(load, a.name, ast.Load())), node)
                    for a in node.names]
            node.module = port_name(node.module)
        return node


def _exec_recipe(path: str, name: str, loaded: dict) -> types.ModuleType:
    """Run one recipe file as a fresh module; ``loaded`` caches the recipe
    modules of this one ``LazyConfig.load`` call."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tree = ast.fix_missing_locations(_PortImports(path).visit(tree))
    module = types.ModuleType(name)
    module.__file__ = path

    def recipe_module(mod: str) -> types.ModuleType:
        if mod not in loaded:
            loaded[mod] = _exec_recipe(_module_file(mod, path), mod, loaded)
        return loaded[mod]

    module.__dict__["__recipe_module__"] = recipe_module
    exec(compile(tree, path, "exec"), module.__dict__)
    return module


class LazyConfig:
    """Load / override / save executable-Python configs."""

    @staticmethod
    def load(path: str) -> Any:
        """Execute ``path`` and return its ``config`` attribute, with the
        JAX package's imports and target names mapped to the port's (see
        the module docstring)."""
        module = _exec_recipe(os.path.abspath(path), "_lazy_config_", {})
        if not hasattr(module, "config"):
            raise ValueError(f"config file {path} must define a `config` object")
        return rename_targets(module.config)

    @staticmethod
    def apply_overrides(cfg: Any, overrides: list[str], *, allow_new: bool = False) -> Any:
        """``["a.b=3", "c='x'", "+new.key=1"]`` → mutated cfg (hydra-grammar
        subset: assignment and +new-key; reference lazy.py:218-240)."""
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override {ov!r} must be key=value")
            key, _, raw = ov.partition("=")
            key = key.strip()
            create = allow_new
            if key.startswith("+"):
                key = key[1:]
                create = True
            _set_dotted(cfg, key, _parse_value(raw.strip()), create=create)
        return cfg

    @staticmethod
    def get(cfg: Any, path: str, default: Any = None) -> Any:
        try:
            return _get_dotted(cfg, path)
        except (KeyError, AttributeError, IndexError):
            return default

    @staticmethod
    def to_py(cfg: Any, prefix: str = "config") -> str:
        """Serialize back to runnable Python (provenance snapshot, reference
        lazy.py:242-353)."""
        import pprint

        return f"{prefix} = {pprint.pformat(cfg, width=100, sort_dicts=False)}\n"

    @staticmethod
    def save(cfg: Any, path: str):
        with open(path, "w") as f:
            f.write(LazyConfig.to_py(cfg))
