"""Dataset registry + manager (reference omni/data/manager/data_registry.py:
12-100, dataset_info.py:12-107, constants.py:44-232).

``DATASETS`` maps names to lazily-constructed dataset factories.
``DataManager(names, size_list=... | ratios=..+total_size=..)`` instantiates
and wraps them in a size-weighted MixedDataset.

A copy of ``dreamllm_tpu/data/registry.py`` with its imports pointed at the port."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from dreamllm_tpu_torch.data.mixed import MixedDataset


@dataclasses.dataclass
class DatasetInfo:
    name: str
    factory: Callable[..., Any]          # () -> dataset (map-style or iterable)
    dataset_type: str = ""
    approx_size: int | None = None
    kwargs: dict = dataclasses.field(default_factory=dict)

    def build(self, **overrides):
        kw = dict(self.kwargs)
        kw.update(overrides)
        # drop kwargs the factory doesn't accept: DataManager passes ONE
        # build_kw dict to every dataset in a mix, and kind-specific options
        # (e.g. pair-only ``quality``) must not crash the other factories
        import inspect

        try:
            sig = inspect.signature(self.factory)
        except (TypeError, ValueError):
            return self.factory(**kw)
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in sig.parameters.values()):
            kw = {k: v for k, v in kw.items() if k in sig.parameters}
        return self.factory(**kw)


class _Registry:
    def __init__(self):
        self._table: dict[str, DatasetInfo] = {}

    def register(self, info: DatasetInfo):
        if info.name in self._table:
            raise KeyError(f"dataset {info.name!r} already registered")
        self._table[info.name] = info
        return info

    def __getitem__(self, name: str) -> DatasetInfo:
        if name not in self._table:
            raise KeyError(
                f"unknown dataset {name!r}; registered: {sorted(self._table)}"
            )
        return self._table[name]

    def __contains__(self, name):
        return name in self._table

    def names(self):
        return sorted(self._table)


DATASETS = _Registry()


def register_dataset(name: str, factory: Callable[..., Any], **info_kw):
    """Decorator/function to add a dataset to the global registry."""
    return DATASETS.register(DatasetInfo(name=name, factory=factory, **info_kw))


class DataManager:
    """Instantiate named datasets and mix them (reference __call__ :56-100)."""

    def __call__(
        self,
        datasets: Sequence[str],
        *,
        size_list: Sequence[int] | None = None,
        ratios: Sequence[float] | None = None,
        total_size: int | None = None,
        **build_kw,
    ):
        if size_list is None:
            assert ratios is not None and total_size is not None, (
                "provide size_list, or ratios + total_size"
            )
            assert len(ratios) == len(datasets)
            s = sum(ratios)
            size_list = [int(total_size * r / s) for r in ratios]
        assert len(size_list) == len(datasets)
        built = [DATASETS[n].build(**build_kw) for n in datasets]
        return MixedDataset(built, size_list)
