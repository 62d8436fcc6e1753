"""Size-weighted dataset mixing (reference manager/mixed_dataset.py:13-59):
bisect routing over cumulative sizes with modulo oversampling, so a dataset
smaller than its assigned share repeats.

A copy of ``dreamllm_tpu/data/mixed.py`` with its imports pointed at the port."""

from __future__ import annotations

import bisect
from typing import Sequence


class MixedDataset:
    def __init__(self, datasets: Sequence, sizes: Sequence[int]):
        assert len(datasets) == len(sizes) and len(datasets) > 0
        self.datasets = list(datasets)
        self.sizes = [int(s) for s in sizes]
        self.cum = []
        total = 0
        for s in self.sizes:
            total += s
            self.cum.append(total)

    def __len__(self) -> int:
        return self.cum[-1]

    def __getitem__(self, index: int):
        if index < 0 or index >= len(self):
            raise IndexError(index)
        di = bisect.bisect_right(self.cum, index)
        local = index - (self.cum[di - 1] if di > 0 else 0)
        ds = self.datasets[di]
        return ds[local % len(ds)]  # modulo oversampling
