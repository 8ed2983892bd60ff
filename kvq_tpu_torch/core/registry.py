"""The dataset registry (copy of kvq_tpu/core/registry.py's ``Registry`` and
``DATASETS``).

The reference resolves dataset classes by reflection (``getattr(datasets,
cfg["type"])``, trainer.py:120-123); here a decorator registry does, so an
unknown ``data.<split>.type`` names the registered ones: ``KVQDataset``,
``SimpleVQADataset`` and ``GenericViewDataset``, and their reference names
``ViewDecompositionDataset_KVQ``,
``ViewDecompositionDataset_add_forSimpleVQA`` and
``ViewDecompositionDataset`` (data/datasets.py), and the seven legacy
DOVER/FastVQA classes of data/legacy_datasets.py.  The port's model keys
are resolved by ``models/vqa_network.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Any] = {}

    def register(self, key: str | None = None) -> Callable:
        def deco(obj):
            k = key or obj.__name__
            if k in self._items:
                raise KeyError(f"duplicate {self.name} registration: {k}")
            self._items[k] = obj
            return obj

        return deco

    def get(self, key: str):
        try:
            return self._items[key]
        except KeyError:
            raise KeyError(
                f"unknown {self.name} '{key}'; available: {sorted(self._items)}"
            ) from None

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def keys(self):
        return sorted(self._items)


DATASETS = Registry("dataset")
