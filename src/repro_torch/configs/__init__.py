"""Architecture configs the port runs, by name (``get_arch``): the LM the
serving path decodes and the four recommender archs it scores."""
from __future__ import annotations

import importlib

ARCHS = {"qwen2-1.5b": "qwen2_1_5b", "wide-deep": "wide_deep",
         "two-tower-retrieval": "two_tower_retrieval", "sasrec": "sasrec",
         "bert4rec": "bert4rec"}


def get_arch(name: str):
    mod = ARCHS.get(name.replace("_", "-"))
    if mod is None:
        raise KeyError(f"arch {name!r} is not yet ported; have "
                       f"{sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


__all__ = ["ARCHS", "get_arch"]
