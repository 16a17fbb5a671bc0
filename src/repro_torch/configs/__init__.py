"""Architecture configs the port serves, by name (``get_arch``)."""
from __future__ import annotations

import importlib

ARCHS = {"qwen2-1.5b": "qwen2_1_5b"}


def get_arch(name: str):
    mod = ARCHS.get(name)
    if mod is None:
        raise KeyError(f"arch {name!r} is not yet ported; have "
                       f"{sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


__all__ = ["ARCHS", "get_arch"]
