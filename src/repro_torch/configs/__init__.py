"""Architecture configs the port runs, by name (``get_arch``): the dense
and MoE LMs the serving path decodes, the four recommender archs it scores
and the GNN (EquiformerV2) it trains.  An arch of the reference that the
port lacks would raise, naming the ROADMAP item that ports it
(``NOT_YET_PORTED``; empty now)."""
from __future__ import annotations

import importlib

ARCHS = {"qwen2-1.5b": "qwen2_1_5b", "antglm-10b": "antglm_10b",
         "phi3-mini-3.8b": "phi3_mini_3_8b",
         "phi3-medium-14b": "phi3_medium_14b",
         "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
         "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
         "wide-deep": "wide_deep",
         "two-tower-retrieval": "two_tower_retrieval", "sasrec": "sasrec",
         "bert4rec": "bert4rec", "equiformer-v2": "equiformer_v2"}
NOT_YET_PORTED: dict = {}


def get_arch(name: str):
    key = name.replace("_", "-")
    mod = ARCHS.get(key)
    if mod is None:
        item = NOT_YET_PORTED.get(key)
        raise KeyError(f"arch {name!r} is not yet ported"
                       + (f" (ROADMAP {item})" if item else "")
                       + f"; have {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


__all__ = ["ARCHS", "get_arch"]
