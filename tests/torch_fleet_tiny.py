"""Tiny-model engine builder of the PyTorch port for fleet tests (the twin
of ``fleet_tiny.py``).

Lives outside test_torch_fleet.py so a spawned subprocess replica can
import the builder without dragging in the test module (whose hypothesis
import is satisfied by a conftest shim that only exists in the pytest
parent).  ``device`` is the port's: None means the card and raises without
one; the CPU tests pass ``"cpu"``.  ``CARD_CFG`` widens the heads to 16, the
narrowest the CUDA kernels take.
"""
import dataclasses

from repro_torch.models.params import init_params
from repro_torch.models.transformer import TransformerConfig
from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                     build_session_fns)

TINY_CFG = TransformerConfig(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                             d_ff=64, vocab_size=53, max_seq_len=160)
CARD_CFG = dataclasses.replace(TINY_CFG, d_model=64)
TINY_ECFG = EngineConfig(lanes=2, prefill_len=32, decoding_length=8,
                         branch_length=4)


def build_tiny(device=None, cfg=TINY_CFG) -> ServingEngine:
    params = init_params(cfg, seed=11, device=device)
    return ServingEngine(build_session_fns(TINY_ECFG, cfg, params,
                                           device=device), TINY_ECFG)
