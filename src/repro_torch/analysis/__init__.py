"""Invariant analysis for the PyTorch port's serving engine (DESIGN.md
§Invariants & analysis) — the port's counterpart of ``repro.analysis``.

* **Static pass** — ``repro_torch.analysis.lint`` walks the AST of the
  port with the rules of ``repro_torch.analysis.rules`` (R1 sync
  discipline on torch, R3 refcount pairing, R6 warm-state pairing).  Run
  it as

      python -m repro_torch.analysis.lint src/repro_torch

  Findings suppress per line with ``# repro-lint: disable=Rn``, the
  reference linter's comment.

* **Runtime sanitizer** — ``repro_torch.analysis.sanitizer`` is the opt-in
  (``EngineConfig.sanitize=True`` / ``serve.py --sanitize``) shadow layer:
  a block-ownership ledger mirroring the ``BlockAllocator`` with a poison
  probe of device memory, a per-request lifecycle state machine on the
  scheduler, and a retrace monitor asserting the session members' input
  signatures (on the card, captured graphs) against a declared manifest.

This module deliberately imports nothing heavyweight: the linter runs on a
bare stdlib interpreter, and the sanitizer needs numpy and torch.  Import
the submodules directly.
"""

__all__ = ["lint", "rules", "sanitizer"]
