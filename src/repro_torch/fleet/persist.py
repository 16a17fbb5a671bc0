"""Warm draft-state persistence (DESIGN.md §Fleet serving).

Serializes the *host-side* statistics that make a replica fast — trie
forests (per-namespace node arrays + frequencies), n-gram backoff tables,
and the hottest prefix-cache token keys — into one versioned, checksummed
JSON document.  Device state (KV blocks) is deliberately absent: it cannot
survive a restart, and a warm replica re-prefills the persisted prefix keys
once instead of trusting foreign KV bytes.

File format (version 1)::

    {"format": "repro-draft-state", "version": 1,
     "checksum": "<sha256 of the canonical payload JSON>",
     "payload": {"sources": {"trie": {...}, "ngram": {...}},
                 "prefix": {"<namespace>": [[tok, ...], ...]}}}

Writes are atomic (temp file + ``os.replace``) so a reader can never see a
torn file; the checksum rejects silent corruption, the version field
rejects format drift — both raise ``DraftStateError`` instead of loading
garbage statistics into a serving engine.

Losslessness: everything here only changes what the engine *proposes*; the
device verifier guarantees outputs (I1), so a corrupt-but-undetected state
file could cost speed, never correctness.  The checks protect performance
and determinism, not safety.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

from repro_torch.core.draft_sources import make_source

STATE_FORMAT = "repro-draft-state"
STATE_VERSION = 1


class DraftStateError(RuntimeError):
    """A warm-state file is unreadable, corrupt, or version-mismatched."""


def _canonical(payload: Dict[str, object]) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def _checksum(payload: Dict[str, object]) -> str:
    return hashlib.sha256(_canonical(payload).encode("utf-8")).hexdigest()


# ------------------------------------------------------------------- collect
def collect_draft_state(scheduler, *,
                        max_prefix_keys: Optional[int] = 64
                        ) -> Dict[str, object]:
    """Snapshot a scheduler's shared draft state into a plain-data payload.

    Sources with nothing to persist (``state_dict() == {}``) are skipped so
    a stateless source's name never collides with a donor's stateful one.
    """
    sources: Dict[str, object] = {}
    for name, src in scheduler.sources.items():
        state = src.state_dict()
        if state:
            sources[name] = state
    payload: Dict[str, object] = {"sources": sources}
    if scheduler.prefix is not None:
        prefix = scheduler.prefix.hot_keys(max_prefix_keys)
        if prefix:
            payload["prefix"] = prefix
    return payload


# ------------------------------------------------------------------- install
def _validate_payload(payload) -> Dict[str, object]:
    if not isinstance(payload, dict):
        raise DraftStateError("draft-state payload is not a dict")
    sources = payload.get("sources", {})
    if not isinstance(sources, dict):
        raise DraftStateError("draft-state 'sources' is not a dict")
    prefix = payload.get("prefix", {})
    if not isinstance(prefix, dict):
        raise DraftStateError("draft-state 'prefix' is not a dict")
    return payload


def install_draft_state(scheduler, payload: Dict[str, object], *,
                        merge: bool = False) -> None:
    """Load (or gossip-merge) a payload into a scheduler's draft sources.

    Source instances named by the payload are created through the registry
    if the scheduler has not touched them yet — an n-gram table loads even
    before the first n-gram request arrives.  Unknown source names and
    per-source shape errors raise ``DraftStateError`` (a clean reject, the
    engine's state untouched by the failing entry).
    """
    payload = _validate_payload(payload)
    for name, state in payload.get("sources", {}).items():
        src = scheduler.sources.get(name)
        if src is None:
            try:
                src = make_source(name, scheduler.config)
            except KeyError as e:
                raise DraftStateError(
                    f"draft-state names unknown source {name!r}: {e}"
                ) from e
            scheduler.sources[name] = src
        try:
            if merge:
                src.merge_state(state)
            else:
                src.load_state_dict(state)
        except ValueError as e:
            raise DraftStateError(
                f"draft-state for source {name!r} is malformed: {e}") from e


# ----------------------------------------------------------------- file I/O
def save_draft_state(path: str, payload: Dict[str, object]) -> None:
    """Atomically write ``payload`` as a versioned, checksummed document."""
    doc = {"format": STATE_FORMAT, "version": STATE_VERSION,
           "checksum": _checksum(payload), "payload": payload}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_draft_state(path: str) -> Dict[str, object]:
    """Read + verify a state file; returns its payload.

    Raises ``DraftStateError`` on unparsable JSON, a foreign format tag, a
    version this reader does not speak, or a checksum mismatch (bit rot /
    truncation / hand edits).
    """
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise DraftStateError(f"cannot read draft state {path!r}: {e}") from e
    if not isinstance(doc, dict) or doc.get("format") != STATE_FORMAT:
        raise DraftStateError(f"{path!r} is not a {STATE_FORMAT} file")
    version = doc.get("version")
    if version != STATE_VERSION:
        raise DraftStateError(
            f"{path!r} is draft-state version {version!r}; this reader "
            f"speaks version {STATE_VERSION}")
    payload = _validate_payload(doc.get("payload"))
    if doc.get("checksum") != _checksum(payload):
        raise DraftStateError(f"{path!r} failed its checksum (corrupt or "
                              "hand-edited)")
    return payload


__all__ = ["DraftStateError", "STATE_FORMAT", "STATE_VERSION",
           "collect_draft_state", "install_draft_state", "save_draft_state",
           "load_draft_state"]
