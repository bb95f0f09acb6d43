"""Persisted link/controller state shared across runtimes and processes.

The runtime is reconstructed per CLI invocation, while the host<->device
link and the learned lane economics stay valid across a mapping session.
This module persists the link measurement, the learned device/host share,
and lane-retirement verdicts in a small JSON file in the checkout's build/
directory (beside the XLA cache), each entry with a timestamp so stale
state expires: a retirement is honored only within its TTL; after that
the next runtime re-measures and the device lane gets another chance.

The file is written atomically (os.replace) and reads tolerate corruption
(a torn write simply looks like an empty state).  Redirect with
MM2TPU_STATE_FILE (empty string disables persistence entirely — tests use
this so parallel test processes never share link verdicts).
"""
from __future__ import annotations

import json
import os
import time

PROBE_TTL_S = float(os.environ.get("MM2TPU_PROBE_TTL_S", "300"))
RETIRE_TTL_S = float(os.environ.get("MM2TPU_RETIRE_TTL_S", "300"))


def _path() -> str | None:
    p = os.environ.get("MM2TPU_STATE_FILE")
    if p is not None:
        return p or None
    from .compile_cache import BUILD_DIR
    return os.path.join(BUILD_DIR, "link_state.json")


def load() -> dict:
    p = _path()
    if not p:
        return {}
    try:
        with open(p) as f:
            st = json.load(f)
        return st if isinstance(st, dict) else {}
    except Exception:
        return {}


def save(update: dict) -> None:
    """Merge `update` into the state file (last writer wins per key)."""
    p = _path()
    if not p:
        return
    try:
        st = load()
        st.update(update)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = f"{p}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(st, f)
        os.replace(tmp, p)
    except Exception:
        pass


def fresh(entry, ttl: float) -> bool:
    return (isinstance(entry, dict) and "t" in entry
            and (time.time() - entry["t"]) < ttl)
