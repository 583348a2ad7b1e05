"""Unified FFTW-style wisdom: one store for plan AND comm verdicts.

Port of ``repro.core.wisdom`` with the same on-disk schema, so a file
written by either package loads in the other.

FFTW accumulates the results of expensive MEASURE-mode planning in
*wisdom* that can be exported, re-imported, and forgotten.  We extend the
idea to the paper's second expensive choice — the communication backend
(§5.3's parcelport swing) — by sharing a single JSON store between the two
autotuners, namespaced by key prefix:

* ``plan/...`` — 1D transform plans written by
  :class:`repro_torch.core.plan.Planner` (key:
  ``plan/{n}/{kind}/b{log2-batch-bucket}/{mode}/{permuted}/{backends}/{hw}``;
  the hardware tag keeps H100 verdicts apart from any other profile's).
* ``comm/...`` — exchange-backend verdicts written by the
  :mod:`repro_torch.core.comm` autotuners (the reference's keys with the
  hardware tag appended).
* ``dfft/...`` — N-D decomposition verdicts (local vs slab vs pencil, with
  mesh-axis assignment and resolved comm specs) written by
  :func:`repro_torch.core.api.plan_nd`.

On-disk schema (one file, stable across both namespaces)::

    {"schema": "repro-wisdom", "version": 1, "entries": {key: record}}

The store is deliberately forgiving on load: a corrupt, empty, or
stale-schema file downgrades to an empty store with a ``UserWarning``
instead of crashing the planner (wisdom is a cache, never ground truth).
``export_wisdom`` / ``import_wisdom`` / ``forget_wisdom`` mirror FFTW's
``fftw_export_wisdom_to_string`` / ``fftw_import_wisdom_from_string`` /
``fftw_forget_wisdom``; exports are canonical (sorted keys) so an
export -> import -> export cycle is byte-identical.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Iterator, Optional

SCHEMA = "repro-wisdom"
VERSION = 1

PLAN_NS = "plan/"
COMM_NS = "comm/"
DFFT_NS = "dfft/"   # N-D decomposition verdicts (repro_torch.core.api.plan_nd)


class WisdomStore:
    """Dict-of-records wisdom cache with optional JSON persistence.

    ``path=None`` keeps the store purely in-process.  With a path, every
    :meth:`put` persists atomically (tmp + rename), and construction loads
    whatever valid wisdom the file holds.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[str, dict] = {}
        if path and os.path.exists(path):
            self._load(path)

    # -- persistence ---------------------------------------------------------

    def _load(self, path: str) -> None:
        try:
            with open(path) as f:
                raw = json.load(f)
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            warnings.warn(f"wisdom file {path!r} unreadable ({e}); "
                          "starting with empty wisdom")
            return
        if (not isinstance(raw, dict) or raw.get("schema") != SCHEMA
                or raw.get("version") != VERSION
                or not isinstance(raw.get("entries"), dict)):
            warnings.warn(f"wisdom file {path!r} has an unrecognized or stale "
                          f"schema (want {SCHEMA} v{VERSION}); starting with "
                          "empty wisdom")
            return
        self._entries = raw["entries"]

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            return
        # one temporary file per process: ranks sharing a wisdom file may
        # save at once, and each rename is atomic
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(self.export_wisdom())
        os.replace(tmp, path)

    # -- mapping surface -----------------------------------------------------

    def get(self, key: str) -> Optional[dict]:
        return self._entries.get(key)

    def put(self, key: str, record: dict, persist: bool = True) -> None:
        """Record ``key``; with ``persist`` False the file is left alone
        (the ranks of a mesh other than its first keep verdicts in memory
        only)."""
        self._entries[key] = record
        if persist:
            self.save()

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self, prefix: str = "") -> Iterator[str]:
        return (k for k in sorted(self._entries) if k.startswith(prefix))

    # -- FFTW-style API ------------------------------------------------------

    def export_wisdom(self) -> str:
        """Serialize to the canonical JSON text (sorted keys, so repeated
        exports of equal stores are byte-identical)."""
        return json.dumps({"schema": SCHEMA, "version": VERSION,
                           "entries": self._entries},
                          indent=1, sort_keys=True)

    def import_wisdom(self, text: str, replace: bool = False) -> int:
        """Merge (or, with ``replace``, adopt) wisdom from an exported
        string.  Returns the number of entries imported.  Unlike file
        loading, a malformed string raises — the caller asked for exactly
        this wisdom, so silence would hide a real bug."""
        raw = json.loads(text)
        if (not isinstance(raw, dict) or raw.get("schema") != SCHEMA
                or raw.get("version") != VERSION
                or not isinstance(raw.get("entries"), dict)):
            raise ValueError(
                f"not a {SCHEMA} v{VERSION} wisdom string")
        if replace:
            self._entries = {}
        self._entries.update(raw["entries"])
        self.save()
        return len(raw["entries"])

    def forget_wisdom(self, prefix: str = "") -> int:
        """Drop all entries (or just those under ``prefix``, e.g. ``comm/``).
        Returns the number forgotten."""
        if not prefix:
            n, self._entries = len(self._entries), {}
        else:
            victims = [k for k in self._entries if k.startswith(prefix)]
            for k in victims:
                del self._entries[k]
            n = len(victims)
        self.save()
        return n

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"WisdomStore(path={self.path!r}, "
                f"entries={len(self._entries)})")


def batch_bucket(batch: int) -> int:
    """log2 bucket for plan keys: batches 4..7 share bucket 2, 4096..8191
    share bucket 12.  Keeps wisdom reuse honest — a plan measured at
    batch=1 must not silently serve batch=4096."""
    return max(int(batch), 1).bit_length() - 1
