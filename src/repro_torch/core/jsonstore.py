"""Shared plumbing for the schema-versioned JSON stores.

A copy of ``repro.core.jsonstore``, so the port reads and writes the
same documents.  The reference has two schema-versioned stores (the
campaign cube store and the serving tune cache); the port has the tune
cache (:class:`repro_torch.service.tunecache.TuneCache`).  Each store
stamps a ``schema_version`` into the document and gates every reader on it;
this module holds the one definition of that gate, i.e. what a version
mismatch means:

* ``strict=True``  — raise :class:`SchemaVersionError` with a message naming
  the path and both versions (a future-versioned document was written by a
  newer tool; silently discarding it would throw away data the user paid
  for).
* ``strict=False`` — warn and tell the caller to start fresh (a
  regenerable artifact must never wedge the writer that is about to
  replace it).
"""
from __future__ import annotations

import json
import os
import warnings


class SchemaVersionError(RuntimeError):
    """A persisted store's ``schema_version`` is not supported by this code."""


def check_schema_version(
    doc: dict, supported: int, path: str, strict: bool = True
) -> bool:
    """Validate ``doc["schema_version"]`` against ``supported``.

    Returns True when the document is readable.  On mismatch: raises
    :class:`SchemaVersionError` when ``strict``, else warns and returns
    False (caller starts with an empty store).
    """
    version = doc.get("schema_version")
    if version == supported:
        return True
    msg = (
        f"{path}: schema_version {version!r} is not supported by this "
        f"build (supports {supported})"
    )
    if strict:
        hint = (
            " — the file was written by a newer version; upgrade, or pass "
            "strict=False to discard it"
            if isinstance(version, int) and version > supported
            else " — regenerate the store or pass strict=False to discard it"
        )
        raise SchemaVersionError(msg + hint)
    warnings.warn(
        msg + "; ignoring the stale store (it will be replaced on the next "
        "save)",
        RuntimeWarning,
        stacklevel=3,
    )
    return False


def atomic_write_json(path: str, doc: dict, indent: int = 1) -> str:
    """Write ``doc`` to ``path`` via a same-directory temp file + rename."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=indent, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
