"""The one memo of what the port derives from a packed operand.

Packed operands (SELL slabs, ELLPACK matrices and the sharded layouts of
:mod:`repro_torch.sparse.formats` and :mod:`repro_torch.graphs.gen`) are
immutable, so each is bounds-scanned, hashed and uploaded to a device
once, however often and by whichever path it is called: :mod:`ops` and
the sharded drives of :mod:`sell_shard` read and fill the same entry, so
an operand that both run sits on a device once.  An entry is keyed by the
object's id and dies with the object.

Keys of an entry: a ``torch.device`` holds the whole operand's tensors
there (:func:`on_device`), ``(shard, device)`` one shard's of a sharded
layout; :mod:`ops` keeps beside them its ``"meta"`` (the bounds-scanned
:class:`~repro_torch.analysis.SlabMeta`), ``"signature"`` (the content
hash a mesh's layouts are cached under), an ELLPACK matrix's ``"live"``
widths and kernel B2's column maps.
"""
from __future__ import annotations

import weakref

import torch

__all__ = ["ENTRIES", "entry", "on_device"]

#: id(operand) -> its entry (see the module docstring)
ENTRIES: dict[int, dict] = {}


def entry(obj) -> dict:
    """``obj``'s entry, made empty at the first ask."""
    e = ENTRIES.get(id(obj))
    if e is None:
        e = ENTRIES[id(obj)] = {}
        weakref.finalize(obj, ENTRIES.pop, id(obj), None)
    return e


def on_device(layout, device: torch.device, shard: int | None = None):
    """``layout``'s tensors on ``device``, uploaded at the first ask: the
    whole operand (``layout.to_device``; ``shard=None``) or shard ``shard``
    of a sharded layout (``layout.shard_to_device``)."""
    e = entry(layout)
    key = device if shard is None else (shard, device)
    if key not in e:
        e[key] = (layout.to_device(device) if shard is None
                  else layout.shard_to_device(shard, device))
    return e[key]
