"""Continuous batcher: fixed decode slots, fill-on-finish request scheduling
— port of ``repro.serve.batcher``.

The engine decodes a fixed-width batch; the batcher multiplexes a request
queue onto those slots.  When a sequence finishes its slot is refilled by
prefilling the next queued prompt alone (a b = 1 prefill: kernel B9 for
its tokens, and for mamba2 and hymba kernel B8 for a chunk-multiple
prompt) and writing that prefill's caches into the slot's batch row.  As
in the reference, a request carries no ``ctx_embeds``: vision and enc-dec
requests decode against the zero context (``"ctx"`` / ``"memory"``) of the
caches.  The admission/eviction loop
is :class:`repro_torch.serve.slots.SlotLoop`, the core the kernel service
batches on.

The reference's ``_splice_caches`` (``batcher.py:109``) guesses the batch
axis of each cache leaf from its shape, which is ambiguous when
``n_layers`` or ``n_slots`` is 1; the port writes the batch row of each
cache field by name (:func:`_write_slot`), in place: the shared caches
belong to the batcher alone.  A KV cache's ``pos`` and ``length`` have no
batch axis: all slots share them, in the reference as here, and the
admitted prefill's replace them.  So attention caches are right only for
prompts of equal length admitted in aligned waves (the reference's
``_splice_caches`` says so too); per-slot lengths would be a feature the
reference lacks.  Where the reference would silently re-position the
live slots' keys, the batcher refuses: it keeps the shared length on the
host and raises :class:`ValueError` at an admission that would change it
while another slot is still decoding.

**On a mesh** (``mesh=``, the parameters placed on it; every family) the
shared caches are placed by :func:`repro_torch.launch.specs.cache_shardings`:
the slots split over the data replicas where their count divides them.  An
admission's b = 1 prefill runs on the one data replica that owns the slot
(``replica=`` of :func:`repro_torch.models.model.prefill`), and
:func:`_write_slot` writes each piece of its caches into the shared piece
on the same device (a KV piece that holds a share of the ring's slots,
``KV_SEQ_SHARD``, takes the same rows of that share); each decode step
runs every replica on its slots.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models import sharding as shrd
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import GenerationConfig
from repro_torch.serve.slots import SlotLoop

__all__ = ["Batcher", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    generated: list[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


def _write_slot(shared: M.Caches, single: M.Caches, slot: int) -> None:
    """Write the b = 1 caches into batch row ``slot`` of the shared ones,
    each entry by name: the layer stacks (``"layers"`` and, with a dense
    first layer, ``"dense0"``) field by field, and the vision / enc-dec
    context (``"ctx"`` / ``"memory"``, (B, T, d)) on axis 0.  The SSM
    leaves are (layers, batch, ...); a KV cache's k / v are (*lead, batch,
    C, Hkv, dh) with ``lead = pos.shape[:-1]`` ((layers,), or vision's
    (groups, every)), so their batch axis is ``pos.dim() - 1``.  A KV
    cache's pos (*lead, C) and length (*lead) are shared by every slot and
    copied from the prefill, as the reference's splice does.  Placed caches
    (a mesh) are written piece by piece, each on its device:
    :func:`_write_slot_placed`."""
    for name, dst in shared.items():
        src = single[name]
        if isinstance(dst, torch.Tensor):
            dst[slot] = src[0]
            continue
        if dst.ssm is not None:
            dst.ssm.state[:, slot] = src.ssm.state[:, 0]
            dst.ssm.conv[:, slot] = src.ssm.conv[:, 0]
        if dst.kv is not None:
            axis = dst.kv.pos.dim() - 1
            dst.kv.k.select(axis, slot).copy_(src.kv.k.select(axis, 0))
            dst.kv.v.select(axis, slot).copy_(src.kv.v.select(axis, 0))
            dst.kv.pos.copy_(src.kv.pos)
            dst.kv.length.copy_(src.kv.length)


def _write_slot_placed(shared: M.Caches, single: M.Caches, slot: int) -> None:
    """:func:`_write_slot` for caches placed on a mesh.  Every device's
    b = 1 piece goes into its shared piece on the same device: a batch leaf
    (a KV cache's k / v on axis ``pos.dim() - 1``, an SSM state's state /
    conv ring on axis 1, the vision / enc-dec context on axis 0) where it
    splits the batch over the data replicas, into the replica that owns
    ``slot`` at its local row; where it replicates the batch, into every
    replica.  ``pos`` and ``length`` are copied to every piece (cut from
    the whole where the two specs differ)."""
    for name, dst in shared.items():
        src = single[name]
        if isinstance(dst, shrd.Sharded):
            _write_leaf(dst, src, slot, 0)
            continue
        for cache, one in ((dst.kv, src.kv), (dst.ssm, src.ssm)):
            if cache is None:
                continue
            for field, d, s in zip(cache._fields, cache, one):
                _write_leaf(d, s, slot, M.cache_batch_axis(cache, field))


def _write_leaf(dst: shrd.Sharded, src: shrd.Sharded, slot: int,
                axis: int | None) -> None:
    """Row 0 of the b = 1 leaf ``src`` into row ``slot`` of ``dst`` along
    its batch ``axis``, piece by piece; a shared field (``axis`` None)
    copied whole."""
    for coord in np.ndindex(dst.pieces.shape):
        piece = dst.pieces[coord]
        if axis is None:
            if src.spec == dst.spec:
                piece.copy_(src.pieces[coord])
            else:
                piece.copy_(src.full(piece.device)[dst.region(coord)])
            continue
        idx, n = dst.block(coord, axis)
        local = dst.shape[axis] // n
        if idx * local <= slot < (idx + 1) * local:
            piece.select(axis, slot - idx * local).copy_(
                src.pieces[coord].select(axis, 0))


class Batcher(SlotLoop[Request]):
    """Slot-multiplexed decode over a fixed batch width."""

    def __init__(self, cfg: ModelConfig, params: M.LM, n_slots: int = 4,
                 gcfg: GenerationConfig | None = None, mesh=None):
        super().__init__(n_slots)
        self.cfg = cfg
        self.params = params
        self.gcfg = gcfg or GenerationConfig()
        self.mesh = M.params_mesh(params, cfg, mesh)
        self.caches = M.init_caches(cfg, n_slots, max_len=self.gcfg.cache_len,
                                    dtype=self.gcfg.dtype, device=params.device,
                                    mesh=self.mesh)
        self._next_tok = np.zeros((n_slots,), np.int32)
        #: The KV caches' shared length as the host knows it: the last
        #: admitted prompt's length plus the decode steps since.
        self._kv_len = 0

    # -- SlotLoop hooks ----------------------------------------------------
    def done(self, req: Request) -> bool:
        return req.done

    def admit(self, slot: int, req: Request) -> None:
        """Prefill the admitted prompt alone and write its caches into the
        slot's row.  With KV caches, a prompt whose length is not the
        shared one is refused while another slot is decoding (its keys
        would move); the request goes back to the head of the queue."""
        s = int(np.asarray(req.prompt).shape[-1])
        if self.caches["layers"].kv is not None and s != self._kv_len and any(
                r is not None and not r.done
                for j, r in enumerate(self.slots) if j != slot):
            self.slots[slot] = None
            self.queue.appendleft(req)
            raise ValueError(
                f"request {req.rid}: a {s}-token prompt would move the "
                f"shared KV length ({self._kv_len}) under the slots still "
                "decoding; attention caches take equal prompt lengths in "
                "aligned waves (the reference's splice)")
        one = M.init_caches(self.cfg, 1, max_len=self.gcfg.cache_len,
                            dtype=self.gcfg.dtype, device=self.params.device,
                            mesh=self.mesh)
        logits, one = M.prefill(self.params, self.cfg,
                                {"tokens": np.asarray(req.prompt)[None]}, one,
                                dtype=self.gcfg.dtype, mesh=self.mesh,
                                replica=self._owner(slot))
        if self.mesh is None:
            _write_slot(self.caches, one, slot)
        else:
            _write_slot_placed(self.caches, one, slot)
        self._kv_len = s
        tok = int(torch.argmax(logits[0, -1]))
        req.generated.append(tok)
        self._next_tok[slot] = tok

    def _owner(self, slot: int) -> int:
        """The data replica whose batch rows hold ``slot`` (0 where the
        replicas do not divide the slots: every replica holds them all)."""
        if self.mesh is None:
            return 0
        n = len(shrd.rows(self.mesh))
        return slot // (self.n_slots // n) if self.n_slots % n == 0 else 0

    def execute(self, active: Sequence[tuple[int, Request]]) -> None:
        """One decode step across all slots (idle ones included, as in the
        reference)."""
        logits, self.caches = M.decode_step(
            self.params, self.cfg, self._next_tok[:, None], self.caches,
            dtype=self.gcfg.dtype, mesh=self.mesh)
        self._kv_len += 1
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for i, req in active:
            if not req.done:
                req.generated.append(int(nxt[i]))
                self._next_tok[i] = nxt[i]
