"""Persistent autotune cache for the port's kernel serving path.

A copy of ``repro.service.tunecache`` with the **same JSON schema**, so a
cache file written by the JAX reference loads here unchanged and the
reference's recorded layout for an operand can be reused as is (same key,
same content signature).  Covered: matrix and graph signatures, tune
entries, the packed-slab memo, the repack ledger, hints, the
cross-process lock + merge-on-save protocol and the campaign warm start
(``warm_from_sweeps``, from a store of
:class:`repro_torch.core.campaign.SweepStore`, which reads the reference's
``BENCH_sweeps.json`` too).

Keys are ``(kernel, device, dtype, machine tag, operand signature)``:
the signature fingerprints the operand's shape, nnz and content digest,
so two operands with the same signature get the same layout without
re-measuring.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import warnings
from collections import OrderedDict
from typing import Any, Iterable, Mapping

import numpy as np

try:                                        # POSIX advisory locking
    import fcntl
except ImportError:                         # non-POSIX: locking degrades
    fcntl = None

from repro_torch.core.autotune import SellTuneResult
from repro_torch.core.jsonstore import (
    SchemaVersionError,
    atomic_write_json,
    check_schema_version,
    load_json,
)

__all__ = [
    "SCHEMA_VERSION",
    "OperandSignature",
    "SchemaVersionError",
    "TuneCache",
    "operand_signature",
]

#: Version stamp of the tune-cache document layout.  Bump on any
#: backwards-incompatible change to the entry encoding.
SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Operand signatures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OperandSignature:
    """Content fingerprint of a sparse operand.

    ``digest`` hashes the operand's actual arrays (blake2b-128), so equal
    signatures mean equal content — safe to key packed layouts on — while
    the shape/nnz fields keep the key human-readable in the JSON store.
    """

    kind: str               # csr | sell-slabs | sell | graph | graph-slabs
    n_rows: int
    n_cols: int
    nnz: int
    digest: str

    @property
    def key(self) -> str:
        return (f"{self.kind}:{self.n_rows}x{self.n_cols}"
                f":nnz{self.nnz}:{self.digest}")


def _digest(arrays: Iterable[np.ndarray]) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(a.tobytes())
    return h.hexdigest()


def machine_tag(machine) -> str:
    """Stable cache identifier of a :class:`~repro_torch.core.sdv.MachineParams`.

    The tune result depends on every machine constant, not just the name, so
    the tag is ``name-<digest of all fields>`` — two same-named variants
    (e.g. a throttled ``tpu-v5e``) can never share a cache entry.
    """
    d = dataclasses.asdict(machine)
    h = hashlib.blake2b(repr(sorted(d.items())).encode(),
                        digest_size=4).hexdigest()
    return f"{d.get('name', 'machine')}-{h}"


def operand_signature(obj: Any) -> OperandSignature:
    """Fingerprint a sparse matrix or graph operand.  Same kinds and hash
    as the reference's, so a tune key written by either package reads the
    same in the other."""
    from repro_torch.graphs.gen import EllpackGraph, SellGraphSlabs
    from repro_torch.sparse.formats import (
        CSRMatrix,
        EllpackMatrix,
        SellCSigmaMatrix,
        SellSlabs,
    )

    if isinstance(obj, CSRMatrix):
        return OperandSignature(
            "csr", obj.n_rows, obj.n_cols, obj.nnz,
            _digest((obj.indptr, obj.indices, obj.data)))
    if isinstance(obj, EllpackMatrix):
        return OperandSignature(
            "ellpack", obj.n_rows, obj.n_cols, obj.nnz,
            _digest((obj.cols, obj.vals)))
    if isinstance(obj, SellSlabs):
        return OperandSignature(
            "sell-slabs", obj.n_rows, obj.n_cols, obj.nnz,
            _digest((*obj.bucket_cols, *obj.bucket_vals, *obj.bucket_rows)))
    if isinstance(obj, SellCSigmaMatrix):
        return OperandSignature(
            "sell", obj.n_rows, obj.n_cols, obj.nnz,
            _digest((*obj.slice_cols, *obj.slice_vals, obj.perm)))
    if isinstance(obj, EllpackGraph):
        return OperandSignature(
            "graph", obj.n_nodes, obj.n_nodes, obj.n_edges,
            _digest((obj.adj,)))
    if isinstance(obj, SellGraphSlabs):
        return OperandSignature(
            "graph-slabs", obj.n_nodes, obj.n_nodes, obj.n_edges,
            _digest((*obj.bucket_adj, *obj.bucket_nodes)))
    raise TypeError(f"unsupported operand type: {type(obj).__name__}")


# ---------------------------------------------------------------------------
# Cross-process coordination
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _file_lock(path: str | None):
    """Advisory exclusive lock on ``path + '.lock'`` (fcntl flock).

    Serializes the load-merge-write critical section of :meth:`TuneCache.save`
    across worker processes sharing one cache file.  Advisory by design:
    readers of the store itself are safe without it (writes land via
    atomic rename), and on platforms without fcntl the lock degrades to a
    no-op (single-worker behavior, last writer wins).  Yields True when a
    real lock is held, False when the section runs unprotected — callers
    that care about multi-worker safety (:meth:`TuneCache._locked`) surface
    the degrade instead of hiding it.

    The lock file lives *beside the cache path* (``abspath(path) + .lock``),
    never in the CWD: a relative cache path must not scatter lock files
    across whatever directory each worker happens to run from — that both
    litters the repo root and silently breaks the mutual exclusion (two
    workers with different CWDs would lock different files).
    """
    if fcntl is None or path is None:
        yield False
        return
    with open(os.path.abspath(path) + ".lock", "a+") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield True
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


#: process-wide once-flag for the lock-degrade warning: a fleet worker on a
#: non-POSIX platform should hear about unsafe sharing once, not per save
_DEGRADE_WARNED = False


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


def _result_to_json(r: SellTuneResult) -> dict:
    return {
        "c": int(r.c), "sigma": int(r.sigma), "w_block": int(r.w_block),
        "k_block": int(r.k_block),
        "col_tile": int(r.col_tile), "row_tile": int(r.row_tile),
        "cycles": float(r.cycles), "pad_factor": float(r.pad_factor),
        "table": [[int(c), int(s), float(pf), float(cy)]
                  for c, s, pf, cy in r.table],
    }


def _result_from_json(d: Mapping) -> SellTuneResult:
    return SellTuneResult(
        c=int(d["c"]), sigma=int(d["sigma"]), w_block=int(d["w_block"]),
        # entries persisted before the multi-RHS core keep a working default
        k_block=int(d.get("k_block", 8)),
        # entries persisted before the out-of-VMEM streaming path keep the
        # dataclass's conservative streaming-tile defaults
        col_tile=int(d.get("col_tile", SellTuneResult.col_tile)),
        row_tile=int(d.get("row_tile", SellTuneResult.row_tile)),
        cycles=float(d["cycles"]), pad_factor=float(d["pad_factor"]),
        table=tuple((int(c), int(s), float(pf), float(cy))
                    for c, s, pf, cy in d["table"]),
    )


class TuneCache:
    """Schema-versioned persistence for kernel layout/tune decisions.

    Document layout (``schema_version`` gates every reader)::

        {"schema_version": 1,
         "entries": {key: {"kernel", "device", "dtype", "source",
                           "c", "sigma", "w_block", "cycles", "pad_factor",
                           "table", "hits"}},
         "hints":   {"kernel|machine": vl},
         "repacks": {key: count}}

    ``path=None`` keeps the cache in memory only (no persistence).  Loading
    a document whose ``schema_version`` this build does not support raises
    :class:`SchemaVersionError` by default — a newer tool wrote it, and
    silently discarding a tune table the user paid for is worse than
    stopping; pass ``strict=False`` to warn and start fresh instead.
    """

    def __init__(self, path: str | None = None, strict: bool = True,
                 max_packed: int = 32):
        self.path = path
        self.strict = strict
        self._entries: dict[str, dict] = {}
        self._hints: dict[str, int] = {}
        self._repacks: dict[str, int] = {}
        # keys written by THIS instance since load/save — merge-on-save may
        # only overlay these on the disk document; a key we merely loaded
        # must not revert another worker's newer value
        self._dirty_entries: set[str] = set()
        self._dirty_hints: set[str] = set()
        self._repack_delta: dict[str, int] = {}
        self._hit_delta: dict[str, int] = {}
        #: in-memory packed-layout memo (device slabs are not JSON material);
        #: LRU-bounded — slabs are O(nnz) each, and a long-running process
        #: must not retain one per operand it ever served
        self._packed: "OrderedDict[tuple, Any]" = OrderedDict()
        self.max_packed = max_packed
        self.hits = 0
        self.misses = 0
        #: critical sections that ran WITHOUT a real file lock on a cache
        #: that has a persistence path — nonzero means multi-worker sharing
        #: of this path is unsafe (last writer wins)
        self.lock_degraded = 0
        if path is not None and os.path.exists(path):
            with self._locked():
                self._load(strict)

    @contextlib.contextmanager
    def _locked(self):
        """The cache's advisory-lock critical section.

        Every persisted read-modify-write flows through here (the lint rule
        ``tunecache-lock-discipline`` enforces it).  When the platform
        cannot take a real lock the degrade is *surfaced*: counted in
        ``stats['lock_degraded']`` and warned once per process, so a
        multi-worker deployment can detect unsafe cache sharing instead of
        silently losing tunes to last-writer-wins races.
        """
        global _DEGRADE_WARNED
        with _file_lock(self.path) as held:
            if not held and self.path is not None:
                self.lock_degraded += 1
                if not _DEGRADE_WARNED:
                    _DEGRADE_WARNED = True
                    warnings.warn(
                        "fcntl is unavailable on this platform: TuneCache "
                        f"file locking for {self.path!r} is degraded to "
                        "last-writer-wins; sharing this cache path across "
                        "worker processes may lose tunes",
                        RuntimeWarning,
                        stacklevel=3,
                    )
            yield

    def _load(self, strict: bool) -> None:
        doc = load_json(self.path)
        if not check_schema_version(doc, SCHEMA_VERSION, self.path, strict):
            return
        self._entries = dict(doc.get("entries", {}))
        self._hints = {k: int(v) for k, v in doc.get("hints", {}).items()}
        self._repacks = {k: int(v) for k, v in doc.get("repacks", {}).items()}

    def _merge_from_disk(self) -> None:
        """Fold the current on-disk document in, overlaying only the keys
        THIS instance wrote since its load: a newer value another worker
        persisted for a key we merely loaded survives.  Runs inside the
        save lock so concurrent workers can't interleave between the read
        and the write.  Honors the instance's ``strict`` mode: a non-strict
        cache that warned-and-ignored a stale store at load time must stay
        able to replace it at save time, not wedge on the same document."""
        doc = load_json(self.path)
        if not check_schema_version(doc, SCHEMA_VERSION, self.path,
                                    strict=self.strict):
            return
        self._entries = {
            **self._entries,                   # stale base (keeps loaded keys
            **doc.get("entries", {}),          #  a racing writer dropped)
            **{k: self._entries[k] for k in self._dirty_entries
               if k in self._entries},
        }
        self._hints = {
            **self._hints,
            **{k: int(v) for k, v in doc.get("hints", {}).items()},
            **{k: self._hints[k] for k in self._dirty_hints
               if k in self._hints},
        }
        # repack counts are event tallies: the true total is whatever is on
        # disk plus the events THIS instance observed since its load
        disk_repacks = {k: int(v) for k, v in doc.get("repacks", {}).items()}
        for key, delta in self._repack_delta.items():
            disk_repacks[key] = disk_repacks.get(key, 0) + delta
        self._repacks = {**self._repacks, **disk_repacks}
        # per-entry hit counters are tallies too: keys this instance wrote
        # or hit get disk's count plus our delta, so concurrent workers'
        # counts accumulate instead of being reverted or reset to 0
        disk_entries = doc.get("entries", {})
        for key in self._dirty_entries | set(self._hit_delta):
            if key in self._entries:
                base = int(disk_entries.get(key, {}).get("hits", 0))
                self._entries[key] = {
                    **self._entries[key],
                    "hits": base + self._hit_delta.get(key, 0),
                }

    def save(self, merge: bool = True) -> str:
        """Persist the cache.  ``merge`` (default) folds in entries other
        workers saved since our load — under the advisory file lock, so a
        fleet of serving processes sharing one cache path can't lose each
        other's tunes to a last-writer-wins race."""
        if self.path is None:
            raise ValueError("TuneCache was created without a path")
        with self._locked():
            if merge and os.path.exists(self.path):
                self._merge_from_disk()
            doc = {
                "schema_version": SCHEMA_VERSION,
                "entries": self._entries,
                "hints": self._hints,
                "repacks": self._repacks,
            }
            out = atomic_write_json(self.path, doc)
        # everything in memory is now persisted: nothing is dirty anymore
        self._dirty_entries.clear()
        self._dirty_hints.clear()
        self._repack_delta.clear()
        self._hit_delta.clear()
        return out

    def __len__(self) -> int:
        return len(self._entries)

    # -- keys --------------------------------------------------------------
    @staticmethod
    def sell_key(kernel: str, signature: OperandSignature | Any,
                 device: str = "cpu", dtype: str = "float64",
                 machine=None, n_devices: int = 1) -> str:
        """Cache key for a SELL layout decision — the reference's spelling.

        ``signature`` may be an :class:`OperandSignature` or a raw operand
        (fingerprinted on the spot).  ``device`` names where the layout
        runs (the card's name for a GPU, ``"cpu"``), so H100 tunes never
        alias TPU or CPU tunes.  ``machine`` is the
        :class:`~repro_torch.core.sdv.MachineParams` the tune scores
        against (callers resolve their default before keying).
        ``n_devices`` joins the key when > 1 (``|dev{n}``): a sharded tune
        scores the busiest shard's rows, not the whole operand's, so
        single-device and n-device layouts never share an entry.
        """
        if not isinstance(signature, OperandSignature):
            signature = operand_signature(signature)
        mtag = machine_tag(machine) if machine is not None else "any-machine"
        key = f"{kernel}|{device}|{dtype}|{mtag}|{signature.key}"
        if int(n_devices) > 1:
            key += f"|dev{int(n_devices)}"
        return key

    # -- tune entries (the duck-typed protocol core.autotune consults) -----
    def get_sell(self, key: str) -> SellTuneResult | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        entry["hits"] = int(entry.get("hits", 0)) + 1
        self._hit_delta[key] = self._hit_delta.get(key, 0) + 1
        return _result_from_json(entry)

    def put_sell(self, key: str, result: SellTuneResult,
                 source: str = "measured") -> None:
        kernel, device, dtype, mtag = (key.split("|", 4) + [""] * 4)[:4]
        entry = _result_to_json(result)
        entry.update(kernel=kernel, device=device, dtype=dtype,
                     machine=mtag, source=source, hits=0)
        self._entries[key] = entry
        self._dirty_entries.add(key)

    # -- repack bookkeeping (ops.spmv's mismatch path) ---------------------
    def note_repack(self, key: str) -> int:
        """Record that an operand had to be repacked at serve time; the
        count persists so repeated mismatches show up in the artifact."""
        self._repacks[key] = self._repacks.get(key, 0) + 1
        self._repack_delta[key] = self._repack_delta.get(key, 0) + 1
        return self._repacks[key]

    @property
    def repacks(self) -> dict[str, int]:
        return dict(self._repacks)

    # -- packed-layout memo (in-memory only, LRU-bounded) ------------------
    def packed_get(self, key: tuple) -> Any | None:
        layout = self._packed.get(key)
        if layout is not None:
            self._packed.move_to_end(key)
        return layout

    def packed_put(self, key: tuple, layout: Any) -> None:
        self._packed[key] = layout
        self._packed.move_to_end(key)
        while len(self._packed) > self.max_packed:
            self._packed.popitem(last=False)

    # -- campaign warm-start ----------------------------------------------
    def hint_vl(self, kernel: str, machine: str) -> int | None:
        """Campaign-derived 'best VL' hint for (kernel, machine), if any."""
        return self._hints.get(f"{kernel}|{machine}")

    def set_hint(self, kernel: str, machine: str, vl: int) -> None:
        self._hints[f"{kernel}|{machine}"] = int(vl)
        self._dirty_hints.add(f"{kernel}|{machine}")

    def warm_from_sweeps(self, store) -> int:
        """Seed VL hints from campaign cubes (offline warm start).

        ``store`` is a :class:`repro_torch.core.campaign.SweepStore` or a
        path to a ``BENCH_sweeps.json`` document (written by either
        package).  For every (machine, kernel) in every stored campaign,
        the hint is the vector VL that minimizes modeled cycles at the
        campaign's most hostile latency corner — the sweep's answer to "how
        long should the vectors be on this memory system", handed to the
        serving tuner as its starting point.  Returns the number of hints
        seeded.
        """
        from repro_torch.core.campaign import SweepStore
        from repro_torch.core.vconfig import SCALAR_VL

        if not isinstance(store, SweepStore):
            # a warm start that silently seeds nothing is worse than an
            # error: a missing path (typo, campaign never run) and a
            # future-versioned document both fail loudly
            if not os.path.exists(str(store)):
                raise FileNotFoundError(
                    f"warm_from_sweeps: no campaign store at {store!r} — "
                    "run a campaign first (python -m "
                    "repro_torch.launch.campaign --campaign paper-fig3)")
            store = SweepStore(str(store), strict=True)
        seeded = 0
        for name in store.names():
            result = store.get(name)
            s = result.spec
            vec = [vi for vi, vl in enumerate(s.vls) if vl != SCALAR_VL]
            if not vec:
                continue
            li = int(np.argmax(s.latencies))         # harshest latency corner
            for mi, m in enumerate(s.machines):
                for ki, kernel in enumerate(s.kernels):
                    curve = result.cycles[mi, ki, :, li, 0]
                    best = min(vec, key=lambda vi: curve[vi])
                    self.set_hint(kernel, m.name, s.vls[best])
                    seeded += 1
        return seeded

    def candidate_vls_for(self, kernel: str, machine: str,
                          spread: int = 1) -> list[int] | None:
        """Narrowed candidate-C list around a campaign hint (pow2 spread),
        or None when no hint exists (caller falls back to the full sweep).
        The registry feeds this to ``tune_sell_layout(candidates_c=...)``,
        so a warm-started node measures a handful of pad factors instead of
        sweeping the full (C, sigma) grid."""
        hint = self.hint_vl(kernel, machine)
        if hint is None:
            return None
        return sorted({max(8, hint >> k) for k in range(spread + 1)}
                      | {hint << k for k in range(spread + 1)})

    @property
    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hints": len(self._hints),
            "repacks": sum(self._repacks.values()),
            "hits": self.hits,
            "misses": self.misses,
            "packed": len(self._packed),
            "lock_degraded": self.lock_degraded,
        }
