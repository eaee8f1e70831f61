"""Slot-based admission/coalescing loop — the one batching core.

A copy of ``repro.serve.slots``; in the port only the kernel service
subclasses it so far (the LM batcher is ROADMAP A12).

Both serving engines in this repo multiplex a request queue onto a fixed
number of slots: the LM batcher (``repro.serve.batcher.Batcher``) fills
decode slots with prompts, the sparse-kernel service
(:class:`repro_torch.service.service.KernelService`) fills them with kernel calls
against registered operands.  The admission loop — evict finished requests,
admit queued ones into free slots, execute one step over whatever is active —
is identical, so it lives here once and the two engines subclass it with
their domain-specific ``admit`` / ``execute`` / ``done`` hooks.

The loop is deliberately synchronous and single-threaded: ``submit`` only
enqueues (the async edge of the API), and ``step``/``run``/``drain`` advance
the world.  That keeps the engines deterministic and testable while matching
the production shape (one scheduler thread feeding a device executor).
"""
from __future__ import annotations

from collections import deque
from typing import Generic, Sequence, TypeVar

R = TypeVar("R")


class SlotLoop(Generic[R]):
    """Fixed-width slot multiplexer: queue -> slots -> step -> evict.

    Subclasses implement:

    * ``done(request)``           — is this request finished?
    * ``execute(active)``         — one step over the ``(slot, request)``
      pairs currently occupying slots (the coalescing point: a subclass may
      group them however its kernels batch best).
    * ``admit(slot, request)``    — optional per-admission work (e.g. the LM
      batcher's prefill-and-splice); default no-op.
    * ``retire(request)``         — optional hook when a finished request
      leaves its slot; default no-op.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.queue: deque[R] = deque()
        self.slots: list[R | None] = [None] * n_slots
        self.completed: list[R] = []

    # -- hooks -------------------------------------------------------------
    def done(self, request: R) -> bool:
        raise NotImplementedError

    def execute(self, active: Sequence[tuple[int, R]]) -> None:
        raise NotImplementedError

    def admit(self, slot: int, request: R) -> None:
        pass

    def retire(self, request: R) -> None:
        pass

    def observe_step(self, queued: int, in_flight: int) -> None:
        """Optional per-round observation point, called once per ``step``
        after admission with the post-admission queue depth and the number
        of occupied slots.  Default no-op; the kernel service publishes
        these as gauges (:mod:`repro_torch.obs`)."""

    # -- the loop ----------------------------------------------------------
    def submit(self, request: R) -> None:
        self.queue.append(request)

    @property
    def pending(self) -> int:
        """Requests not yet completed (queued + in slots)."""
        return len(self.queue) + sum(r is not None for r in self.slots)

    def active(self) -> list[tuple[int, R]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def _evict_done(self) -> None:
        for i, req in enumerate(self.slots):
            if req is not None and self.done(req):
                self.retire(req)
                self.completed.append(req)
                self.slots[i] = None

    def _fill_slots(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = req
                self.admit(i, req)

    def step(self) -> bool:
        """One scheduling round: evict, admit, execute.  False = idle."""
        self._evict_done()
        self._fill_slots()
        act = self.active()
        self.observe_step(len(self.queue), len(act))
        if not act:
            return False
        self.execute(act)
        return True

    def run(self, max_steps: int = 10_000) -> list[R]:
        """Drive the loop until the queue and all slots drain."""
        steps = 0
        while (self.queue or any(r is not None for r in self.slots)) \
                and steps < max_steps:
            if not self.step():
                break
            steps += 1
        self._evict_done()
        return self.completed
