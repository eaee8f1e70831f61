"""Request tracing: spans, ring buffer, JSONL + Chrome-trace exporters.

A copy of ``repro.obs.trace``.

A :class:`Span` is one timed stage of one request's life (``request`` →
``preflight`` / ``queued`` / ``execute``) or one batched launch.  Spans
form trees through ``parent_id`` and fan *in* through ``links``: a
coalesced launch span links the root spans of every request it serves, so
one batched core call is queryable from any of its N requests and vice
versa.  ``trace_id`` names the tree (the root span's id), which is what
the completeness invariant counts: every submitted request — including
rejected and failed ones — must retire exactly one closed root span.

Closed spans land in a bounded ring buffer (a long-running server must
not grow one span per request forever); ``dropped`` counts evictions so
an exporter can state its own truncation.  Two export formats:

* :meth:`Tracer.export_jsonl` — one span per line, the
  ``scripts/obs_report.py`` dashboard input;
* :meth:`Tracer.export_chrome` — Chrome trace-event JSON, loadable in
  Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``; each
  request tree renders as its own track.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
from collections import deque

from repro_torch.obs import timer

__all__ = ["Span", "Tracer"]


@dataclasses.dataclass(slots=True)
class Span:
    """One timed stage.  ``end_us is None`` means still open."""

    span_id: int
    name: str
    trace_id: int
    parent_id: int | None = None
    start_us: float = 0.0
    end_us: float | None = None
    status: str = "ok"              # ok | error | rejected
    attrs: dict = dataclasses.field(default_factory=dict)
    links: tuple[int, ...] = ()     # fan-in: span ids this span aggregates

    @property
    def open(self) -> bool:
        return self.end_us is None

    @property
    def duration_us(self) -> float:
        return 0.0 if self.end_us is None else self.end_us - self.start_us

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_us": round(self.start_us, 1),
            "end_us": None if self.end_us is None else round(self.end_us, 1),
            "duration_us": round(self.duration_us, 1),
            "status": self.status,
            "attrs": self.attrs,
            "links": list(self.links),
        }


class Tracer:
    """Span factory + bounded buffer of closed spans.

    ``start``/``end`` are the hot-path API (a dict insert and a clock read
    each); the context-manager :meth:`span` is for code with one obvious
    scope.  ``end`` is idempotent — closing a span twice keeps the first
    verdict, so retire paths can close defensively without double-count.
    """

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ids = itertools.count(1)
        self._open: dict[int, Span] = {}
        self._closed: deque[Span] = deque(maxlen=capacity)
        self.dropped = 0            # closed spans evicted by the ring bound

    # -- lifecycle ---------------------------------------------------------
    def start(self, name: str, parent: Span | None = None,
              links=(), **attrs) -> Span:
        sid = next(self._ids)
        span = Span(
            span_id=sid,
            name=name,
            trace_id=parent.trace_id if parent is not None else sid,
            parent_id=parent.span_id if parent is not None else None,
            start_us=timer.now_us(),
            attrs=attrs,
            links=tuple(l.span_id if isinstance(l, Span) else int(l)
                        for l in links) if links else (),
        )
        self._open[sid] = span
        return span

    def end(self, span: Span | None, status: str = "ok", **attrs) -> None:
        if span is None or span.end_us is not None:
            return
        span.end_us = timer.now_us()
        span.status = status
        if attrs:
            span.attrs.update(attrs)
        self._open.pop(span.span_id, None)
        if len(self._closed) == self.capacity:
            self.dropped += 1
        self._closed.append(span)

    @contextlib.contextmanager
    def span(self, name: str, parent: Span | None = None, **attrs):
        s = self.start(name, parent=parent, **attrs)
        try:
            yield s
        except BaseException:
            self.end(s, status="error")
            raise
        self.end(s)

    # -- queries -----------------------------------------------------------
    @property
    def open_count(self) -> int:
        return len(self._open)

    def open_spans(self) -> list[Span]:
        return list(self._open.values())

    def spans(self) -> list[Span]:
        """Closed spans currently in the ring, oldest first."""
        return list(self._closed)

    def closed_roots(self, name: str | None = None) -> list[Span]:
        """Closed parentless spans, optionally filtered by name.  The trace
        completeness invariant counts ``closed_roots("request")`` — launch
        spans are also roots (they fan in N request trees, so no single
        parent is right) and must not inflate the request count."""
        return [s for s in self._closed
                if s.parent_id is None and (name is None or s.name == name)]

    def children(self, span: Span) -> list[Span]:
        return [s for s in self._closed if s.parent_id == span.span_id]

    def reset(self) -> None:
        self._open.clear()
        self._closed.clear()
        self.dropped = 0

    # -- exporters ---------------------------------------------------------
    def export_jsonl(self, path_or_file, include_open: bool = True) -> int:
        """One span per line (closed spans, then still-open ones flagged
        ``"open": true`` so the dashboard can count orphans).  Returns the
        number of spans written."""

        def _write(fh) -> int:
            n = 0
            for span in self._closed:
                fh.write(json.dumps(span.to_dict()) + "\n")
                n += 1
            if include_open:
                for span in self._open.values():
                    doc = span.to_dict()
                    doc["open"] = True
                    fh.write(json.dumps(doc) + "\n")
                    n += 1
            return n

        if hasattr(path_or_file, "write"):
            return _write(path_or_file)
        with open(path_or_file, "w", encoding="utf-8") as fh:
            return _write(fh)

    def export_chrome(self, path_or_file) -> int:
        """Chrome trace-event JSON (Perfetto-loadable).

        Closed spans become complete ("X") events with the request tree as
        the track (tid = trace_id); fan-in links become flow events ("s"
        arrow from each linked root into the launch span) so Perfetto
        draws the N-requests-into-one-launch arrows.  Returns the event
        count.
        """
        events = []
        by_id = {s.span_id: s for s in self._closed}
        for span in self._closed:
            events.append({
                "name": span.name,
                "ph": "X",
                "ts": span.start_us,
                "dur": span.duration_us,
                "pid": 0,
                "tid": span.trace_id,
                "args": {**span.attrs, "status": span.status,
                         "span_id": span.span_id},
            })
            for link in span.links:
                src = by_id.get(link)
                if src is None:
                    continue
                flow = {"cat": "fanin", "id": span.span_id * 100000 + link,
                        "pid": 0}
                events.append({**flow, "name": "fanin", "ph": "s",
                               "ts": src.start_us, "tid": src.trace_id})
                events.append({**flow, "name": "fanin", "ph": "f", "bp": "e",
                               "ts": span.start_us, "tid": span.trace_id})
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if hasattr(path_or_file, "write"):
            json.dump(doc, path_or_file)
        else:
            with open(path_or_file, "w", encoding="utf-8") as fh:
                json.dump(doc, fh)
        return len(events)
