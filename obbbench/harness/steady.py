"""The steady state of a traced stream, read from the program's own spans.

In ``detect_stream`` the k-th ``detect/wait`` span (the host's wait on the
card inside ``detect/fetch``), the k-th ``detect/dispatch`` and the k-th
run of merges and fusion belong to group k. The first group is dispatched
to an empty queue (the fill) and the last group's merges run with nothing
queued (the drain), so the steady window runs from the end of the first
wait to the start of the last. Its groups are those whose dispatch starts
inside it.

A span nested in a span of the same name is folded into the span that
holds it, so each wait, dispatch and merge counts once however the
spans nest.
"""

from __future__ import annotations

from dataclasses import dataclass

WAIT = "obb/stage/detect/wait"
DISPATCH = "obb/stage/detect/dispatch"


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def intersect(xs, ys) -> list:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        s, e = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if e > s:
            out.append((s, e))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def outermost(trace, match) -> list:
    """(start, end) of the spans whose name ``match`` accepts, in time
    order, each span nested in an accepted one dropped."""
    out = []
    for s, e in sorted((s, -e) for n, s, e in trace.spans if match(n)):
        if not out or s >= out[-1][1]:
            out.append((s, -e))
    return out


@dataclass
class Steady:
    start: float
    end: float
    groups: list          # indices of the groups dispatched inside
    waits: list           # (group, seconds) of the waits wholly inside
    mpix: list            # megapixels of each group

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def group_mpix(self) -> float:
        return sum(self.mpix[k] for k in self.groups)

    def idle(self, trace) -> list:
        """Intervals of the window in which no kernel ran on the card."""
        busy = merged((max(k.start, self.start), min(k.end, self.end))
                      for k in trace.kernels
                      if k.end > self.start and k.start < self.end)
        gaps, t = [], self.start
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = e
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def idle_while(self, trace, match) -> float:
        """Seconds of the window in which the card was idle while the host
        was inside a span that ``match`` accepts, its children included."""
        return length(intersect(self.idle(trace), outermost(trace, match)))


def steady(trace, record, cell) -> Steady | None:
    """The steady window of a traced stream, or None with fewer than two
    waits or no megapixels to count."""
    waits = outermost(trace, lambda n: n == WAIT)
    if len(waits) < 2 or waits[-1][0] <= waits[0][1]:
        return None
    a, b = waits[0][1], waits[-1][0]
    chunk = max(1, cell.workload.get("params", {}).get("chunk", 1))
    sheets = record.get("mpix", [])
    mpix = [sum(sheets[i:i + chunk]) for i in range(0, len(sheets), chunk)]
    dispatches = outermost(trace, lambda n: n == DISPATCH)
    groups = [k for k, (s, _) in enumerate(dispatches)
              if a <= s < b and k < len(mpix)]
    inside = [(k, e - s) for k, (s, e) in enumerate(waits)
              if a <= s and e <= b and k < len(mpix)]
    st = Steady(a, b, groups, inside, mpix)
    return st if st.group_mpix > 0 else None
