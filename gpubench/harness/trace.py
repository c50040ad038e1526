"""Reading the device trace: busy time as the union of the intervals in
which a kernel, copy or set ran, in the whole calculation and inside
each host span, the idle time between them by the host span it fell in
(and the longest gaps), and device time by operation name.

`profile_calc` runs one calculation under torch.profiler with CUDA
activity only (no CPU activity: its cost is the program's host time);
a marker fill launched right after a synchronise at the start ties the
trace's clock to the host's (`time.time_ns`), in which the spans are
taken.
"""

from __future__ import annotations

import bisect
import dataclasses
import time


def union(intervals) -> list[tuple[float, float]]:
    """Merge (start, end) intervals; the result is sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_and_gaps(intervals, t0: float, t1: float):
    """The busy length of [t0, t1] under the intervals' union, and the
    idle gaps of [t0, t1] as (start, end), longest first."""
    busy, gaps, cursor = 0.0, [], t0
    for s, e in union(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        busy += e - s
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append((cursor, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return busy, gaps


def busy_within(merged, t0: float, t1: float) -> float:
    """The length of [t0, t1] under `merged`, a sorted disjoint union."""
    busy = 0.0
    for s, e in merged[max(0, bisect.bisect_right(merged, (t0,)) - 1):]:
        if s >= t1:
            break
        busy += max(0.0, min(e, t1) - max(s, t0))
    return busy


def span_at(spans, t: float, default: str = "driver") -> str:
    """The innermost (shortest) span (name, start, end) holding time t."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else default


@dataclasses.dataclass
class Profile:
    busy_s: float
    window_s: float
    device_ops: list  # [[name, seconds], ...], most time first
    idle_gaps: list  # [[name, seconds], ...]: idle time a span, then the longest gaps
    span_busy_s: dict  # span name -> device busy seconds inside its occurrences


def summarise(events, spans, t0_ns: int, t1_ns: int, top: int = 10) -> Profile:
    """events: (name, start_ns, end_ns) of device activity; spans: (name,
    start_ns, end_ns) on the host, in the same clock."""
    busy, gaps = busy_and_gaps([(s, e) for _, s, e in events], t0_ns, t1_ns)
    merged = union((s, e) for _, s, e in events)
    span_busy: dict[str, float] = {}
    for name, s, e in spans:
        span_busy[name] = span_busy.get(name, 0.0) + busy_within(merged, s, e) * 1e-9
    per_name: dict[str, float] = {}
    for name, s, e in events:
        per_name[name] = per_name.get(name, 0.0) + (e - s) * 1e-9
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    # the idle time in each span the host was in, then the longest gaps
    per_span: dict[str, float] = {}
    for s, e in gaps:
        name = span_at(spans, (s + e) / 2)
        per_span[name] = per_span.get(name, 0.0) + (e - s) * 1e-9
    named = [[f"{n} (all gaps)", v] for n, v in sorted(per_span.items(), key=lambda kv: -kv[1])]
    named = named[: top // 2]
    named += [[f"{span_at(spans, (s + e) / 2)} @{(s - t0_ns) * 1e-6:.0f}ms", (e - s) * 1e-9]
              for s, e in gaps[: top - len(named)]]
    return Profile(busy * 1e-9, (t1_ns - t0_ns) * 1e-9,
                   [[n[:120], v] for n, v in ops], named, span_busy)


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every kernel, copy and set the
    profiler saw on a CUDA device."""
    import torch

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or ev.is_user_annotation():
            continue
        start = ev.start_ns()
        out.append((ev.name(), start, start + ev.duration_ns()))
    return out


def profile_calc(run_calc, spans) -> Profile:
    """Run `run_calc()` under torch.profiler (CUDA activity); `spans` is
    the list the host span wrappers append (name, start_ns, end_ns) to
    during the run, in `time.time_ns`, each synchronised on both sides
    so that the device work launched in a span ends inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(1 << 20, device="cuda")
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        torch.cuda.synchronize()
        t_mark = time.time_ns()
        marker.fill_(1.0)
        torch.cuda.synchronize()
        t0 = time.time_ns()
        run_calc()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    finally:
        prof.stop()
    events = sorted(device_events(prof), key=lambda e: e[1])
    if not events:
        raise RuntimeError("the profiler saw no device activity")
    # the first device event is the marker: its start is t_mark plus a
    # launch's latency, so the offset maps the trace's clock onto the host's
    offset = events[0][1] - t_mark
    events = [(n, s - offset, e - offset) for n, s, e in events[1:]]
    return summarise(events, spans, t0, t1)
