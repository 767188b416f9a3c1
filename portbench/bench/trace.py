"""A traced window: ``torch.profiler`` over a stretch of the run, reduced
to what the per-layer readers need.

- ``device_ops``: every operation the device ran (kernels, copies,
  sets), as (name, start, end) in seconds from the window's start,
  clipped to the window;
- ``linked``: every kernel a host op launched, as (kernel name,
  seconds, the names of the op and of each range and op around it);
- ``host_ops``: the host's ops, as (name, start, end), to say what the
  host was doing while the device sat idle.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

TOP = 10       # entries of each list of the result line's breakdown
WINDOW = "portbench.window"   # the range that marks the traced window


class Trace:
    def __init__(self, device_ops, linked, host_ops, window_s: float):
        self.device_ops: List[Tuple[str, float, float]] = device_ops
        self.linked: List[Tuple[str, float, Tuple[str, ...]]] = linked
        self.host_ops: List[Tuple[str, float, float]] = host_ops
        self.window_s = window_s

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations, as sorted disjoint
        intervals."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """The device's idle stretches inside the window."""
        out, t = [], 0.0
        for a, b in self.intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window_s > t:
            out.append((t, self.window_s))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host op running at ``t``."""
        best, start = "host: no op (python or waiting)", -1.0
        for name, a, b in self.host_ops:
            if a <= t <= b and a > start:
                best, start = name, a
        return best

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for name, a, b in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2)[:160], b - a]
                              for a, b in gaps]}


@contextlib.contextmanager
def capture(ranges: Sequence[str] = ()):
    """Profile the body; yields a holder whose ``trace`` is set on exit.
    ``ranges`` are the names of ``record_function`` ranges the body opens:
    their mirrors on the device timeline are not device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    holder = type("Holder", (), {"trace": None})()
    prof = profile(activities=acts)
    t0 = time.perf_counter()
    with prof:
        if torch.cuda.is_available():
            # the profiler's first kernel pays its set-up: before the window
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            yield holder
    window = time.perf_counter() - t0
    events = prof.events()
    marks = [e for e in events
             if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if marks:
        origin = marks[0].time_range.start
        window = (marks[0].time_range.end - origin)
        window /= 1e6
    else:
        starts = [e.time_range.start for e in events]
        origin = min(starts) if starts else 0.0
    skip = set(ranges) | {WINDOW}
    device_ops, host_ops, linked = [], [], []
    for e in events:
        a = (e.time_range.start - origin) / 1e6
        b = (e.time_range.end - origin) / 1e6
        if e.device_type == DeviceType.CUDA:
            if e.name in skip:
                continue
            a, b = max(a, 0.0), min(b, window)
            if b > a:
                device_ops.append((e.name, a, b))
        elif e.device_type == DeviceType.CPU and e.name != WINDOW:
            host_ops.append((e.name, a, b))
            if e.kernels:
                chain, p = [], e
                while p is not None:
                    chain.append(p.name)
                    p = p.cpu_parent
                for k in e.kernels:
                    linked.append((k.name, k.duration / 1e6, tuple(chain)))
    holder.trace = Trace(device_ops, linked, host_ops, window)
    holder.reduce_s = time.perf_counter() - t0 - window


class NothingToRead(LookupError):
    """A layer's kernels or range that the traced window does not hold:
    the run fails with the layer's name, never reads 0 or a part."""


def matched(trace: Trace, entries: List[dict], set_name: str
            ) -> List[Tuple[dict, List[Tuple[str, float, float]]]]:
    """Each entry of kernel set ``set_name`` with the device operations
    whose name holds its ``match``; raises when the set has no entry or
    an entry matches nothing, so that a renamed or hidden kernel fails
    the run instead of leaving the set's share to the rest."""
    if not entries:
        raise NothingToRead(f"kernel set {set_name!r} has no entry")
    out = []
    for entry in entries:
        ops = [op for op in trace.device_ops if entry["match"] in op[0]]
        if not ops:
            raise NothingToRead(
                f"kernel set {set_name!r}: entry {entry['match']!r} matches "
                "no device operation in the traced window")
        out.append((entry, ops))
    return out


def in_range(trace: Trace, name: str) -> float:
    """Seconds of the kernels launched inside range ``name``; raises when
    none was."""
    found = [d for _, d, chain in trace.linked if name in chain]
    if not found:
        raise NothingToRead(f"range {name!r} launched no kernel in the "
                            "traced window")
    return sum(found)
