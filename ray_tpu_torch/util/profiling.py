"""Stack-sampling profiler: where is this (live) process spending time?

The capability analog of the reference's py-spy integration (reference:
dashboard/modules/reporter/reporter_agent.py shells out to py-spy for
the dashboard's "Stack Trace" / "CPU Flame Graph" buttons). py-spy
reads a foreign process's interpreter state from outside; this module
samples *in-process* over ``sys._current_frames()`` instead — no
ptrace, no extra dependency — and the runtime exposes it over the
control plane (worker/agent ``profile``/``dump_stacks`` RPC handlers,
``profile_target`` on the head) so the driver can profile any live
worker or actor by id: ``ray-tpu stack <actor>``, ``ray-tpu profile
<actor>``, or the dashboard's ``/profile`` page.

Output formats:
  - folded stacks ("a;b;c 42" per line) — flamegraph.pl / speedscope
    both ingest this directly;
  - speedscope JSON (``to_speedscope``) for the interactive viewer;
  - one-shot thread dumps (``dump_stacks``) for "where is it stuck
    RIGHT NOW" — the jstack analog.

Sampling runs in whatever thread calls :func:`profile` (the RPC
handlers hop to an executor thread) and skips itself; the GIL makes a
sample a consistent snapshot of every other thread.

The port's copy of ``ray_tpu/util/profiling.py``, unchanged but for
import paths.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional

MAX_PROFILE_S = 120.0       # RPC-exposed: bound a typo'd duration
MAX_STACK_DEPTH = 128


def _thread_names() -> Dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate()
            if t.ident is not None}


def _frames_of(frame, short: bool = True) -> List[str]:
    """Root->leaf frame labels for one thread. ``short`` keeps only the
    basename of the file (folded output stays readable); the dump path
    uses full paths so a stuck frame is clickable."""
    out: List[str] = []
    f = frame
    while f is not None and len(out) < MAX_STACK_DEPTH:
        code = f.f_code
        fname = os.path.basename(code.co_filename) if short \
            else code.co_filename
        out.append(f"{code.co_name} ({fname}:{f.f_lineno})")
        f = f.f_back
    out.reverse()
    return out


def dump_stacks() -> List[dict]:
    """One-shot snapshot of every thread's current stack (the jstack
    analog). Returns [{"thread", "thread_id", "daemon", "frames"}]
    with frames ordered root->leaf."""
    names = _thread_names()
    daemons = {t.ident: t.daemon for t in threading.enumerate()
               if t.ident is not None}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append({
            "thread": names.get(tid, f"thread-{tid}"),
            "thread_id": tid,
            "daemon": bool(daemons.get(tid, False)),
            "frames": _frames_of(frame, short=False),
        })
    out.sort(key=lambda s: (s["thread"] != "MainThread", s["thread"]))
    return out


def format_stacks(stacks: List[dict]) -> str:
    """Human-readable text for a dump_stacks() payload."""
    parts = []
    for s in stacks:
        flag = " daemon" if s.get("daemon") else ""
        parts.append(f'Thread "{s["thread"]}"{flag} '
                     f'(id {s.get("thread_id")}):')
        parts.extend(f"  {fr}" for fr in s["frames"])
        parts.append("")
    return "\n".join(parts)


def profile(duration_s: float = 2.0, hz: int = 100,
            skip_threads: Optional[set] = None) -> dict:
    """Sample all threads for ``duration_s`` at ``hz`` and aggregate
    into folded stacks: {"thread:<name>;root;...;leaf": sample_count}.

    Runs in the calling thread (the RPC handlers call it from an
    executor thread so the event loop stays live) and never samples
    itself. Returns {"folded", "samples", "duration_s", "hz"}.
    """
    import math
    duration_s = float(duration_s)
    if not math.isfinite(duration_s):
        # NaN passes min/max clamps unchanged and would make the loop's
        # exit comparison permanently false — a pinned thread forever
        duration_s = 2.0
    duration_s = min(max(duration_s, 0.0), MAX_PROFILE_S)
    hz = max(1, min(int(hz), 1000))
    interval = 1.0 / hz
    skip = set(skip_threads or ())
    skip.add(threading.get_ident())
    folded: Dict[str, int] = {}
    samples = 0
    t_start = time.monotonic()
    end = t_start + duration_s
    next_tick = t_start
    while True:
        now = time.monotonic()
        if now >= end:
            break
        names = _thread_names()
        for tid, frame in sys._current_frames().items():
            if tid in skip:
                continue
            stack = _frames_of(frame, short=True)
            key = ";".join(
                [f"thread:{names.get(tid, f'thread-{tid}')}"] + stack)
            folded[key] = folded.get(key, 0) + 1
        samples += 1
        next_tick += interval
        sleep = next_tick - time.monotonic()
        if sleep > 0:
            time.sleep(sleep)
    return {"folded": folded, "samples": samples,
            "duration_s": time.monotonic() - t_start, "hz": hz}


def folded_text(result: dict) -> str:
    """flamegraph.pl-compatible folded output, heaviest stacks first."""
    items = sorted(result.get("folded", {}).items(),
                   key=lambda kv: (-kv[1], kv[0]))
    return "\n".join(f"{stack} {count}" for stack, count in items)


def to_speedscope(result: dict, name: str = "ray-tpu profile") -> dict:
    """Convert a profile() result into a speedscope-JSON document
    (https://www.speedscope.app/file-format-schema.json, "sampled"
    profile). Weights are seconds (count / hz)."""
    period = 1.0 / max(1, int(result.get("hz", 100)))
    frames: List[dict] = []
    index: Dict[str, int] = {}
    samples: List[List[int]] = []
    weights: List[float] = []
    for stack, count in sorted(result.get("folded", {}).items()):
        sample = []
        for part in stack.split(";"):
            i = index.get(part)
            if i is None:
                i = index[part] = len(frames)
                frames.append({"name": part})
            sample.append(i)
        samples.append(sample)
        weights.append(count * period)
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "ray-tpu",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "seconds",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
    }
