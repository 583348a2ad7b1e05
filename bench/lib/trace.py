"""Reduce a ``torch.profiler`` trace of the card to what the per-layer
readers take: device time by kernel name, the union of device activity
(busy seconds), the traced window, and the longest idle gaps by what the
host was doing.

A reduced trace is a plain dict, so readers can be tested on canned
tables:

    {"kernels": [[name, seconds, count], ...],   # longest first
     "busy_s": float, "window_s": float,
     "idle_gaps": [[host op, seconds], ...],      # longest first
     "steps": int, ...}                           # counts the driver adds
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

#: NCCL's ``nccl:<collective>`` ranges are annotations over its kernels,
#: not device work of their own
ANNOTATION_PREFIXES = ("nccl:",)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(device: List[Tuple[float, float, str]],
                  host: List[Tuple[float, float, str]],
                  window_s: float, top_gaps: int = 10) -> Dict:
    """``device`` and ``host``: (start us, end us, name) of each device
    operation and host operation of the traced window."""
    device = [ev for ev in device if not ev[2].startswith(ANNOTATION_PREFIXES)]
    by_name: Dict[str, List[float]] = {}
    for s, e, name in device:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += (e - s) * 1e-6
        row[1] += 1
    kernels = sorted(([n, t, c] for n, (t, c) in by_name.items()),
                     key=lambda r: -r[1])
    spans = _union([(s, e) for s, e, _ in device])
    busy = sum(e - s for s, e in spans) * 1e-6
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1],
                    spans[i + 1][0]) for i in range(len(spans) - 1)),
                  reverse=True)[:200]
    labels: Dict[str, float] = {}
    if host:
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        for length, s, e in gaps:
            mid = 0.5 * (s + e)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            # the innermost host op running then: the latest to start
            name = (host[int(inside[np.argmax(hs[inside])])][2]
                    if inside.size else "no host op traced")
            labels[name] = labels.get(name, 0.0) + length * 1e-6
    idle = sorted(([n, t] for n, t in labels.items()), key=lambda r: -r[1])
    return {"kernels": kernels, "busy_s": busy, "window_s": window_s,
            "idle_gaps": idle[:top_gaps]}


def reduce_profile(prof, window_s: float) -> Dict:
    """A finished ``torch.profiler.profile`` of the card, reduced."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        row = (float(tr.start), float(tr.end), ev.name)
        if ev.device_type == DeviceType.CUDA:
            device.append(row)
        else:
            host.append(row)
    return reduce_events(device, host, window_s)


def breakdown(trace: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten longest idle gaps by host op."""
    return {"device_ops": [[n, t] for n, t, _ in trace["kernels"][:10]],
            "idle_gaps": [[n, t] for n, t in trace["idle_gaps"][:10]]}


class Tracer:
    """Profile the card over the first ``steps`` steps of a window:
    ``step()`` after each step stops it once they are done; the trace is
    reduced after the window (``result``). Off, and free, unless ``on``."""

    def __init__(self, on: bool, steps: int):
        self.on, self.steps, self.left = on, steps, steps
        self.prof, self.window_s, self._t0 = None, 0.0, 0.0
        self._done = None

    def __enter__(self):
        if self.on:
            import time

            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._t0 = time.perf_counter()
        return self

    def step(self) -> None:
        if self.prof is None or self._done is not None:
            return
        self.left -= 1
        if self.left <= 0:
            self._stop()

    def _stop(self) -> None:
        import time

        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self._done = self.prof

    def __exit__(self, *exc):
        if self.prof is not None and self._done is None:
            self._stop()
        return False

    @property
    def result(self):
        """The reduced trace with ``steps`` traced, None when off."""
        if self._done is None:
            return None
        out = reduce_profile(self._done, self.window_s)
        out["steps"] = self.steps - max(self.left, 0)
        return out
