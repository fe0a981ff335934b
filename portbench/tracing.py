"""The device trace of a traced window, reduced on the profiler's one
timeline: device activities (kernels, copies, sets), the window's span,
the union of device activity (busy), the top device operations and the
longest idle gaps, each named by what the host was doing.

`trace_window(fn)` runs ``fn()`` under `torch.profiler` and returns a
`Trace`.  On a card the profiler records CUDA activities alone (the card's
kernels and copies, the CUDA runtime's calls and the profiler's own work,
which name the idle gaps): recording the host's operators as well slows the
traced work further (a fleet run: 15.4 s against 12.8 s).  The window is
marked on the device itself, by a one-element kernel launched as it opens
and another once ``fn``'s work has finished.  Without a card the profiler
records the CPU, and the window is a `record_function` span.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Tuple

WINDOW_SPAN = "portbench.window"
#: Idle gaps shorter than this are not attributed (launch spacing).
GAP_MIN_NS = 2_000


@dataclasses.dataclass
class Trace:
    """Device activities as (name, start_ns, end_ns), sorted by start; the
    host's CPU events likewise; the window's span in ns."""

    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    window_start: int
    window_end: int

    @property
    def window_s(self) -> float:
        return (self.window_end - self.window_start) * 1e-9

    def named(self, name: str) -> List[Tuple[str, int, int]]:
        """The device activities whose name contains ``name``."""
        return [a for a in self.device if name in a[0]]

    def busy_s(self) -> float:
        """Seconds covered by at least one device activity in the window."""
        busy, cur_s, cur_e = 0, None, None
        for _, s, e in self.device:
            s, e = max(s, self.window_start), min(e, self.window_end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-9

    def device_ops(self, top: int = 10) -> List[list]:
        """[[name, seconds]] of the device operations that took most time."""
        tot: Dict[str, int] = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0) + (e - s)
        return [[n, v * 1e-9] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[[host activity, seconds]]: idle time of the device in the window
        (gaps of at least GAP_MIN_NS), summed by the innermost host event
        running at each gap's middle ("host idle" where none ran)."""
        starts = [h[1] for h in self.host]
        gaps: Dict[str, int] = {}
        edge = self.window_start
        for _, s, e in self.device + [("", self.window_end, self.window_end)]:
            if s - edge >= GAP_MIN_NS:
                name = self._host_at((edge + s) // 2, starts)
                gaps[name] = gaps.get(name, 0) + (s - edge)
            edge = max(edge, e)
        return [[n, v * 1e-9] for n, v in
                sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t: int, starts: List[int]) -> str:
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(i - 4000, 0) - 1, -1):
            name, s, e = self.host[j]
            if e >= t and (best is None or e - s < best[2] - best[1]):
                best = self.host[j]
        return best[0] if best is not None else "host idle"


def trace_window(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """(fn(), its Trace): ``fn`` runs under the profiler between the two
    window marks, and ends with the device synchronised."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA if card else ProfilerActivity.CPU]
    if card:
        mark = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            if card:
                mark.add_(1)
            out = fn()
            if card:
                torch.cuda.synchronize()
                mark.add_(1)
                torch.cuda.synchronize()
    device, host, span = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((name, s, e))
        elif name == WINDOW_SPAN:
            span = (s, e)
        else:
            host.append((name, s, e))
    device.sort(key=lambda a: a[1])
    host.sort(key=lambda a: a[1])
    if card:
        if len(device) < 2:
            raise RuntimeError("the profiler kept no window marks")
        (_, start, _), (_, _, end) = device[0], device[-1]
        return out, Trace(device[1:-1], host, start, end)
    if span is None:
        raise RuntimeError("the profiler kept no window span")
    return out, Trace(device, host, *span)
