"""The traced stretch: a few calls under ``torch.profiler``, reduced to the
device's operations, the host's, and the stretch's own span.

Device time counts kernels, copies and sets (``DEVICE_KINDS``); the busy
time is the union of their intervals inside the stretch, so overlapping
streams count once.  An idle gap is a stretch of that window in which no
device operation runs; it is named by the innermost host operation that
was running at its middle.
"""

from __future__ import annotations

import collections
import dataclasses
import re

STRETCH = "portbench.stretch"
DEVICE_KINDS = ("kernel", "memcpy", "memset")
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    """device: (name, kind, start_ns, end_ns); host: (name, start_ns,
    end_ns); span: the stretch's (start_ns, end_ns); calls: how many calls
    it held."""

    device: list
    host: list
    span: tuple
    calls: int

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e9

    def busy_intervals(self) -> list:
        lo, hi = self.span
        ivs = sorted((max(s, lo), min(e, hi)) for _, _, s, e in self.device
                     if e > lo and s < hi)
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernels(self):
        return [d for d in self.device if d[1] == "kernel"]

    def device_ms_per_call(self, match) -> float:
        """Device ms a call in the kernels whose name ``match`` accepts."""
        ns = sum(e - s for name, _, s, e in self.kernels() if match(name))
        return ns / 1e6 / self.calls

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, summed by name, in
        seconds."""
        tot = collections.Counter()
        for name, _, s, e in self.device:
            tot[name[:NAME_CHARS]] += (e - s) / 1e9
        return [[n, t] for n, t in tot.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle time inside the stretch, summed by the host
        operation running at each gap's middle, in seconds."""
        lo, hi = self.span
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        host = sorted((h for h in self.host if h[0] != STRETCH),
                      key=lambda h: h[1])
        tot = collections.Counter()
        stack, nxt = [], 0          # the open host ops, innermost last
        for s, e in gaps:
            mid = (s + e) // 2
            while nxt < len(host) and host[nxt][1] <= mid:
                while stack and stack[-1][2] <= host[nxt][1]:
                    stack.pop()
                stack.append(host[nxt])
                nxt += 1
            while stack and stack[-1][2] <= mid:
                stack.pop()
            name = stack[-1][0] if stack else "(no host op)"
            tot[name[:NAME_CHARS]] += (e - s) / 1e9
        return [[n, t] for n, t in tot.most_common(top)]


def _kind(event, name: str) -> str:
    try:
        kind = str(event.activity_type()).lower()
    except AttributeError:
        kind = ""
    if "memcpy" in kind or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in kind or name.startswith("Memset"):
        return "memset"
    if "annotation" in kind:
        return "annotation"
    return "kernel" if (not kind or "kernel" in kind) else kind


def reduce(prof, calls: int) -> Trace:
    """A finished ``torch.profiler.profile`` -> a Trace.  A device event
    that bears the name of a host range (``record_function``, such as the
    stretch's own, or c10d's ``nccl:<collective>``) is that range's mirror
    on the device's timeline, not an operation, and is left out."""
    from torch.autograd import DeviceType

    device, host, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if name == STRETCH:
                span = (start, end)
            host.append((name, start, end))
        else:
            device.append((name, _kind(e, name), start, end))
    if span is None:
        raise RuntimeError(f"the trace has no {STRETCH} range")
    ranges = {h[0] for h in host}
    device = [d for d in device if d[1] in DEVICE_KINDS and d[0] not in ranges
              and not d[0].startswith("nccl:")]
    return Trace(device, host, span, calls)


def name_matcher(kernel: str):
    """Whether a trace's kernel name is ``kernel``'s: the whole identifier,
    demangled (``void k_mul<...>(...)``) or mangled (``_Z5k_mul...``)."""
    plain = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}(?![A-Za-z0-9_])")
    mangled = re.compile(rf"(?<![0-9]){len(kernel)}{re.escape(kernel)}")
    return lambda name: bool(plain.search(name) or mangled.search(name))


def profile_calls(call, n: int) -> Trace:
    """Run ``call`` n times under the profiler (CPU and CUDA activity) and
    reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            for _ in range(n):
                call()
    return reduce(prof, n)
