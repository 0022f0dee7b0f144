"""The traced sub-window: ``torch.profiler`` over a bounded run of calls,
and the view of it that the per-layer readers take.

The sub-window starts on an idle device (a synchronize) and ends with
one, so every device operation of its calls lies inside it.  Its length
runs from the first device operation to the end of the last.  A device
operation is the port's kernel when its function's name is one that the
port gives its own CUDA kernels (``speex_resampler_tpu_torch.utils.
launches.kernel_name``, over every geometry, scheme and form); every
other operation (PyTorch's, a copy or fill, any library's) is not.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .roofline import CallWork

#: the span that the benchmark records around each call of the entry
CALL_SPAN = "perfbench.call"
TOP = 10


@functools.lru_cache(maxsize=1)
def port_kernel_names() -> frozenset:
    """The function names of the port's CUDA kernels, without template
    arguments, as the port's own kernel table names them."""
    from speex_resampler_tpu_torch.utils import launches
    names = set()
    for geometry in launches.MODULES:
        for scheme in ("highest", "int8", "split5", "fixed"):
            for form in ("rows", "band", "stream"):
                names.add(launches.kernel_name(geometry, scheme,
                                               form=form).split("<")[0])
    return frozenset(names)


def kernel_function(name: str) -> str:
    """The function's own name in a device operation's name as the
    profiler gives it (``void (anonymous namespace)::tiled_fir_int8_kernel
    <3, true>(fir::Launch, ...)`` -> ``tiled_fir_int8_kernel``)."""
    head = name.replace("(anonymous namespace)", "").split("(")[0]
    head = head.split("<")[0].rsplit("::", 1)[-1].split()
    return head[-1] if head else ""


def is_port_kernel(name: str) -> bool:
    return kernel_function(name) in port_kernel_names()


@dataclasses.dataclass
class TraceView:
    """What a per-layer reader reads: the sub-window's device and host
    operations (name, start s, end s), the calls made in it, and the
    work of a call with the chip's peaks (None off the table)."""
    calls: int
    device: list
    host: list
    work: CallWork
    peaks: dict | None

    @property
    def window_s(self) -> float:
        if not self.device:
            return 0.0
        return (max(e for _, _, e in self.device)
                - min(s for _, s, _ in self.device))

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _merged(self.device))

    def op_seconds(self, port: bool) -> float:
        """Summed device time of the port's kernels, or of the rest."""
        return sum(e - s for n, s, e in self.device
                   if is_port_kernel(n) == port)


def _merged(ops) -> list:
    spans = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return spans


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def view(prof, calls: int, work: CallWork, peaks) -> TraceView:
    """The profiler's events as a :class:`TraceView`.  A span recorded
    on the host (``record_function``) that the profiler also draws on
    the device's timeline is no device operation and is left out."""
    dev, host = [], []
    for e in prof.events():
        item = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(item)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name == CALL_SPAN):
            dev.append(item)
    return TraceView(calls=calls, device=dev, host=host, work=work,
                     peaks=peaks)


def breakdown(v: TraceView) -> dict:
    """The device operations that took most time, summed by name, and
    the longest idle gaps of the device, each named by the innermost
    host operation that was running at its middle."""
    by_name: dict = {}
    for n, s, e in v.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans = _merged(v.device)
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(spans, spans[1:]) if b[0] > a[1]),
                  reverse=True)[:TOP]
    named = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        inner = [h for h in v.host if h[1] <= mid <= h[2]]
        name = max(inner, key=lambda h: h[1])[0] if inner else "host idle"
        named.append([name, length])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}
