"""Reduction of a torch.profiler trace of the device to what the per-layer
readers need: device time by kernel name and group, the busy time (the union
of the device activities), and the idle gaps labelled by the harness span
the host was in.

``port_kernel`` and ``kernel_group`` are ``chip_smoke.py``'s, copied so that a
later change there does not move the yardstick.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

# device kernel name -> the port kernel (wrapper) it belongs to
PORT_KERNELS = (("paged_decode_kernel", "paged decode attention"),
                ("paged_prefill_kernel", "paged_flash_prefill"),
                ("paged_prefill_tc_kernel", "paged_flash_prefill"),
                ("flash_kernel", "flash_attention"),
                ("flash_tc_kernel", "flash_attention"),
                ("ssd_chunk_state_kernel", "ssd"),
                ("ssd_state_pass_kernel", "ssd"),
                ("ssd_chunk_scan_kernel", "ssd"),
                ("ssd_fma_kernel", "ssd"))


def port_kernel(name: str):
    """The port kernel a device activity belongs to, or None."""
    n = name.lower()
    for key, kernel in PORT_KERNELS:
        if key in n:
            return kernel
    return None


def kernel_group(name: str) -> str:
    """Coarse class of a device activity, by its name."""
    n = name.lower()
    if port_kernel(n):
        return "port kernels"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmuls"
    return "other (elementwise, reductions, sort, indexing)"


@dataclass
class DeviceTrace:
    """The traced window's device activities, in seconds on the host's
    clock (shifted by the offset measured with a marker)."""
    intervals: list                       # (start, end, name), sorted
    by_name: dict = field(default_factory=dict)    # name -> seconds

    def kernel_seconds(self, port: str) -> float:
        """Device seconds of one port kernel (``PORT_KERNELS``'s names)."""
        return sum(s for n, s in self.by_name.items() if port_kernel(n) == port)

    def busy(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi) in which some device activity ran."""
        total, cur_s, cur_e = 0.0, None, None
        for s, e, _ in self.intervals:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def gaps(self, lo: float, hi: float):
        """Idle intervals of [lo, hi): (start, end) where nothing ran."""
        out, t = [], lo
        for s, e, _ in self.intervals:
            if e <= t:
                continue
            if s > t:
                out.append((t, min(s, hi)))
            t = max(t, e)
            if t >= hi:
                break
        if t < hi:
            out.append((t, hi))
        return [(a, b) for a, b in out if b > a]

    def top_kernels(self, n: int = 10):
        by_group = {}
        for name, s in self.by_name.items():
            key = port_kernel(name) or name[:80]
            by_group[key] = by_group.get(key, 0.0) + s
        return sorted(by_group.items(), key=lambda kv: -kv[1])[:n]


def from_events(events, offset_ns: int, marker_start_ns: int | None) -> DeviceTrace:
    """``events``: (name, start_ns, end_ns) of device activities; host time
    = device time - ``offset_ns``. The marker activity (started at
    ``marker_start_ns``) is left out."""
    iv, by_name = [], {}
    for name, s, e in events:
        if s == marker_start_ns:
            continue
        a, b = (s - offset_ns) / 1e9, (e - offset_ns) / 1e9
        iv.append((a, b, name))
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    iv.sort()
    return DeviceTrace(iv, by_name)


def label_gaps(gaps, spans, n: int = 10):
    """The ``n`` longest idle gaps, each labelled by the innermost harness
    span (name, start, end) that holds its midpoint, or ``between steps``.
    Returns [[label, seconds], ...]."""
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        label, width = "between steps", None
        for name, s, e in spans:
            if s <= mid < e and (width is None or e - s < width):
                label, width = name, e - s
        out.append([label, b - a])
    return out


class Tracer:
    """Profiles the device over a steady sub-window of a run's window: from
    the first step that starts at ``start_s`` or later, for ``seconds``,
    whole steps only. Only device activity is recorded (a host-op trace of
    a decode loop is millions of events); a marker kernel launched right
    after a synchronise ties the device's clock to the run's."""

    def __init__(self, start_s: float, seconds: float, cuda: bool):
        """``cuda``: profile the device (else only the sub-window's bounds
        and counters are kept). Starting the profiler the first time in a
        process takes seconds: it is started and stopped once here, in
        set-up, so that the sub-window's start costs milliseconds."""
        self.start_s, self.seconds, self.cuda = start_s, seconds, cuda
        if cuda:
            import torch
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.zeros(1, device="cuda").add_(1.0)
                torch.cuda.synchronize()
        self.lo = self.hi = None
        self.trace: DeviceTrace | None = None
        self.counters = {}       # the engine's stats over the sub-window
        self.n_events, self.read_s = 0, 0.0
        self._prof = None
        self._stats0 = None

    def __call__(self, run, now):
        if self.lo is None and now is not None and now >= self.start_s:
            self._stats0 = dict(run.engine.stats)
            self._start(run)
        elif self.lo is not None and self.hi is None and (
                now is None or now >= self.lo + self.seconds):
            self._stop(run)
            self.counters = {k: v - self._stats0.get(k, 0)
                             for k, v in run.engine.stats.items()}

    def _start(self, run):
        if not self.cuda:
            self.lo = run.clock() - run.t0
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        marker = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.lo = run.clock() - run.t0
        marker.fill_(1.0)
        torch.cuda.synchronize()

    def _stop(self, run):
        if not self.cuda:
            self.hi = run.clock() - run.t0
            return
        import torch
        torch.cuda.synchronize()
        self.hi = run.clock() - run.t0
        self._prof.stop()

    def finish(self):
        """Reads the trace, once the window has closed (a trace of a few
        seconds holds some hundred thousand activities)."""
        if self._prof is None:
            return
        t = time.perf_counter()
        events = device_events(self._prof)
        self._prof = None
        self.n_events, self.read_s = len(events), time.perf_counter() - t
        if not events:
            return
        first = min(s for _, s, _ in events)
        self.trace = from_events(events, first - int(self.lo * 1e9), first)


def device_events(prof):
    """(name, start_ns, end_ns) of every device activity of a profile."""
    from torch.autograd import DeviceType
    try:
        evs = prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns(), e.end_ns()) for e in evs
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        return [(e.name, int(e.time_range.start * 1e3),
                 int(e.time_range.end * 1e3)) for e in prof.events()
                if e.device_type == DeviceType.CUDA]
