"""The traced run's device trace: ``torch.profiler`` (CUPTI) over the last
``SPAN_S`` seconds of the window, reduced in memory (nothing is written to
disk) to device time by kernel name, the device's busy time, and the idle
gaps named by what the host was doing."""

import time

import torch

SPAN_S = 3.0


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.prof = None
        self.window_s = 0.0
        if enabled:
            # The first profile of a process initializes CUPTI, which takes
            # seconds: do it here, before the window.
            with torch.profiler.profile(activities=_activities()):
                torch.ones(1, device=_device()).add_(1)
                _sync()

    def maybe_start(self, elapsed: float, seconds: float):
        if (self.enabled and self.prof is None
                and elapsed >= seconds - SPAN_S):
            _sync()
            self.prof = torch.profiler.profile(activities=_activities())
            self.prof.start()
            self.mark = torch.profiler.record_function("bench_window")
            self.mark.__enter__()
            self.t0 = time.perf_counter()
            self.active = True

    def stop(self):
        if not self.active:
            return
        _sync()
        self.window_s = time.perf_counter() - self.t0
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.active = False

    def summary(self):
        """None when nothing was traced, else a TraceSummary."""
        if self.prof is None:
            return None
        return TraceSummary(self.prof.events(), self.window_s)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _is_device(e) -> bool:
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


class TraceSummary:
    def __init__(self, events, window_s: float):
        cpu, dev = [], []
        w0 = w1 = None
        for e in events:
            tr = e.time_range
            if _is_device(e):
                if e.name != "bench_window":     # the window's annotation
                    dev.append((tr.start, tr.end, e.name))
            else:
                cpu.append((tr.start, tr.end, e.name))
                if e.name == "bench_window":
                    w0, w1 = tr.start, tr.end
        if w0 is None:
            w0 = min((a for a, _, _ in cpu), default=0.0)
            w1 = w0 + window_s * 1e6
        self.window_s = window_s
        self.by_name = {}
        for a, b, n in dev:
            self.by_name[n] = self.by_name.get(n, 0.0) + (b - a) * 1e-6
        # Busy: the union of device intervals inside the window.
        ivs = sorted((max(a, w0), min(b, w1)) for a, b, _ in dev
                     if b > w0 and a < w1)
        merged = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        # Idle gaps (edges of the window included), each named by the
        # innermost host operation covering its middle.
        edges = [w0] + [v for iv in merged for v in iv] + [w1]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        cpu.sort()
        self.gaps = {}
        starts = [a for a, _, _ in cpu]
        import bisect
        for a, b in gaps:
            mid = 0.5 * (a + b)
            k = bisect.bisect_right(starts, mid)
            best = None
            for j in range(k - 1, max(-1, k - 400), -1):
                ca, cb, cn = cpu[j]
                if cb >= mid and cn != "bench_window" and (
                        best is None or cb - ca < best[0]):
                    best = (cb - ca, cn)
            name = best[1] if best else "host outside any operation"
            self.gaps[name] = self.gaps.get(name, 0.0) + (b - a) * 1e-6

    def kernel_s(self, names) -> float:
        return sum(t for n, t in self.by_name.items()
                   if any(n.startswith(p) for p in names))

    def non_port_s(self) -> float:
        return sum(t for n, t in self.by_name.items()
                   if not n.startswith("qct_"))

    def breakdown(self):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, t] for n, t in top],
                "idle_gaps": [[n, t] for n, t in gaps]}
