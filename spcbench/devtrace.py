"""The device trace of a run, read from ``torch.profiler``.

:class:`Tracer` turns the profiler on around the requests a traffic kind
chooses to trace, and records the traced window and a span per traced
request on the host clock that the profiler's own timestamps use
(``time.time_ns``).  :func:`summarise` reduces the profiler's events to
what the per-layer readers and the result line need: the device's busy
seconds in the window, busy and kernel seconds inside each span, the
device operations that took most time, and the idle gaps by what the
host was doing during them.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

#: Entries kept in each list of the result's ``breakdown``.
TOP = 10
#: Longest name kept for an operation (kernel names carry templates).
NAME_CHARS = 160
#: How far back the search for the host operation covering a gap walks.
WALK = 256


class Tracer:
    """Profiles the requests between :meth:`begin` and :meth:`end`."""

    def __init__(self, device: str) -> None:
        self.device = device
        self.spans: list = []
        self.window_ns = None
        self.summary = None
        self._prof = None
        self._stopped = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.time_ns()

    @contextlib.contextmanager
    def request(self, name: str):
        """One traced request: a span on the host clock and a labelled
        range in the profiler's host events."""
        from torch.profiler import record_function
        t0 = time.time_ns()
        with record_function(name):
            yield
        self.spans.append((t0, time.time_ns()))

    def end(self) -> None:
        if self._prof is None:
            return
        if self.device.startswith("cuda"):
            import torch
            torch.cuda.synchronize()
        self.window_ns = (self._t0, time.time_ns())
        self._prof.__exit__(None, None, None)
        self._stopped, self._prof = self._prof, None

    def summarise(self) -> "Summary | None":
        """The :class:`Summary` of the traced window, read once the run's
        window has closed (None if nothing was traced)."""
        if self._prof is not None:
            self.end()
        if self.summary is None and self._stopped is not None:
            self.summary = summarise(
                self._stopped.profiler.kineto_results.events(),
                self.window_ns)
            self._stopped = None
        return self.summary


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged, sorted intervals covering the given ones."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > e[:-1]
    last = np.r_[np.flatnonzero(new)[1:] - 1, s.size - 1]
    return s[new], e[last]


class Summary:
    """Reductions of one traced window (times in ns unless named _s)."""

    def __init__(self, window, dev, host) -> None:
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        self.dev_names, ds, de = dev
        ds, de = np.clip(ds, w0, w1), np.clip(de, w0, w1)
        self._dev = (ds, de)
        self.busy = _union(ds, de)
        self.busy_s = float((self.busy[1] - self.busy[0]).sum()) * 1e-9
        self.has_device = bool(ds.size)
        self.device_ops = _top(self.dev_names, de - ds)
        self.idle_gaps = _gaps_by_host(self.busy, window, host)

    def busy_in(self, spans) -> np.ndarray:
        """Seconds of device activity inside each (t0, t1) span."""
        s, e = self.busy
        out = []
        for t0, t1 in spans:
            out.append(np.clip(np.minimum(e, t1) - np.maximum(s, t0), 0,
                               None).sum() * 1e-9)
        return np.asarray(out, dtype=np.float64)

    def kernel_in(self, spans, part: str) -> np.ndarray:
        """Seconds of the device operations whose name holds ``part``
        that start inside each span."""
        ds, de = self._dev
        hit = np.array([part in n for n in self.dev_names], dtype=bool)
        out = []
        for t0, t1 in spans:
            at = hit & (ds >= t0) & (ds < t1)
            out.append((de[at] - ds[at]).sum() * 1e-9)
        return np.asarray(out, dtype=np.float64)


def _top(names, durations_ns) -> list:
    total = defaultdict(int)
    for name, d in zip(names, durations_ns.tolist()):
        total[name[:NAME_CHARS]] += d
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, ns * 1e-9] for name, ns in ranked]


def _gaps_by_host(busy, window, host) -> list:
    """The device's idle time in ``window``, summed by the innermost host
    event running at each gap's midpoint."""
    w0, w1 = window
    s, e = busy
    g0 = np.r_[w0, e]
    g1 = np.r_[s, w1]
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    names, hs, he = host
    order = np.argsort(hs, kind="stable")
    names = [names[i][:NAME_CHARS] for i in order]
    hs, he = hs[order], he[order]
    mid = (g0 + g1) // 2
    # the innermost host event covering each midpoint: the latest-starting
    # one of the WALK that start before it; -1 where none covers it
    j = np.searchsorted(hs, mid, side="right") - 1
    cover = np.full(mid.size, -1, dtype=np.int64)
    open_ = np.flatnonzero(j >= 0)
    for step in range(WALK):
        k = j[open_] - step
        ok = k >= 0
        hit = ok & (he[np.maximum(k, 0)] >= mid[open_])
        cover[open_[hit]] = k[hit]
        open_ = open_[ok & ~hit]
        if open_.size == 0:
            break
    total = defaultdict(int)
    for c, dt in zip(cover.tolist(), (g1 - g0).tolist()):
        total[names[c] if c >= 0 else "(host Python between operations)"] \
            += dt
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, ns * 1e-9] for name, ns in ranked]


def summarise(events, window) -> Summary:
    """A :class:`Summary` of the profiler's kineto events."""
    from torch.autograd import DeviceType
    dev_n, dev_s, dev_e, host_n, host_s, host_e = [], [], [], [], [], []
    for ev in events:
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation():   # a host range mirrored, no work
                continue
            dev_n.append(ev.name())
            dev_s.append(start)
            dev_e.append(end)
        elif end > start:
            host_n.append(ev.name())
            host_s.append(start)
            host_e.append(end)
    dev = (dev_n, np.asarray(dev_s, dtype=np.int64),
           np.asarray(dev_e, dtype=np.int64))
    host = (host_n, np.asarray(host_s, dtype=np.int64),
            np.asarray(host_e, dtype=np.int64))
    return Summary(window, dev, host)


def idle_percent(summary) -> float | None:
    """The idle share of a traced window, or None without device events."""
    if summary is None or not summary.has_device or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
