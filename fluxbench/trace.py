"""The traced window of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA activity) around the closed loop, reduced to what the per-layer
metrics and the ``breakdown`` read.

* the window: the harness's ``fluxbench.window`` span on the host;
* the device's operations (kernels, copies, sets; the profiler's own
  annotations left out), clipped to the window;
* busy time: the union of those intervals; the idle gaps between them,
  each named by the host's operation that overlaps it most (the shorter one
  where two overlap as much: the more specific).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch

#: the host span the harness opens around the measured window
WINDOW_SPAN = "fluxbench.window"
#: host spans too wide to name a gap: they enclose every gap of a call
_ENCLOSING = {WINDOW_SPAN, "fluxbench.call"}
#: the longest gaps that are named one by one; the rest are summed
_NAMED_GAPS = 4000
#: a host operation longer than this is searched for among all gaps
_LONG_NS = 1_000_000


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool):
    """``torch.profiler`` over the block when ``enabled`` (CPU activity,
    and CUDA where the run is on the card); yields the profiler or None."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _ns(e, what):
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


class Trace:
    """The reduced trace: the window's bounds, the device's operations and
    the host's, as numpy arrays in the profiler's nanoseconds."""

    def __init__(self, prof):
        dev, host = [], []
        window = None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if getattr(e, "is_user_annotation", lambda: False)():
                    continue
                dev.append((start, end, name))
            else:
                if name == WINDOW_SPAN:
                    window = (start, end)
                host.append((start, end, name))
        if window is None:
            raise RuntimeError(f"trace: no {WINDOW_SPAN!r} span")
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.dev_start, self.dev_end, self.dev_name = self._clip(dev)
        self.host = host

    def _clip(self, events):
        events = [(max(s, self.t0), min(e, self.t1), n) for s, e, n in events
                  if e > self.t0 and s < self.t1]
        events.sort()
        return (np.array([s for s, _, _ in events], np.int64),
                np.array([e for _, e, _ in events], np.int64),
                [n for _, _, n in events])

    def device_seconds(self, match=None):
        """(seconds, count) of the device operations whose name contains
        ``match`` (all of them where ``match`` is None)."""
        if match is None:
            keep = np.ones(len(self.dev_name), bool)
        else:
            keep = np.array([match in n for n in self.dev_name], bool)
        dur = (self.dev_end - self.dev_start)[keep]
        return float(dur.sum()) * 1e-9, int(keep.sum())

    def busy_intervals(self):
        """The union of the device's operations: (starts, ends)."""
        if not len(self.dev_start):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        s, e = self.dev_start, np.maximum.accumulate(self.dev_end)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > e[:-1]
        starts = s[new]
        ends = e[np.append(np.flatnonzero(new)[1:] - 1, len(s) - 1)]
        return starts, ends

    def busy_s(self):
        starts, ends = self.busy_intervals()
        return float((ends - starts).sum()) * 1e-9

    def gaps(self):
        """The idle intervals of the window: (starts, ends)."""
        starts, ends = self.busy_intervals()
        gs = np.concatenate([[self.t0], ends])
        ge = np.concatenate([starts, [self.t1]])
        keep = ge > gs
        return gs[keep], ge[keep]

    def top_device_ops(self, n=10):
        """The ``n`` device operations that took most time, summed by
        name: [[name, seconds], ...]."""
        tot = defaultdict(int)
        for s, e, name in zip(self.dev_start, self.dev_end, self.dev_name):
            tot[name] += int(e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns * 1e-9] for name, ns in top]

    def idle_by_host(self, n=10):
        """The idle time summed by what the host was doing, the ``n``
        largest: [[host operation, seconds], ...].  The longest gaps are
        named one by one; the rest are summed as one entry."""
        gs, ge = self.gaps()
        order = np.argsort(gs - ge)                   # longest first
        named, rest = order[:_NAMED_GAPS], order[_NAMED_GAPS:]
        hs = np.array([h[0] for h in self.host], np.int64)
        he = np.array([h[1] for h in self.host], np.int64)
        names = [h[2] for h in self.host]
        wide = np.array([nm in _ENCLOSING for nm in names], bool)
        long_idx = np.flatnonzero(((he - hs) > _LONG_NS) & ~wide)
        by_start = np.argsort(hs)
        hs_sorted = hs[by_start]
        tot = defaultdict(int)
        for g in named:
            a, b = int(gs[g]), int(ge[g])
            lo = np.searchsorted(hs_sorted, a - _LONG_NS, "left")
            hi = np.searchsorted(hs_sorted, b, "left")
            cand = np.union1d(by_start[lo:hi], long_idx).astype(np.int64)
            cand = cand[~wide[cand]] if len(cand) else cand
            label = "host: outside any traced operation"
            if len(cand):
                ov = np.minimum(he[cand], b) - np.maximum(hs[cand], a)
                best = ov.max()
                if best > 0:
                    pick = cand[ov == best]
                    label = names[int(pick[np.argmin(he[pick] - hs[pick])])]
            tot[label] += b - a
        if len(rest):
            tot[f"{len(rest)} shorter gaps"] += int(
                (ge[rest] - gs[rest]).sum())
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns * 1e-9] for name, ns in top]
