"""The traced run's profiler: slices of steps spread over the window, and
what the device did in them.

A ``SliceSchedule`` records ``steps`` steps (after one warm-up step) when
the window reaches each of ``fractions`` of its length, so the trace stays
small and samples the whole window. At the end of each slice its events
are reduced and dropped: the device's span (first device operation's
start to the last one's end), its busy time (the union of kernel, copy and
set intervals), each device operation's time by name, and each idle gap
of the device charged to what the host was doing at its middle (the
innermost host operation open then). ``busy_s`` and ``window_s`` sum the
slices; the idle share is 1 - busy_s / window_s.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import ProfilerAction, ProfilerActivity, profile

# Gaps shorter than this between device operations are launch latency,
# not idle time worth naming (they still count as idle).
NAMED_GAP_US = 5.0


class SliceSchedule:
    """A ``torch.profiler`` schedule over the host clock: at each of
    ``fractions`` of ``seconds`` after ``start()``, one warm-up step, then
    ``steps`` recorded steps, the last of them saving."""

    def __init__(self, seconds: float, fractions, steps: int,
                 clock: Callable[[], float]):
        self.seconds, self.fractions, self.steps = seconds, fractions, steps
        self.clock = clock
        self.starts: List[float] = []
        self.action = ProfilerAction.NONE
        self._left = 0
        self._next = 0

    def start(self) -> None:
        t0 = self.clock()
        self.starts = [t0 + f * self.seconds for f in self.fractions]
        self._next, self._left = 0, 0

    def __call__(self, step: int) -> ProfilerAction:
        if self._left > 0:
            self._left -= 1
            self.action = ProfilerAction.RECORD_AND_SAVE if self._left == 0 \
                else ProfilerAction.RECORD
        elif self.starts and self._next < len(self.starts) \
                and self.clock() >= self.starts[self._next]:
            self._next += 1
            self._left = self.steps
            self.action = ProfilerAction.WARMUP
        else:
            self.action = ProfilerAction.NONE
        return self.action

    @property
    def recording(self) -> bool:
        return self.action in (ProfilerAction.RECORD,
                               ProfilerAction.RECORD_AND_SAVE)


def union_intervals(intervals: List[tuple]) -> List[tuple]:
    """Sorted, merged (start, end) intervals."""
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


@dataclass
class SliceReading:
    """One slice: the device's span and busy time (seconds), device time
    by operation name (seconds, count), idle seconds by host operation,
    and the tags of the steps it recorded."""
    span_s: float
    busy_s: float
    device_ops: Dict[str, list]
    idle_by_host: Dict[str, float]
    tags: list = field(default_factory=list)


def reduce_events(device: List[tuple],
                  host: List[tuple]) -> Optional[SliceReading]:
    """A slice's reading from ``device`` (name, start_us, end_us) and
    ``host`` (name, start_us, end_us) events; None with no device event."""
    if not device:
        return None
    ops: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for name, a, b in device:
        ops[name][0] += (b - a) * 1e-6
        ops[name][1] += 1
    merged = union_intervals([(a, b) for _, a, b in device])
    span = merged[-1][1] - merged[0][0]
    busy = sum(b - a for a, b in merged)
    host = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    idle: Dict[str, float] = defaultdict(float)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        gap = start - end
        name = "launch latency (< 5 us)"
        if gap >= NAMED_GAP_US:
            mid = 0.5 * (start + end)
            name = "host between operators (none open)"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(-1, i - 4000), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
        idle[name] += gap * 1e-6
    return SliceReading(span * 1e-6, busy * 1e-6, dict(ops), dict(idle))


def profiler_events(prof) -> tuple:
    """(device events, host events) of a finished profiler cycle, each
    (name, start_us, end_us); the host events are those of the thread
    that steps the profiler (the one that launches the steps' work)."""
    device, host = [], []
    events = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    main = {e.thread for e in events if e.name.startswith("ProfilerStep#")}
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # The steps' own ranges are mirrored on the device's timeline
            # as annotations; they are no operation of the device.
            if not (e.is_user_annotation or e.name.startswith("ProfilerStep")):
                device.append((e.name, start, end))
        elif e.thread in main:
            host.append((e.name, start, end))
    return device, host


class Trace:
    """The traced window, in two profiler sessions one after the other:
    the first records only the device (``SLICES`` at ``fractions`` of the
    window; the host's own profiling would slow it and inflate the
    device's idle time) and gives every reading; the second, one slice
    near the end with the host's operations too, gives only the host
    operations the device's idle gaps fall in. Call ``step(tag)`` at the
    end of each step (``tag``: what the step ran, such as its layouts,
    kept for a step the first session records) inside ``with trace:``;
    ``actions`` holds each step's profiler action, ``ends`` the host clock
    at each step's end."""

    def __init__(self, seconds: float, fractions, steps: int, clock,
                 host_fraction: float = 0.85):
        self.clock = clock
        self.sessions = [
            (SliceSchedule(seconds, fractions, steps, clock),
             [ProfilerActivity.CUDA]),
            (SliceSchedule(seconds, (host_fraction,), steps, clock),
             [ProfilerActivity.CPU, ProfilerActivity.CUDA])]
        self.slices: List[SliceReading] = []
        self.host_slices: List[SliceReading] = []
        self.actions: list = []
        self.ends: list = []
        self._tags: list = []
        self._index = 0
        self._prof = None

    def _ready(self, prof) -> None:
        device, host = profiler_events(prof)
        reading = reduce_events(device, host)
        if reading is None:
            raise RuntimeError("a profiled slice recorded no device "
                               "operation")
        reading.tags = self._tags
        (self.slices if self._index == 0 else self.host_slices).append(
            reading)
        self._tags = []

    def _open(self) -> None:
        schedule, activities = self.sessions[self._index]
        self._prof = profile(activities=activities, schedule=schedule,
                             on_trace_ready=self._ready, acc_events=False)
        self._prof.__enter__()

    @property
    def schedule(self) -> SliceSchedule:
        return self.sessions[self._index][0]

    def __enter__(self) -> "Trace":
        for schedule, _ in self.sessions:
            schedule.start()
        self._index = 0
        self._open()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)

    def step(self, tag=None) -> None:
        schedule = self.schedule
        self.actions.append(schedule.action)
        if schedule.recording and self._index == 0:
            self._tags.append(tag)
        self._prof.step()
        self.ends.append(self.clock())
        if self._index == 0 and schedule._next == len(schedule.starts) \
                and schedule._left == 0 \
                and schedule.action == ProfilerAction.NONE:
            self._prof.__exit__(None, None, None)
            self._index = 1
            self._open()

    def quiet_steps(self) -> list:
        """The indices of the steps that neither they nor the step before
        were profiled or reduced a slice: the window where the profiler
        is off."""
        return [i for i in range(2, len(self.ends))
                if self.actions[i] == ProfilerAction.NONE
                and self.actions[i - 1] == ProfilerAction.NONE]

    def quiet_periods(self) -> list:
        """The host-clock periods (s) of those steps."""
        return [self.ends[i] - self.ends[i - 1] for i in self.quiet_steps()]

    # -- what the readers read --------------------------------------------
    @property
    def busy_s(self) -> float:
        return sum(s.busy_s for s in self.slices)

    @property
    def window_s(self) -> float:
        return sum(s.span_s for s in self.slices)

    @property
    def tags(self) -> list:
        return [t for s in self.slices for t in s.tags]

    def family_seconds(self, pattern: str) -> tuple:
        """(seconds, launches) of the device operations whose name matches
        ``pattern`` (a regular expression), summed over the device-only
        slices; raises where a slice recorded none of them (the profiler
        missed them, or the path no longer runs them)."""
        if not self.slices:
            raise RuntimeError("no profiled slice was recorded")
        rx = re.compile(pattern)
        total, count = 0.0, 0
        for s in self.slices:
            found = [v for k, v in s.device_ops.items() if rx.search(k)]
            if not found:
                raise RuntimeError(f"a profiled slice recorded no device "
                                   f"operation matching {pattern!r}")
            total += sum(v[0] for v in found)
            count += sum(v[1] for v in found)
        return total, count

    def breakdown(self) -> dict:
        """The ten device operations with the most time (device-only
        slices) and the ten host operations the device's idle time fell in
        most (the slice with the host's operations), in seconds."""
        ops: Dict[str, float] = defaultdict(float)
        idle: Dict[str, float] = defaultdict(float)
        for s in self.slices:
            for k, v in s.device_ops.items():
                ops[k[:120]] += v[0]
        for s in self.host_slices:
            for k, v in s.idle_by_host.items():
                idle[k[:120]] += v

        def top(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def discard_session(fn) -> None:
    """One short profiler session around ``fn()``, thrown away: the first
    session of a process can record no kernel of the port's."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()


def quiet_steps(r) -> list:
    """The window's step records (``r.steps``) that the profiler left
    alone (``Trace.quiet_steps``); all of them in an untraced run."""
    steps = getattr(r, "steps", None)
    if steps is None:
        return []
    if r.trace is None:
        return list(steps)
    return [steps[i] for i in r.trace.quiet_steps() if i < len(steps)]


def quiet_period(r) -> Optional[float]:
    """The mean host-clock period (s) of a step the profiler left alone,
    or of every step over the window in an untraced run."""
    if r.trace is None:
        n = len(r.steps)
        return r.window_s / n if n else None
    periods = r.trace.quiet_periods()
    return sum(periods) / len(periods) if periods else None
