"""The system's tracer: host spans, device spans and counters, kept in memory
and exported after a run.

* **Host spans** on ``time.perf_counter_ns``: a name, the start and end, the
  index of the enclosing span (−1 for none) and the id of the frame whose
  ``SLAM.track()`` call caused it (None outside a call: construction, the
  warm-ups, ``flush()``).  The frame id is the one identifier the spans of
  one call share.
* **Device spans**: CUDA event pairs on the current stream, each placed on
  the host's clock after the run through one anchor event per device,
  recorded with its host time once the device is synchronised, when tracing
  starts.  ``programs`` holds the map-side programs' pairs (name, start,
  end): ``SLAM.program_events``.  ``pure`` holds the pairs whose launches
  hold no host read between them (graph replays, the programs that may not
  read back): the device cannot idle on the host's account inside them, so
  their union is the device's busy time.
* **Counters**, counted whether tracing is on or off (an integer add), but
  for the pinned-slot waits that blocked, which are timed with their span.

Tracing is off until ``switch(True, devices)``; ``SLAM.time_programs`` is
the switch.  Off, every span site costs one attribute check and records
nothing: no event, no list append.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

# the spans in which the host is blocked on the card
WAITS = ("fetch_wait", "pinned_wait", "read")

_OFF = contextlib.nullcontext()


class _HostSpan:
    __slots__ = ("tracer", "rec")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.rec = [name, 0, 0, -1, tracer.frame]

    def __enter__(self):
        tr, rec = self.tracer, self.rec
        if tr.open:
            rec[3] = tr.open[-1]
        tr.open.append(len(tr.spans))
        tr.spans.append(rec)
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        self.tracer.open.pop()
        return False


class _FrameSpan(_HostSpan):
    """The ``track`` span of one call: its frame id is every nested span's."""

    __slots__ = ("outer",)

    def __init__(self, tracer: "Tracer", fid: int):
        self.outer = tracer.frame
        tracer.frame = fid
        super().__init__(tracer, "track")

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.tracer.frame = self.outer
        return False


class _DeviceSpan:
    __slots__ = ("tracer", "name", "program", "pure", "start")

    def __init__(self, tracer: "Tracer", name: str, program: bool, pure: bool):
        self.tracer, self.name, self.program, self.pure = tracer, name, program, pure

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        tr = self.tracer
        if self.program:
            tr.programs.append((self.name, self.start, end))
        if self.pure:
            tr.pure.append((self.name, self.start, end, torch.cuda.current_device()))
        return False


class Tracer:
    """Spans and counters of one system (module docstring)."""

    def __init__(self):
        self.on = False
        self.cuda = False            # device spans are recorded (a CUDA device was given)
        self.frame: Optional[int] = None
        self.spans: list = []        # [name, start ns, end ns, parent index, frame id]
        self.open: list = []         # indices of the open host spans, innermost last
        self.programs: list = []     # (name, start event, end event)
        self.pure: list = []         # (name, start event, end event, device index)
        self.anchors: Dict[int, tuple] = {}   # device index -> (event, host ns)
        self.counts: Dict[str, int] = {}

    def switch(self, on: bool, devices=()) -> None:
        """Turn tracing on or off.  Turned on, each CUDA device of
        ``devices`` that has no anchor yet is synchronised and gets one."""
        on = bool(on)
        if on and not self.on:
            for dev in devices:
                dev = torch.device(dev)
                if dev.type != "cuda" or dev.index in self.anchors:
                    continue
                torch.cuda.synchronize(dev)
                with torch.cuda.device(dev):
                    anchor = torch.cuda.Event(enable_timing=True)
                    t_ns = time.perf_counter_ns()
                    anchor.record()
                    anchor.synchronize()
                self.anchors[dev.index] = (anchor, t_ns)
            self.cuda = bool(self.anchors)
        self.on = on

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def span(self, name: str):
        """A host span around the ``with`` body."""
        return _HostSpan(self, name) if self.on else _OFF

    def frame_span(self, fid: int):
        """The ``track`` span of frame ``fid``'s call."""
        return _FrameSpan(self, fid) if self.on else _OFF

    def device_span(self, name: str, *, program: bool = False, reads: bool = False):
        """A device span around the ``with`` body's launches: a map-side
        ``program`` goes to ``programs``, and whatever does not ``reads``
        back to ``pure``."""
        return _DeviceSpan(self, name, program, not reads) if self.on and self.cuda else _OFF

    def export(self, counters: dict, since: Optional[dict] = None) -> dict:
        """Everything recorded, after the device has finished it: ``host``
        spans as recorded, ``device`` spans of ``pure`` as [name, start ns,
        end ns] on the host's clock, and ``counters`` (as deltas from
        ``since``, an earlier export's or ``counters`` dict)."""
        device = []
        for name, start, end, dev in self.pure:
            anchor = self.anchors.get(dev)
            if anchor is None:
                continue
            ev, t_ns = anchor
            device.append([name, t_ns + round(ev.elapsed_time(start) * 1e6),
                           t_ns + round(ev.elapsed_time(end) * 1e6)])
        if since is not None:
            counters = {k: v - since.get(k, 0) for k, v in counters.items()}
        return dict(host=[list(s) for s in self.spans], device=device, device_clock=self.cuda,
                    counters=counters)
