"""The per-frame tracking program as captured CUDA graphs, and the pinned host
buffers the frame loop stages through.

``FrameGraphs`` is the counterpart of the JAX package's jitted ``_frame`` and
``_frame_reloc`` programs (``orb_slam2_ros2_tpu/pipeline/system.py``): the
eager ``SLAM.frame_program`` is ~10⁴ small launches, and ``jax.jit`` hands the
JAX system one compiled program a frame.  Here the program is captured once
per projection-search threshold (3.0 while tracking, 5.0 on the frame after a
relocalization) and image signature, and each frame replays it:

* static inputs — the two images, ``last`` (``SlamFrame``), ``velocity``,
  ``local`` (``LocalMap``) and the reference keyframe as an int32 [1] tensor —
  are copied in before the replay;
* the map is read (and its tracking counters bumped) at the addresses of the
  SLAM's persistent map storage, which keyframe programs copy their results
  into, so a keyframe needs no new capture; a capacity change re-allocates
  that storage and drops the graphs;
* a replay overwrites the static outputs, so every output is cloned after it
  (a pipelined frame's outputs must outlive the next frame's replay).

The first frame of a graph runs the program eagerly on a side stream (the
warm-up ``torch.cuda.graphs`` asks for; it also builds the kernels and runs
K1's one-time occupancy query), and that run is the frame's result; the
capture follows.  A failing capture or replay raises: there is no eager
fallback on CUDA.  ``capture=False`` runs the same static-buffer wrapper with
the program called eagerly in place of the replay (the CPU tests).

The two hand-written kernels launch on ``torch.cuda.current_stream()`` and
K1 takes its level table by value, so a capture records both as they are
(on the H100 a replay runs each once, bit-equal to the eager program).  The
kernel wrappers count a launch where they launch (``fast.fast_nms_launches``,
``patches.patch_launches``): the eager first frame counts, a capture launches
nothing and counts nothing, and a replay — launched by the CUDA graph, not by a
wrapper — counts in ``replays`` only (``chip_smoke.py`` profiles replays to
see the kernels run inside them).
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .loop_closing import HostCopy


def tree_leaves(x) -> list:
    """The tensors of nested tuples / NamedTuples, in order."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tree_leaves(v)]
    return []


def tree_map(fn: Callable, x):
    """``fn`` applied to every tensor of nested tuples / NamedTuples."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def _signature(img: torch.Tensor) -> tuple:
    return tuple(img.shape), img.dtype


@contextlib.contextmanager
def _capturing():
    """Around a capture: the sync debug mode off (``torch.cuda.graph``
    synchronises the device before it captures; that synchronisation is the
    capture's own, not the frame program's), and Python's cyclic garbage
    collector paused — a collection during the capture could free another
    SLAM's graph, and destroying a graph while a stream captures invalidates
    the capture (seen on the card)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if gc_was_enabled:
            gc.enable()
        torch.cuda.set_sync_debug_mode(prev)


class _Captured(NamedTuple):
    graph: Optional[torch.cuda.CUDAGraph]
    inputs: tuple             # static (img_l, img_r, last, velocity, local)
    in_leaves: list
    ref_kf: torch.Tensor      # static int32 [1]
    outputs: Optional[tuple]  # the program's static outputs
    map_ptrs: tuple           # the map storage the graph reads


class FrameGraphs:
    """A frame program captured per (``proj_th``, image signatures).

    ``program(img_l, img_r, last, velocity, local, mapstate, ref_kf, *,
    proj_th)`` returns a tuple of tensors (``SLAM.frame_program`` without
    its map, or the split's tracker program, whose ``mapstate`` is the
    published map view); ``mapstate`` is storage at fixed addresses.
    ``run`` takes the same arguments (``ref_kf`` a host int) and returns
    the program's outputs, tensors the caller owns."""

    def __init__(self, program: Callable, *, capture: bool = True):
        self.program = program
        self.capture = capture
        self._graphs: Dict[tuple, _Captured] = {}
        self.replays = 0
        self.capture_log: list = []   # (proj_th, image shapes) of each capture

    @property
    def captures(self) -> int:
        """Graphs captured (static buffers allocated) so far."""
        return len(self.capture_log)

    def clear(self) -> None:
        """Drop every graph: the map storage was re-allocated."""
        self._graphs.clear()

    def run(self, img_l, img_r, last, velocity, local, mapstate, ref_kf: int, *, proj_th: float):
        key = (proj_th, _signature(img_l), _signature(img_r))
        g = self._graphs.get(key)
        if g is None:
            return self._first(key, (img_l, img_r, last, velocity, local), mapstate, ref_kf, proj_th)
        if g.map_ptrs != tuple(t.data_ptr() for t in mapstate):
            raise RuntimeError("the map storage moved under a captured frame graph")
        torch._foreach_copy_(g.in_leaves, tree_leaves((img_l, img_r, last, velocity, local)))
        g.ref_kf.fill_(int(ref_kf))
        if g.graph is not None:
            g.graph.replay()
            outputs = g.outputs
        else:
            outputs = self.program(*g.inputs, mapstate, g.ref_kf, proj_th=proj_th)
        self.replays += 1
        return tree_map(torch.clone, outputs)

    def _first(self, key, inputs, mapstate, ref_kf: int, proj_th: float):
        """Allocate the static inputs, run the frame eagerly on them (on a
        side stream for a capture), then capture; returns the eager run."""
        statics = tree_map(torch.clone, inputs)
        dev = inputs[0].device
        ref = torch.full((1,), int(ref_kf), dtype=torch.int32, device=dev)
        map_ptrs = tuple(t.data_ptr() for t in mapstate)
        self.capture_log.append((proj_th, key[1][0], key[2][0]))
        if not self.capture:
            self._graphs[key] = _Captured(None, statics, tree_leaves(statics), ref, None, map_ptrs)
            return self.run(*inputs, mapstate, ref_kf, proj_th=proj_th)

        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = self.program(*statics, mapstate, ref, proj_th=proj_th)
        main.wait_stream(side)
        for t in tree_leaves(result):
            t.record_stream(main)

        graph = torch.cuda.CUDAGraph()
        with _capturing(), torch.cuda.graph(graph):
            outputs = self.program(*statics, mapstate, ref, proj_th=proj_th)
        self._graphs[key] = _Captured(graph, statics, tree_leaves(statics), ref, outputs, map_ptrs)
        return result


class _Slot:
    __slots__ = ("buf", "event")

    def __init__(self, shape, dtype):
        self.buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.event = torch.cuda.Event()


class PinnedRing:
    """A few pinned host buffers per (shape, dtype), allocated once and used
    in turn, each behind the event of its last copy: images go to the card
    and stats vectors come back with ``non_blocking`` copies, where a copy
    from or to pageable memory would wait for all work queued before it."""

    def __init__(self, device, n_slots: int = 4):
        self.device = torch.device(device)
        self.n_slots = n_slots
        self._rings: Dict[tuple, list] = {}

    def _slot(self, shape, dtype) -> _Slot:
        key = (tuple(shape), dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [[_Slot(shape, dtype) for _ in range(self.n_slots)], 0]
        slots, i = ring
        ring[1] = (i + 1) % len(slots)
        slot = slots[i]
        slot.event.synchronize()   # its previous copy is done
        return slot

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device, through the next pinned slot."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        slot = self._slot(src.shape, src.dtype)
        slot.buf.copy_(src)
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        out.copy_(slot.buf, non_blocking=True)
        slot.event.record()
        return out

    def to_host(self, t: torch.Tensor) -> HostCopy:
        """Start copying a device tensor to the next pinned slot; the slot
        is reused ``n_slots`` copies later."""
        slot = self._slot(t.shape, t.dtype)
        return HostCopy(t, slot.buf, slot.event)
