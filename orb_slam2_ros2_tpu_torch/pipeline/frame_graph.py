"""The per-frame tracking program and the keyframe programs as captured CUDA
graphs, a generic captured step (``StepGraph``, the odometry step's and the
essential graph's), and the pinned host buffers the frame loop stages
through.

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

The three hand-written kernels launch on ``torch.cuda.current_stream()`` and
K1 takes its level table by value, so a capture records each as it is
(on the H100 a replay runs each once, bit-equal to the eager program).  The
kernel wrappers count a launch where they launch (``fast.fast_nms_launches``,
``patches.patch_launches``, ``brief.brief_launches``): the eager first frame counts, a capture launches
nothing and counts nothing, and a replay — launched by the CUDA graph, not by a
wrapper — counts in ``replays`` only (``chip_smoke.py`` profiles replays to
see the kernels run inside them).

``KeyframeGraphs`` is the counterpart of JAX's jitted ``_map_front``,
``_map_tail_variants``, ``_cull_kfs`` and the split's ``_bookkeep_d1``: the
map-side programs take their ids as int32 [1] tensors and write the map
fields they change into the storage inside the graph (JAX donates the map),
so a replay returns only the local map, the keyframe's row or the frame's
map-side stats.

``RelocGraph`` is the counterpart of JAX's ``_reloc_query_jit`` and
``_reloc_fused`` as one graph: the BoW query and the candidate cascade of a
LOST frame.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..mapstate.map_state import MapState, copy_into
from ..solvers import local_ba
from .trace import Tracer


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


class _Step(NamedTuple):
    graph: Optional[torch.cuda.CUDAGraph]
    inputs: tuple      # static inputs
    in_leaves: list
    outputs: Optional[tuple]


class StepGraph:
    """A program over nested tuples of tensors, captured as one CUDA graph
    per input signature (shapes, dtypes, devices) at its first call, which
    runs eagerly on a side stream and is that call's result; later calls
    copy their inputs into the static ones, replay, and clone the outputs.
    ``fixed`` tensors are passed after the inputs as they are, not copied:
    the graph reads them at their addresses, which the caller keeps.  The
    program must not read the host, and whatever it reads besides its
    inputs (constants, kernel tables) must outlive the graph.  A failing
    capture raises.  ``capture=False`` calls the program on the static
    inputs in place of the replay (the CPU tests).

    ``traced(tracer, graph)`` names the step's graph to a ``Tracer``: a
    first call that captures is a host span ``capture.<graph>``, a replay
    (its copy-in, the graph and the clone-out, no host read) a device span
    ``<graph>_graph`` around a host span ``graph_launch`` (the graph's
    launch), and both are counted."""

    def __init__(self, program: Callable, *, capture: bool = True):
        self.program = program
        self.capture = capture
        self._graphs: Dict[tuple, _Step] = {}
        self.replays = 0
        self.tracer: Optional[Tracer] = None
        self.graph = "step"

    def traced(self, tracer: Optional[Tracer], graph: str) -> "StepGraph":
        self.tracer, self.graph = tracer, graph
        return self

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def __call__(self, *args, fixed: tuple = ()):
        leaves = tree_leaves(args)
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)
        g = self._graphs.get(key)
        if g is None:
            return self._first(key, args, fixed)
        tr = self.tracer
        if tr is None:
            return self._replay(g, leaves, fixed)
        tr.count(f"replays.{self.graph}")
        with tr.device_span(f"{self.graph}_graph"):
            return self._replay(g, leaves, fixed, tr)

    def _replay(self, g: _Step, leaves: list, fixed: tuple, tr: Optional[Tracer] = None):
        torch._foreach_copy_(g.in_leaves, leaves)
        if g.graph is not None:
            with tr.span("graph_launch") if tr is not None else contextlib.nullcontext():
                g.graph.replay()
            outputs = g.outputs
        else:
            outputs = self.program(*g.inputs, *fixed)
        self.replays += 1
        return tree_map(torch.clone, outputs)

    def _first(self, key, args, fixed: tuple):
        statics = tree_map(torch.clone, args)
        if not self.capture:
            self._graphs[key] = _Step(None, statics, tree_leaves(statics), None)
            return self(*args, fixed=fixed)
        tr = self.tracer
        if tr is not None:
            tr.count(f"captures.{self.graph}")
        with tr.span(f"capture.{self.graph}") if tr is not None else contextlib.nullcontext():
            dev = tree_leaves(args)[0].device
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                result = self.program(*statics, *fixed)
            main.wait_stream(side)
            for t in tree_leaves(result):
                t.record_stream(main)
            graph = torch.cuda.CUDAGraph()
            with _capturing(), torch.cuda.graph(graph):
                outputs = self.program(*statics, *fixed)
        self._graphs[key] = _Step(graph, statics, tree_leaves(statics), outputs)
        return result


class FrameGraphs:
    """A frame program captured per (``proj_th``, input signatures): one
    ``StepGraph`` a threshold, whose inputs are the frame's tensors and the
    reference keyframe as an int32 [1] tensor, with the map storage passed
    as ``fixed``.

    ``program(img_l, img_r, last, velocity, local, mapstate, ref_kf, *,
    proj_th)`` returns a tuple of tensors (``SLAM.frame_program`` without
    its map, or the split's tracker program, whose ``mapstate`` is the
    published map view); ``mapstate`` is storage at fixed addresses.
    ``run`` takes the same arguments (``ref_kf`` a host int) and returns
    the program's outputs, tensors the caller owns.  ``tracer`` names its
    steps' graph ``frame`` (``StepGraph.traced``)."""

    def __init__(self, program: Callable, *, capture: bool = True):
        self.program = program
        self.capture = capture
        self.tracer: Optional[Tracer] = None
        self._steps: Dict[float, tuple] = {}   # proj_th -> (StepGraph, map storage pointers)
        self.replays = 0
        self.capture_log: list = []   # (proj_th, image shapes) of each capture

    @property
    def captures(self) -> int:
        """Graphs captured (static buffers allocated) so far."""
        return len(self.capture_log)

    def clear(self) -> None:
        """Drop every graph: the map storage was re-allocated."""
        self._steps.clear()

    def _step(self, proj_th: float, map_ptrs: tuple) -> StepGraph:
        entry = self._steps.get(proj_th)
        if entry is None:
            program = self.program

            def frame(img_l, img_r, last, velocity, local, ref_kf, mapstate):
                return program(img_l, img_r, last, velocity, local, mapstate, ref_kf, proj_th=proj_th)

            entry = self._steps[proj_th] = (StepGraph(frame, capture=self.capture).traced(self.tracer, "frame"),
                                            map_ptrs)
        if entry[1] != map_ptrs:
            raise RuntimeError("the map storage moved under a captured frame graph")
        return entry[0]

    def run(self, img_l, img_r, last, velocity, local, mapstate, ref_kf: int, *, proj_th: float):
        step = self._step(proj_th, tuple(t.data_ptr() for t in mapstate))
        ref = id_tensor(ref_kf, img_l.device)
        captures, replays = step.captures, step.replays
        out = step(img_l, img_r, last, velocity, local, ref, fixed=(mapstate,))
        if step.captures > captures:
            self.capture_log.append((proj_th, tuple(img_l.shape), tuple(img_r.shape)))
        self.replays += step.replays - replays
        return out


def held_addresses(held: Optional[tuple], tensors, what: str, graph: str) -> tuple:
    """The data pointers of ``tensors`` (``what``), which a captured
    ``graph`` reads at fixed addresses: they must equal ``held`` unless
    nothing is held yet."""
    ptrs = tuple(t.data_ptr() for t in tensors)
    if held is not None and ptrs != held:
        raise RuntimeError(f"{what} moved under a captured {graph}")
    return ptrs


def donating(program: Callable, nbytes: dict, key) -> Callable:
    """``program(storage, *inputs) -> (new map, *outputs)`` as a
    ``StepGraph`` program over ``(*inputs, storage)``: it writes the fields
    of the new map that changed into the storage (``copy_into``, inside the
    graph: JAX donates the map) and returns only the outputs, an output
    that views the storage cloned before the write; the bytes it writes go
    to ``nbytes[key]``."""

    def donated(*args):
        *ins, storage = args
        new, *outs = program(storage, *ins)
        held = {t.untyped_storage().data_ptr() for t in storage}
        outs = tree_map(lambda t: t.clone() if t.untyped_storage().data_ptr() in held else t, tuple(outs))
        nbytes[key] = copy_into(storage, new)
        return outs

    return donated


def id_tensor(v, device) -> torch.Tensor:
    """An id (host int or tensor) as an int32 [1] tensor on ``device``; a
    host int is filled in by a kernel, not copied from the host."""
    if torch.is_tensor(v):
        return v.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(v), dtype=torch.int32, device=device)


class KeyframeGraphs:
    """The map-side programs, each one ``StepGraph``: the keyframe front
    program, each ``(do_ba, do_cull)`` variant of the tail that is asked
    for, the keyframe cull of an aborted BA (``SLAM._flush_pending``), and
    the split's per-frame bookkeeping.

    ``front(mapstate, frame, Tcw, mp_ids, fid, kf_id)``, ``tail(mapstate,
    kf_id, do_ba, do_cull)``, ``cull(mapstate, kf_id)`` and
    ``bookkeep(mapstate, local, mp_ids, visible, found, ref_kf)`` are the
    eager programs (``SLAM.map_front_program``, ``map_tail_program``,
    ``_cull_kfs``, ``bookkeep_program``), which return a new map first.
    Here the ids go in as
    int32 [1] tensors and the map storage as ``fixed``; each captured
    program writes the fields it changed into the storage, inside the graph
    (JAX donates the map), and returns only its small outputs, so no replay
    clones a whole map.  ``copied_bytes`` counts the bytes written into the
    storage.  A storage of other shapes needs ``clear()`` first.  ``tracer``
    names the steps' graph ``keyframe``."""

    def __init__(self, front: Callable, tail: Callable, cull: Callable, bookkeep: Callable, *,
                 capture: bool = True):
        self._front, self._tail, self._cull, self._bookkeep = front, tail, cull, bookkeep
        self.capture = capture
        self.tracer: Optional[Tracer] = None
        self._steps: Dict[object, StepGraph] = {}
        self._map_ptrs: Optional[tuple] = None
        self._bytes: Dict[object, int] = {}   # bytes each program writes into the storage
        self.copied_bytes = 0

    @property
    def captures(self) -> int:
        return sum(s.captures for s in self._steps.values())

    @property
    def replays(self) -> int:
        return sum(s.replays for s in self._steps.values())

    def clear(self) -> None:
        """Drop every graph: the map storage was re-allocated."""
        self._steps.clear()
        self._map_ptrs = None

    def _run(self, key, program: Callable, mapstate: MapState, *inputs):
        self._map_ptrs = held_addresses(self._map_ptrs, mapstate, "the map storage", "keyframe graph")
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = StepGraph(donating(program, self._bytes, key),
                                                capture=self.capture).traced(self.tracer, "keyframe")
        out = step(*inputs, fixed=(mapstate,))
        self.copied_bytes += self._bytes[key]
        return out

    def map_front(self, mapstate: MapState, frame, Tcw, mp_ids, fid, kf_id):
        """Insert the keyframe and run the front half into the storage.
        Returns (local, the keyframe's fused mp_ids, its Tcw)."""
        dev = mapstate.kf_Tcw.device
        return self._run("map_front", self._front, mapstate, frame, Tcw, mp_ids,
                         id_tensor(fid, dev), id_tensor(kf_id, dev))

    def map_tail(self, mapstate: MapState, kf_id, do_ba: bool, do_cull: bool):
        """The ``(do_ba, do_cull)`` tail into the storage; returns the local
        map.  ``local_ba.local_ba_runs`` counts one BA a run, as the eager
        program does (a capture runs the program twice, a replay never)."""
        tail = self._tail
        runs = local_ba.local_ba_runs
        (local,) = self._run(("map_tail", do_ba, do_cull),
                             lambda m, k: tail(m, k, do_ba, do_cull),
                             mapstate, id_tensor(kf_id, mapstate.kf_Tcw.device))
        local_ba.local_ba_runs = runs + int(do_ba)
        return local

    def cull_kfs(self, mapstate: MapState, kf_id) -> None:
        """The keyframe cull into the storage."""
        cull = self._cull
        self._run("cull_kfs", lambda m, k: (cull(m, k),), mapstate,
                  id_tensor(kf_id, mapstate.kf_Tcw.device))

    def bookkeep(self, mapstate: MapState, local, mp_ids, visible, found, ref_kf):
        """The split's map side of a frame into the storage: the tracking
        counters bumped there.  ``local`` is the published local map and
        ``mp_ids`` / ``visible`` / ``found`` the frame's, on the storage's
        device.  Returns (the map-side stats [19], the frame-centred local
        map)."""
        return self._run("bookkeep", self._bookkeep, mapstate, local, mp_ids, visible, found,
                         id_tensor(ref_kf, mapstate.kf_Tcw.device))


class RelocGraph:
    """The relocalization program — BoW query, candidates and the batched
    cascade — as one ``StepGraph``.  ``program(frame, u, db, mapstate,
    vocab)`` returns (packed [C, 19], cur_mp [C, N]); the frame, the RANSAC's
    uniform draw ``u`` and the keyframe database are copied in (the database
    is rebound at every keyframe registration), the map storage and the
    vocabulary are read at their addresses (``fixed``), which must not move
    until ``clear()``.  The program reads nothing back, so a warm-up call on
    any frame captures what a LOST frame replays.  ``tracer`` names the
    step's graph ``reloc``."""

    def __init__(self, program: Callable, *, capture: bool = True):
        self.program = program
        self.capture = capture
        self.tracer: Optional[Tracer] = None
        self.clear()

    def clear(self) -> None:
        """Drop the graph: the map storage or the vocabulary was replaced."""
        self._step: Optional[StepGraph] = None   # built at the next call
        self._ptrs: Optional[tuple] = None

    @property
    def captures(self) -> int:
        return self._step.captures if self._step is not None else 0

    @property
    def replays(self) -> int:
        return self._step.replays if self._step is not None else 0

    def __call__(self, frame, u: torch.Tensor, db, mapstate: MapState, vocab):
        self._ptrs = held_addresses(self._ptrs, tree_leaves((mapstate, vocab)),
                                    "the map storage or the vocabulary", "relocalization graph")
        if self._step is None:
            self._step = StepGraph(self.program, capture=self.capture).traced(self.tracer, "reloc")
        return self._step(frame, u, db, fixed=(mapstate, vocab))


class _Slot:
    __slots__ = ("buf", "event")

    def __init__(self, shape, dtype):
        self.buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.event = torch.cuda.Event()


class PinnedRing:
    """A few pinned host buffers per (shape, dtype), allocated once and used
    in turn, each behind the event of its last copy: images go to the card
    and stats vectors come back with ``non_blocking`` copies, where a copy
    from or to pageable memory would wait for all work queued before it.
    With a ``tracer`` on, the wait for a slot is a span ``pinned_wait``, and
    a wait that blocked is counted (``pinned_waits``, ``pinned_wait_ns``)."""

    def __init__(self, device, n_slots: int = 4):
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.tracer: Optional[Tracer] = None
        self._rings: Dict[tuple, list] = {}

    def _slot(self, shape, dtype) -> _Slot:
        key = (tuple(shape), dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [[_Slot(shape, dtype) for _ in range(self.n_slots)], 0]
        slots, i = ring
        ring[1] = (i + 1) % len(slots)
        slot = slots[i]
        tr = self.tracer
        if tr is None or not tr.on:
            slot.event.synchronize()   # its previous copy is done
            return slot
        with tr.span("pinned_wait"):
            if not slot.event.query():
                t0 = time.perf_counter_ns()
                slot.event.synchronize()
                tr.count("pinned_waits")
                tr.count("pinned_wait_ns", time.perf_counter_ns() - t0)
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
        from .loop_closing import HostCopy   # loop_closing imports this module

        slot = self._slot(t.shape, t.dtype)
        return HostCopy(t, slot.buf, slot.event)
