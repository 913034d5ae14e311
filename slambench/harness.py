"""One run of one cell: load the cell's configuration, traffic mix and
metrics by the names ``BENCHMARK.json`` gives, set up, drive
``SLAM.track()`` for the window, then judge what the window produced.

Everything that belongs to one configuration, mix or per-layer metric is in
a file of its own under ``slambench/``: ``configs/<config>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py`` (a ``read(record)``
that returns a number or None).  Adding one is adding a file and an entry.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import roofline, timing
from .gen import stream as gen_stream
from .reference import check


# ------------------------------------------------------------------ discovery
def load_cell(root: Path, workload: str) -> dict:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic mix and metrics loaded from their files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    bench_dir = root / bench["paths"][0]
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = dict(m, kind=kind, read=load_reader(bench_dir, m["name"]))
    return dict(
        cell=cell,
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text()),
        metrics=metrics,
    )


def load_reader(bench_dir: Path, name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ the system
def slam_config(config: dict):
    """The port's ``SLAMConfig`` with the configuration file's sections set."""
    from orb_slam2_ros2_tpu_torch.config import SLAMConfig

    cfg = SLAMConfig()
    for section, values in config["slam"].items():
        cur = getattr(cfg, section)
        cfg = cfg.replace(**{section: dataclasses.replace(cur, **values)})
    return cfg


def full_slam_section(cfg) -> dict:
    """The configuration as run, as plain dicts (the reference's input)."""
    return {f.name: dataclasses.asdict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def _counters(slam) -> dict:
    lc = slam.loop_closer
    graphs = lc.graphs if lc is not None else None
    return dict(
        frame_captures=slam._frame_graphs.captures if slam._frame_graphs is not None else 0,
        keyframe_captures=slam._kf_graphs.captures,
        loop_captures=graphs.captures if graphs is not None else 0,
        gba_captures=slam._gba_graphs.captures,
        reloc_captures=slam._reloc_graph.captures,
        host_reads=lc.host_reads if lc is not None else 0,
        keyframes=slam._n_kf,
        closures=slam.loops_closed,
        kf_capacity=slam.map.kf_capacity,
        mp_capacity=slam.map.mp_capacity,
    )


def _map_readings(m, sample: list):
    """What mapping left for the sampled keyframes (CPU tensors): each one's
    pose and, per slot, the point it observes; and every such point's
    position with, per observation, the observing keyframe's pose and
    keypoint (an observation counts where the keyframe is valid and its
    slot names the point back)."""
    if not sample:
        return [], {}
    samples, ids = [], []
    for k in sample:
        idx = m.kf_mp_idx[k]
        safe = idx.clamp(min=0).long()
        ok = (idx >= 0) & m.mp_valid[safe]
        samples.append(dict(kf_Tcw=m.kf_Tcw[k].cpu(), mp_idx=idx.cpu(), mp_pos=m.mp_pos[safe].cpu(), mp_ok=ok.cpu()))
        ids.append(idx[ok].long())
    p = torch.unique(torch.cat(ids))
    kf, feat = m.mp_obs_kf[p].long(), m.mp_obs_feat[p].long()
    kc, fc = kf.clamp(0, m.kf_capacity - 1), feat.clamp(0, m.kf_uv.shape[1] - 1)
    valid = (kf >= 0) & (feat >= 0) & m.kf_valid[kc] & (m.kf_mp_idx[kc, fc].long() == p[:, None])
    points = dict(ids=p, pos=m.mp_pos[p], valid=valid, Tcw=m.kf_Tcw[kc], uv=m.kf_uv[kc, fc], right_u=m.kf_right_u[kc, fc],
                  octave=m.kf_octave[kc, fc])
    return samples, {k: v.cpu() for k, v in points.items()}


# ------------------------------------------------------------------ the run
class _SliceTracer:
    """``torch.profiler`` over window frames [start, end), recording the
    card's activity only (no host operator is recorded; the profiler still
    slows the host's loop, by 20-40% on the card these cells ran on).  The
    slice's edges are two marker kernels
    (``torch.cuda._sleep(1)``) on the current stream, launched before frame
    ``start`` and before frame ``end`` are handed over; the profiler stops
    three calls after the second (the device has then finished the slice's
    work: each call waits for the frame before it).  The host's own spans
    (the handoff and each ``track()`` call) are kept on its clock, so that
    the idle gaps can be labelled by what the host was doing."""

    def __init__(self):
        self.prof, self.state = None, "idle"
        self.marks_ns, self.spans = [], []
        self.frames_in_slice, self.slice_host_s = 0, 0.0

    def _mark(self):
        self.marks_ns.append(time.perf_counter_ns())
        torch.cuda._sleep(1)

    def step(self, k: int, start: int, end: int) -> bool:
        """Start, mark or stop at window frame ``k``; True where the
        profiler was started or stopped."""
        if self.state == "idle" and k == start:
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._mark()
            self.state = "on"
            return True
        if self.state == "on" and k == end:
            self._mark()
            self.frames_in_slice = end - start
            self.slice_host_s = (self.marks_ns[1] - self.marks_ns[0]) / 1e9
            self.state = "ending"
        elif self.state == "ending" and k == end + 3:
            self.close()
            return True
        return False

    def span(self, name: str, t0_ns: int, t1_ns: int) -> None:
        if self.state == "on":
            self.spans.append((t0_ns, t1_ns, name))

    def close(self) -> None:
        """Stop (at the window's close at the latest, the slice ending there)."""
        if self.state == "on":
            self._mark()
            self.slice_host_s = (self.marks_ns[1] - self.marks_ns[0]) / 1e9
        if self.state in ("on", "ending"):
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.state = "done"


def run_cell(loaded: dict, *, seed: int, seconds: float, trace: bool, device, t_start: float,
             control=None, fault=None) -> dict:
    """Set up, measure for ``seconds``, judge.  Returns the result line's
    fields and an ``info`` dict for the earlier line.  ``fault(slam)`` plants
    a fault in the system under test (the tests' check that the comparison
    fails); ``control="fp8"`` judges the reference computed in float8 in
    the program's place instead of the program's frontend (the control that
    has to fail)."""
    from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM

    device = torch.device(device)
    on_card = device.type == "cuda"
    config, traffic = loaded["config"], loaded["traffic"]
    cfg = slam_config(config)
    rgbd = bool(config["rgbd"])
    t_imports = time.perf_counter()
    stream = gen_stream.build(traffic, dataclasses.asdict(cfg.camera), rgbd, seed, seconds, device)
    t_render = time.perf_counter()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    slam = SLAM(cfg, rgbd=rgbd, device=device)
    t_slam = time.perf_counter()
    undo = fault(slam) if fault is not None else None
    fg_spans = timing.EventSpans()
    if trace:
        slam.time_programs = True
        if slam._frame_graphs is not None:
            slam._frame_graphs.run = fg_spans.wrap(slam._frame_graphs.run)
    # warm-up: at least warm_frames frames, and on until warm_keyframes
    # keyframes are in the map (their programs captured), at most
    # warm_max_frames
    n_warm = 0
    while n_warm < traffic["warm_max_frames"] and (
            n_warm < traffic["warm_frames"] or slam._n_kf < traffic["warm_keyframes"]):
        slam.track(*stream.frame(n_warm))
        n_warm += 1
    if on_card:
        torch.cuda.synchronize(device)

    # ---- the window: a closed loop, the next frame handed over when the call returns
    c0, n_ev0, n_fg0 = _counters(slam), len(slam.program_events), len(fg_spans.pairs)
    handed, delivered, lost, closed_at = {}, {}, [], []
    n_closed = slam.loops_closed
    traj_seen = len(slam.trajectory)
    trace_from, trace_to = traffic["trace_frames"]
    tracer = _SliceTracer() if trace and on_card else None
    i = n_warm
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        k = i - n_warm
        if tracer is not None:
            # starting and stopping the profiler is not the system's time:
            # the window is moved on by it
            t_pause = time.perf_counter()
            if tracer.step(k, trace_from, trace_to):
                pause = time.perf_counter() - t_pause
                t0 += pause
                for f in handed:
                    if f not in delivered:
                        handed[f] += pause
        if time.perf_counter() - t0 >= seconds:
            break
        if i >= len(stream):
            raise RuntimeError(f"the stream ran dry: {len(stream)} frames "
                               f"({traffic['ceiling_frames_per_s']} frames/s ceiling) before the "
                               f"{seconds} s window closed; raise the traffic file's ceiling")
        t_prep = time.perf_counter_ns()
        a, b = stream.frame(i)
        t_hand_ns = time.perf_counter_ns()
        pose, stats = slam.track(a, b)
        t_ret_ns = time.perf_counter_ns()
        t_hand, t_ret = t_hand_ns / 1e9, t_ret_ns / 1e9
        if tracer is not None:
            tracer.span("prepare", t_prep, t_hand_ns)
            tracer.span("track", t_hand_ns, t_ret_ns)
        handed[i] = t_hand
        new = slam.trajectory[traj_seen:]
        traj_seen = len(slam.trajectory)
        for fid, _ in new:
            delivered[fid] = t_ret
        if pose is None and not stats.get("pipeline_fill"):
            pending = [f for f in handed if f not in delivered and f not in lost and f < i]
            lost.append(pending[0] if pending else i)
        if slam.loops_closed > n_closed:
            n_closed = slam.loops_closed
            closed_at.append(i)
        i += 1
    t1 = time.perf_counter()
    window_s = t1 - t0
    if tracer is not None:
        tracer.close()
    if on_card:
        torch.cuda.synchronize(device)
    c1 = _counters(slam)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    in_window = sorted(handed)
    done = [f for f in in_window if f in delivered]
    latency_ms = [1000.0 * (delivered[f] - handed[f]) for f in done]
    lost_in_window = [f for f in lost if f in handed]
    record = dict(
        setup_s=setup_s, window_s=window_s, frames_done=len(done), latency_ms=latency_ms,
        keyframes=c1["keyframes"] - c0["keyframes"], closures=c1["closures"] - c0["closures"],
        program_events=[(n, s.elapsed_time(e)) for n, s, e in slam.program_events[n_ev0:]] if trace and on_card
        else [],
        frame_graph_ms=fg_spans.ms(n_fg0) if trace and on_card else [],
    )
    if tracer is not None and tracer.prof is not None:
        t_red = time.perf_counter()
        record.update(timing.reduce_trace(tracer.prof, tracer.marks_ns, tracer.spans))
        record["slice_frames_per_s"] = tracer.frames_in_slice / tracer.slice_host_s if tracer.slice_host_s else None
        tracer.prof = None
        record["trace_reduce_s"] = time.perf_counter() - t_red
    info = dict(
        frames_handed=len(in_window), frames_done=len(done), latency_samples=len(latency_ms),
        in_flight_at_close=len(in_window) - len(done) - len(lost_in_window),
        window_s=window_s, stream_frames=len(stream), warm_frames=n_warm, seed_draws=stream.seed_draws,
        setup_parts_s=dict(imports=t_imports - t_start, render=t_render - t_imports, slam=t_slam - t_render,
                           warm=t0 - t_slam),
        window_counters={k: c1[k] - c0[k] for k in c1}, counters_at_close=c1,
        latency_ms_pcts={str(q): timing.percentile(latency_ms, q) for q in (50, 75, 90, 95, 97.5, 99, 100)},
        trace_reduce_s=record.get("trace_reduce_s"), slice_frames_per_s=record.get("slice_frames_per_s"),
        gap_labels=record.get("gap_labels"), lost_frame_ids=lost_in_window[:200], closures_at_frames=closed_at,
    )

    # ---- after the window: flush, free the program's state, judge
    slam.flush()
    live = list(slam.trajectory)
    final = slam.final_trajectory()
    if callable(undo):
        undo()
    m = slam.map
    kf_valid = m.kf_valid.cpu().numpy()
    kf_frame = m.kf_frame_id.cpu().numpy()
    valid_kfs = [int(k) for k in np.nonzero(kf_valid)[0]]
    window_kfs = [k for k in valid_kfs if int(kf_frame[k]) in handed] or valid_kfs
    rng = gen_stream.seed_rng(seed, 3)
    n_sample = min(int(config["check"]["sample_keyframes"]), len(window_kfs))
    sample = sorted(rng.choice(window_kfs, size=n_sample, replace=False).tolist()) if n_sample else []
    port_feats = [dict(frame=int(kf_frame[k]), **{
        name: getattr(m, f"kf_{name}")[k].cpu() for name in ("uv", "octave", "desc", "right_u", "depth")},
        valid=m.kf_feat_valid[k].cpu()) for k in sample]
    map_samples, map_points = _map_readings(m, sample)
    del slam, m
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    slam_section = full_slam_section(cfg)
    ref_feats, judged, work = [], [], []
    for pf in port_feats:
        a, b = stream.frame(pf["frame"])
        rf = check.reference_features(a, b, slam_section, rgbd, device, "bf16")
        work.append(rf.pop("work"))
        ref_feats.append(rf)
        if control is not None:
            # the control: the reference in a lower precision in the program's place
            cf = check.reference_features(a, b, slam_section, rgbd, device, control)
            cf.pop("work")
            judged.append(cf)
    readings = check.judge(config, slam_section, stream.gt_twc, live, final, judged if control else port_feats,
                           ref_feats, map_samples, map_points, lost_in_window)
    if work:
        record["k1_work"] = work[0]["k1"]
        record["k2_work"] = {"ops": 0.0, "bytes": float(np.mean([w["k2"]["bytes"] for w in work]))}
    record["peaks"] = roofline.PEAKS
    info.update(sampled_keyframes=[pf["frame"] for pf in port_feats], readings_detail=readings["detail"])

    metrics = {}
    for name, m_ in loaded["metrics"].items():
        if (m_["kind"] == "per_layer") != bool(trace):
            continue
        value = m_["read"](record)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": m_["unit"]}
    out = dict(correct=readings["correct"], attempted=len(done) + len(lost_in_window),
               failed=len(lost_in_window), metrics=metrics, memory_peak_bytes=int(memory_peak),
               checks=readings["checks"], info=info)
    if trace and "busy_s" in record:
        out.update(busy_s=record["busy_s"], trace_window_s=record["trace_window_s"],
                   breakdown={"device_ops": record["device_ops"], "idle_gaps": record["idle_gaps"]})
    return out
