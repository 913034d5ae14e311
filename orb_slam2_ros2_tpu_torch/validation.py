"""The adversarial validation harness (port of the repository's
``validation.py``)::

    python -m orb_slam2_ros2_tpu_torch.validation [--frames 400] [--lap 150]
        [--device cuda] [--config cfg.yaml] [--out result.json]

Three runs at ``SLAMConfig()`` (or ``--config``), on ``--device``:

- the benign baseline: the closed circle of ``SyntheticStereoDataset``,
  ``lap + lap // 2`` frames (one lap and half a revisit);
- the adversarial multi-lap world (``AdversarialStereoDataset``: depthless
  sky, moving distractors, exposure flicker, a repeated-texture wall),
  ``--frames`` frames at ``--lap`` frames a lap: live and final ATE, loop
  precision and recall over closure opportunities, the post-closure laps
  that stay localized;
- the kidnapping test on the adversarial map: tracking forced LOST at 12
  frames sampled around the lap, each offered once for relocalization.

Prints one JSON line (the JAX harness's keys, and the closures' frames);
writes it to ``--out`` when given, and nothing else.  The metric functions below have the definitions
of the JAX harness, loop recall included (closure opportunities: revisit
laps entered while the loop was still open), so that the two packages'
numbers compare.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

import numpy as np

from .config import SLAMConfig
from .io.synthetic import AdversarialStereoDataset, SyntheticStereoDataset
from .io.trajectory import ate_rmse, umeyama_align
from .pipeline.tracking import TrackState

T0 = time.time()


def log(msg: str) -> None:
    print(f"[validation {time.time() - T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def run_sequence(slam, ds, n_frames: int, track: Optional[Callable] = None):
    """Track a sequence; returns (est Twc or None a frame, gt Twc, the frames
    at which the closure count rose, frames lost).  ``track(img_l, img_r)``
    replaces ``slam.track``."""
    track = track or slam.track
    est, gt, closures, lost = [], [], [], 0
    prev_loops = 0
    for i in range(n_frames):
        imgL, imgR, Twc_gt = ds.frame(i)
        Tcw, _ = track(imgL, imgR)
        if Tcw is None:
            lost += 1
            est.append(None)
        else:
            est.append(np.linalg.inv(Tcw))
        gt.append(Twc_gt)
        if slam.loops_closed > prev_loops:
            closures.append(i)
            prev_loops = slam.loops_closed
    slam.flush()
    return est, gt, closures, lost


def ate_of(est, gt) -> float:
    """Live ATE over the frames that returned a pose (nan under 10)."""
    pairs = [(e, g) for e, g in zip(est, gt) if e is not None]
    if len(pairs) < 10:
        return float("nan")
    return float(ate_rmse([p[0] for p in pairs], [p[1] for p in pairs]))


def ate_final_of(slam, gt) -> float:
    """ATE of the final exported trajectory (the reference's
    SaveTrajectoryKITTI: relative frame poses composed with the final
    keyframe poses, so the closure's and the GBA's corrections apply to the
    whole path)."""
    fin = dict(slam.final_trajectory())
    pairs = [(np.linalg.inv(fin[i]), g) for i, g in enumerate(gt) if i in fin]
    if len(pairs) < 10:
        return float("nan")
    return float(ate_rmse([p[0] for p in pairs], [p[1] for p in pairs]))


def loop_precision_recall(slam, est, gt, closures, frames_per_lap: int, n_frames: int):
    """Precision: accepted closures whose revisit of the previous lap's pose
    lies within 3 m.  Recall: revisit laps (2nd+) entered while the loop was
    still open that produced a true closure.  After the first true closure
    the later laps must stay localized instead: ≥ 90% of their frames posed
    with a median error under 3 m after one Umeyama alignment of the whole
    trajectory.  Returns (precision, recall, accepted, true, opportunity
    laps, laps with a true closure, post-closure laps, of them localized)."""
    tp = 0
    for i in closures:
        j = i - frames_per_lap
        if j < 0:
            continue  # a closure before any revisit is a false positive
        if np.linalg.norm(gt[i][:3, 3] - gt[j][:3, 3]) < 3.0:
            tp += 1
    n_acc = len(closures)
    precision = tp / n_acc if n_acc else float("nan")
    windows = {i // frames_per_lap for i in range(frames_per_lap, n_frames)}
    true_frames = [i for i in closures if i >= frames_per_lap
                   and np.linalg.norm(gt[i][:3, 3] - gt[i - frames_per_lap][:3, 3]) < 3.0]
    first_true = min(true_frames) if true_frames else n_frames
    opportunity = {w for w in windows if w * frames_per_lap <= first_true}
    laps_hit = len({i // frames_per_lap for i in true_frames} & opportunity)
    recall = laps_hit / len(opportunity) if opportunity else float("nan")
    est_by = {i: e for i, e in enumerate(est) if e is not None}
    if est_by:
        src = np.stack([e[:3, 3] for e in est_by.values()])
        dst = np.stack([gt[i][:3, 3] for i in est_by])
        s_, R_, t_ = umeyama_align(src, dst)
        est_by = {i: (s_ * (R_ @ e[:3, 3]) + t_) for i, e in est_by.items()}
    localized = 0
    post = sorted(windows - opportunity)
    for w in post:
        fr = range(w * frames_per_lap, min((w + 1) * frames_per_lap, n_frames))
        errs = [np.linalg.norm(est_by[i] - gt[i][:3, 3]) for i in fr if i in est_by]
        if len(errs) >= 0.9 * len(fr) and np.median(errs) < 3.0:
            localized += 1
    return (precision, recall, n_acc, tp, len(opportunity), laps_hit, len(post), localized)


def reloc_success(slam, ds, frames_per_lap: int, n_frames: int, est, n_attempts: int = 12,
                  seed: int = 3, track: Optional[Callable] = None):
    """Kidnapping test: force LOST, offer one frame sampled from the tracked
    frames of the last three quarters of the run, count the
    relocalizations at the right place — the matched keyframe's lap angle
    within an eighth of a lap of the query frame's (robust to map-frame
    corrections committed after the run).  Returns (success rate,
    attempts)."""
    track = track or slam.track
    rng = np.random.default_rng(seed)
    kf_frame_id = slam.map.kf_frame_id.cpu().numpy()
    ok = 0
    pool = np.asarray([i for i in range(n_frames // 4, n_frames) if est[i] is not None], np.int64)
    for i in rng.choice(pool, size=min(n_attempts, len(pool)), replace=False):
        slam.state = TrackState.LOST
        imgL, imgR, _ = ds.frame(int(i))
        Tcw, stats = track(imgL, imgR)
        if Tcw is None or "reloc_kf" not in stats:
            continue
        d = abs(int(kf_frame_id[stats["reloc_kf"]]) - int(i)) % frames_per_lap
        d = min(d, frames_per_lap - d)
        ok += d <= frames_per_lap // 8
    return ok / n_attempts, n_attempts


def _round(x: float, nd: int = 3):
    return round(x, nd) if x == x else None


def main(argv=None) -> dict:
    from .pipeline.system import SLAM

    ap = argparse.ArgumentParser(prog="orb_slam2_ros2_tpu_torch.validation")
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--lap", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="torch device to render and track on")
    ap.add_argument("--config", default="", help="YAML config (default: SLAMConfig())")
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    cfg = SLAMConfig.from_yaml(args.config) if args.config else SLAMConfig()
    results = {}

    log("benign baseline run…")
    n_b = args.lap + args.lap // 2
    ds_b = SyntheticStereoDataset(cfg.camera, n_frames=n_b, circle=True, device=args.device)
    slam_b = SLAM(cfg, device=args.device)
    est, gt, closures, lost = run_sequence(slam_b, ds_b, n_b)
    results["benign"] = dict(
        frames=n_b, lost=lost, ate=_round(ate_of(est, gt)), ate_final=_round(ate_final_of(slam_b, gt)),
        keyframes=slam_b.n_keyframes, loops=len(closures),
    )
    log(f"benign: {results['benign']}")
    del slam_b

    log("adversarial run…")
    ds_a = AdversarialStereoDataset(cfg.camera, n_frames=args.frames, frames_per_lap=args.lap,
                                    device=args.device)
    slam_a = SLAM(cfg, device=args.device)
    est, gt, closures, lost = run_sequence(slam_a, ds_a, args.frames)
    prec, rec, n_acc, tp, n_opp, laps_hit, n_post, n_loc = loop_precision_recall(
        slam_a, est, gt, closures, args.lap, args.frames)
    results["adversarial"] = dict(
        frames=args.frames, lost=lost, ate=_round(ate_of(est, gt)),
        ate_final=_round(ate_final_of(slam_a, gt)), keyframes=slam_a.n_keyframes,
        loop_closures_accepted=n_acc, loop_true_positives=tp, loop_precision=_round(prec),
        closure_opportunity_laps=n_opp, laps_with_true_closure=laps_hit, loop_recall=_round(rec),
        post_closure_laps=n_post, post_closure_laps_localized=n_loc, closure_frames=closures,
    )
    log(f"adversarial: {results['adversarial']}")

    log("reloc kidnapping test…")
    rate, n_att = reloc_success(slam_a, ds_a, args.lap, args.frames, est)
    results["reloc"] = dict(success_rate=_round(rate), attempts=n_att)
    log(f"reloc: {results['reloc']}")
    line = json.dumps(results)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return results


if __name__ == "__main__":
    main()
