"""Where the full SLAM host loop's time goes, call by call (port of the
repository's ``profile_loop.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_loop [--frames 80] [--warm 40]

Full SLAM (loop closing on, ``th_depth=60``) on the KITTI-like world
(``box_scale=2.5``, sky) of ``bench_full.py``: WARM frames, then N frames
whose ``track()`` calls are split, without any added synchronisation, into

* ``pre`` — host time up to the frame's one read (the images' upload, the
  frame graph's input copies, replay and output clones dispatched);
* ``fetch`` — the first ``.cpu()`` of a device tensor inside the call
  (``host_vec.cpu()``, the one synchronisation of a frame: it waits for the
  frame's device work);
* ``post`` — host time after it (keyframe decision, keyframe programs, the
  mapping tail, loop stages).

Medians of each part are printed by class of call: ``track``, ``tail``
(the deferred mapping tail ran), ``kf`` (a keyframe was inserted).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..pipeline.system import SLAM
from . import _frames, _timing


class _FirstRead:
    """Marks the first ``Tensor.cpu()`` of a device tensor while active."""

    def __init__(self):
        self.marks: dict = {}
        self._real = torch.Tensor.cpu

    def __enter__(self):
        real, marks = self._real, self.marks

        def cpu(t, *a, **kw):
            if t.device.type == "cpu" or "t0" in marks:
                return real(t, *a, **kw)
            marks["t0"] = time.perf_counter()
            out = real(t, *a, **kw)
            marks["t1"] = time.perf_counter()
            return out

        torch.Tensor.cpu = cpu
        return self

    def __exit__(self, *exc):
        torch.Tensor.cpu = self._real


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_loop", __doc__)
    ap.add_argument("--frames", type=int, default=80, help="N split frames (JAX: 80)")
    ap.add_argument("--warm", type=int, default=40, help="frames before them (JAX: 40)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _frames.with_th_depth(_timing.load_config(args.config))
    frames = _frames.render(cfg, args.frames + args.warm, dev, box_scale=2.5, sky=True)
    slam = SLAM(cfg, device=dev)
    tracked = sum(slam.track(il, ir)[0] is not None for il, ir in frames[:args.warm])
    slam.flush()

    rows = []
    with _FirstRead() as fr:
        for il, ir in frames[args.warm:]:
            fr.marks.clear()
            n_kf, pending = slam._n_kf, slam._pending_kf is not None
            t0 = time.perf_counter()
            pose, _ = slam.track(il, ir)
            t1 = time.perf_counter()
            tracked += pose is not None
            f0, f1 = fr.marks.get("t0", t1), fr.marks.get("t1", t1)
            rows.append({"cls": "kf" if slam._n_kf > n_kf else ("tail" if pending else "track"),
                         "pre": (f0 - t0) * 1e3, "fetch": (f1 - f0) * 1e3, "post": (t1 - f1) * 1e3,
                         "total": (t1 - t0) * 1e3})
    slam.flush()
    _timing.note_slam(slam)

    classes = {}
    for cls in ("track", "tail", "kf"):
        sel = [r for r in rows if r["cls"] == cls]
        if sel:
            classes[cls] = {k: float(np.median([r[k] for r in sel])) for k in ("pre", "fetch", "post", "total")}
            classes[cls]["n"] = len(sel)
    out = {"frames": args.frames, "warm": args.warm, "tracked": tracked, "total_frames": len(frames),
           "keyframes": slam.n_keyframes, "classes": classes,
           "all_mean_ms": float(np.mean([r["total"] for r in rows]))}
    del slam
    _timing.release(dev)
    return _timing.emit("profile_loop", dev, out)


if __name__ == "__main__":
    main()
