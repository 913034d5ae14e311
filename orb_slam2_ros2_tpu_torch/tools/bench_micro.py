"""Microbenchmarks of frontend formulations (port of the repository's
``bench_micro.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.bench_micro [--frames 10] [--reps 3] [--height 376] [--width 1241]

On T random 2×H×W images (uniform 0-255 from ``numpy.random.default_rng
(0)``, as JAX), each formulation captured as one graph and replayed over the
T frames:

* FAST+NMS three ways over the stereo pyramid: K1 once over the canvas
  holding both pyramids (the production call); K1 per level and image
  through ``fast_score_nms_dispatch`` (16 launches); and the plain twin,
  ``nms3(fast_score(level))``, which the production path never runs;
* the pyramid three ways: the matmul pyramid batched over both images, the
  same twice on one image, and ``F.interpolate`` (bilinear, antialiased) level
  after level as the counterpart of ``jax.image.resize``;
* ``select_keypoints`` (616 slots, border 23, 32-px cells) batched over
  both images against a Python loop, each behind K1 at level 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fast
from ..ops.canvas import build_canvas, canvas_layout, padded_canvas_shape
from ..ops.pyramid import build_pyramid, level_shapes, pyramid_weights
from . import _timing

N_LEVELS, SCALE, TH = 8, 1.2, 7.0
SELECT = dict(border=23, cell=32, topk_per_cell=4, strong_threshold=20.0)
CAPACITY = 616


def main(argv=None) -> dict:
    ap = _timing.base_parser("bench_micro", __doc__)
    ap.add_argument("--frames", type=int, default=10, help="T frames a pass (JAX: 10)")
    ap.add_argument("--reps", type=int, default=3, help="passes; the best is kept (JAX: 3)")
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--width", type=int, default=1241)
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    H, W = args.height, args.width
    r = np.random.default_rng(0)
    stack = torch.from_numpy(r.uniform(0, 255, (args.frames, 2, H, W)).astype(np.float32)).to(dev)
    weights = pyramid_weights(H, W, N_LEVELS, SCALE, dev)
    shapes = level_shapes(H, W, N_LEVELS, SCALE)
    row_off, _, _ = canvas_layout(H, W, N_LEVELS, SCALE)
    rows_p, cols_p = padded_canvas_shape(H, W, N_LEVELS, SCALE)
    table = fast.pyramid_table(tuple(row_off.tolist()), tuple(shapes), 2, rows_p, cols_p)

    # FAST inputs: each frame's pyramid and its canvas, made outside the timing
    pyrs = [build_pyramid(x, N_LEVELS, SCALE, weights) for x in stack]
    canvases = [torch.cat([build_canvas([lv[b] for lv in p], cols_p, rows_p) for b in range(2)]) for p in pyrs]

    def resize(x):
        out = []
        for b in range(2):
            lv = [x[b].to(torch.bfloat16)]
            for hl, wl in shapes[1:]:
                lv.append(F.interpolate(lv[-1].float()[None, None], size=(hl, wl), mode="bilinear",
                                        align_corners=False, antialias=True)[0, 0].to(torch.bfloat16))
            out += lv
        return out

    def score0(x):
        return fast.fast_score_nms_dispatch(x.to(torch.bfloat16), TH)

    runs = {
        "fast_nms_k1_canvas": ([(c,) for c in canvases], lambda c: fast.fast_score_nms_pyramid(c, table, TH)),
        "fast_nms_k1_per_level": ([tuple(p) for p in pyrs],
                                  lambda *p: [fast.fast_score_nms_dispatch(lv[b], TH) for lv in p for b in range(2)]),
        "fast_nms_plain_twin": ([tuple(p) for p in pyrs], lambda *p: [fast.nms3(fast.fast_score(lv, TH)) for lv in p]),
        "pyramid_matmul_batched": ([(x,) for x in stack], lambda x: build_pyramid(x, N_LEVELS, SCALE, weights)),
        "pyramid_matmul_2x_single": ([(x,) for x in stack], lambda x: build_pyramid(x[0], N_LEVELS, SCALE, weights)
                                     + build_pyramid(x[1], N_LEVELS, SCALE, weights)),
        "pyramid_interpolate_2x": ([(x,) for x in stack], resize),
        "select_batched": ([(x,) for x in stack], lambda x: fast.select_keypoints(score0(x), CAPACITY, **SELECT)),
        "select_2x_loop": ([(x,) for x in stack], lambda x: [fast.select_keypoints(score0(x[b]), CAPACITY, **SELECT)
                                                            for b in range(2)]),
    }
    ms = {}
    for name, (frames, body) in runs.items():
        ms[name] = _timing.scan_time(body, frames, dev, n_rep=args.reps)
        _timing.release(dev)
    return _timing.emit("bench_micro", dev, {"frames": args.frames, "reps": args.reps, "shape": [2, H, W],
                                             "ms_per_frame": ms})


if __name__ == "__main__":
    main()
