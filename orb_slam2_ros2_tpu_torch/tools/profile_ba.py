"""Local BA in parts, the top-k over the map points, and the vocabulary's
transform and sparse BoW (port of the repository's ``profile_ba.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_ba [--warm 30] [--reps 3]

Builds a map with WARM frames of full SLAM (``th_depth=60``, no loop
closing) on the KITTI-like world (``box_scale=2.5``, sky), then times each
program eagerly and as its own graph, around the reference keyframe:

* local BA in three parts: ``extract_window_points`` (the window and its
  observations), ``solve_ba_points`` (the two-phase LM) and the whole
  ``local_ba`` (with the write-back into a copy of the map, restored before
  each call);
* the top-k over the M map-point slots → 8192 (int32 scores, the
  ``utils.topk_bounded`` the window extraction runs);
* JAX's ``approx_max_k`` has no torch counterpart: reported as absent, and
  nothing is timed in its place;
* the packaged 10⁵-word vocabulary's ``transform`` (5 levels) of keyframe
  0's descriptors and ``sparse_bow`` of its words (a sort of the frame's
  word ids; the port keeps no top-k over the 10⁵ words).
"""

from __future__ import annotations

import torch

from ..bow.keyframe_db import sparse_bow
from ..bow.vocabulary import transform
from ..pipeline.frame_graph import donating, id_tensor
from ..pipeline.system import SLAM
from ..solvers.local_ba import extract_window_points, local_ba
from ..solvers.schur_ba import solve_ba_points
from ..utils import topk_bounded
from . import _frames, _timing

TOPK = 8192


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_ba", __doc__)
    ap.add_argument("--warm", type=int, default=30, help="frames that build the map (JAX: 30)")
    ap.add_argument("--reps", type=int, default=3, help="timed calls; the best is kept (JAX: 3)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _frames.with_th_depth(_timing.load_config(args.config))
    frames = _frames.render(cfg, args.warm, dev, box_scale=2.5, sky=True)
    slam = SLAM(cfg, enable_loop_closing=False, device=dev)
    tracked = _frames.run_slam(slam, frames)
    _timing.note_slam(slam)
    b, o = cfg.ba, cfg.orb
    state, cam, kf = slam.map, slam.map_cam, id_tensor(slam.ref_kf, dev)
    window = dict(max_free=b.max_local_ba_kfs, max_fixed=b.max_local_ba_fixed, max_points=b.local_ba_points,
                  scale_factor=o.scale_factor)
    lm = dict(chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo, phase_iters=tuple(b.local_ba_phase_iters),
              lam=b.lm_lambda_init)
    res = {}

    def time_it(name, program, args_, **kw):
        r = _timing.bench(program, args_, dev, reps=args.reps, **kw)
        res[name] = {"ms": r["ms"], "eager_ms": r["eager_ms"]}
        _timing.release(dev)
        return r["out"]

    prob = time_it("extract_window", lambda k, m: extract_window_points(m, k, **window)[0], (kf,), fixed=(state,))
    time_it("solve_ba_points", lambda c, p: solve_ba_points(c, p, **lm), (cam, prob))
    storage = _frames.clone(state)
    dst, src = list(storage), list(state)
    full = lambda m, k: local_ba(m, k, cam, **window, **lm)  # noqa: E731
    time_it("local_ba", donating(lambda m, k: (full(m, k),), {}, "local_ba"), (kf,), fixed=(storage,),
            restore=lambda: torch._foreach_copy_(dst, src), eager=lambda k, m: full(m, k))
    del storage

    M = state.mp_capacity

    def big_topk(mask):
        score = torch.where(mask, 1 + torch.arange(M, dtype=torch.int32, device=mask.device), 0)
        return topk_bounded(score, TOPK)[1]

    time_it("topk_M_8192_i32", big_topk, (state.mp_valid,))

    vocab = slam._resolve_vocab(0)
    desc, valid = state.kf_desc[0], state.kf_feat_valid[0]
    words = time_it("vocab_transform", lambda d, v: transform(vocab, d, v), (desc, valid))
    time_it("sparse_bow", lambda w: tuple(sparse_bow(vocab, w, cfg.bow.max_words_per_query)), (words,))
    out = {"warm": args.warm, "tracked": tracked, "keyframes": slam.n_keyframes, "mappoints": slam.n_mappoints,
           "mp_capacity": M, "n_words": vocab.n_words, "reps": args.reps, "programs": res,
           "absent": {"approx_max_k_M_8192": "torch has no approx_max_k; nothing is timed in its place"}}
    del slam
    _timing.release(dev)
    return _timing.emit("profile_ba", dev, out)


if __name__ == "__main__":
    main()
