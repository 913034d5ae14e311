"""An ORBvoc-scale (10⁶-word) vocabulary on the live keyframe path (port of
the repository's ``profile_orbvoc.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_orbvoc [--frames 84] [--lap 86] [--branching 10] [--depth 6]

Two full-SLAM runs (loop closing on, ``th_depth=60``) over the circle world
(``box_scale=2.5``, sky): one with the packaged 10⁵-word vocabulary, one
with a k=10, L=6 DBoW-text vocabulary (10⁶ leaves) — the reference loads the
real ORBvoc at startup (System.cc:92-95) and pays its transform on every
keyframe and frame.  After each run, on its map:

* ``kf_add_detect_ms`` — the keyframe registration and loop query
  (``loop_closing.LoopGraphs.detect``: BoW transform, the row written into
  the database in place, the candidate query) replayed on a copy of the
  database, restored before each call, and the eager program beside it;
* ``reloc_query_ms`` — the relocalization program (``frame_graph.RelocGraph``
  over ``SLAM.reloc_program``: the BoW query and the candidate cascade as
  one graph) on the last frame, and the eager program beside it.

The 10⁶-word file is the random-centroid, descent-consistent vocabulary of
``write_orbvoc_scale`` (timing-representative, not ORBvoc's recall), written
under ``build/`` and reused when present.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..pipeline.frame_graph import id_tensor
from ..pipeline.loop_closing import LoopGraphs
from ..pipeline.system import RELOC_CANDIDATES, SLAM
from ..solvers.epnp import uniform_draw
from . import _frames, _timing

BUILD = Path(__file__).resolve().parents[2] / "build"
CHUNK = 20_000   # rows formatted at a time


def write_orbvoc_scale(path: str, rng: np.random.Generator, branching: int = 10, depth: int = 6) -> int:
    """A full ``branching``-ary, ``depth``-level DBoW text vocabulary with
    random centroids, in the file format the reference parses (``parent_id
    is_leaf d0..d31 weight``, 1-indexed parent ids, level after level),
    byte for byte what ``np.savetxt(fmt="%g")`` writes, formatted a block
    of rows at a time.  Returns the number of nodes."""
    k, L = branching, depth
    n_inner = sum(k ** d for d in range(1, L))
    n_nodes = n_inner + k ** L
    parents = np.empty(n_nodes, np.int64)
    prev, start = np.array([-1]), 0
    for _ in range(L):
        cur = np.arange(start, start + prev.size * k)
        parents[cur] = np.repeat(prev + 1, k)
        prev, start = cur, start + cur.size
    desc = rng.integers(0, 256, (n_nodes, 32), dtype=np.uint8)
    is_leaf = np.zeros(n_nodes, np.int64)
    is_leaf[n_inner:] = 1
    weight = np.where(is_leaf == 1, rng.uniform(0.1, 2.0, n_nodes), 0.0)
    cols = np.column_stack([parents.astype(np.float64), is_leaf.astype(np.float64), desc.astype(np.float64), weight])
    row = " ".join(["%g"] * cols.shape[1]) + "\n"
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for i in range(0, n_nodes, CHUNK):
            block = cols[i:i + CHUNK]
            f.write((row * block.shape[0]) % tuple(block.ravel().tolist()))
    return n_nodes


def vocabulary_file(directory: Path, branching: int, depth: int) -> tuple:
    """(path, seconds to write it: 0 when it was there) of the scale
    vocabulary; written to a temporary name first, so a cut write is not
    reused."""
    path = directory / f"orbvoc_k{branching}_L{depth}.txt"
    if path.exists():
        return str(path), 0.0
    directory.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    part = path.with_suffix(".part")
    write_orbvoc_scale(str(part), np.random.default_rng(0), branching, depth)
    os.replace(part, path)
    return str(path), time.perf_counter() - t0


def run_one(cfg, vocab_path: str, label: str, frames, dev, reps: int) -> dict:
    cfg = cfg.replace(bow=dataclasses.replace(cfg.bow, vocab_path=vocab_path))
    t0 = time.perf_counter()
    slam = SLAM(cfg, device=dev)
    tracked = _frames.run_slam(slam, frames)
    _timing.note_slam(slam)
    lc = slam.loop_closer
    out = {"label": label, "n_words": lc.vocab.n_words if lc is not None else 0, "frames": len(frames),
           "tracked": tracked, "keyframes": slam.n_keyframes, "loops_closed": slam.loops_closed,
           "wall_s": time.perf_counter() - t0}
    if lc is None:
        return out
    # registration + query on a copy of the database (the program writes
    # the keyframe's row into it)
    db = _frames.clone(lc.db)
    dst, src = list(db), list(lc.db)
    lg = LoopGraphs(cfg, lc.vocab, capture=dev.type == "cuda")
    kf = id_tensor(slam.ref_kf, dev)
    r = _timing.bench(lambda k: lg.detect(slam.map, db, k), (kf,), dev, reps=reps, graph=False,
                      restore=lambda: torch._foreach_copy_(dst, src),
                      eager=lambda k: lg.eager["detect"](slam.map, db, k))
    out.update(kf_add_detect_ms=r["ms"], kf_add_detect_eager_ms=r["eager_ms"])
    del lg, db
    # the relocalization program of the last frame, through the system's graph
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frame = slam.last.frame
    u = uniform_draw((RELOC_CANDIDATES,), frame.feats.capacity, gen)
    args = (frame, u, lc.db, slam.map, lc.vocab)
    r = _timing.bench(slam._reloc_graph, args, dev, reps=reps, graph=False, eager=slam.reloc_program)
    out.update(reloc_query_ms=r["ms"], reloc_query_eager_ms=r["eager_ms"],
               reloc_candidates=int((r["out"][0][:, 2] >= 0).sum()))
    del slam
    _timing.release(dev)
    return out


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_orbvoc", __doc__)
    ap.add_argument("--frames", type=int, default=84, help="frames of the circle world (JAX: 84)")
    ap.add_argument("--lap", type=int, default=0, help="frames a lap of the circle (JAX: frames + 2)")
    ap.add_argument("--branching", type=int, default=10, help="the scale vocabulary's k (JAX: 10)")
    ap.add_argument("--depth", type=int, default=6, help="its levels L (JAX: 6)")
    ap.add_argument("--reps", type=int, default=3, help="timed calls; the best is kept (JAX: 3)")
    ap.add_argument("--vocab-dir", default=str(BUILD), help="where the scale vocabulary is kept")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _frames.with_th_depth(_timing.load_config(args.config))
    frames = _frames.render(cfg, args.frames, dev, lap=args.lap, box_scale=2.5, sky=True, circle=True)
    path, write_s = vocabulary_file(Path(args.vocab_dir), args.branching, args.depth)
    runs = [run_one(cfg, "", "default_1e5", frames, dev, args.reps),
            run_one(cfg, path, f"scale_k{args.branching}_L{args.depth}", frames, dev, args.reps)]
    return _timing.emit("profile_orbvoc", dev, {
        "orbvoc_live": runs, "vocab_write_s": write_s, "vocab_bytes": os.path.getsize(path),
        "add_detect_ratio": runs[1].get("kf_add_detect_ms", 0.0) / max(runs[0].get("kf_add_detect_ms", 0.0), 1e-9)})


if __name__ == "__main__":
    main()
