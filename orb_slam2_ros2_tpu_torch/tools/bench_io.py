"""Map persistence formats: npz against the reference's protobuf and txt
(port of the repository's ``bench_io.py``; reference TxtVsProto.cc:10-48,
whose README claims protobuf −78% time and −50% size against txt)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.bench_io [--keyframes 48] [--points 4000] [--features 512]

One synthetic map (``build_state``: K keyframes, P points, N features a
keyframe, 64 keyframe and 8192 point slots) lives on the device; each
format saves it (the save copies it to the host, as ``SLAM.save`` does) and
loads it back onto the device, timed by the host's clock, with the bytes
written.  Each load is held to the saved state (``load_equal``): every
field bit-equal through npz; through ``.pb`` and txt the keyframe poses
and point positions within 1e-6 (``.pb``) or 1e-4 (txt, which prints
``%g``), the descriptors, covisibility, parents and counts exact.  The
sanity statistic of TxtVsProto.cc:16-27 (the largest keyframe translation
norm) is printed and checked on every load.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..config import MapConfig, ORBConfig, SLAMConfig
from ..io.persistence import load_map, save_map
from ..io.proto_map import load_proto_map, save_proto_map
from ..io.txt_map import load_txt_map, save_txt_map
from ..mapstate.map_state import MapState, empty_map
from . import _timing

FORMAT_TOL = {"npz": 0.0, "proto": 1e-6, "txt": 1e-4}


def bench_config(max_keypoints: int = 512) -> SLAMConfig:
    """The JAX script's configuration: 64 keyframe and 8192 point slots."""
    return SLAMConfig(orb=ORBConfig(max_keypoints=max_keypoints),
                      map=MapConfig(max_keyframes=64, max_mappoints=8192, max_obs_per_mp=12))


def build_state(cfg: SLAMConfig, K: int = 48, P: int = 4000, N: int = 512, seed: int = 0, device="cuda"):
    """A synthetic map of ``K`` keyframes on a line, ``P`` points and ``N``
    features a keyframe (each keyframe observing a contiguous window of the
    points), drawn with numpy from ``seed`` — the JAX script's recipe."""
    rng = np.random.default_rng(seed)
    st = empty_map(cfg, device)
    O = st.mp_obs_kf.shape[1]
    KC, MC = cfg.map.max_keyframes, cfg.map.max_mappoints

    kf_valid = np.zeros(KC, bool)
    kf_valid[:K] = True
    Tcw = np.tile(np.eye(4, dtype=np.float32), (KC, 1, 1))
    Tcw[:K, 0, 3] = 0.4 * np.arange(K)
    uv = np.zeros((KC, N, 2), np.float32)
    uv[:K] = rng.uniform(5, 370, (K, N, 2)).astype(np.float32)
    desc = np.zeros((KC, N, 8), np.uint32)
    desc[:K] = rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32)
    fv = np.zeros((KC, N), bool)
    fv[:K] = True
    depth = rng.uniform(4, 40, (KC, N)).astype(np.float32)
    mp_idx = np.full((KC, N), -1, np.int32)
    per_kf = min(N, P)
    for k in range(K):
        start = (k * P // K) % max(P - per_kf, 1)
        mp_idx[k, :per_kf] = (start + np.arange(per_kf)) % P

    mp_valid = np.zeros(MC, bool)
    mp_valid[:P] = True
    pos = np.zeros((MC, 3), np.float32)
    pos[:P] = rng.uniform([-20, -5, 4], [20, 5, 60], (P, 3)).astype(np.float32)
    normal = np.zeros((MC, 3), np.float32)
    normal[:P, 2] = -1.0
    mdesc = np.zeros((MC, 8), np.uint32)
    mdesc[:P] = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    obs_kf = np.full((MC, O), -1, np.int32)
    obs_feat = np.full((MC, O), -1, np.int32)
    n_obs = np.zeros(MC, np.int32)
    ks, js = np.nonzero(mp_idx >= 0)
    for k, j in zip(ks, js):
        m = mp_idx[k, j]
        o = n_obs[m]
        if o < O:
            obs_kf[m, o], obs_feat[m, o] = k, j
            n_obs[m] = o + 1
    covis = np.zeros((KC, KC), np.int32)
    covis[:K, :K] = 30
    np.fill_diagonal(covis, 0)
    parent = np.full(KC, -1, np.int32)
    parent[1:K] = np.arange(K - 1)

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)

    return st._replace(
        kf_Tcw=t(Tcw), kf_valid=t(kf_valid), kf_uv=t(uv), kf_desc=t(desc), kf_feat_valid=t(fv),
        kf_depth=t(depth), kf_mp_idx=t(mp_idx), mp_pos=t(pos), mp_normal=t(normal), mp_desc=t(mdesc),
        mp_valid=t(mp_valid), mp_min_dist=t(np.where(mp_valid, 2.0, 0.0).astype(np.float32)),
        mp_max_dist=t(np.where(mp_valid, 80.0, 1e9).astype(np.float32)),
        mp_ref_kf=t(np.where(mp_valid, 0, -1).astype(np.int32)), mp_obs_kf=t(obs_kf), mp_obs_feat=t(obs_feat),
        mp_n_obs=t(n_obs), covis=t(covis), kf_parent=t(parent),
        next_kf=t(np.asarray(K, np.int32)), next_mp=t(np.asarray(P, np.int32)),
    )


def load_equal(saved: MapState, loaded: MapState, fmt: str, K: int, P: int) -> bool:
    """``loaded`` holds ``saved``: every field bit-equal for npz; for the
    reference formats the poses and positions within ``FORMAT_TOL``, the
    descriptors, covisibility, parents and counts exact."""
    if fmt == "npz":
        return all(torch.equal(a, b) for a, b in zip(saved, loaded))
    tol = FORMAT_TOL[fmt]

    def close(a, b):
        return bool(torch.allclose(a.cpu(), b.cpu(), rtol=tol, atol=tol))

    return (close(loaded.kf_Tcw[:K], saved.kf_Tcw[:K]) and close(loaded.mp_pos[:P], saved.mp_pos[:P])
            and torch.equal(loaded.kf_desc[:K], saved.kf_desc[:K]) and torch.equal(loaded.mp_desc[:P], saved.mp_desc[:P])
            and torch.equal(loaded.covis[:K, :K], saved.covis[:K, :K])
            and torch.equal(loaded.kf_parent[:K], saved.kf_parent[:K])
            and int(loaded.mp_n_obs.sum()) == int(saved.mp_n_obs.sum())
            and int(loaded.next_kf) == int(saved.next_kf))


def _size(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def max_translation(state: MapState) -> float:
    """The largest keyframe translation norm (TxtVsProto.cc:16-27)."""
    return float(torch.linalg.vector_norm(state.kf_Tcw[:, :3, 3].cpu(), dim=1).max())


def main(argv=None) -> dict:
    ap = _timing.base_parser("bench_io", __doc__)
    ap.add_argument("--keyframes", type=int, default=48)
    ap.add_argument("--points", type=int, default=4000)
    ap.add_argument("--features", type=int, default=512)
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = bench_config(args.features)
    K, P = args.keyframes, args.points
    st = build_state(cfg, K, P, args.features, device=dev)
    t_norm = max_translation(st)
    formats = {
        "npz": ("m.map.npz", lambda p: save_map(p, st, cfg), lambda p: load_map(p, dev)[0]),
        "proto": ("m.pb", lambda p: save_proto_map(p, st, cfg), lambda p: load_proto_map(p, cfg, dev)),
        "txt": ("txt", lambda p: save_txt_map(p, st, cfg), lambda p: load_txt_map(p, cfg, dev)),
    }
    tmp = tempfile.mkdtemp(prefix="bench_io_")
    res = {}
    try:
        for name, (rel, save, load) in formats.items():
            path = os.path.join(tmp, rel)
            _timing.sync(dev)
            t0 = time.perf_counter()
            save(path)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = load(path)
            _timing.sync(dev)
            t_load = time.perf_counter() - t0
            tn = max_translation(loaded)
            if abs(tn - t_norm) >= 1e-3:
                raise AssertionError(f"{name}: max|t| {tn} != {t_norm}")
            res[name] = {"save_ms": t_save * 1e3, "load_ms": t_load * 1e3, "bytes": _size(path),
                         "load_equal": load_equal(st, loaded, name, K, P)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    p, x = res["proto"], res["txt"]
    return _timing.emit("bench_io", dev, {
        "metric": "map_io_formats", "max_kf_translation": t_norm, "formats": res,
        "proto_vs_txt_time": (p["save_ms"] + p["load_ms"]) / max(x["save_ms"] + x["load_ms"], 1e-9),
        "proto_vs_txt_size": p["bytes"] / max(x["bytes"], 1)})


if __name__ == "__main__":
    main()
