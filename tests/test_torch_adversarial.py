"""The port's adversarial and multi-lap worlds and its validation metrics
against the JAX package and the repository's ``validation.py``, on the CPU.

* ``multi_lap_circle_trajectory`` and ``AdversarialStereoDataset``'s poses:
  exactly equal.
* ``render_adversarial`` at 160×96, each flag off in turn, all on and all
  off, at several frame times: at most 0.1% of the pixels more than 0.5 grey
  levels apart, and at most 0.1% of the depths more than 1e-5 apart
  (relative).  The share is not zero because the f32 sines of XLA and of
  torch differ by an ulp on some arguments, which moves a distractor
  sphere's centre: a ray grazing its silhouette can then hit the sphere on
  one path and miss it on the other (one depth flips, and the 5×5 blur
  spreads the flip over its neighbours); a grazing ray's square root also
  amplifies the ulp.  The renderer's dot products and discriminant round
  as XLA:CPU's fused multiply-adds do, which keeps every other depth within
  1e-5.
* the depthless-sky check of ``tests/test_adversarial.py`` on the port's
  frontend: the sky band yields no stereo depth beyond 55 m.
* ``ate_of``, ``ate_final_of``, ``loop_precision_recall`` and
  ``reloc_success`` (its kidnapping score, with a stand-in SLAM) equal to
  the repository's ``validation.py`` on the same arrays.
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.io import synthetic as jsyn
from orb_slam2_ros2_tpu.io.trajectory import ate_rmse as jax_ate_rmse
from orb_slam2_ros2_tpu_torch import validation as tval
from orb_slam2_ros2_tpu_torch.features.extractor import make_stereo_frontend
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams
from orb_slam2_ros2_tpu_torch.io import synthetic as tsyn

GREY_TOL, DEPTH_RTOL, MAX_SHARE = 0.5, 1e-5, 1e-3
W, H = 160, 96
K_INV = np.linalg.inv(np.array([[100.0, 0, 80.0], [0, 100.0, 48.0], [0, 0, 1]], np.float32))
FLAGS = {
    "all": {},
    "no_sky": dict(sky=False),
    "no_distractors": dict(n_distractors=0),
    "no_exposure": dict(exposure=False),
    "no_repeat": dict(repeat_texture=False),
    "none": dict(sky=False, n_distractors=0, exposure=False, repeat_texture=False),
}


def adversarial_cfg(mod):
    """The configuration of ``tests/test_adversarial.py``."""
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192),
        orb=mod.ORBConfig(n_features=1200, max_keypoints=1536),
        tracking=mod.TrackingConfig(min_init_depth_kps=60, max_local_mappoints=4096, max_local_keyframes=16,
                                    motion_search_radius=35.0, min_localmap_matches=15,
                                    min_localmap_inliers=15, min_frames=1),
        map=mod.MapConfig(max_keyframes=128, max_mappoints=32768, max_obs_per_mp=16),
        bow=mod.BoWConfig(branching=6, depth=3),
        ba=mod.BAConfig(pcg_iters=20),
    )


def assert_images_agree(j_img, t_img, j_depth=None, t_depth=None):
    d = np.abs(np.asarray(j_img) - t_img.numpy())
    assert (d > GREY_TOL).mean() <= MAX_SHARE, f"{int((d > GREY_TOL).sum())} pixels over {GREY_TOL}"
    if j_depth is not None:
        jd, td = np.asarray(j_depth), t_depth.numpy()
        assert np.array_equal(np.isfinite(jd), np.isfinite(td))
        fin = np.isfinite(jd)
        rel = np.abs(jd[fin] - td[fin]) / np.abs(jd[fin])
        assert (rel > DEPTH_RTOL).mean() <= MAX_SHARE, f"{int((rel > DEPTH_RTOL).sum())} depths over {DEPTH_RTOL}"


@pytest.mark.parametrize("n,lap,radius,z", [(200, 52, 4.0, 15.0), (400, 150, 4.0, 15.0), (130, 800, 30.0, 40.0)])
def test_multi_lap_trajectory_matches_jax(n, lap, radius, z):
    np.testing.assert_array_equal(tsyn.multi_lap_circle_trajectory(n, lap, radius, z),
                                  jsyn.multi_lap_circle_trajectory(n, lap, radius, z))


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("t", [0, 17, 151])
def test_render_adversarial_matches_jax(flags, t):
    T = jsyn.multi_lap_circle_trajectory(t + 1, 150)[t]
    j_img, j_depth = jsyn.render_adversarial(jnp.asarray(K_INV), jnp.asarray(T), H, W,
                                             jnp.asarray(float(t), jnp.float32), **FLAGS[flags])
    t_img, t_depth = tsyn.render_adversarial(torch.from_numpy(K_INV), torch.from_numpy(T), H, W,
                                             torch.tensor(float(t)), **FLAGS[flags])
    assert_images_agree(j_img, t_img, j_depth, t_depth)


def test_adversarial_dataset_matches_jax():
    cam_j, cam_t = adversarial_cfg(jcfg).camera, adversarial_cfg(tcfg).camera
    jd = jsyn.AdversarialStereoDataset(cam_j, n_frames=12, frames_per_lap=80)
    td = tsyn.AdversarialStereoDataset(cam_t, n_frames=12, frames_per_lap=80, device="cpu")
    np.testing.assert_array_equal(td.poses_wc, jd.poses_wc)
    assert td.frames_per_lap == jd.frames_per_lap and td.flags == jd.flags and len(td) == len(jd)
    jl, jr, jT = jd.frame(7)
    tl, tr, tT = td.frame(7)
    np.testing.assert_array_equal(tT, jT)
    assert_images_agree(jl, tl)
    assert_images_agree(jr, tr)


def test_depthless_sky_region_is_featureless():
    """The sky band yields no stereo depth beyond 55 m: the adversarial
    condition the benign world lacks (``tests/test_adversarial.py``)."""
    cfg = adversarial_cfg(tcfg)
    ds = tsyn.AdversarialStereoDataset(cfg.camera, n_frames=4, frames_per_lap=56, device="cpu")
    img_l, img_r, _ = ds.frame(0)
    frame = make_stereo_frontend(cfg, "cpu")(img_l, img_r, CameraParams.from_config(cfg.camera, "cpu"))
    sky = frame.feats.valid & (frame.feats.uv[:, 1] < 30) & (frame.depth > 0)
    assert (frame.depth[sky] < 55).all(), "the sky produced far depth"
    assert int(frame.feats.valid.sum()) > 0


# ------------------------------------------------------------- metrics --

def root_harness() -> dict:
    """The metric functions of the repository's ``validation.py``, taken from
    its source (importing the script would point the JAX compile cache at a
    fixed path)."""
    path = Path(__file__).resolve().parents[1] / "validation.py"
    names = {"ate_of", "ate_final_of", "loop_precision_recall", "reloc_success"}
    body = [n for n in ast.parse(path.read_text()).body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"np": np, "ate_rmse": jax_ate_rmse}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    assert names <= set(ns)
    return ns


LAP, N = 150, 400
CASES = {
    "none": [],
    "true": [212],
    "false_then_true": [170, 230],
    "before_revisit": [40, 260],
    "late_laps": [301, 350, 399],
}


def noisy_run(seed: int, n_lost: int = 20):
    """(est, gt): the multi-lap circle and an estimate of it off by a drift
    and noise, with ``n_lost`` frames lost."""
    rng = np.random.default_rng(seed)
    gt = list(tsyn.multi_lap_circle_trajectory(N, LAP))
    est = []
    for i, g in enumerate(gt):
        e = g.astype(np.float64).copy()
        e[:3, 3] += rng.normal(0, 0.05, 3) + 0.002 * i
        est.append(e)
    for i in rng.choice(N, n_lost, replace=False):
        est[i] = None
    return est, gt


@pytest.mark.parametrize("case", list(CASES))
def test_loop_precision_recall_matches_root(case):
    root = root_harness()
    est, gt = noisy_run(1)
    closures = CASES[case]
    got = tval.loop_precision_recall(None, est, gt, closures, LAP, N)
    want = root["loop_precision_recall"](None, est, gt, closures, LAP, N)
    np.testing.assert_array_equal(np.array(got, np.float64), np.array(want, np.float64))


@pytest.mark.parametrize("n_lost", [0, 20, 395])
def test_ate_matches_root(n_lost):
    root = root_harness()
    est, gt = noisy_run(2, n_lost)
    np.testing.assert_array_equal(tval.ate_of(est, gt), root["ate_of"](est, gt))
    fin = [(i, np.linalg.inv(e).astype(np.float32)) for i, e in enumerate(est) if e is not None]
    slam = SimpleNamespace(final_trajectory=lambda: fin)
    np.testing.assert_array_equal(tval.ate_final_of(slam, gt), root["ate_final_of"](slam, gt))


class _KidnapStandIn:
    """A SLAM that relocalizes frame i at the keyframe a table names, or
    not at all; ``ds.frame(i)`` hands it i as the image."""

    def __init__(self, answers: dict, kf_frame_id):
        self.map = SimpleNamespace(kf_frame_id=torch.tensor(kf_frame_id))
        self.answers, self.state, self.offered = answers, None, []

    def track(self, img_l, _img_r):
        self.offered.append(img_l)
        kf = self.answers.get(img_l)
        return (None, {}) if kf is None else (np.eye(4), {"reloc_kf": kf})


@pytest.mark.parametrize("seed", [3, 5])
def test_reloc_success_score_matches_root(seed):
    root = root_harness()
    est, _ = noisy_run(seed)
    kf_frame_id = list(range(0, N, 6))                     # keyframe k at frame 6k
    rng = np.random.default_rng(seed)
    # right place, wrong lap angle, or no relocalization, frame by frame
    answers = {i: (int(rng.integers(len(kf_frame_id))) if rng.random() < 0.3 else (i // 6) % len(kf_frame_id))
               for i in range(N) if rng.random() < 0.8}
    ds = SimpleNamespace(frame=lambda i: (i, i, None))
    s_t, s_j = _KidnapStandIn(answers, kf_frame_id), _KidnapStandIn(answers, kf_frame_id)
    got = tval.reloc_success(s_t, ds, LAP, N, est, seed=seed)
    want = root["reloc_success"](s_j, ds, LAP, N, est, seed=seed)
    assert got == want and s_t.offered == s_j.offered and len(s_t.offered) == 12
    assert s_t.state == tval.TrackState.LOST
