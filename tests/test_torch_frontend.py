"""Parity of the PyTorch port's frontend with the JAX package, on the CPU.

Inputs are numpy arrays made from a seed (or frames rendered by the JAX
package) handed to both packages.  On the CPU the port's kernel wrappers run
their plain PyTorch versions; the CUDA kernels themselves are compared with
those plain versions by the ``gpu`` tests at the end (skipped without a card)
and by ``chip_smoke.py``.

Tolerances: FAST, NMS, keypoint selection, patches, hamming, canvas centres
and the copied numpy builders are exact; the pyramid is within one bf16 ulp
(f32 sums in another order); BRIEF bits agree on identical patches up to a
budget of 1e-3 (a comparison whose blurred difference is within rounding of
zero may flip).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.features import extractor as jext
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.ops import brief as jbrief
from orb_slam2_ros2_tpu.ops import canvas as jcanvas
from orb_slam2_ros2_tpu.ops import fast as jfast
from orb_slam2_ros2_tpu.ops import hamming as jham
from orb_slam2_ros2_tpu.ops import pallas_patches as jpp
from orb_slam2_ros2_tpu.ops import pyramid as jpyr
from orb_slam2_ros2_tpu.ops import stereo as jstereo
from orb_slam2_ros2_tpu.ops.pallas_fast import fast_score_pallas
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.features import extractor as text
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.ops import brief as tbrief
from orb_slam2_ros2_tpu_torch.ops import canvas as tcanvas
from orb_slam2_ros2_tpu_torch.ops import fast as tfast
from orb_slam2_ros2_tpu_torch.ops import hamming as tham
from orb_slam2_ros2_tpu_torch.ops import patches as tpatches
from orb_slam2_ros2_tpu_torch.ops import pyramid as tpyr
from orb_slam2_ros2_tpu_torch.ops import stereo as tstereo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRIEF_BIT_BUDGET = 1e-3


def small_cfg(mod):
    """The small configuration of ``__graft_entry__.entry()``."""
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                                width=320, height=192),
        orb=mod.ORBConfig(n_features=500, max_keypoints=512),
        tracking=mod.TrackingConfig(min_init_depth_kps=150, max_local_mappoints=4096,
                                    max_local_keyframes=16, only_tracking=True),
        map=mod.MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
    )


def bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def frame_pair():
    cfg = small_cfg(jcfg)
    ds = JDataset(cfg.camera, n_frames=2, speed=0.35)
    img_l, img_r, _ = ds.frame(1)
    return np.asarray(img_l), np.asarray(img_r)


@pytest.fixture(scope="module")
def jax_frontend_out(frame_pair):
    """JAX features + patches of one stereo pair, plus its StereoFrame."""
    cfg = small_cfg(jcfg)
    o, c = cfg.orb, cfg.camera
    caps = tuple(jext.level_capacities(o.max_keypoints, o.n_levels, o.scale_factor))
    cam = JCam.from_config(c)
    imgs = jnp.stack([jnp.asarray(frame_pair[0]), jnp.asarray(frame_pair[1])])
    feats, patches = jax.jit(lambda x: jext.extract_features_batch(
        x, cam, h=c.height, w=c.width, n_levels=o.n_levels, scale_factor=o.scale_factor,
        caps=caps, border=o.edge_border, min_th=float(o.min_th_fast),
        ini_th=float(o.ini_th_fast), cell=o.cell_size, undistort=False))(imgs)
    sframe = jax.jit(jext.make_stereo_frontend(cfg))(imgs[0], imgs[1], cam)
    return jax.tree.map(np.array, feats), np.array(patches), jax.tree.map(np.array, sframe)


# ---------------------------------------------------------------- imports --

def test_import_leaves_jax_out():
    """Importing the port, every module of it, never imports JAX or the JAX
    package (directly, transitively or lazily at import), nor the shell's
    optional libraries (rclpy, matplotlib, Pillow)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import orb_slam2_ros2_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "want = ['bow.vocabulary', 'bow.keyframe_db', 'geometry.align', 'geometry.sim3',\n"
        "        'solvers.epnp', 'solvers.sim3_solver', 'io.persistence', 'pipeline.loop_closing',\n"
        "        'solvers.pose_graph', 'solvers.pcg_ba', 'solvers.global_ba', 'cli', 'io.datasets',\n"
        "        'io.native_loader', 'io.proto_map', 'io.txt_map', 'proto', 'viewer', 'viz',\n"
        "        'ros2_bridge', 'validation', 'scale_run', 'train_corpus_vocab', 'pipeline.tracking',\n"
        "        'pipeline.frame_graph', 'solvers.schur_ba', 'features.extractor', 'tools._timing',\n"
        "        'tools.profile_frame', 'tools.profile_orbvoc', 'tools.bench_posegraph', 'tools.bench',\n"
        "        'tools.bench_full', 'tools.bench_loop', 'tools.bench_scaling']\n"
        "missing = [w for w in want if p.__name__ + '.' + w not in names]\n"
        "assert not missing, missing\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'orb_slam2_ros2_tpu.'))"
        " or n == 'orb_slam2_ros2_tpu']\n"
        "assert not bad, bad\n"
        "optional = [n for n in sys.modules if n.split('.')[0] in ('rclpy', 'matplotlib', 'PIL')]\n"
        "assert not optional, optional\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_sources_never_name_jax():
    """No source of the port, nor ``chip_smoke.py``, imports JAX or the JAX
    package, even lazily."""
    pkg = os.path.join(REPO, "orb_slam2_ros2_tpu_torch")
    offenders = []
    sources = [(REPO, ["chip_smoke.py"])] + [(root, files) for root, _, files in os.walk(pkg)]
    for root, files in sources:
        for f in files:
            if f.endswith(".py"):
                text_ = open(os.path.join(root, f)).read()
                for line in text_.splitlines():
                    s = line.strip()
                    if s.startswith(("import ", "from ")) and (
                        " jax" in s or "orb_slam2_ros2_tpu " in s or "orb_slam2_ros2_tpu." in s
                    ):
                        offenders.append((f, s))
    assert not offenders, offenders


# ------------------------------------------------------ copied numpy code --

@pytest.mark.parametrize("name", [
    "brief_template", "rotated_offset_lut", "pair_difference_matrix", "moment_weights",
    "resize_weights", "area_weights", "pyramid_block_weights", "circle_offsets",
    "level_shapes", "canvas_layout", "padded_canvas_shape", "level_capacities",
])
def test_copied_builders_equal(name):
    cases = {
        "brief_template": lambda m: m.brief_template(17),
        "rotated_offset_lut": lambda m: m.rotated_offset_lut(17),
        "pair_difference_matrix": lambda m: m._pair_difference_matrix(17),
        "moment_weights": lambda m: np.stack(m._moment_weights()),
        "resize_weights": lambda m: m._resize_weights(320, 267),
        "area_weights": lambda m: m._area_weights(1241, 1034),
        "pyramid_block_weights": lambda m: m._pyramid_block_weights(192, 320, 8, 1.2),
        "circle_offsets": lambda m: m.CIRCLE_OFFSETS,
        "level_shapes": lambda m: m.level_shapes(376, 1241, 8, 1.2),
        "canvas_layout": lambda m: m.canvas_layout(376, 1241, 8, 1.2),
        "padded_canvas_shape": lambda m: m.padded_canvas_shape(376, 1241, 8, 1.2),
        "level_capacities": lambda m: m.level_capacities(2048, 8, 1.2),
    }
    where = {
        "brief_template": (jbrief, tbrief), "rotated_offset_lut": (jbrief, tbrief),
        "pair_difference_matrix": (jbrief, tbrief), "moment_weights": (jbrief, tbrief),
        "resize_weights": (jpyr, tpyr), "area_weights": (jpyr, tpyr),
        "pyramid_block_weights": (jpyr, tpyr), "circle_offsets": (jfast, tfast),
        "level_shapes": (jpyr, tpyr), "canvas_layout": (jcanvas, tcanvas),
        "padded_canvas_shape": (jcanvas, tcanvas), "level_capacities": (jext, text),
    }
    jm, tm = where[name]
    want, got = cases[name](jm), cases[name](tm)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def jax_defaults(cfg) -> dict:
    """``dataclasses.asdict`` of a JAX configuration with the port's
    deliberate departures from its defaults: the global BA after a loop
    runs ungated (``config.LoopConfig.global_ba_phase_iters``) and local BA
    erases the outliers of its fixed anchors too
    (``config.BAConfig.local_ba_erase_in_anchors``)."""
    d = dataclasses.asdict(cfg)
    d["loop"]["global_ba_phase_iters"] = tcfg.LoopConfig().global_ba_phase_iters
    d["ba"]["local_ba_erase_in_anchors"] = tcfg.BAConfig().local_ba_erase_in_anchors
    return d


def test_config_defaults_equal():
    assert tcfg.LoopConfig().global_ba_phase_iters == (10, 0) and tcfg.BAConfig().local_ba_erase_in_anchors
    assert dataclasses.asdict(tcfg.SLAMConfig()) == jax_defaults(jcfg.SLAMConfig())
    assert dataclasses.asdict(small_cfg(tcfg)) == jax_defaults(small_cfg(jcfg))


# ------------------------------------------------------------------ FAST --

@pytest.mark.parametrize("shape", [(2, 96, 200), (2, 77, 130), (1, 19, 33)])
@pytest.mark.parametrize("nms", [True, False])
def test_fast_plain_matches_jax(shape, nms):
    """The port's plain K1 equals JAX ``nms3(fast_score)`` on the whole map
    (borders included) and the Pallas kernel in its interior; ties come
    from a flat block."""
    r = np.random.default_rng(sum(shape))
    a = r.uniform(0, 255, shape).astype(np.float32)
    a[:, 5:15, 5:25] = 100.0
    ja, ta = bf16_pair(a)
    ref = jfast.fast_score(ja, 7.0)
    ref = f32(jfast.nms3(ref) if nms else ref)
    got = f32(tfast.fast_score_nms(ta, 7.0, nms=nms))
    plain = tfast.fast_score(ta, 7.0)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(f32(tfast.nms3(plain) if nms else plain), ref)
    pal = f32(fast_score_pallas(ja, 7.0, interpret=True, nms=nms))
    m = 5
    np.testing.assert_array_equal(got[:, m:-m, m:-m], pal[:, m:-m, m:-m])


def test_select_keypoints_matches_jax():
    """Identical bf16 score maps → identical keypoints, responses and
    validity, including the lower-index-first order of tied cells."""
    r = np.random.default_rng(3)
    a = r.uniform(0, 255, (2, 120, 200)).astype(np.float32)
    a[:, 40:80, 60:140] = 50.0
    ja, ta = bf16_pair(a)
    score_j = jfast.nms3(jfast.fast_score(ja, 7.0))
    score_t = tfast.fast_score_nms(ta, 7.0)
    for cap in (64, 2000):
        uv_t, resp_t, val_t = tfast.select_keypoints(score_t, cap, border=23, cell=32,
                                                     topk_per_cell=4, strong_threshold=20.0)
        for b in range(2):
            uv_j, resp_j, val_j = jfast.select_keypoints(score_j[b], cap, border=23, cell=32,
                                                         topk_per_cell=4, strong_threshold=20.0)
            np.testing.assert_array_equal(uv_t[b].numpy(), np.asarray(uv_j))
            np.testing.assert_array_equal(resp_t[b].numpy(), np.asarray(resp_j))
            np.testing.assert_array_equal(val_t[b].numpy(), np.asarray(val_j))


# --------------------------------------------------------------- patches --

@pytest.mark.parametrize("case", ["interior", "clamped"])
def test_patches_plain_matches_jax(case):
    """Plain K2 equals ``extract_patches_xla`` and the Pallas kernel in
    interpret mode, clamped corners included."""
    r = np.random.default_rng(0)
    if case == "interior":
        canvas = r.uniform(0, 255, (256, 256)).astype(np.float32)
        ys = r.integers(jpp.CENTER, 256 - 56, 32)
        xs = r.integers(jpp.CENTER, 256 - 192, 32)
        centers = np.stack([ys, xs], 1).astype(np.int32)
    else:
        canvas = r.uniform(0, 255, (128, 256)).astype(np.float32)
        centers = np.array([[0, 0], [127, 255], [0, 255], [127, 0]] * 2, np.int32)
    want = np.asarray(jpp.extract_patches_xla(jnp.asarray(canvas), jnp.asarray(centers)))
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jpp.extract_patches_pallas(jnp.asarray(canvas), jnp.asarray(centers)))
    got = tpatches.extract_patches_48x64(torch.from_numpy(canvas), torch.from_numpy(centers)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


def test_patches_bf16_out_of_range_centres():
    """bf16 canvas, centres beyond every edge: the DMA-window clip and the
    dynamic_slice clamp both apply, as in JAX."""
    r = np.random.default_rng(5)
    canvas = r.uniform(0, 255, (300, 400)).astype(np.float32)
    jc, tc_ = bf16_pair(canvas)
    centers = r.integers(-40, 460, (64, 2)).astype(np.int32)
    want = np.asarray(jpp.extract_patches_xla(jc, jnp.asarray(centers)))
    got = tpatches.extract_patches_48x64(tc_, torch.from_numpy(centers)).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs the plain version only for CPU tensors; any other
    device launches the kernel or raises — here the meta device raises."""
    x = torch.empty((2, 32, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tfast.fast_score_nms(x, 7.0)
    with pytest.raises(ValueError):
        tpatches.extract_patches_48x64(x[0], torch.zeros((8, 2), dtype=torch.int32, device="meta"))


# --------------------------------------------------------------- pyramid --

def test_pyramid_within_one_bf16_ulp():
    r = np.random.default_rng(7)
    img = r.uniform(0, 255, (2, 192, 320)).astype(np.float32)
    lj = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    lt = tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)
    for a, b in zip(lj, lt):
        a, b = f32(a), f32(b)
        assert a.shape == b.shape
        mag = np.maximum(np.abs(a), np.abs(b))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert np.all(np.abs(a - b) <= ulp)


# ----------------------------------------------------------------- BRIEF --

def test_brief_bits_on_identical_patches(jax_frontend_out):
    """Identical patches and angles → descriptor bits agree up to the
    budget; orientations agree to f32 rounding."""
    feats, patches, _ = jax_frontend_out
    p = np.array(patches.reshape(-1, 48, 64))
    ang_j = np.array(jbrief.orientations(jnp.asarray(p)))
    ang_t = tbrief.orientations(torch.from_numpy(p), tbrief.moment_weights("cpu")).numpy()
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-5)
    d_j = np.asarray(jbrief.describe(jnp.asarray(p), jnp.asarray(ang_j)))
    d_t = tbrief.describe(torch.from_numpy(p), torch.from_numpy(ang_j), tbrief.pair_matrix("cpu"))
    d_t = d_t.numpy().view(np.uint32)
    diff = np.unpackbits((d_j ^ d_t).view(np.uint8)).sum()
    rate = diff / (d_j.size * 32)
    assert rate <= BRIEF_BIT_BUDGET, rate


def test_angles_deg_matches_jax():
    a = np.random.default_rng(2).uniform(-np.pi, np.pi, 1000).astype(np.float32)
    np.testing.assert_array_equal(tbrief.angles_deg(torch.from_numpy(a)).numpy(),
                                  np.asarray(jbrief.angles_deg(jnp.asarray(a))))


# --------------------------------------------------------------- hamming --

def test_hamming_and_unpack_exact():
    r = np.random.default_rng(11)
    a = r.integers(0, 2**32, (70, 8), dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 2**32, (50, 8), dtype=np.uint64).astype(np.uint32)
    a[0] = 0xFFFFFFFF  # sign bits set in every word
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    np.testing.assert_array_equal(tham.hamming_matrix(ta, tb).numpy(),
                                  np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(tham.unpack_signs(ta).numpy(),
                                  f32(jham.unpack_signs(jnp.asarray(a))))
    bits = (tham.unpack_signs(ta) < 0)
    np.testing.assert_array_equal(tbrief.pack_bits(bits).numpy().view(np.uint32), a)


# ---------------------------------------------------------------- stereo --

def test_canvas_centers_exact(jax_frontend_out):
    feats, _, _ = jax_frontend_out
    cfg = small_cfg(jcfg)
    off, _, _ = jcanvas.canvas_layout(192, 320, 8, 1.2)
    want = np.asarray(jstereo.canvas_centers(jnp.asarray(feats.uv_raw), jnp.asarray(feats.octave),
                                             cfg.orb.scale_factor, jnp.asarray(off)))
    got = tstereo.canvas_centers(torch.from_numpy(feats.uv_raw), torch.from_numpy(feats.octave),
                                 cfg.orb.scale_factor, torch.from_numpy(off)).numpy()
    np.testing.assert_array_equal(got, want)


def test_stereo_match_on_identical_features(jax_frontend_out):
    """The JAX left/right features and patches through both matchers: the
    same matched set, right_u and depth to f32 rounding."""
    feats, patches, _ = jax_frontend_out
    c = small_cfg(jcfg).camera
    kw = dict(scale_factor=1.2, fx=c.fx, bf=c.bf, image_width=c.width)
    side = [jax.tree.map(lambda a, b=b: a[b], feats) for b in (0, 1)]
    ru_j, d_j = jstereo.stereo_match(*[jax.tree.map(jnp.asarray, s) for s in side],
                                     jnp.asarray(patches[0]), jnp.asarray(patches[1]), **kw)
    ts = [convert.features_to_torch(s, "cpu") for s in side]
    ru_t, d_t = tstereo.stereo_match(ts[0], ts[1], torch.from_numpy(patches[0]),
                                     torch.from_numpy(patches[1]), **kw)
    np.testing.assert_array_equal(ru_t.numpy() >= 0, np.asarray(ru_j) >= 0)
    np.testing.assert_allclose(ru_t.numpy(), np.asarray(ru_j), atol=1e-3)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-4, atol=1e-4)


def test_stereo_frontend_end_to_end(frame_pair, jax_frontend_out):
    """Whole frontend on one rendered pair: keypoints, descriptors and depth
    of the two packages agree (the pyramid's one-ulp differences may move a
    few corners)."""
    _, _, sj = jax_frontend_out
    cfg = small_cfg(tcfg)
    fe = text.make_stereo_frontend(cfg, "cpu")
    st = fe(torch.from_numpy(frame_pair[0]), torch.from_numpy(frame_pair[1]),
            TCam.from_config(cfg.camera, "cpu"))
    fj, ft = sj.feats, st.feats
    same_kp = (np.all(ft.uv.numpy() == fj.uv, axis=1) & (ft.valid.numpy() == fj.valid))
    assert same_kp.mean() >= 0.97, same_kp.mean()
    both = same_kp & fj.valid
    desc_same = np.all(ft.desc.numpy().view(np.uint32)[both] == fj.desc[both], axis=1)
    assert desc_same.mean() >= 0.97, desc_same.mean()
    dep_both = both & (sj.depth > 0) & (st.depth.numpy() > 0)
    assert dep_both.sum() >= 0.95 * (both & (sj.depth > 0)).sum()
    np.testing.assert_allclose(st.depth.numpy()[dep_both], sj.depth[dep_both], rtol=1e-3)


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode (run python3 chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nms", [True, False])
def test_fast_nms_kernel_equals_plain_on_gpu(cuda_device, nms):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x = (torch.rand((2, 376, 1241), generator=g, device=cuda_device) * 255).to(torch.bfloat16)
    x[:, 100:130, 200:270] = 77.0
    ker = tfast.fast_score_nms(x, 7.0, nms=nms)
    ref = tfast.fast_score(x, 7.0)
    ref = tfast.nms3(ref) if nms else ref
    torch.cuda.synchronize()
    assert torch.equal(ker, ref)


@pytest.mark.gpu
def test_patches_kernel_equals_plain_on_gpu(cuda_device):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1)
    canvas = (torch.rand((3542, 1536), generator=g, device=cuda_device) * 255).to(torch.bfloat16)
    c = torch.stack([torch.randint(-30, 3600, (4096,), generator=g, device=cuda_device),
                     torch.randint(-30, 1600, (4096,), generator=g, device=cuda_device)], 1)
    c = c.to(torch.int32).contiguous()
    ker = tpatches.extract_patches_48x64(canvas, c)
    torch.cuda.synchronize()
    assert torch.equal(ker, tpatches.extract_patches_plain(canvas, c))
