"""Parity of the port's small geometry helpers with the JAX package's, on the
CPU, and the port's device defaults.

Seeded numpy inputs go through both packages: ``CameraParams.K``,
``project_stereo``, ``distort_points``, ``se3.identity`` / ``compose`` /
``log`` (small and large angles), ``robust.octave_inv_sigma2`` /
``chi2_gate`` and ``align.quat_to_rot``, within f32 1e-5 relative (1e-5
absolute near zero); masks and the identity exact.

No public function or method of the port defaults its ``device`` to the CPU:
an entry point runs on the card unless the caller asks for the CPU.
"""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch as tpkg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.geometry import align as jalign
from orb_slam2_ros2_tpu.geometry import camera as jcam
from orb_slam2_ros2_tpu.geometry import robust as jrob
from orb_slam2_ros2_tpu.geometry import se3 as jse3
from orb_slam2_ros2_tpu_torch.geometry import align as talign
from orb_slam2_ros2_tpu_torch.geometry import camera as tcam
from orb_slam2_ros2_tpu_torch.geometry import robust as trob
from orb_slam2_ros2_tpu_torch.geometry import se3 as tse3

RTOL, ATOL = 1e-5, 1e-5
CAM = dict(fx=400.0, fy=390.0, cx=320.0, cy=240.0, baseline=0.5, width=640, height=480,
           k1=-0.2, k2=0.05, p1=1e-3, p2=-5e-4, k3=0.01)


def close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def cams():
    return (jcam.CameraParams.from_config(jcfg.CameraConfig(**CAM)),
            tcam.CameraParams.from_config(tcfg.CameraConfig(**CAM), "cpu"))


def test_intrinsic_matrix(cams):
    jc, tc = cams
    np.testing.assert_array_equal(tc.K.numpy(), np.asarray(jc.K))


def test_project_stereo(cams):
    jc, tc = cams
    r = np.random.default_rng(0)
    pc = np.stack([r.uniform(-5, 5, 300), r.uniform(-3, 3, 300), r.uniform(-1, 30, 300)], 1).astype(np.float32)
    pc[:5, 2] = [0.0, -1.0, 1e-7, 2e-6, 1e-6]   # at, behind and just in front of the plane
    uv_j, ur_j, ok_j = jcam.project_stereo(jc, jnp.asarray(pc))
    uv_t, ur_t, ok_t = tcam.project_stereo(tc, torch.from_numpy(pc))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    close(uv_t, uv_j)
    close(ur_t, ur_j)


def test_distort_points_inverts_undistort(cams):
    jc, tc = cams
    r = np.random.default_rng(1)
    uv = np.stack([r.uniform(0, 640, 500), r.uniform(0, 480, 500)], 1).astype(np.float32)
    got = tcam.distort_points(tc, torch.from_numpy(uv))
    close(got, jcam.distort_points(jc, jnp.asarray(uv)), atol=1e-3)  # pixels of ~10²: 1e-5 relative
    # the fixed-point undistortion takes the distorted points back
    back = tcam.undistort_points(tc, got)
    np.testing.assert_allclose(back.numpy(), uv, atol=0.05)


def test_se3_identity_and_compose():
    np.testing.assert_array_equal(tse3.identity((3, 2), device="cpu").numpy(),
                                  np.asarray(jse3.identity((3, 2))))
    np.testing.assert_array_equal(tse3.identity(device="cpu").numpy(), np.asarray(jse3.identity()))
    r = np.random.default_rng(2)
    xa, xb = (r.normal(0, 0.5, (7, 6)).astype(np.float32) for _ in range(2))
    A, B = np.array(jse3.exp(jnp.asarray(xa))), np.array(jse3.exp(jnp.asarray(xb)))
    close(tse3.compose(torch.from_numpy(A), torch.from_numpy(B)), jse3.compose(jnp.asarray(A), jnp.asarray(B)))


@pytest.mark.parametrize("scale", [0.0, 1e-9, 1e-5, 1e-3, 0.5, 2.5])
def test_se3_log(scale):
    """Through exp then log, rotation angles from 0 (the series branches of
    ``so3_log`` and ``V``) to 2.5 rad.  phi agrees within 1e-5.  rho within
    1e-5 plus the f32 conditioning of ``V`` outside its series branch
    (θ² ≥ 1e-8): (1 − cos θ)/θ² and (θ − sin θ)/θ³ lose 2⁻²⁴/θ² of relative
    accuracy to one rounding of cos and sin, which moves V⁻¹t by about
    2⁻²⁴·|t|/θ in each package (1.2e-4 m at θ = 1e-3 rad for |t| ≈ 1 m)."""
    r = np.random.default_rng(int(scale * 1e9) % 2**31)
    xi = np.concatenate([r.normal(0, 1.0, (64, 3)), scale * r.normal(0, 1.0, (64, 3))], 1)
    xi[:, 3:] = np.clip(xi[:, 3:], -2.5 / np.sqrt(3), 2.5 / np.sqrt(3))
    T = np.array(jse3.exp(jnp.asarray(xi, jnp.float32)))
    got = tse3.log(torch.from_numpy(T)).numpy()
    want = np.asarray(jse3.log(jnp.asarray(T)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=RTOL, atol=ATOL)
    theta = np.linalg.norm(want[:, 3:], axis=1)
    t_norm = np.linalg.norm(T[:, :3, 3], axis=1)
    cond = np.where(theta ** 2 >= 1e-8, 4 * 2.0 ** -24 * t_norm / np.maximum(theta, 1e-4), 0.0)
    err = np.abs(got[:, :3] - want[:, :3]).max(axis=1)
    assert np.all(err <= ATOL + RTOL * t_norm + cond), (err - cond).max()


def test_octave_weights_and_gate():
    octave = np.arange(8, dtype=np.int32).repeat(3)
    close(trob.octave_inv_sigma2(torch.from_numpy(octave), 1.2, 8),
          jrob.octave_inv_sigma2(jnp.asarray(octave), 1.2, 8), atol=0)
    e2 = np.random.default_rng(3).uniform(0, 12, 400).astype(np.float32)
    e2[:3] = [5.991, 7.815, 5.9909]
    for th in (5.991, 7.815):
        np.testing.assert_array_equal(trob.chi2_gate(torch.from_numpy(e2), th).numpy(),
                                      np.asarray(jrob.chi2_gate(jnp.asarray(e2), th)))


def test_quat_to_rot():
    q = np.random.default_rng(4).normal(size=(50, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    close(talign.quat_to_rot(torch.from_numpy(q)), jalign.quat_to_rot(jnp.asarray(q)))


def test_no_public_function_defaults_to_the_cpu():
    """Every public function, method and class constructor of every port
    module takes its ``device`` from the caller or defaults to the card."""
    offenders = []
    for info in pkgutil.walk_packages(tpkg.__path__, tpkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            members = [(name, obj)]
            if inspect.isclass(obj):
                members += [(f"{name}.{m}", f) for m, f in vars(obj).items()
                            if not m.startswith("_") or m == "__init__"]
            for qual, f in members:
                f = f.__func__ if isinstance(f, (staticmethod, classmethod)) else f
                if not callable(f):
                    continue
                try:
                    params = inspect.signature(f).parameters
                except (TypeError, ValueError):
                    continue
                dev = params.get("device")
                if dev is not None and dev.default == "cpu":
                    offenders.append(f"{info.name}.{qual}")
    assert not offenders, offenders
