"""Parity of the port's Horn alignment and EPnP RANSAC with the JAX package,
on the CPU.

The same numpy inputs from a seed go through both.  ``horn_align`` agrees to
1e-5.  ``epnp_solve`` is compared on poses (1e-3 in the se(3) tangent), not
on null vectors: their sign, and their basis where singular values nearly
tie, differ between SVD implementations.  ``ransac_pnp`` is given the minimal
sets the JAX function drew (``jax.random.split`` + ``jax.random.choice``
exactly as it draws them), so everything after the draw runs on equal
hypotheses: best score within 2, pose within 1e-3.  The port's own draw
(Gumbel top-k from a ``torch.Generator``) is checked for determinism, for
choosing valid rows only, and for not raising when fewer than ``min_set``
rows are valid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.geometry import align as jalign
from orb_slam2_ros2_tpu.geometry import se3 as jse3
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.geometry.camera import project as jproject
from orb_slam2_ros2_tpu.solvers import epnp as jepnp
from orb_slam2_ros2_tpu_torch.geometry import align as talign
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.solvers import epnp as tepnp

CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, baseline=0.5, width=640, height=480)


def t(a):
    return torch.from_numpy(np.array(a))


def cams():
    return JCam.from_config(jcfg.CameraConfig(**CAM)), TCam.from_config(tcfg.CameraConfig(**CAM), "cpu")


def rot(r):
    q, _ = np.linalg.qr(r.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def tangent_err(Ta, Tb) -> float:
    """‖log(Ta · Tb⁻¹)‖ over rotation and translation parts."""
    d = np.asarray(jse3.log(jnp.asarray(np.asarray(Ta)) @ jse3.inverse(jnp.asarray(np.asarray(Tb)))))
    return float(np.abs(d).max())


# ------------------------------------------------------------------ Horn --

@pytest.mark.parametrize("case", ["rigid", "scale", "weighted"])
def test_horn_align_matches_jax(case):
    r = np.random.default_rng({"rigid": 0, "scale": 1, "weighted": 2}[case])
    B, S = 7, 20
    R_gt = np.stack([rot(r) for _ in range(B)])
    t_gt = r.normal(size=(B, 3)).astype(np.float32)
    s_gt = r.uniform(0.5, 2.5, B).astype(np.float32) if case == "scale" else np.ones(B, np.float32)
    src = r.normal(size=(B, S, 3)).astype(np.float32)
    dst = (s_gt[:, None, None] * np.einsum("bij,bsj->bsi", R_gt, src) + t_gt[:, None]).astype(np.float32)
    w = np.ones((B, S), np.float32)
    if case == "weighted":
        dst[:, :5] += 10.0
        w[:, :5] = 0.0
    with_scale = case == "scale"
    Rj, tj, sj = jalign.horn_align(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), with_scale=with_scale)
    Rt, tt, st = talign.horn_align(t(src), t(dst), t(w), with_scale=with_scale)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), R_gt, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), s_gt, rtol=1e-4)


def test_max_eigvec_and_quat_match_jax():
    r = np.random.default_rng(3)
    A = r.normal(size=(64, 4, 4)).astype(np.float32)
    N = A + A.swapaxes(1, 2)
    vj = np.asarray(jalign._max_eigvec_4x4(jnp.asarray(N)))
    vt = talign._max_eigvec_4x4(t(N)).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    lam, vec = np.linalg.eigh(N.astype(np.float64))
    assert np.abs(np.abs(np.einsum("bi,bi->b", vt, vec[:, :, -1])) - 1).max() < 1e-3
    q = vt / np.linalg.norm(vt, axis=1, keepdims=True)
    np.testing.assert_allclose(talign.quat_to_rot(t(q)).numpy(), np.asarray(jalign.quat_to_rot(jnp.asarray(q))),
                               atol=1e-6)


# ------------------------------------------------------------------ EPnP --

def scene(seed=3, n=100, outlier_frac=0.0, px_noise=0.3, planar=False):
    """The scenes of ``tests/test_reloc_bow.py``."""
    r = np.random.default_rng(seed)
    cam_j, _ = cams()
    if planar:
        Tcw_gt = jse3.exp(jnp.asarray([0.2, -0.1, 0.4, 0.08, -0.03, 0.15], jnp.float32))
        pw = np.stack([r.uniform(-4, 4, n), r.uniform(-2.5, 2.5, n), np.full(n, 9.0)], 1).astype(np.float32)
    else:
        Tcw_gt = jse3.exp(jnp.asarray([0.3, -0.2, 0.5, 0.1, -0.05, 0.2], jnp.float32))
        pw = np.stack([r.uniform(-5, 5, n), r.uniform(-3, 3, n), r.uniform(4, 20, n)], 1).astype(np.float32)
    uv, _ = jproject(cam_j, jse3.apply(Tcw_gt, jnp.asarray(pw)))
    uv = np.asarray(uv) + r.normal(0, px_noise, (n, 2)).astype(np.float32) * (px_noise > 0)
    n_out = int(n * outlier_frac)
    uv[:n_out] += r.uniform(30, 100, (n_out, 2))
    return np.asarray(Tcw_gt), pw, uv.astype(np.float32), n_out


@pytest.mark.parametrize("case,kw,gt_tol", [
    ("minimal_exact", dict(n=6, px_noise=0.0), 0.05),
    ("planar", dict(seed=11, n=8, px_noise=0.0, planar=True), 0.08),
    ("well_conditioned", dict(n=40, px_noise=0.0), 0.01),
])
def test_epnp_solve_matches_jax(case, kw, gt_tol):
    cam_j, cam_t = cams()
    Tcw_gt, pw, uv, _ = scene(**kw)
    Tj, okj = jepnp.epnp_solve(cam_j, jnp.asarray(pw), jnp.asarray(uv))
    Tt, okt = tepnp.epnp_solve(cam_t, t(pw), t(uv))
    assert bool(okj) and bool(okt)
    assert tangent_err(Tt.numpy(), Tj) < 1e-3
    assert tangent_err(Tt.numpy(), Tcw_gt) < gt_tol


def test_epnp_solve_batched_and_degenerate():
    """A batch of sets equals the sets one by one; a collinear set and a
    set of one repeated point (singular barycentric system) are refused
    without raising, as the JAX version refuses them."""
    cam_j, cam_t = cams()
    _, pw, uv, _ = scene(n=60, px_noise=0.0)
    r = np.random.default_rng(5)
    sets = np.stack([r.choice(60, 6, replace=False) for _ in range(8)])
    Tb, okb = tepnp.epnp_solve(cam_t, t(pw[sets]), t(uv[sets]))
    for h in range(8):
        T1, ok1 = tepnp.epnp_solve(cam_t, t(pw[sets[h]]), t(uv[sets[h]]))
        assert bool(ok1) == bool(okb[h])
        np.testing.assert_allclose(Tb[h].numpy(), T1.numpy(), atol=1e-4)
    line = np.stack([np.linspace(-1, 1, 6), np.zeros(6), np.full(6, 8.0)], 1).astype(np.float32)
    same = np.tile(pw[:1], (6, 1))
    for bad in (line, same):
        uvb = np.asarray(jproject(cam_j, jnp.asarray(bad))[0])
        Tt, okt = tepnp.epnp_solve(cam_t, t(bad), t(uvb))
        _, okj = jepnp.epnp_solve(cam_j, jnp.asarray(bad), jnp.asarray(uvb))
        assert not bool(okt) and not bool(okj)
        np.testing.assert_array_equal(Tt.numpy(), np.eye(4, dtype=np.float32))


def test_beta_cases_and_gauss_newton_match_jax():
    """Well-conditioned inter-distance systems: the β initializations agree
    to 1e-4 relative, and five Gauss-Newton steps land on the same β."""
    r = np.random.default_rng(7)
    dv = r.normal(size=(4, 6, 3)).astype(np.float32)
    beta_true = np.array([1.3, -0.4, 0.2, 0.0], np.float32)
    comb = np.einsum("k,kni->ni", beta_true, dv)
    rho = (comb * comb).sum(1).astype(np.float32)
    bj = np.asarray(jepnp._beta_cases(jnp.asarray(dv), jnp.asarray(rho)))
    bt = tepnp._beta_cases(t(dv), t(rho)).numpy()
    np.testing.assert_allclose(bt, bj, rtol=1e-4, atol=1e-5)
    gj = np.asarray(jax.vmap(lambda b: jepnp._gauss_newton_betas(b, jnp.asarray(dv), jnp.asarray(rho)))(jnp.asarray(bj)))
    gt = tepnp._gauss_newton_betas(t(bj), t(dv)[None], t(rho)[None]).numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-4)


def jax_minimal_sets(key, valid, n_hyp=64, min_set=6):
    """The minimal sets ``ransac_pnp`` / ``ransac_sim3`` of the JAX package
    draw from ``key``, by the same calls."""
    n = valid.shape[0]
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(min_set,), replace=False, p=jax.nn.softmax(logits)))(keys))


def test_ransac_pnp_on_jax_sets_matches_jax():
    cam_j, cam_t = cams()
    Tcw_gt, pw, uv, n_out = scene(n=120, outlier_frac=0.3)
    valid = np.ones(120, bool)
    valid[100:110] = False
    inv_s2 = np.random.default_rng(1).uniform(0.5, 1.0, 120).astype(np.float32)
    key = jax.random.PRNGKey(0)
    Tj, inlj, nj = jepnp.ransac_pnp(cam_j, jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(inv_s2),
                                    jnp.asarray(valid), key)
    sets = jax_minimal_sets(key, valid)
    Tt, inlt, nt = tepnp.ransac_pnp(cam_t, t(pw), t(uv), t(inv_s2), t(valid), sets=t(sets))
    assert int(nj) > 50
    assert abs(int(nt) - int(nj)) <= 2
    assert tangent_err(Tt.numpy(), Tj) < 1e-3
    assert (inlt.numpy() != np.asarray(inlj)).sum() <= 2
    assert not inlt.numpy()[100:110].any() and inlt.numpy()[:n_out].mean() < 0.2
    assert tangent_err(Tt.numpy(), Tcw_gt) < 0.1


def test_ransac_pnp_generator_path():
    """The port's own draw: deterministic for a seed, different for another,
    valid rows only, batched over leading dimensions; with fewer than
    ``min_set`` valid rows it fills the sets with invalid rows and does not
    raise."""
    _, cam_t = cams()
    Tcw_gt, pw, uv, _ = scene(n=120, outlier_frac=0.3)
    valid = np.ones(120, bool)
    valid[::3] = False
    ones = torch.ones(120)

    def gen(seed):
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        return g

    s1 = tepnp.sample_minimal_sets(t(valid), 64, 6, gen(7))
    s2 = tepnp.sample_minimal_sets(t(valid), 64, 6, gen(7))
    s3 = tepnp.sample_minimal_sets(t(valid), 64, 6, gen(8))
    assert torch.equal(s1, s2) and not torch.equal(s1, s3)
    assert s1.shape == (64, 6) and valid[s1.numpy()].all()
    assert all(len(set(row)) == 6 for row in s1.numpy().tolist())
    T1, inl1, n1 = tepnp.ransac_pnp(cam_t, t(pw), t(uv), ones, t(valid), gen(7))
    T2, _, n2 = tepnp.ransac_pnp(cam_t, t(pw), t(uv), ones, t(valid), gen(7))
    assert torch.equal(T1, T2) and int(n1) == int(n2) > 40
    assert tangent_err(T1.numpy(), Tcw_gt) < 0.1
    # two problems as one batch: the second has no valid row at all
    vb = np.stack([valid, np.zeros(120, bool)])
    Tb, inlb, nb = tepnp.ransac_pnp(cam_t, t(np.stack([pw, pw])), t(uv), ones, t(vb), gen(7))
    assert Tb.shape == (2, 4, 4) and int(nb[0]) > 40 and int(nb[1]) == 0 and not inlb[1].any()
    few = np.zeros(120, bool)
    few[[50, 60, 70]] = True
    sf = tepnp.sample_minimal_sets(t(few), 16, 6, gen(1)).numpy()
    assert all({50, 60, 70} <= set(row) and len(set(row)) == 6 for row in sf.tolist())
    _, _, nf = tepnp.ransac_pnp(cam_t, t(pw), t(uv), ones, t(few), gen(1))
    assert 0 <= int(nf) <= 3
    with pytest.raises(ValueError):
        tepnp.ransac_pnp(cam_t, t(pw), t(uv), ones, t(valid))
