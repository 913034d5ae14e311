"""The relocalization query and cascade through ``frame_graph.RelocGraph``
(``SLAM.reloc_program``), on the CPU, on the JAX-saved map of
``tests/test_torch_reloc.py`` (its ``built`` fixture), and the one-sided
Jacobi SVD the cascade now decomposes with.

``RelocGraph(capture=False)`` runs the CUDA path's static-buffer wrapper
with the program called where the card replays its graph:

* the wrapper runs under ``torch_host_reads.NoHostReads``;
* it equals the eager path the port took before (BoW query,
  ``find_reloc_candidates``, ``reloc_all_candidates`` drawing from the
  generator seeded with the frame id) bit for bit, and the RANSAC's uniform
  draw handed in as ``u`` equals the generator's own;
* the slice relocalizes on the JAX-saved map through the wrapper onto the
  keyframe the JAX system accepts, within 0.5 m;
* a warm-up (``SLAM._warm_reloc``) captures what a LOST frame replays, so
  the LOST frame captures nothing, and a capacity change drops the graph;
* ``linalg_small.jacobi_svd`` against ``torch.linalg.svd`` in float64:
  singular values within 2e-6 of the largest, each right singular vector
  of a singular value 1% apart from its neighbours within 1e-4 of its
  reference up to sign,
  V orthogonal within 1e-5; ``lstsq_min_norm`` against ``pinv`` within
  1e-4 of the solution's scale (10·κ·ε of f32 at the condition number
  κ ≈ 100 of the systems).

On the card (``gpu``, skipped here) the replay equals the eager wrapper.
"""

import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_reloc import (  # noqa: F401  (built and jax_reloc are fixtures)
    N_FRAMES,
    RELOC_FRAME,
    built,
    jax_reloc,
    load_port,
)
from torch_host_reads import NoHostReads

from orb_slam2_ros2_tpu_torch.bow import vocabulary as tvoc
from orb_slam2_ros2_tpu_torch.bow.keyframe_db import find_reloc_candidates, sparse_bow
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_ros2_tpu_torch.solvers import epnp as tepnp
from orb_slam2_ros2_tpu_torch.solvers import linalg_small


@pytest.fixture(scope="module")
def lost(built):
    """A port in localization mode on the JAX map and the features of a
    frame it has to relocalize."""
    slam = load_port(built)
    img_l, img_r, _ = built["frames"][RELOC_FRAME]
    frame = slam._frontend(torch.from_numpy(img_l), torch.from_numpy(img_r), slam.cam)
    return slam, frame


def eager_reloc(slam, frame, fid):
    """The port's relocalization before the graph: query, then the cascade
    drawing from a generator seeded with ``fid``."""
    lc = slam.loop_closer
    words = tvoc.transform(lc.vocab, frame.feats.desc, frame.feats.valid)
    qvec = sparse_bow(lc.vocab, words, slam.cfg.bow.max_words_per_query)
    cand, _ = find_reloc_candidates(lc.db, slam.map, qvec, n_words=lc.vocab.n_words)
    gen = torch.Generator()
    gen.manual_seed(fid)
    return cand, tsys.reloc_all_candidates(slam.map, slam.map_cam, frame, cand, gen, **slam._reloc_common)


def graph_reloc(slam, frame, fid):
    gen = torch.Generator()
    gen.manual_seed(fid)
    u = tepnp.uniform_draw((tsys.RELOC_CANDIDATES,), frame.feats.capacity, gen)
    return slam._reloc_graph(frame, u, slam.loop_closer.db, slam.map, slam.loop_closer.vocab)


def test_reloc_program_reads_nothing_back(lost):
    slam, frame = lost
    with NoHostReads() as mode:
        packed, cur_mp = graph_reloc(slam, frame, RELOC_FRAME)
    assert mode.ops > 1000
    assert packed.shape == (tsys.RELOC_CANDIDATES, 19) and cur_mp.shape == (tsys.RELOC_CANDIDATES, 768)


@pytest.mark.parametrize("fid", [RELOC_FRAME, 3])
def test_wrapper_equals_the_eager_path_bit_for_bit(lost, fid):
    slam, frame = lost
    cand, (pe, me) = eager_reloc(slam, frame, fid)
    pg, mg = graph_reloc(slam, frame, fid)
    assert (cand >= 0).sum() >= 2 and pe[:, 0].sum() >= 1
    assert torch.equal(pg, pe) and torch.equal(mg, me)


def test_uniform_draw_equals_the_generator(lost):
    """``u`` from ``uniform_draw`` gives the minimal sets and the cascade
    the generator gives."""
    slam, frame = lost
    cand, (pe, me) = eager_reloc(slam, frame, 7)
    gen = torch.Generator()
    gen.manual_seed(7)
    u = tepnp.uniform_draw((len(cand),), frame.feats.capacity, gen)
    pu, mu = tsys.reloc_all_candidates(slam.map, slam.map_cam, frame, cand, u=u, **slam._reloc_common)
    assert torch.equal(pu, pe) and torch.equal(mu, me)
    valid = frame.feats.valid[None].expand(3, -1)
    gen.manual_seed(11)
    want = tepnp.sample_minimal_sets(valid, tepnp.N_HYP, 6, gen)
    gen.manual_seed(11)
    got = tepnp.sample_minimal_sets(valid, tepnp.N_HYP, 6, u=tepnp.uniform_draw((3,), valid.shape[-1], gen))
    assert torch.equal(got, want)


def test_slice_relocalizes_through_the_wrapper(built, jax_reloc):
    slam = load_port(built)
    pose, info = slam.track(*built["frames"][RELOC_FRAME][:2])
    assert pose is not None and slam.state == TrackState.OK and info["relocalized"], info
    assert info["n_inliers"] >= 50
    assert np.linalg.norm(pose[:3, 3] - built["poses"][RELOC_FRAME][:3, 3]) < 0.5
    pj = jax_reloc["packed"]
    assert info["reloc_kf"] == int(pj[int(np.argmax(pj[:, 0] > 0)), 2])
    assert slam._reloc_graph.replays == 1
    for i in range(RELOC_FRAME + 1, N_FRAMES):   # tracks on
        pose, _ = slam.track(*built["frames"][i][:2])
        assert pose is not None and slam.state == TrackState.OK


def test_warm_up_then_lost_frame_captures_nothing(built):
    """The warm-up feeds keyframe 0's features against an empty database:
    the program and its signature are the LOST frame's, so the LOST frame
    replays what the warm-up captured; a capacity change drops it."""
    slam = load_port(built)
    with NoHostReads():
        slam._warm_reloc()
    g = slam._reloc_graph
    assert g.captures == 1 and g.replays == 1
    pose, info = slam.track(*built["frames"][RELOC_FRAME][:2])
    assert info["relocalized"] and g.captures == 1 and g.replays == 2
    slam._grow(mp_capacity=2 * slam.map.mp_capacity)
    assert g.captures == 0 and slam._gba_graphs.captures == 0
    slam.state = TrackState.LOST
    pose, info = slam.track(*built["frames"][RELOC_FRAME + 1][:2])
    assert info["relocalized"] and g.captures == 1


# ------------------------------------------------------------ Jacobi SVD --

def conditioned(r, B, m, n, decades):
    return r.normal(size=(B, m, n)) @ np.diag(np.logspace(0, -decades, n))


@pytest.mark.parametrize("m,n,decades", [(12, 12, 4), (6, 3, 2), (6, 5, 3), (8, 12, 3), (6, 4, 0)],
                         ids=["M_12x12", "centred_6x3", "beta3_6x5", "wide_8x12", "even_6x4"])
def test_jacobi_svd_matches_torch_linalg(m, n, decades):
    r = np.random.default_rng(m * 100 + n)
    A = torch.from_numpy(conditioned(r, 64, m, n, decades).astype(np.float32))
    s, V, W = linalg_small.jacobi_svd(A)
    ref = torch.linalg.svd(A.double(), full_matrices=True)
    k = min(m, n)
    smax = ref.S[..., :1]
    assert ((s[..., :k].double() - ref.S[..., :k]).abs() / smax).max() <= 2e-6
    if n > m:
        assert (s[..., k:].double() / smax).max() <= 2e-6   # the null space
    Vr = ref.Vh.transpose(-1, -2)
    # a singular value's vector is defined (up to sign) when its value is
    # apart from its neighbours' (the null space's zeros included) by 1% of
    # the larger: one-sided Jacobi keeps relative accuracy
    S = torch.cat([ref.S, torch.zeros_like(ref.S[..., :1])], -1) if n > m else ref.S
    d = (S[..., 1:] - S[..., :-1]).abs() / S[..., :-1]
    inf = torch.full_like(S[..., :1], float("inf"))
    separated = (torch.minimum(torch.cat([inf, d], -1), torch.cat([d, inf], -1)) > 1e-2)[..., :k]
    cos = (V[..., :k].double() * Vr[..., :k]).sum(-2).abs()
    assert separated.float().mean() > 0.5
    assert (1 - cos[separated]).max() <= 1e-4
    assert (V.transpose(-1, -2) @ V - torch.eye(n)).abs().max() <= 1e-5
    assert torch.allclose(W, A @ V, atol=1e-5 * float(smax.max()))


def test_lstsq_min_norm_matches_pinv():
    r = np.random.default_rng(5)
    A = conditioned(r, 64, 6, 5, 2)
    A[:32, :, 4] = 2 * A[:32, :, 3]   # rank-deficient half
    A = torch.from_numpy(A.astype(np.float32))
    b = torch.from_numpy(r.normal(size=(64, 6)).astype(np.float32))
    rcond = 1.1920929e-07 * 6
    x = linalg_small.lstsq_min_norm(A, b, rcond)
    want = torch.einsum("...nm,...m->...n", torch.linalg.pinv(A.double(), rtol=rcond), b.double())
    scale = want.abs().amax(-1, keepdim=True)
    assert ((x.double() - want).abs() / scale).max() <= 1e-4


# ------------------------------------------------------------ on the card --

@pytest.mark.gpu
def test_captured_reloc_graph_equals_the_eager_wrapper_on_gpu(built):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the relocalization program is captured there "
                    "(run python3 chip_smoke.py on the card)")
    from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import RelocGraph

    slam = tsys.SLAM(load_port(built).cfg, enable_loop_closing=False, device="cuda")
    slam.load(built["path"])   # captures at the load's warm-up
    img_l, img_r, _ = built["frames"][RELOC_FRAME]
    frame = slam._frontend(torch.from_numpy(img_l).cuda(), torch.from_numpy(img_r).cuda(), slam.cam)
    eager = RelocGraph(slam.reloc_program, capture=False)
    for fid in (RELOC_FRAME, 3):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(fid)
        u = tepnp.uniform_draw((tsys.RELOC_CANDIDATES,), frame.feats.capacity, gen)
        args = (frame, u, slam.loop_closer.db, slam.map, slam.loop_closer.vocab)
        want, got = eager(*args), slam._reloc_graph(*args)
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert slam._reloc_graph.captures == 1
