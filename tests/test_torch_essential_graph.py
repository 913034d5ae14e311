"""The essential graph through ``loop_closing.EssentialGraph`` with int32 [1]
tensor ids, on the CPU, against the JAX package's ``optimize_essential``.

``EssentialGraph(capture=False)`` runs the CUDA path's three static-buffer
wrappers (the problem, one GN step replayed 20 times, the commit) with each
program called where the card replays its graph.  On the 12-keyframe ring
of ``tests/test_torch_loop_closing.py`` after the group correction and the
attach of the matched points:

* both single-process routes (dense Cholesky, and PCG with
  ``dense_max_k=0`` on the 16-slot map) equal JAX within that file's
  tolerances (integer tables exact, poses within 1 mm / 1e-3°, points
  within 5 mm) and the eager ``optimize_essential`` bit for bit;
* every part runs under ``torch_host_reads.NoHostReads``;
* a second closure with other inputs in the same statics (another loop
  pair and Sim3) equals its own eager run;
* ``LoopCloser.warm_essential`` captures at the signatures a closure
  meets, so ``correct`` after it captures nothing, and ``grow`` drops the
  graphs.

On the card (``gpu``, skipped here) the replays equal the eager program.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch
from test_torch_loop_closing import (  # noqa: F401  (two_torch_threads is autouse, ring a fixture)
    assert_maps_agree, np_tree, ring, t_sim3, two_torch_threads)
from torch_host_reads import NoHostReads

from orb_slam2_ros2_tpu.pipeline import loop_closing as jlc
from orb_slam2_ros2_tpu.solvers.pose_graph import optimize_pose_graph as j_opg
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_ros2_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_ros2_tpu_torch.solvers.pose_graph import optimize_pose_graph as t_opg

DENSE_MAX_K = {"dense": 256, "pcg": 0}   # the PCG route on the 16-slot ring


def t32(v) -> torch.Tensor:
    return torch.tensor([int(v)], dtype=torch.int32)


@pytest.fixture(scope="module")
def corrected(ring):
    """The JAX ring after the group correction and the attach, and the
    inputs of the essential graph in both packages."""
    sj = ring["sj"]
    mw = ring["cfg_j"].mapping.min_covis_weight
    pre_j = sj.covis > 0
    s1j, S_nc, gmask = jlc.correct_group(sj, 11, 0, ring["S12"], min_covis_weight=mw)
    s2j = jax.jit(jlc.attach_matched_mps)(s1j, 11, ring["matched"])
    t_in = (convert.map_state_to_torch(np_tree(s2j), "cpu"), t_sim3(ring["S12"]), t_sim3(S_nc),
            torch.from_numpy(np.asarray(gmask)), torch.from_numpy(np.asarray(pre_j)))
    return dict(j_in=(s2j, ring["S12"], S_nc, gmask, pre_j), t_in=t_in)


def eager(state, kf_cur, kf_cand, S12, S_nc, gmask, pre, route):
    return tlc.optimize_essential(state, kf_cur, kf_cand, S12, S_nc, gmask, pre, essential_weight=100,
                                  pose_graph_fn=partial(t_opg, iters=20, dense_max_k=DENSE_MAX_K[route]))


def assert_bit_equal(a, b):
    for name in ("kf_Tcw", "mp_pos"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("route", list(DENSE_MAX_K))
def test_essential_graph_matches_jax_and_the_eager_program(corrected, route):
    s2j, S12j, S_ncj, gmask_j, pre_j = corrected["j_in"]
    ej = jax.jit(partial(jlc.optimize_essential, essential_weight=100,
                         pose_graph_fn=partial(j_opg, iters=20, dense_max_k=DENSE_MAX_K[route])))(s2j, 11, 0, S12j, S_ncj, gmask_j, pre_j)
    state, S12, S_nc, gmask, pre = corrected["t_in"]
    g = tlc.EssentialGraph(essential_weight=100, capture=False, dense_max_k=DENSE_MAX_K[route])
    ids = t32(11), t32(0)
    with NoHostReads():
        et = g(state, *ids, S12, S_nc, gmask, pre)
    assert_maps_agree(ej, et, point_m=5e-3, pose_m=1e-3)
    assert_bit_equal(et, eager(state, 11, 0, S12, S_nc, gmask, pre, route))
    assert g.captures == 3 and g.replays == 22

    # another closure (pair and Sim3) through the same statics
    S12b = tsim3.Sim3(R=S12.R, t=S12.t + 0.05, s=S12.s * 1.01)
    ids = t32(10), t32(1)
    with NoHostReads():
        et2 = g(state, *ids, S12b, S_nc, gmask, pre)
    assert_bit_equal(et2, eager(state, 10, 1, S12b, S_nc, gmask, pre, route))
    assert not torch.equal(et2.kf_Tcw, et.kf_Tcw)
    assert g.captures == 3 and g.replays == 44


def test_warm_essential_captures_what_a_closure_meets(ring):
    """After ``warm_essential`` a real correction reuses every part's
    statics (the warm-up's identity Sim3 and keyframe-0 pair have the
    closure's signatures); a capacity change drops them."""
    lc = tlc.LoopCloser(ring["cfg_t"], ring["ct"].vocab)
    lc.warm_essential(ring["stt"])
    g = lc.essential
    assert g.captures == 3
    gt = convert.local_map_to_torch(np_tree(ring["group"]), "cpu")
    out = lc.correct(ring["stt"], ring["cam_t"], 11, 0, t_sim3(ring["S12"]),
                     torch.from_numpy(np.asarray(ring["matched"])), gt, run_gba=False)
    assert lc.essential is g and g.captures == 3 and g.replays == 44
    direct = tlc.LoopCloser(ring["cfg_t"], ring["ct"].vocab).correct(
        ring["stt"], ring["cam_t"], 11, 0, t_sim3(ring["S12"]), torch.from_numpy(np.asarray(ring["matched"])),
        gt, run_gba=False)
    for a, b in zip(out, direct):
        assert torch.equal(a, b)
    lc.grow(2 * ring["stt"].kf_capacity)
    assert lc.essential is None


# ------------------------------------------------------------ on the card --

@pytest.mark.gpu
@pytest.mark.parametrize("route", list(DENSE_MAX_K))
def test_captured_essential_graph_equals_the_eager_program_on_gpu(corrected, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the essential graph is captured there "
                    "(run python3 chip_smoke.py on the card)")
    dev = torch.device("cuda")
    state, S12, S_nc, gmask, pre = (convert.map_state_to_torch(np_tree(corrected["j_in"][0]), dev),
                                    *(x.to(dev) if torch.is_tensor(x) else tsim3.Sim3(*(t.to(dev) for t in x))
                                      for x in corrected["t_in"][1:]))
    g = tlc.EssentialGraph(essential_weight=100, capture=True, dense_max_k=DENSE_MAX_K[route])
    want = eager(state, 11, 0, S12, S_nc, gmask, pre, route)
    for _ in range(3):   # the first call runs eagerly and captures; then replays
        assert_bit_equal(g(state, 11, 0, S12, S_nc, gmask, pre), want)
    assert g.captures == 3
