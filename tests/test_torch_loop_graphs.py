"""Detection and the Sim3 stages through ``loop_closing.LoopGraphs`` with
int32 [1] tensor ids, on the CPU, against the JAX package's jitted
``_add_detect_prog``, ``_frame_detect_prog`` and ``_sim3_a/b/c``.

``LoopGraphs(capture=False)`` runs the CUDA path's static-buffer wrappers
with each program called where the card replays its graph.  On the
12-keyframe ring of ``tests/test_torch_loop_closing.py`` (keyframes 0-10
registered in both databases, keyframe 11 the revisit):

* each program equals JAX within that file's tolerances (integer tables
  exact, Sim3s within 1e-4), stage A on JAX's minimal sets passed as
  ``sets``;
* each equals the eager program (``LoopGraphs.eager`` with host-int ids)
  bit for bit, stage A on the same uniform draw ``u``;
* each runs under ``torch_host_reads.NoHostReads``;
* detection writes the keyframe's row into the database in place;
* the rebind test: a second call through the same wrapper with other ids
  (and other inputs) equals its own eager run, which a host int baked into
  a capture would not.

The correction's programs are in ``tests/test_torch_correct_graph.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_epnp import jax_minimal_sets
from test_torch_loop_closing import (  # noqa: F401  (two_torch_threads is autouse, ring a fixture)
    assert_sim3_close, np_tree, ring, t_sim3, two_torch_threads)
from torch_host_reads import NoHostReads

from orb_slam2_ros2_tpu.pipeline import loop_closing as jlc
from orb_slam2_ros2_tpu_torch.bow.keyframe_db import KeyFrameDB
from orb_slam2_ros2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_ros2_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_leaves
from orb_slam2_ros2_tpu_torch.solvers.epnp import uniform_draw

PROGRAMS = ("detect", "frame_detect", "sim3_a", "sim3_b", "sim3_c")
CUR, CAND = 11, 0          # the loop pair of the ring
OTHER = (10, 1)            # the rebind test's pair


def clone_db(db) -> KeyFrameDB:
    return KeyFrameDB(*(t.clone() for t in db))


def assert_bit_equal(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


def draw(state, seed):
    gen = torch.Generator().manual_seed(seed)
    return uniform_draw((), state.kf_uv.shape[1], gen, tlc.SIM3_HYPOTHESES, device="cpu")


@pytest.fixture(scope="module")
def jax_stages(ring):
    """JAX's detection of keyframe 11 after 0-10, its frame query, and the
    three stages of (11, 0) with the minimal sets of their key."""
    sj, cam = ring["sj"], ring["cam_j"]
    cj = jlc.LoopCloser(ring["cfg_j"], ring["cj"].vocab)
    for k in range(CUR):
        cj.add_keyframe_to_db(sj, k)
    db, rows = cj._add_detect_prog(jax.tree.map(jnp.copy, cj.db), sj, jnp.asarray(CUR))
    frame_rows = cj._frame_detect_prog(db, sj, sj.kf_desc[CUR], sj.kf_feat_valid[CUR], jnp.asarray(CUR))
    key = jax.random.PRNGKey(11)
    a = cj._sim3_a(sj, cam, CUR, CAND, key)
    sets = jax_minimal_sets(key, np.asarray(a[1]), min_set=3)
    b = cj._sim3_b(sj, cam, CUR, CAND, *a[:3])
    c = cj._sim3_c(sj, cam, CUR, CAND, b[0], b[1])
    return dict(db=db, rows=rows, frame_rows=frame_rows, a=a, sets=sets, b=b, c=c)


@pytest.fixture(scope="module")
def port(ring, jax_stages):
    """The port's database after registering keyframes 0-10 and the inputs
    of each program: host-int ids for the eager run, the JAX stage's inputs
    carried over."""
    ct = tlc.LoopCloser(ring["cfg_t"], ring["ct"].vocab)
    stt = ring["stt"]
    for k in range(CUR):
        ct.add_keyframe_to_db(stt, k)
    j = jax_stages
    ok, bj = (torch.from_numpy(np.asarray(x)) for x in j["a"][1:3])
    S_a, S_b = t_sim3(j["a"][0]), t_sim3(j["b"][0])
    matched = torch.from_numpy(np.asarray(j["b"][1]))
    desc, valid = stt.kf_desc[CUR], stt.kf_feat_valid[CUR]
    inputs = dict(
        detect=(CUR,), frame_detect=(desc, valid, CUR),
        sim3_a=(), sim3_b=(S_a, ok, bj), sim3_c=(S_b, matched),   # stage A: a draw or sets
    )
    return dict(ct=ct, db0=clone_db(ct.db), inputs=inputs)


def run(g, name, state, cam, db, ids, args):
    """One program through the wrapper ``g`` (``LoopGraphs``)."""
    if name == "detect":
        return g.detect(state, db, *args)
    if name == "frame_detect":
        return g.frame_detect(state, db, *args)
    return getattr(g, name)(state, cam, *ids, *args)


def eager(g, name, state, cam, db, ids, args):
    """The same program eagerly (``g.eager``), ids as host ints."""
    if name in ("detect", "frame_detect"):
        return g.eager[name](state, db, *args)
    return g.eager[name](state, cam, *ids, *args)


def with_draw(name, args, u):
    return (u,) if name == "sim3_a" else args


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_matches_jax(ring, jax_stages, port, name):
    """Each program through the wrapper against JAX: candidate rows and the
    database exact, stage outputs exact or within 1e-4."""
    j = jax_stages
    g = tlc.LoopGraphs(ring["cfg_t"], ring["ct"].vocab, capture=False)
    db = clone_db(port["db0"])
    args = port["inputs"][name]
    if name == "sim3_a":
        args = (torch.from_numpy(j["sets"]),)
    if name == "frame_detect":   # the query runs after keyframe 11's registration, as JAX's does
        g.detect(ring["stt"], db, CUR)
    with NoHostReads():
        out = run(g, name, ring["stt"], ring["cam_t"], db, (CUR, CAND), args)
    if name in ("detect", "frame_detect"):
        np.testing.assert_array_equal(out.numpy(), np.asarray(j["rows" if name == "detect" else "frame_rows"]))
        np.testing.assert_array_equal(db.word_ids.numpy(), np.asarray(j["db"].word_ids))
        np.testing.assert_allclose(db.weights.numpy(), np.asarray(j["db"].weights), atol=1e-6)
        assert int(out[0, 0]) == CAND
        return
    want = j[name[-1]]
    S, *rest = out if name != "sim3_c" else (None, *out)
    if S is not None:
        assert_sim3_close(S, want[0])
        want = want[1:]
    for got, w in zip(rest, want):
        if isinstance(got, tuple):     # the loop group
            for name_, leaf in got._asdict().items():
                want_leaf = np.asarray(getattr(w, name_)).astype(leaf.numpy().dtype)
                np.testing.assert_array_equal(leaf.numpy(), want_leaf, err_msg=name_)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    gates = rest[-1].numpy()
    assert gates[-1] == 1 and gates[0] >= 20


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_equals_eager_and_rebinds(ring, port, name):
    """Each program through one wrapper, first on (11, 0), then on (10, 1)
    with other inputs: both bit-equal to the eager program with host-int
    ids, both under ``NoHostReads``, and the second differs from the
    first."""
    stt, cam = ring["stt"], ring["cam_t"]
    g = tlc.LoopGraphs(ring["cfg_t"], ring["ct"].vocab, capture=False)
    db_g, db_e = clone_db(port["db0"]), clone_db(port["db0"])
    args = with_draw(name, port["inputs"][name], draw(stt, 0))
    outs = []
    for ids, args in (((CUR, CAND), args), (OTHER, rebound(name, args, stt))):
        with NoHostReads():
            got = run(g, name, stt, cam, db_g, ids, args)
        want = eager(g, name, stt, cam, db_e, ids, args)
        assert_bit_equal(got, want, f"{name} {ids}")
        assert_bit_equal(tuple(db_g), tuple(db_e), f"{name} {ids}: the database")
        outs.append(got)
    assert g.captures == 1 and g.replays == 2
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1]))), \
        f"{name}: the second pair gave the first pair's result"


def rebound(name, args, stt):
    """The rebind test's inputs for the pair ``OTHER``: keyframe 10's
    detection and frame query, another draw, or a perturbed Sim3."""
    if name == "detect":
        return (OTHER[0],)
    if name == "frame_detect":
        return (stt.kf_desc[OTHER[0]], stt.kf_feat_valid[OTHER[0]], OTHER[0])
    if name == "sim3_a":
        return (draw(stt, 1),)
    S = args[0]
    S = tsim3.Sim3(R=S.R, t=S.t + 0.05, s=S.s)
    return (S, *args[1:])


def test_detect_writes_its_row_in_place(ring, port, jax_stages):
    """The registration writes keyframe 11's row into the database storage
    at its addresses (the row was empty), equal to JAX's row; the other
    rows keep their bits."""
    db = clone_db(port["db0"])
    ptrs = [t.data_ptr() for t in db]
    assert bool((db.word_ids[CUR] == -1).all())
    g = tlc.LoopGraphs(ring["cfg_t"], ring["ct"].vocab, capture=False)
    g.detect(ring["stt"], db, CUR)
    assert [t.data_ptr() for t in db] == ptrs
    np.testing.assert_array_equal(db.word_ids[CUR].numpy(), np.asarray(jax_stages["db"].word_ids[CUR]))
    others = torch.arange(db.word_ids.shape[0]) != CUR
    assert torch.equal(db.word_ids[others], port["db0"].word_ids[others])
    assert torch.equal(db.weights[others], port["db0"].weights[others])


def test_a_moved_database_drops_the_graph(ring, port):
    """A database at other addresses (the capacity grew) drops the detection
    graph: the next call captures anew on the new storage."""
    g = tlc.LoopGraphs(ring["cfg_t"], ring["ct"].vocab, capture=False)
    dbs = [clone_db(port["db0"]) for _ in range(2)]
    for db in (dbs[0], dbs[0], dbs[1]):
        g.detect(ring["stt"], db, CUR)
    assert g.capture_log == ["detect", "detect"] and g.replays == 3
