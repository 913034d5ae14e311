"""Parity of the port's BoW vocabulary and keyframe database with the JAX
package, on the CPU.

One JAX ``SLAM`` builds a small map (the fixture of
``tests/test_torch_mapping.py``); its keyframe descriptors train a 6×3
vocabulary in both packages and are the database's contents.  Word ids,
sparse-vector ids, candidate ids and every integer are equal exactly (the ±1
dot products of ``transform`` are exact in f32, every top-k is stable);
sparse weights agree to 1e-6 and scores to 1e-5.  The queries also run with
the packaged 10⁴-word ``vocab_synth.npz``, where the shared-word gate is
active.  Loop candidates are queried on a copy of the map whose covisibility
was thinned (a 6-frame map is connected all over), the same copy in both
packages.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import run_jax_mapping, small_cfg, to_torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
from orb_slam2_ros2_tpu.bow import keyframe_db as jdb
from orb_slam2_ros2_tpu.bow import vocabulary as jvoc
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.bow import keyframe_db as tdb
from orb_slam2_ros2_tpu_torch.bow import vocabulary as tvoc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ASSETS = os.path.join(REPO, "orb_slam2_ros2_tpu", "assets")
PORT_ASSETS = os.path.join(REPO, "orb_slam2_ros2_tpu_torch", "assets")
MAX_WORDS = 256


def t(a):
    return torch.from_numpy(np.array(a))


def words32(a):
    """uint32 descriptor words as the port's int32 tensor."""
    return t(np.ascontiguousarray(a).view(np.int32))


def assert_vocab_equal(vt, vj):
    assert (vt.branching, vt.depth, vt.n_words) == (vj.branching, vj.depth, vj.n_words)
    for a, b in zip(vt.levels, vj.levels):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    np.testing.assert_array_equal(vt.idf.numpy(), np.asarray(vj.idf))


@pytest.fixture(scope="module")
def world():
    """The JAX-built map, its thinned-covisibility copy, and the training
    descriptors (every valid keyframe feature)."""
    slam, _, _ = run_jax_mapping(small_cfg(jcfg))
    state = jax.tree.map(np.asarray, slam.map)
    kv = state.kf_valid
    assert kv.sum() >= 4
    covis = state.covis.copy()
    ids = np.flatnonzero(kv)
    for a in ids:            # keep only the links between neighbouring ids
        for b in ids:
            if abs(int(a) - int(b)) > 1:
                covis[a, b] = 0
    thin = state._replace(covis=covis)
    train = state.kf_desc[kv][state.kf_feat_valid[kv]]
    return dict(state=state, thin=thin, train=train, ids=ids)


@pytest.fixture(scope="module", params=["trained_6x3", "vocab_synth"])
def vocabs(request, world):
    """(JAX vocabulary, port vocabulary, JAX database, port database)."""
    if request.param == "trained_6x3":
        vj = jvoc.train_vocabulary(world["train"], branching=6, depth=3, seed=0)
        vt = tvoc.train_vocabulary(world["train"], branching=6, depth=3, seed=0, device="cpu")
    else:
        vj = jvoc.load_vocabulary(os.path.join(JAX_ASSETS, "vocab_synth.npz"))
        vt = tvoc.load_vocabulary(os.path.join(PORT_ASSETS, "vocab_synth.npz"), "cpu")
        assert vj.n_words >= tdb.WORD_GATE_MIN_VOCAB == jdb.WORD_GATE_MIN_VOCAB
    assert_vocab_equal(vt, vj)
    dbj = jax.jit(lambda s: jdb.rebuild(vj, s, max_words=MAX_WORDS))(world["state"])
    dbt = tdb.rebuild(vt, to_torch(world["state"]), max_words=MAX_WORDS)
    return vj, vt, dbj, dbt


# ---------------------------------------------------------- host-side code --

@pytest.mark.parametrize("name", ["vocab_synth.npz", "vocab_synth_l5.npz"])
def test_copied_assets_equal(name):
    a, b = os.path.join(JAX_ASSETS, name), os.path.join(PORT_ASSETS, name)
    assert filecmp.cmp(a, b, shallow=False)
    assert_vocab_equal(tvoc.load_vocabulary(b, "cpu"), jvoc.load_vocabulary(a))


def test_train_vocabulary_and_npz_round_trip(world, tmp_path):
    r = np.random.default_rng(4)
    descs = np.concatenate([world["train"][:1500], r.integers(0, 2**32, (500, 8), dtype=np.uint32)])
    vj = jvoc.train_vocabulary(descs, branching=4, depth=3, seed=2)
    vt = tvoc.train_vocabulary(descs, branching=4, depth=3, seed=2, device="cpu")
    assert_vocab_equal(vt, vj)
    assert_vocab_equal(tvoc.train_vocabulary(descs.view(np.int32), branching=4, depth=3, seed=2,
                                            device="cpu"), vj)
    # each package reads the other's file
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jvoc.save_vocabulary(vj, pj)
    tvoc.save_vocabulary(vt, pt)
    assert_vocab_equal(tvoc.load_vocabulary(pj, "cpu"), vj)
    assert_vocab_equal(tvoc.load_vocabulary(pt, "cpu"), jvoc.load_vocabulary(pt))
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            assert zj[f].dtype == zt[f].dtype and np.array_equal(zj[f], zt[f]), f
    back = convert.vocabulary_to_torch(convert.to_numpy(vt), "cpu")
    assert_vocab_equal(back, vj)
    assert_vocab_equal(convert.vocabulary_to_torch(jax.tree.map(np.asarray, vj), "cpu"), vj)


def test_load_dbow_text_matches_jax(tmp_path):
    """A k=3, L=2 text vocabulary with one short family (2 of 3 children),
    and a file with a junk line (the tolerant pass)."""
    r = np.random.default_rng(9)
    lines = ["3 2 0 0"]
    for _ in range(3):
        lines.append("0 0 " + " ".join(map(str, r.integers(0, 256, 32))) + " 0.0")
    for parent, n in ((1, 3), (2, 2), (3, 3)):
        for _ in range(n):
            lines.append(f"{parent} 1 " + " ".join(map(str, r.integers(0, 256, 32))) + f" {r.uniform(0.1, 2):.4f}")
    for name, extra in (("clean.txt", []), ("junk.txt", ["trailing junk"])):
        p = tmp_path / name
        p.write_text("\n".join(lines + extra) + "\n")
        assert_vocab_equal(tvoc.load_dbow_text(str(p), "cpu"), jvoc.load_dbow_text(str(p)))


# --------------------------------------------------------------- transform --

def test_transform_and_bow_vector_match_jax(world, vocabs):
    vj, vt, _, _ = vocabs
    r = np.random.default_rng(1)
    k = int(world["ids"][-1])
    desc = np.concatenate([world["state"].kf_desc[k], r.integers(0, 2**32, (200, 8), dtype=np.uint32)])
    valid = np.concatenate([world["state"].kf_feat_valid[k], r.random(200) < 0.8])
    wj = np.asarray(jax.jit(lambda d, v: jvoc.transform(vj, d, v))(desc, valid))
    wt = tvoc.transform(vt, words32(desc), t(valid))
    assert wt.dtype == torch.int32
    np.testing.assert_array_equal(wt.numpy(), wj)
    assert (wj[valid] >= 0).all() and (wj[~valid] == -1).all() and len(set(wj[valid].tolist())) > 20
    # leading batch dimensions give the rows one by one
    wb = tvoc.transform(vt, words32(desc).reshape(2, -1, 8), t(valid).reshape(2, -1))
    np.testing.assert_array_equal(wb.reshape(-1).numpy(), wj)
    np.testing.assert_allclose(tvoc.bow_vector(vt, wt).numpy(), np.asarray(jvoc.bow_vector(vj, jnp.asarray(wj))),
                               atol=1e-6)


@pytest.mark.parametrize("max_words", [64, MAX_WORDS, 1200])
def test_sparse_bow_matches_jax(world, vocabs, max_words):
    """Truncating (64), roomy (256) and wider than the descriptor count
    (1200 > 768: padded) rows."""
    vj, vt, _, _ = vocabs
    k = int(world["ids"][1])
    desc, valid = world["state"].kf_desc[k], world["state"].kf_feat_valid[k]
    wj = jvoc.transform(vj, jnp.asarray(desc), jnp.asarray(valid))
    bj = jdb.sparse_bow(vj, wj, max_words)
    bt = tdb.sparse_bow(vt, t(np.asarray(wj)), max_words)
    assert bt.ids.shape == (max_words,) and bt.ids.dtype == torch.int32
    np.testing.assert_array_equal(bt.ids.numpy(), np.asarray(bj.ids))
    np.testing.assert_allclose(bt.weights.numpy(), np.asarray(bj.weights), atol=1e-6)
    assert (np.asarray(bj.ids) >= 0).sum() > 20


# ---------------------------------------------------------------- database --

def test_rebuild_matches_jax_and_rowwise_add(world, vocabs):
    vj, vt, dbj, dbt = vocabs
    np.testing.assert_array_equal(dbt.word_ids.numpy(), np.asarray(dbj.word_ids))
    np.testing.assert_allclose(dbt.weights.numpy(), np.asarray(dbj.weights), atol=1e-6)
    state = to_torch(world["state"])
    # an odd chunk (ragged last batch) changes nothing
    db5 = tdb.rebuild(vt, state, max_words=MAX_WORDS, chunk=5)
    assert torch.equal(db5.word_ids, dbt.word_ids) and torch.equal(db5.weights, dbt.weights)
    db = tdb.KeyFrameDB.empty(state.kf_capacity, MAX_WORDS, "cpu")
    assert db.max_words == MAX_WORDS
    for k in world["ids"].tolist():
        db = tdb.add_keyframe(db, vt, k, state.kf_desc[k], state.kf_feat_valid[k])
    np.testing.assert_array_equal(db.word_ids.numpy(), dbt.word_ids.numpy())
    np.testing.assert_allclose(db.weights.numpy(), dbt.weights.numpy(), atol=1e-7)
    # a keyframe id that lives on the device writes the same row
    k = int(world["ids"][2])
    one = tdb.add_keyframe(tdb.KeyFrameDB.empty(state.kf_capacity, MAX_WORDS, "cpu"), vt, torch.tensor(k),
                           state.kf_desc[k], state.kf_feat_valid[k])
    assert torch.equal(one.word_ids[k], db.word_ids[k]) and int((one.word_ids >= 0).any(1).sum()) == 1
    back = convert.keyframe_db_to_torch(convert.to_numpy(dbt), "cpu")
    assert torch.equal(back.word_ids, dbt.word_ids) and torch.equal(back.weights, dbt.weights)
    assert torch.equal(convert.keyframe_db_to_torch(jax.tree.map(np.asarray, dbj), "cpu").word_ids, dbt.word_ids)


def _query(world, vj, vt, k, flip, mix=None):
    """Keyframe ``k``'s descriptors with ``flip`` of them replaced by noise
    (and every second one by keyframe ``mix``'s), as a sparse query in both
    packages."""
    r = np.random.default_rng(k)
    desc = world["state"].kf_desc[k].copy()
    valid = world["state"].kf_feat_valid[k].copy()
    if mix is not None:
        desc[1::2] = world["state"].kf_desc[mix][1::2]
        valid[1::2] = world["state"].kf_feat_valid[mix][1::2]
    n = int(flip * len(desc))
    desc[:n] = r.integers(0, 2**32, (n, 8), dtype=np.uint32)
    qj = jdb.sparse_bow(vj, jvoc.transform(vj, jnp.asarray(desc), jnp.asarray(valid)), MAX_WORDS)
    qt = tdb.sparse_bow(vt, tvoc.transform(vt, words32(desc), t(valid)), MAX_WORDS)
    return qj, qt


def test_scores_and_shared_words_match_jax(world, vocabs):
    vj, vt, dbj, dbt = vocabs
    kv = world["state"].kf_valid
    for k in world["ids"][[0, -1]].tolist():
        qj, qt = _query(world, vj, vt, k, 0.3)
        sj = np.asarray(jdb.query_scores(dbj, qj, jnp.asarray(kv), n_words=vj.n_words))
        st = tdb.query_scores(dbt, qt, t(kv), n_words=vt.n_words).numpy()
        np.testing.assert_allclose(st, sj, atol=1e-5)
        assert np.argmax(sj) == k and (sj[~kv] == 0).all()
        cj = np.asarray(jdb.shared_word_counts(dbj, qj, jnp.asarray(kv), n_words=vj.n_words))
        ct = tdb.shared_word_counts(dbt, qt, t(kv), n_words=vt.n_words)
        assert ct.dtype == torch.int32
        np.testing.assert_array_equal(ct.numpy(), cj)
        gj = np.asarray(jdb._group_scores(jax.tree.map(jnp.asarray, world["state"]), jnp.asarray(sj)))
        gt = tdb._group_scores(to_torch(world["state"]), t(sj)).numpy()
        np.testing.assert_allclose(gt, gj, atol=1e-5)


@pytest.mark.parametrize("which", ["state", "thin"])
def test_find_reloc_candidates_match_jax(world, vocabs, which):
    vj, vt, dbj, dbt = vocabs
    sj, st = jax.tree.map(jnp.asarray, world[which]), to_torch(world[which])
    seen = set()
    ids = world["ids"].tolist()
    for n, k in enumerate(ids):
        # even rounds query a noisy keyframe, odd ones a blend of two
        mix = ids[(n + 3) % len(ids)] if n % 2 else None
        qj, qt = _query(world, vj, vt, k, 0.3, mix)
        ij, tj = jdb.find_reloc_candidates(dbj, sj, qj, n_words=vj.n_words)
        it, tt = tdb.find_reloc_candidates(dbt, st, qt, n_words=vt.n_words)
        assert it.dtype == torch.int32 and it.shape == (5,)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
        seen.add(int((np.asarray(ij) >= 0).sum()))
    assert min(seen) >= 1 and max(seen) >= 2, seen


def test_find_loop_candidates_match_jax(world, vocabs):
    """On the thinned map a query keyframe is connected to its neighbouring
    ids only, so older keyframes are loop candidates."""
    vj, vt, dbj, dbt = vocabs
    sj, st = jax.tree.map(jnp.asarray, world["thin"]), to_torch(world["thin"])
    n_found = 0
    for k in world["ids"].tolist():
        for mcw in (15, 1):
            qj, qt = _query(world, vj, vt, k, 0.1)
            ij, tj = jdb.find_loop_candidates(dbj, sj, qj, k, n_words=vj.n_words, min_covis_weight=mcw)
            it, tt = tdb.find_loop_candidates(dbt, st, qt, k, n_words=vt.n_words, min_covis_weight=mcw)
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
            np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
            ids = np.asarray(ij)
            assert k not in ids and all(abs(int(c) - k) > 1 for c in ids[ids >= 0])
            n_found += int((ids >= 0).sum())
    assert n_found > 0
    # a device-resident query keyframe gives the same answer
    k = int(world["ids"][-1])
    qj, qt = _query(world, vj, vt, k, 0.1)
    a = tdb.find_loop_candidates(dbt, st, qt, k, n_words=vt.n_words, min_covis_weight=1)
    b = tdb.find_loop_candidates(dbt, st, qt, torch.tensor(k), n_words=vt.n_words, min_covis_weight=1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
