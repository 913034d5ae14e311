"""The port's localize-in-a-saved-map slice against the JAX package, on the
CPU, at the configuration of ``tests/test_persistence_reloc.py`` (320×192,
768 keypoints, a 6×3 vocabulary trained on the first keyframe).

A JAX ``SLAM`` maps 18 rendered frames and saves the map (npz) with its
vocabulary.  On that file:

* ``reloc_project_augment`` gives exactly the JAX tables on the same state,
  frame, pose and partial assignment;
* ``reloc_all_candidates`` on the converted JAX state, with the minimal sets
  the JAX cascade draws from ``PRNGKey(fid)`` (split per candidate, then per
  hypothesis), gives the same accepted flags and candidate ids, inlier counts
  within 3% and poses within 5 mm / 0.05°;
* the slice: the port loads the JAX file, relocalizes on a frame from the
  middle of the trajectory within 0.5 m of the JAX run's pose, inserts no
  keyframe, opens the wide-search window, and its reference keyframe slides
  as it tracks on; blank frames make it LOST and the next real frame
  relocalizes again; in mapping mode keyframes stay suppressed for
  ``max_frames`` frames after the relocalization;
* the port's own ``save`` is read back by the JAX ``load_map`` with every
  field equal to what the JAX system saved;
* protobuf and directory map paths raise ``NotImplementedError``; the
  ``LoopCloser`` methods and loop closing with mapping, which raised before
  the loop-closing slice, now run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_epnp import jax_minimal_sets
from test_torch_mapping import rot_deg
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.bow import keyframe_db as jdb
from orb_slam2_ros2_tpu.bow import vocabulary as jvoc
from orb_slam2_ros2_tpu.io import persistence as jpers
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.matching import matcher as jmatcher
from orb_slam2_ros2_tpu.ops.hamming import hamming_matrix as jhamming
from orb_slam2_ros2_tpu.pipeline import system as jsys
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.bow import vocabulary as tvoc
from orb_slam2_ros2_tpu_torch.errors import FileNotOpenError
from orb_slam2_ros2_tpu_torch.io import persistence as tpers
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState

N_FRAMES = 18
RELOC_FRAME = 12


def reloc_cfg(mod, **tracking):
    """The configuration of ``tests/test_persistence_reloc.py``."""
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                                width=320, height=192),
        orb=mod.ORBConfig(n_features=600, max_keypoints=768),
        tracking=mod.TrackingConfig(**{**dict(min_init_depth_kps=120, max_local_mappoints=4096,
                                              max_local_keyframes=16), **tracking}),
        map=mod.MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
        bow=mod.BoWConfig(branching=6, depth=3),
    )


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The JAX system's run over the sequence and its saved map."""
    cfg = reloc_cfg(jcfg)
    ds = JDataset(cfg.camera, n_frames=N_FRAMES, speed=0.35)
    frames = [tuple(np.array(x) for x in ds.frame(i)) for i in range(N_FRAMES)]
    slam = jsys.SLAM(cfg, enable_loop_closing=False)
    poses = []
    for img_l, img_r, _ in frames:
        pose, stats = slam.track(img_l, img_r)
        assert pose is not None, stats
        poses.append(pose)
    slam._ensure_loop_closer(slam.ref_kf)  # the vocabulary to save beside the map
    path = str(tmp_path_factory.mktemp("maps") / "m")
    slam.save(path)
    assert slam.n_keyframes >= 5
    return dict(path=path, slam=slam, frames=frames, poses=poses)


@pytest.fixture(scope="module")
def jax_reloc(built):
    """A fresh JAX system in localization mode on the saved map, the
    relocalization frame's features, its BoW candidates and the cascade's
    result."""
    slam = jsys.SLAM(reloc_cfg(jcfg, only_tracking=True))
    slam.load(built["path"])
    img_l, img_r, _ = built["frames"][RELOC_FRAME]
    frame = slam._frontend(img_l, img_r, slam.cam)
    vocab = slam.loop_closer.vocab
    q = jdb.sparse_bow(vocab, jvoc.transform(vocab, frame.feats.desc, frame.feats.valid),
                       slam.cfg.bow.max_words_per_query)
    cand_ids, _ = jdb.find_reloc_candidates(slam.loop_closer.db, slam.map, q, n_words=vocab.n_words)
    key = jax.random.PRNGKey(RELOC_FRAME)
    packed, cur_mp = slam._reloc_fused(slam.map, slam.cam, frame, cand_ids, key)
    return dict(slam=slam, frame=frame, cand_ids=np.asarray(cand_ids), key=key,
                packed=np.asarray(packed), cur_mp=np.asarray(cur_mp))


def jax_cascade_sets(slam, frame, cand_ids, key):
    """The minimal sets the JAX cascade draws: its key split per candidate,
    each candidate's RANSAC drawing over its own ``found`` mask (the first
    stage of ``reloc_all_candidates.one``, recomputed here)."""
    state, m = slam.map, slam.cfg.matcher
    N = frame.feats.capacity
    sets = []
    for cand, k in zip(cand_ids.tolist(), jax.random.split(key, len(cand_ids))):
        cc = max(cand, 0)
        live = (cand >= 0) & bool(state.kf_valid[cc])
        has_mp = state.kf_feat_valid[cc] & (state.kf_mp_idx[cc] >= 0)
        dist = jhamming(frame.feats.desc, state.kf_desc[cc])
        mask = frame.feats.valid[:, None] & has_mp[None, :] & live
        mt = jmatcher.best_match(dist, mask, m.min_threshold, 0.75)
        keep = jmatcher.rotation_consistency(frame.feats.angle, state.kf_angle[cc][jnp.maximum(mt.idx, 0)],
                                             mt.found)
        mt = jmatcher.mutual_filter(jmatcher.MatchResult(idx=jnp.where(keep, mt.idx, -1), dist=mt.dist), N)
        sets.append(jax_minimal_sets(k, np.asarray(mt.found)))
    return np.stack(sets)


def load_port(built, only_tracking=True, **tracking):
    slam = tsys.SLAM(reloc_cfg(tcfg, only_tracking=only_tracking, **tracking),
                     enable_loop_closing=False, device="cpu")
    slam.load(built["path"])
    return slam


# ------------------------------------------------------------ persistence --

def test_port_loads_the_jax_map(built):
    slam = load_port(built)
    jm = built["slam"].map
    assert slam.state == TrackState.NOT_INITING and slam._n_kf == int(jm.next_kf)
    assert slam.n_keyframes == built["slam"].n_keyframes and slam.n_mappoints == built["slam"].n_mappoints
    for name, a in convert.to_numpy(slam.map).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jm, name)), err_msg=name)
    # the database rebuilt on load is the JAX system's
    jdb_ = jdb.rebuild(built["slam"].loop_closer.vocab, jm, max_words=slam.cfg.bow.max_words_per_query)
    np.testing.assert_array_equal(slam.loop_closer.db.word_ids.numpy(), np.asarray(jdb_.word_ids))
    np.testing.assert_allclose(slam.loop_closer.db.weights.numpy(), np.asarray(jdb_.weights), atol=1e-6)


def test_port_save_is_loaded_by_jax(built, tmp_path):
    slam = load_port(built)
    out = str(tmp_path / "port")
    slam.save(out)
    js, jcfg_dict = jpers.load_map(out + ".map.npz")
    orig, orig_cfg = jpers.load_map(built["path"] + ".map.npz")
    for f in orig._fields:
        a, b = np.asarray(getattr(js, f)), np.asarray(getattr(orig, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert jcfg_dict["camera"] == orig_cfg["camera"] and jcfg_dict["bow"]["depth"] == 3
    vj = jvoc.load_vocabulary(out + ".vocab.npz")
    for a, b in zip(vj.levels, built["slam"].loop_closer.vocab.levels):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a file written before kf_Tcp existed loads with identity there
    with np.load(out + ".map.npz") as z:
        old = {k: z[k] for k in z.files if k != "kf_Tcp"}
    np.savez_compressed(str(tmp_path / "old.map.npz"), **old)
    st, _ = tpers.load_map(str(tmp_path / "old.map.npz"))
    assert torch.equal(st.kf_Tcp, torch.eye(4).expand_as(st.kf_Tcp))
    assert tpers._cfg_to_dict(slam.cfg) == jpers._cfg_to_dict(reloc_cfg(jcfg, only_tracking=True))
    del old["mp_pos"]
    np.savez_compressed(str(tmp_path / "bad.map.npz"), **old)
    with pytest.raises(KeyError):
        tpers.load_map(str(tmp_path / "bad.map.npz"))


def test_other_formats_and_missing_files_raise(built, tmp_path):
    slam = load_port(built)
    for path in (str(tmp_path / "m.pb"), str(tmp_path) + "/", str(tmp_path)):
        with pytest.raises(NotImplementedError, match="persistence"):
            slam.save(path)
        with pytest.raises(NotImplementedError, match="persistence"):
            slam.load(path)
    with pytest.raises(FileNotOpenError):
        slam.load(str(tmp_path / "nothing"))
    # a map saved without a vocabulary loads without a database
    bare = tsys.SLAM(reloc_cfg(tcfg, only_tracking=True), device="cpu")
    tpers.save_map(str(tmp_path / "bare.map.npz"), slam.map, slam.cfg)
    bare.load(str(tmp_path / "bare"))
    assert bare.loop_closer is None and bare.n_keyframes == slam.n_keyframes
    assert bare.track(*built["frames"][RELOC_FRAME][:2]) == (None, {"reloc": "no_vocab"})


@pytest.mark.parametrize("name", ["detect_async", "detect_frame_async", "detect", "detect_resolve",
                                  "compute_sim3", "sim3_begin", "sim3_step", "warmup", "correct"])
def test_unported_loop_closer_methods_raise(name):
    """The ``LoopCloser`` methods that raised before the loop-closing slice
    run now, on the two-keyframe revisit world of
    ``test_torch_loop_closing``: none raises, and each returns what its
    caller expects."""
    from test_torch_loop_closing import loop_world, make_cfg

    from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam

    cfg_j, cfg_t = make_cfg(jcfg), make_cfg(tcfg)
    st, _ = loop_world(cfg_j)
    state = convert.map_state_to_torch(st, "cpu")
    cam = TCam.from_config(cfg_t.camera, "cpu")
    lc = LoopCloser(cfg_t, tvoc.train_vocabulary(
        np.random.default_rng(0).integers(0, 2**32, (64, 8), dtype=np.uint32), branching=2, depth=2))
    assert lc.db.word_ids.shape == (8, 1024)
    gen = torch.Generator().manual_seed(0)
    calls = {
        "detect_async": lambda: lc.detect_async(state, 1) is None,          # a young map: no query
        "detect_frame_async": lambda: lc.detect_frame_async(state, state.kf_desc[1], state.kf_feat_valid[1],
                                                            1) is None,
        "detect": lambda: lc.detect(state, 1) is None,
        "detect_resolve": lambda: lc.detect_resolve(20, np.full((5, 9), -1, np.int32)) is None,
        "compute_sim3": lambda: lc.compute_sim3(state, cam, 1, 0, gen) is not None,
        "sim3_begin": lambda: lc.sim3_begin(state, cam, 1, 0) is None and lc.pending_sim3["stage"] == "a",
        "sim3_step": lambda: lc.sim3_step(state, cam) is None,              # nothing pending
        "warmup": lambda: lc.warmup(state, cam) is None,
        "correct": lambda: lc.correct(state, cam, 1, 0, *lc.compute_sim3(state, cam, 1, 0, gen),
                                      run_gba=False).kf_Tcw.shape == state.kf_Tcw.shape,
    }
    assert calls[name]()


def test_loop_closing_with_mapping_stays_refused():
    """Loop closing with mapping, refused before the loop-closing slice, is
    accepted; localization mode ignores the flag."""
    assert tsys.SLAM(reloc_cfg(tcfg), enable_loop_closing=True, device="cpu").enable_loop_closing
    assert not tsys.SLAM(reloc_cfg(tcfg, only_tracking=True), enable_loop_closing=True,
                         device="cpu").enable_loop_closing


# ---------------------------------------------------------- vocabulary -----

def test_resolve_vocab_precedence(built, tmp_path):
    slam = load_port(built)
    # no path, no packaged 6x3 artifact: trained on the keyframe's own
    # descriptors, as the JAX system trained the saved one
    v = slam._resolve_vocab(0)
    assert (v.branching, v.depth) == (6, 3)
    jv = built["slam"]._resolve_vocab(0)
    for a, b in zip(v.levels, jv.levels):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    # the packaged artifacts by tree shape
    for depth, words in ((4, 10**4), (5, 10**5)):
        s = tsys.SLAM(reloc_cfg(tcfg).replace(bow=tcfg.BoWConfig(branching=10, depth=depth)),
                      enable_loop_closing=False, device="cpu")
        assert s._resolve_vocab(0).n_words == words
    # an explicit path wins; a missing one raises
    p = str(tmp_path / "v.npz")
    tvoc.save_vocabulary(v, p)
    s = tsys.SLAM(reloc_cfg(tcfg).replace(bow=tcfg.BoWConfig(branching=10, depth=5, vocab_path=p)),
                  enable_loop_closing=False, device="cpu")
    assert s._resolve_vocab(0).n_words == 216
    s = tsys.SLAM(reloc_cfg(tcfg).replace(bow=tcfg.BoWConfig(vocab_path=str(tmp_path / "no.npz"))),
                  enable_loop_closing=False, device="cpu")
    with pytest.raises(FileNotOpenError):
        s._resolve_vocab(0)


def test_ensure_loop_closer_add_and_grow(built):
    """``_ensure_loop_closer`` sizes the rows to the live map, ``_add_kf_to_db``
    writes the row ``rebuild`` computes, and a keyframe grow re-pads the
    rows."""
    loaded = load_port(built)
    slam = tsys.SLAM(reloc_cfg(tcfg), enable_loop_closing=False, device="cpu")
    slam.map, slam._n_kf = loaded.map, loaded._n_kf
    assert slam.loop_closer is None
    slam._add_kf_to_db(2)
    db = slam.loop_closer.db
    assert db.word_ids.shape[0] == slam.map.kf_capacity
    from orb_slam2_ros2_tpu_torch.bow.keyframe_db import rebuild

    full = rebuild(slam.loop_closer.vocab, slam.map, max_words=db.max_words)
    assert torch.equal(db.word_ids[2], full.word_ids[2]) and torch.equal(db.weights[2], full.weights[2])
    assert int((db.word_ids >= 0).any(1).sum()) == 1
    slam._grow(kf_capacity=2 * slam.map.kf_capacity)
    assert slam.loop_closer.db.word_ids.shape == (128, db.word_ids.shape[1])
    assert torch.equal(slam.loop_closer.db.word_ids[:64], db.word_ids)
    assert (slam.loop_closer.db.word_ids[64:] == -1).all() and (slam.loop_closer.db.weights[64:] == 0).all()
    slam.loop_closer.grow(16)  # never shrinks
    assert slam.loop_closer.db.word_ids.shape[0] == 128


# ------------------------------------------------------------- cascade -----

def test_reloc_project_augment_matches_jax(built, jax_reloc):
    """Same state, candidate, frame, pose and partial assignment: the
    per-feature tables and the added counts are equal, wide and narrow."""
    js, frame = jax_reloc["slam"], jax_reloc["frame"]
    cfg = js.cfg
    cand = int(jax_reloc["cand_ids"][0])
    Tcw = np.asarray(built["poses"][RELOC_FRAME])
    # a partial assignment: the accepted row's table with every third entry cleared
    cur_mp = jax_reloc["cur_mp"][0].copy()
    cur_mp[::3] = -1
    ts = convert.map_state_to_torch(jax.tree.map(np.asarray, js.map), "cpu")
    tf = convert.stereo_frame_to_torch(jax.tree.map(np.asarray, frame), "cpu")
    tcam = tsys.CameraParams.from_config(reloc_cfg(tcfg).camera, "cpu")
    common = dict(width=cfg.camera.width, height=cfg.camera.height, scale_factor=cfg.orb.scale_factor,
                  n_levels=cfg.orb.n_levels, ratio=0.9)
    total = 0
    for th, max_dist in ((10.0, cfg.matcher.max_threshold), (3.0, cfg.matcher.min_threshold)):
        mj, nj = jsys.reloc_project_augment(js.map, cand, js.cam, frame, jnp.asarray(Tcw), jnp.asarray(cur_mp),
                                            th=th, max_dist=max_dist, **common)
        for c in (cand, torch.tensor([cand])):
            mt, nt = tsys.reloc_project_augment(ts, c, tcam, tf, torch.from_numpy(Tcw), torch.from_numpy(cur_mp),
                                                th=th, max_dist=max_dist, **common)
            assert mt.dtype == torch.int32 and int(nt) == int(nj)
            np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        total += int(nj)
        kept = cur_mp >= 0
        np.testing.assert_array_equal(np.asarray(mj)[kept], cur_mp[kept])
    assert total > 20


def test_reloc_all_candidates_matches_jax(built, jax_reloc):
    js, frame = jax_reloc["slam"], jax_reloc["frame"]
    cand_ids, pj = jax_reloc["cand_ids"], jax_reloc["packed"]
    assert (cand_ids >= 0).sum() >= 2 and pj[:, 0].sum() >= 1
    sets = jax_cascade_sets(js, frame, cand_ids, jax_reloc["key"])
    slam = load_port(built)
    ts = convert.map_state_to_torch(jax.tree.map(np.asarray, js.map), "cpu")
    tf = convert.stereo_frame_to_torch(jax.tree.map(np.asarray, frame), "cpu")
    packed, cur_mp = tsys.reloc_all_candidates(ts, slam.cam, tf, torch.from_numpy(cand_ids),
                                               sets=torch.from_numpy(sets), **slam._reloc_common)
    pt = packed.numpy()
    assert pt.shape == (5, 19) and cur_mp.shape == (5, 768) and cur_mp.dtype == torch.int32
    np.testing.assert_array_equal(pt[:, 0], pj[:, 0])     # accepted flags
    np.testing.assert_array_equal(pt[:, 2], pj[:, 2])     # candidate ids
    acc = pj[:, 0] > 0
    assert np.abs(pt[acc, 1] - pj[acc, 1]).max() <= 0.03 * pj[acc, 1].max()
    Tt, Tj = pt[acc, 3:].reshape(-1, 4, 4), pj[acc, 3:].reshape(-1, 4, 4)
    assert np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max() <= 5e-3
    assert rot_deg(Tj, Tt).max() <= 0.05
    # the accepted rows assign (nearly) the same map points
    for i in np.flatnonzero(acc):
        diff = (cur_mp[i].numpy() != jax_reloc["cur_mp"][i]).sum()
        assert diff <= 0.03 * (jax_reloc["cur_mp"][i] >= 0).sum(), (i, diff)
    # empty candidate slots are refused and keep their id
    assert (pt[cand_ids < 0, 0] == 0).all()


# --------------------------------------------------------------- the slice --

@pytest.fixture(scope="module")
def localized(built):
    """The port in localization mode on the JAX map: relocalize in the
    middle of the trajectory, then track to its end."""
    slam = load_port(built)
    records = []
    for i in range(RELOC_FRAME, N_FRAMES):
        pose, info = slam.track(*built["frames"][i][:2])
        records.append((i, pose, info, slam.state, slam.ref_kf, slam.n_keyframes))
    return slam, records


def test_slice_relocalizes_on_the_jax_map(built, localized, jax_reloc):
    slam, records = localized
    i, pose, info, state, ref_kf, n_kf = records[0]
    assert pose is not None and state == TrackState.OK, info
    assert info["relocalized"] and info["n_inliers"] >= 50 and info["reloc_candidates"] >= 1
    assert np.linalg.norm(pose[:3, 3] - built["poses"][i][:3, 3]) < 0.5
    assert info["reloc_kf"] == ref_kf and slam.last_reloc_fid == 0
    # the JAX system accepts the same keyframe for this frame
    pj = jax_reloc["packed"]
    assert info["reloc_kf"] == int(pj[int(np.argmax(pj[:, 0] > 0)), 2])
    # deterministic: the generator is seeded with the frame id
    again = load_port(built)
    pose2, info2 = again.track(*built["frames"][i][:2])
    np.testing.assert_array_equal(pose2, pose)
    assert info2 == info


def test_slice_tracks_on_and_the_reference_slides(built, localized):
    slam, records = localized
    n_kf0 = built["slam"].n_keyframes
    assert all(r[3] == TrackState.OK and r[1] is not None for r in records), [r[2] for r in records]
    assert all(r[5] == n_kf0 for r in records)          # no keyframe inserted
    assert len({r[4] for r in records}) >= 2            # the reference slid
    i, pose = records[-1][0], records[-1][1]
    assert np.linalg.norm(pose[:3, 3] - built["poses"][i][:3, 3]) < 0.5
    # the trajectory records compose with the map's keyframes
    final = dict(slam.final_trajectory())
    assert sorted(final) == list(range(len(records)))
    np.testing.assert_allclose(final[len(records) - 1], pose, atol=1e-4)


def test_blank_frames_lose_track_and_the_next_frame_relocalizes(built, localized):
    slam, _ = localized
    blank = np.zeros_like(built["frames"][0][0])
    pose, _ = slam.track(blank, blank)
    assert pose is None and slam.state == TrackState.LOST
    pose, info = slam.track(blank, blank)               # a LOST frame with nothing to match
    assert pose is None and slam.state == TrackState.LOST and "relocalized" not in info
    fid = slam.frame_id
    pose, info = slam.track(*built["frames"][10][:2])
    assert pose is not None and info["relocalized"] and slam.state == TrackState.OK
    assert slam.last_reloc_fid == fid
    assert np.linalg.norm(pose[:3, 3] - built["poses"][10][:3, 3]) < 0.5
    pose, stats = slam.track(*built["frames"][11][:2])  # the wide-search frame
    assert pose is not None and stats["n_inliers"] >= 50
    assert np.linalg.norm(pose[:3, 3] - built["poses"][11][:3, 3]) < 0.5


def test_reloc_window_and_keyframe_suppression(built):
    """Continued SLAM on the loaded map (mapping mode): the frame after the
    relocalization searches wide, the 50-inlier bar holds for ``max_frames``
    frames, and no keyframe is inserted until ``max_frames`` frames after
    the relocalization."""
    slam = load_port(built, only_tracking=False, max_frames=2, min_frames=0)
    n_kf0 = slam._n_kf
    seen_th = []
    program = slam.frame_program

    def spy(*a, proj_th=3.0, **kw):
        seen_th.append(proj_th)
        return program(*a, proj_th=proj_th, **kw)

    slam.frame_program = spy
    asked = []
    # statistics that satisfy every other term of the keyframe rule: only
    # the suppression can say no
    forced = dict(n_tracked=0, n_ref_matches=100, n_close_tracked=0, n_close_untracked=1000)
    pose, info = slam.track(*built["frames"][RELOC_FRAME][:2])
    assert info["relocalized"]
    for i in range(RELOC_FRAME + 1, RELOC_FRAME + 5):
        pose, stats = slam.track(*built["frames"][i][:2])
        assert pose is not None
        asked.append(slam._need_keyframe(forced))
    assert seen_th == [5.0, 3.0, 3.0, 3.0]
    # frames 1 and 2 after the relocalization (fid ≤ last_reloc_fid + 2) are
    # suppressed whatever the statistics say; frames 3 and 4 are not
    assert asked == [False, False, True, True]
    assert slam._n_kf >= n_kf0
    # the stricter bar: 40 inliers pass outside the window, not inside
    t = slam.cfg.tracking
    assert t.min_localmap_inliers < 40 < t.min_localmap_inliers_reloc
