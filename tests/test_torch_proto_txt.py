"""The reference's protobuf and txt map formats in the port against the JAX
package, on the CPU, on the map of ``tests/test_proto_map.py`` (3 keyframes,
40 points, a loop edge; random descriptors from a seed) given to both
packages (``convert.map_state_to_torch``):

* the ``.pb`` bytes and the txt files both packages write are identical,
  without a vocabulary and with one (a 4×2 tree trained by the JAX package
  on the map's descriptors, converted);
* each package loads the other's files: ``msg_to_state`` field by field,
  integer fields exact, floats within 1e-5 (the tolerance of
  ``tests/test_torch_mapping_slice.py``);
* ``SLAM.save`` / ``SLAM.load`` through a ``.pb`` path, a directory (with
  and without its separator), an npz stem and a path with no extension (the
  warning); a missing map names the three paths ``load`` tried.
"""

import os

import numpy as np
import pytest
import torch
from test_proto_map import _small_state
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.bow import vocabulary as jvoc
from orb_slam2_ros2_tpu.io import proto_map as jpm
from orb_slam2_ros2_tpu.io import txt_map as jtm
from orb_slam2_ros2_tpu_torch.convert import map_state_to_torch, vocabulary_to_torch
from orb_slam2_ros2_tpu_torch.errors import FileNotOpenError
from orb_slam2_ros2_tpu_torch.io import proto_map as tpm
from orb_slam2_ros2_tpu_torch.io import txt_map as ttm
from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM

FLOAT_TOL = 1e-5


def cfg(mod):
    return mod.SLAMConfig(
        camera=mod.CameraConfig(width=320, height=192),
        orb=mod.ORBConfig(max_keypoints=64),
        map=mod.MapConfig(max_keyframes=8, max_mappoints=128, max_obs_per_mp=6),
        bow=mod.BoWConfig(branching=4, depth=2),
    )


@pytest.fixture(scope="module")
def maps():
    jstate = _small_state(cfg(jcfg))
    kf_desc = np.asarray(jstate.kf_desc)[np.asarray(jstate.kf_feat_valid)]
    jv = jvoc.train_vocabulary(kf_desc, branching=4, depth=2)
    return dict(jax=jstate, torch=map_state_to_torch(jstate, "cpu"), jvocab=jv,
                tvocab=vocabulary_to_torch(jv, "cpu"))


def assert_states_match(t: MapState, j) -> None:
    """Port state ``t`` against JAX state ``j``, field by field."""
    for f in MapState._fields:
        a = getattr(t, f).numpy()
        b = np.asarray(getattr(j, f))
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=FLOAT_TOL, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("with_vocab", [False, True])
def test_written_files_identical(maps, with_vocab, tmp_path):
    jv, tv = (maps["jvocab"], maps["tvocab"]) if with_vocab else (None, None)
    jpm.save_proto_map(str(tmp_path / "j.pb"), maps["jax"], cfg(jcfg), vocab=jv)
    tpm.save_proto_map(str(tmp_path / "t.pb"), maps["torch"], cfg(tcfg), vocab=tv)
    a, b = (tmp_path / "t.pb").read_bytes(), (tmp_path / "j.pb").read_bytes()
    assert a == b and len(a) > 10_000
    jtm.save_txt_map(str(tmp_path / "jtxt"), maps["jax"], cfg(jcfg), vocab=jv)
    ttm.save_txt_map(str(tmp_path / "ttxt"), maps["torch"], cfg(tcfg), vocab=tv)
    for name in ("KeyFrames.txt", "MapPoints.txt"):
        assert (tmp_path / "ttxt" / name).read_bytes() == (tmp_path / "jtxt" / name).read_bytes()
    msg = tpm.state_to_msg(maps["torch"], cfg(tcfg), tv)
    kf0 = msg.keyframes.keyframes[0]
    assert len(msg.keyframes.keyframes) == 3 and len(msg.mappoints.mappoints) == 40
    assert (len(kf0.bow_vector.words) > 0) == with_vocab
    assert (len(kf0.feature_vector.nodes) > 0) == with_vocab


@pytest.mark.parametrize("fmt", ["pb", "txt"])
def test_cross_loads_both_ways(maps, fmt, tmp_path):
    save = {"pb": (jpm.save_proto_map, tpm.save_proto_map), "txt": (jtm.save_txt_map, ttm.save_txt_map)}
    load = {"pb": (jpm.load_proto_map, tpm.load_proto_map), "txt": (jtm.load_txt_map, ttm.load_txt_map)}
    jsave, tsave = save[fmt]
    jload, tload = load[fmt]
    suffix = ".pb" if fmt == "pb" else ""
    jpath, tpath = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    jsave(jpath, maps["jax"], cfg(jcfg), vocab=maps["jvocab"])
    tsave(tpath, maps["torch"], cfg(tcfg), vocab=maps["tvocab"])
    # JAX file → port, port file → JAX, against what JAX reads from its own file
    ref = jload(jpath, cfg(jcfg))
    assert_states_match(tload(jpath, cfg(tcfg), "cpu"), ref)
    assert_states_match(tload(tpath, cfg(tcfg), "cpu"), jload(tpath, cfg(jcfg)))
    # the round trip keeps the map (the txt format prints floats with %g)
    st = tload(tpath, cfg(tcfg), "cpu")
    K, P = 3, 40
    tol = 1e-6 if fmt == "pb" else 1e-4
    np.testing.assert_allclose(st.kf_Tcw[:K].numpy(), maps["torch"].kf_Tcw[:K].numpy(), atol=tol)
    np.testing.assert_allclose(st.mp_pos[:P].numpy(), maps["torch"].mp_pos[:P].numpy(), rtol=tol, atol=tol)
    assert torch.equal(st.kf_desc[:K, :P], maps["torch"].kf_desc[:K, :P])
    assert torch.equal(st.mp_desc[:P], maps["torch"].mp_desc[:P])
    assert torch.equal(st.covis[:K, :K], maps["torch"].covis[:K, :K])
    assert int(st.mp_n_obs.sum()) == K * P and int(st.next_kf) == K
    assert st.kf_parent[:3].tolist() == [-1, 0, 1]
    assert (0, 2) in {tuple(sorted(e)) for e in st.loop_edges.tolist() if e[0] >= 0}


def test_capacity_is_checked(maps, tmp_path):
    path = str(tmp_path / "m.pb")
    tpm.save_proto_map(path, maps["torch"], cfg(tcfg))
    small = cfg(tcfg).replace(map=tcfg.MapConfig(max_keyframes=2, max_mappoints=128, max_obs_per_mp=6))
    with pytest.raises(ValueError, match="capacity"):
        tpm.load_proto_map(path, small, "cpu")


def _saved_slam(maps):
    slam = SLAM(cfg(tcfg), device="cpu")
    slam.map = maps["torch"]
    return slam


@pytest.mark.parametrize("kind", ["pb", "dir_sep", "dir_existing", "stem", "no_ext"])
def test_slam_save_load_paths(maps, kind, tmp_path, capsys):
    slam = _saved_slam(maps)
    if kind == "dir_existing":
        (tmp_path / "m").mkdir()
    save_path = {"pb": "m.pb", "dir_sep": "m/", "dir_existing": "m", "stem": "m.x", "no_ext": "m"}[kind]
    save_path = os.path.join(str(tmp_path), save_path)
    slam.save(save_path)
    warned = "has no extension" in capsys.readouterr().err
    assert warned == (kind == "no_ext")
    if kind == "pb":
        assert os.path.isfile(save_path)
    elif kind.startswith("dir"):
        assert sorted(os.listdir(tmp_path / "m")) == ["KeyFrames.txt", "MapPoints.txt"]
    else:
        assert os.path.isfile(save_path + ".map.npz")
        assert not os.path.exists(save_path + ".vocab.npz")   # no loop closer yet

    fresh = SLAM(cfg(tcfg), device="cpu")
    fresh.load(save_path)
    assert fresh.n_keyframes == 3 and fresh.n_mappoints == 40 and fresh._n_kf == 3
    assert fresh.state.name == "NOT_INITING"
    exact = kind not in ("dir_sep", "dir_existing")
    tol = 0.0 if exact else 1e-4
    np.testing.assert_allclose(fresh.map.kf_Tcw.numpy(), slam.map.kf_Tcw.numpy(), atol=tol)
    assert torch.equal(fresh.map.kf_mp_idx, slam.map.kf_mp_idx)
    if kind in ("stem", "no_ext"):
        assert fresh.loop_closer is None   # saved without a vocabulary
    else:
        # the reference formats rebuild the database with the resolved vocabulary
        assert fresh.loop_closer is not None and fresh.loop_closer.span == fresh._loop_stage
        assert fresh.loop_closer.db is not None
        assert fresh.loop_closer.vocab.branching == 4 and fresh.loop_closer.vocab.depth == 2


def test_slam_save_with_vocabulary_and_missing_map(maps, tmp_path):
    slam = _saved_slam(maps)
    slam._ensure_loop_closer(0)
    slam.save(str(tmp_path / "v.pb"))
    slam.save(str(tmp_path / "v"))
    assert os.path.isfile(tmp_path / "v.vocab.npz")
    # the vocabulary the port saved, read by the JAX package, words the same map the same
    jv = jvoc.load_vocabulary(str(tmp_path / "v.vocab.npz"))
    jmsg = jpm.state_to_msg(maps["jax"], cfg(jcfg), vocab=jv)
    assert (tmp_path / "v.pb").read_bytes() == jmsg.SerializeToString()
    missing = str(tmp_path / "nothing")
    with pytest.raises(FileNotOpenError) as err:
        slam.load(missing)
    for tried in (missing, missing + ".map.npz", missing + os.sep):
        assert repr(tried) in str(err.value)
