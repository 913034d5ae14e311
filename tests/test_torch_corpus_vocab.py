"""The port's vocabulary corpus trainer (``train_corpus_vocab``) against the
JAX repository's root ``train_corpus_vocab.py``, on the CPU at 320×192 with
600 features (768 keypoint slots).

* The five corpus worlds equal the root script's list (read from its
  ``main`` with ``ast``): names, frame counts, trajectories and render flags.
* Extraction: two frame pairs of every world, rendered by the JAX package,
  through JAX's ``extract_features_batch`` over ``[l0, l1, r0, r1]`` and the
  port's ``CorpusExtractor``: the same number of valid descriptors in the
  same order, bits within the frontend's 1e-3 budget.
* Training: one fixed descriptor set (with repeats beyond the cap) through
  the root script's ``train_only`` and the port's: tree levels and idf
  exact.  The root script writes into the JAX package's asset, so its
  ``numpy.savez_compressed`` is replaced by a capture and the asset's bytes
  are checked unchanged.
* ``main`` end to end on the port's own renders (one pair a world, depth 2):
  the file it writes loads as a vocabulary, and a second run trains on its
  cache.
* The cache is opt-in and keyed on the extraction settings: no file without
  ``cache=``, and a changed config field, pair count or BRIEF template
  extracts anew (extraction stubbed).
"""

import ast
import hashlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.features import extractor as jext
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.io import synthetic as jsyn
from orb_slam2_ros2_tpu_torch import train_corpus_vocab as tcv
from orb_slam2_ros2_tpu_torch.bow.vocabulary import load_vocabulary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ASSET = os.path.join(REPO, "orb_slam2_ros2_tpu", "assets", "vocab_synth_l5.npz")
BRIEF_BIT_BUDGET = 1e-3


def cfg_of(mod):
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192),
        orb=mod.ORBConfig(n_features=600, max_keypoints=768),
    )


def reference_worlds(camera):
    """The ``datasets`` list of the root script's ``main``, built with the
    JAX package's datasets."""
    with open(os.path.join(REPO, "train_corpus_vocab.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in main.body if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "datasets")
    env = dict(SyntheticStereoDataset=jsyn.SyntheticStereoDataset,
               AdversarialStereoDataset=jsyn.AdversarialStereoDataset, c=camera)
    return eval(compile(ast.Expression(node.value), "train_corpus_vocab.py", "eval"), env)


@pytest.fixture(scope="module")
def worlds():
    return reference_worlds(cfg_of(jcfg).camera), tcv.worlds(cfg_of(tcfg).camera, "cpu")


def test_worlds_equal_the_reference_script(worlds):
    ref, port = worlds
    assert [(n, k) for n, _, k in port] == [(n, k) for n, _, k in ref]
    for (name, jd, _), (_, td, _) in zip(ref, port):
        assert type(jd).__name__ == type(td).__name__, name
        np.testing.assert_array_equal(td.poses_wc, jd.poses_wc)
        for attr in ("n_frames", "box_scale", "sky", "frames_per_lap"):
            assert getattr(td, attr, None) == getattr(jd, attr, None), (name, attr)
        if hasattr(jd, "flags"):
            assert td.flags == jd.flags, name


def test_corpus_extraction_matches_jax(worlds):
    ref, _ = worlds
    jc, tc = cfg_of(jcfg), cfg_of(tcfg)
    o, c = jc.orb, jc.camera
    caps = tuple(jext.level_capacities(o.max_keypoints, o.n_levels, o.scale_factor))
    jcam = JCam.from_config(c)
    jfn = jax.jit(lambda imgs: jext.extract_features_batch(
        imgs, jcam, h=c.height, w=c.width, n_levels=o.n_levels, scale_factor=o.scale_factor, caps=caps,
        border=o.edge_border, min_th=float(o.min_th_fast), ini_th=float(o.ini_th_fast), cell=o.cell_size,
        undistort=c.has_distortion))
    extract = tcv.CorpusExtractor(tc, "cpu")
    n_bits = n_diff = 0
    for name, ds, _ in ref:
        for i in (0, 2):
            l0, r0, _ = ds.frame(i)
            l1, r1, _ = ds.frame(i + 1)
            feats, _ = jfn(jnp.stack([l0, l1, r0, r1]))
            want = np.asarray(feats.desc).reshape(-1, 8)[np.asarray(feats.valid).reshape(-1)]
            got = extract(*(torch.from_numpy(np.array(x)) for x in (l0, l1, r0, r1)))
            assert got.dtype == np.uint32 and got.shape == want.shape and len(want) > 500, name
            n_bits += want.size * 32
            n_diff += int(np.unpackbits((got ^ want).view(np.uint8)).sum())
    assert n_diff / n_bits <= BRIEF_BIT_BUDGET


def descriptor_set() -> np.ndarray:
    r = np.random.default_rng(11)
    base = r.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    # near-duplicates around 300 centres, and exact repeats beyond the cap
    flips = r.integers(0, 2**32, (2400, 8), dtype=np.uint64).astype(np.uint32) & np.uint32(0x01010101)
    descs = np.concatenate([base[r.integers(0, 300, 2400)] ^ flips, np.repeat(base[:5], 9, axis=0)])
    return descs[r.permutation(len(descs))]


def test_training_matches_train_only(monkeypatch):
    # the root script; importing it pins JAX to the CPU (as conftest does)
    # and puts a fixed checkout path first on sys.path, which is undone here
    path = list(sys.path)
    try:
        import train_corpus_vocab as ref
    finally:
        sys.path[:] = path

    with open(JAX_ASSET, "rb") as f:
        asset_before = hashlib.sha256(f.read()).hexdigest()
    saved = {}
    monkeypatch.setattr(np, "savez_compressed", lambda path, **arrays: saved.update(arrays, path=path))
    monkeypatch.setattr(ref.os.path, "getsize", lambda path: 0)
    descs = descriptor_set()
    ref.train_only(descs.copy())
    monkeypatch.undo()
    with open(JAX_ASSET, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == asset_before
    assert saved["path"].endswith(os.path.join("orb_slam2_ros2_tpu", "assets", "vocab_synth_l5.npz"))

    levels, idf, stats = tcv.train_only(descs, depth=5, log=lambda msg: None)
    assert (int(saved["branching"]), int(saved["depth"])) == (10, 5)
    assert len(levels) == 5
    for d, t in enumerate(levels):
        np.testing.assert_array_equal(t, saved[f"level_{d}"])
    np.testing.assert_array_equal(idf, saved["idf"])
    uniq = np.unique(descs, axis=0)
    assert stats["descriptors"] == len(descs) and stats["unique"] == len(uniq)
    assert stats["capped"] == len(descs) - 5 * (9 - tcv.REPEAT_CAP)
    assert 0 < stats["leaves_populated"] <= stats["capped"]


def test_main_writes_a_vocabulary_and_reuses_its_cache(tmp_path):
    cfg = cfg_of(tcfg)
    out, cache = tmp_path / "vocab.npz", tmp_path / "descs.npy"
    first = tcv.main(out=out, cache=cache, device="cpu", depth=2, pairs=1, cfg=cfg)
    assert os.path.exists(cache) and first["descriptors"] > 2000
    v = load_vocabulary(str(out), "cpu")
    assert (v.branching, v.depth, v.n_words) == (10, 2, 100)
    assert 0 < first["leaves_populated"] <= first["leaves"] == 100
    second = tcv.main(out=tmp_path / "again.npz", cache=cache, device="cpu", depth=2, pairs=1, cfg=cfg)
    assert {k: v for k, v in second.items() if "seconds" not in k and k != "out"} == \
           {k: v for k, v in first.items() if "seconds" not in k and k != "out"}
    a, b = np.load(out), np.load(tmp_path / "again.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("change", ["none", "no_cache", "config", "pairs", "template"])
def test_cache_is_opt_in_and_keyed_on_the_settings(change, tmp_path, monkeypatch):
    import dataclasses

    from orb_slam2_ros2_tpu_torch.ops import brief

    calls = []

    def fake_corpus(cfg, device, pairs=None, log=print):
        calls.append((cfg, pairs))
        return descriptor_set()

    monkeypatch.setattr(tcv, "corpus", fake_corpus)
    cfg = cfg_of(tcfg)
    cache = tmp_path / "descs.npz"
    tcv.main(out=tmp_path / "a.npz", cache=cache, device="cpu", depth=1, pairs=1, cfg=cfg)
    assert len(calls) == 1 and cache.exists()
    kw = dict(cache=cache, pairs=1, cfg=cfg)
    if change == "no_cache":
        cache.unlink()
        kw["cache"] = None
    elif change == "config":
        kw["cfg"] = dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, ini_th_fast=cfg.orb.ini_th_fast + 1))
    elif change == "pairs":
        kw["pairs"] = 2
    elif change == "template":
        tpl = tmp_path / "pattern.txt"
        np.savetxt(tpl, np.flipud(brief.brief_template()), fmt="%d")
        brief.set_template_file(str(tpl))
    try:
        tcv.main(out=tmp_path / "b.npz", device="cpu", depth=1, **kw)
    finally:
        brief.clear_template_override()
    assert len(calls) == (1 if change == "none" else 2)
    assert cache.exists() == (change != "no_cache")
