"""``tools/profile_orbvoc.py`` on the CPU: its DBoW-text generator at
branching 3 and depth 3 writes the bytes ``tests/test_orbvoc_scale.py``'s
``_write_orbvoc_scale`` writes (that module's ``K_BRANCH`` and ``DEPTH``
patched), the port's ``load_dbow_text`` reads 27 leaves from it, and
``main`` at a few frames of the 320×192 camera returns its keys for both
runs (the packaged 10⁵-word vocabulary, then the generated one).
"""

import numpy as np
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_tools_frontend import run, small_yaml  # noqa: F401  (fixture)

import test_orbvoc_scale as jscale
from orb_slam2_ros2_tpu_torch.bow.vocabulary import load_dbow_text, transform
from orb_slam2_ros2_tpu_torch.tools import profile_orbvoc


def test_generator_bytes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jscale, "K_BRANCH", 3)
    monkeypatch.setattr(jscale, "DEPTH", 3)
    n_j = jscale._write_orbvoc_scale(str(tmp_path / "j.txt"), np.random.default_rng(0))
    n_t = profile_orbvoc.write_orbvoc_scale(str(tmp_path / "t.txt"), np.random.default_rng(0), 3, 3)
    assert n_t == n_j == 3 + 9 + 27
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_port_loader_reads_the_generated_tree(tmp_path):
    path = str(tmp_path / "v.txt")
    profile_orbvoc.write_orbvoc_scale(path, np.random.default_rng(1), 3, 3)
    v = load_dbow_text(path, "cpu")
    assert v.n_words == 27 and [t.shape[0] for t in v.levels] == [3, 9, 27]
    desc = torch.randint(-2**31, 2**31 - 1, (64, 8), dtype=torch.int32, generator=torch.Generator().manual_seed(0))
    words = transform(v, desc, torch.ones(64, dtype=torch.bool))
    assert int(words.min()) >= 0 and int(words.max()) < 27
    path2, write_s = profile_orbvoc.vocabulary_file(tmp_path, 3, 3)
    assert write_s > 0 and profile_orbvoc.vocabulary_file(tmp_path, 3, 3) == (path2, 0.0)


def test_main_returns_its_keys(small_yaml, tmp_path):  # noqa: F811
    out = run("profile_orbvoc", "--config", small_yaml, "--frames", "8", "--lap", "96", "--branching", "3",
              "--depth", "3", "--reps", "1", "--vocab-dir", str(tmp_path))
    small, scale = out["orbvoc_live"]
    assert small["n_words"] == 10 ** 5 and scale["n_words"] == 27
    for r in (small, scale):
        assert r["tracked"] == r["frames"] == 8
        for key in ("kf_add_detect_ms", "kf_add_detect_eager_ms", "reloc_query_ms", "reloc_query_eager_ms"):
            assert r[key] > 0, key
    assert out["vocab_write_s"] > 0 and out["vocab_bytes"] > 1000
