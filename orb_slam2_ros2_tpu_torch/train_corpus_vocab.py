"""Train the packaged 10⁵-word vocabulary from a rendered multi-world corpus
(port of the JAX repository's root ``train_corpus_vocab.py``).

The corpus: the benign forward and circle worlds at several scales and the
adversarial world (repeated-texture wall, distractor spheres, exposure
flicker), the worlds the validation harness relocalizes in.  Descriptors
come from the production extractor, ``extract_features_batch`` over each
frame pair's four images ``[l0, l1, r0, r1]`` (one FAST launch over a
four-image level table and one patch launch on CUDA).  Training is the
numpy k-medians tree of ``bow.vocabulary`` (k = 10, L = 5, exact repeats
capped at 4, ``default_rng(0)``, idf from the leaf counts).  Extraction runs
on ``--device`` (the card by default); training runs on the host.

    python -m orb_slam2_ros2_tpu_torch.train_corpus_vocab [--out FILE]
        [--cache FILE] [--device cuda]

writes ``--out`` (default: the package's ``assets/vocab_synth_l5.npz``) and
prints one JSON line.  With ``--cache`` the descriptor corpus is kept in that
file beside the extraction settings it was made with (``cache_key``: the
whole ``SLAMConfig``, the pair count and the BRIEF sampling matrix), and a later run with the same settings
trains on it without rendering; a run with other settings extracts anew.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .bow import vocabulary as V
from .config import SLAMConfig
from .features import extractor as ex
from .geometry.camera import CameraParams
from .io.synthetic import AdversarialStereoDataset, SyntheticStereoDataset
from .ops import brief

ASSET = Path(__file__).resolve().parent / "assets" / "vocab_synth_l5.npz"
BRANCHING = 10
REPEAT_CAP = 4


def worlds(camera, device):
    """The corpus worlds: (name, dataset, frames)."""
    return [
        ("fwd-sky", SyntheticStereoDataset(camera, n_frames=100, speed=0.8, box_scale=2.5, sky=True,
                                           device=device), 100),
        ("fwd-plain", SyntheticStereoDataset(camera, n_frames=80, speed=1.2, box_scale=1.0,
                                             device=device), 80),
        ("circle", SyntheticStereoDataset(camera, n_frames=80, circle=True, box_scale=2.5, sky=True,
                                          device=device), 80),
        ("adversarial", AdversarialStereoDataset(camera, n_frames=140, frames_per_lap=52,
                                                 device=device), 140),
        ("adv-notex", AdversarialStereoDataset(camera, n_frames=60, frames_per_lap=40,
                                               repeat_texture=False, n_distractors=6,
                                               device=device), 60),
    ]


class CorpusExtractor:
    """``extract_features_batch`` over four images a call, on one device."""

    def __init__(self, cfg: SLAMConfig, device):
        self.cam = CameraParams.from_config(cfg.camera, device)
        self.consts = ex.frontend_constants(cfg, device, n_images=4)
        self.kw = ex._extract_kw(cfg)

    def __call__(self, l0, l1, r0, r1) -> np.ndarray:
        """The valid descriptors of both eyes of two frames, uint32 [D, 8]
        (image by image: l0, l1, r0, r1)."""
        imgs = torch.stack([l0, l1, r0, r1]).float()
        feats, _ = ex.extract_features_batch(imgs, self.cam, self.consts, **self.kw)
        desc = feats.desc.reshape(-1, 8).cpu().numpy().view(np.uint32)
        return desc[feats.valid.reshape(-1).cpu().numpy()]


def corpus(cfg: SLAMConfig, device, pairs=None, log=print) -> np.ndarray:
    """Descriptors of frame pairs (0, 1), (2, 3), … of every world — the
    first ``pairs`` of each when given — uint32 [D, 8]."""
    extract = CorpusExtractor(cfg, device)
    out = []
    for name, ds, n in worlds(cfg.camera, device):
        starts = list(range(0, n - 1, 2))[:pairs]
        for i in starts:
            l0, r0, _ = ds.frame(i)
            l1, r1, _ = ds.frame(i + 1)
            out.append(extract(l0, l1, r0, r1))
            if i % 20 == 0:
                log(f"{name} {i}/{n} ({sum(len(a) for a in out)} desc)")
    return np.concatenate(out)


def train_only(descs: np.ndarray, depth: int = 5, log=print):
    """Cap exact repeats at 4, then the k-medians tree (k = 10) to ``depth``.
    Returns (levels, idf, stats); ``stats`` holds the corpus, unique and
    capped counts and the populated leaves."""
    # the repeated-texture wall floods the corpus with identical descriptors;
    # a small cap > 1 keeps frequency signal for the idf weights
    uniq, counts = np.unique(descs, axis=0, return_counts=True)
    capped = np.repeat(uniq, np.minimum(counts, REPEAT_CAP), axis=0)
    log(f"corpus: {len(descs)} descriptors, {len(uniq)} unique, {len(capped)} after cap")
    rng = np.random.default_rng(0)
    k = BRANCHING
    levels = []
    groups = [capped]
    for d in range(depth):
        table = np.zeros((k ** (d + 1), 8), np.uint32)
        next_groups = []
        for gi, g in enumerate(groups):
            centers = V._kmedians(g, k, rng)
            table[gi * k:(gi + 1) * k] = centers
            assign = V._hamming_np(g, centers).argmin(1) if len(g) else np.zeros((0,), np.int64)
            for c in range(k):
                next_groups.append(g[assign == c])
        levels.append(table)
        groups = next_groups
        log(f"level {d} done")
    leaf_counts = np.array([len(g) for g in groups], np.float32)
    idf = np.log(max(len(capped), 1) / np.maximum(leaf_counts, 1.0)).astype(np.float32)
    stats = dict(descriptors=int(len(descs)), unique=int(len(uniq)), capped=int(len(capped)),
                 leaves_populated=int((leaf_counts > 0).sum()), leaves=k ** depth)
    return levels, idf, stats


def cache_key(cfg: SLAMConfig, pairs=None) -> str:
    """What a cached corpus was extracted with: the whole config, the pair
    count and the BRIEF sampling matrix (which a template override sets)."""
    pm = brief.pair_matrix("cpu", ex._template_pair_matrix(cfg)).numpy()
    return f"{cfg!r} pairs={pairs} brief={hashlib.sha256(pm.tobytes()).hexdigest()}"


def _load_cached(cache, key: str):
    """The corpus in ``cache`` if it was extracted with ``key``, else None."""
    if cache is None or not os.path.exists(cache):
        return None
    with np.load(cache) as f:
        return f["descs"] if str(f["key"]) == key else None


def main(out=ASSET, cache=None, device="cuda", depth: int = 5, pairs=None,
         cfg: SLAMConfig | None = None) -> dict:
    """Render and extract the corpus (or take it from ``cache`` when that
    holds one of the same settings), train to ``depth`` on the first
    ``pairs`` frame pairs of each world (all by default), write ``out``;
    returns the run's counts and seconds."""
    cfg = cfg or SLAMConfig()
    key = cache_key(cfg, pairs)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    descs = _load_cached(cache, key)
    if descs is not None:
        log(f"loaded cached corpus {descs.shape} from {cache}")
    else:
        descs = corpus(cfg, device, pairs, log)
        if cache is not None:
            os.makedirs(os.path.dirname(os.fspath(cache)) or ".", exist_ok=True)
            with open(cache, "wb") as f:
                np.savez(f, descs=descs, key=key)
            log(f"corpus cached to {cache}")
    t_corpus = time.time() - t0
    levels, idf, stats = train_only(descs, depth, log)
    np.savez_compressed(out, branching=BRANCHING, depth=depth, idf=idf,
                        **{f"level_{d}": t for d, t in enumerate(levels)})
    stats.update(out=os.fspath(out), depth=depth, corpus_seconds=t_corpus, seconds=time.time() - t0)
    log(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB), "
        f"{stats['leaves_populated']}/{stats['leaves']} leaves populated")
    return stats


def _cli(argv=None) -> None:
    p = argparse.ArgumentParser(prog="orb_slam2_ros2_tpu_torch.train_corpus_vocab")
    p.add_argument("--out", default=str(ASSET))
    p.add_argument("--cache", default=None, help="corpus cache file (default: none)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    print(json.dumps(main(a.out, a.cache, a.device)))


if __name__ == "__main__":
    _cli()
