"""Bag-of-binary-words vocabulary: an array-resident k-ary tree.

Port of ``orb_slam2_ros2_tpu/bow/vocabulary.py`` (replaces DBoW3, reference
src/System.cc:93, ``transform(desc, bowVec, featVec, 4)`` in
include/ORB_SLAM2/Frame.h:224-231).  ``transform`` is a batched hamming tree
descent over all descriptors at once; the trainer (hierarchical k-medians
with bitwise-majority centroids, the DBoW recipe), the DBoW text parser and
the npz round trip are host-side numpy and produce the same arrays as the
JAX package's.

Tree layout: ``branching = k``, ``depth = L``.  Depth-d nodes are stored
contiguously: the children of node i at depth d are rows ``[i·k, (i+1)·k)``
of the depth d+1 table.  Word id = leaf index in [0, k^L).  Centroids are
int32 words holding the bits of the files' uint32 words, as descriptors are.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.hamming import unpack_signs


class Vocabulary(NamedTuple):
    """Array-resident vocabulary.  levels[d] = int32[k^(d+1), 8] centroids."""

    levels: tuple            # tuple of int32[k^(d+1), 8]
    idf: torch.Tensor        # f32[n_words] inverse-document-frequency weights
    branching: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth

    @property
    def device(self) -> torch.device:
        return self.idf.device


def from_arrays(levels, idf, branching: int, depth: int, device) -> Vocabulary:
    """Vocabulary from host arrays (uint32 or int32 centroid words)."""
    def words(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))

    return Vocabulary(
        levels=tuple(words(t).to(device) for t in levels),
        idf=torch.from_numpy(np.array(idf, dtype=np.float32)).to(device),
        branching=int(branching), depth=int(depth),
    )


def _bit_majority(descs: np.ndarray, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Bitwise-majority centroid of packed uint32[N, 8] descriptors."""
    bits = np.unpackbits(descs.view(np.uint8), axis=1)  # [N, 256]
    if weights is None:
        maj = bits.mean(axis=0) >= 0.5
    else:
        w = weights[:, None]
        maj = (bits * w).sum(0) / max(w.sum(), 1e-9) >= 0.5
    return np.packbits(maj.astype(np.uint8)).view(np.uint32)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 8] × [M, 8] → [N, M] hamming distances (numpy, training only)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8).reshape(x.shape[0], x.shape[1], -1), axis=2).sum(2)


def _kmedians(descs: np.ndarray, k: int, rng, iters: int = 8) -> np.ndarray:
    """Binary k-medians: k centroids for packed descriptors [N, 8]."""
    n = len(descs)
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    init = rng.choice(n, size=min(k, n), replace=False)
    centers = descs[init]
    if len(centers) < k:
        centers = np.concatenate([centers, rng.integers(0, 2**32, (k - len(centers), 8), dtype=np.uint32)])
    for _ in range(iters):
        d = _hamming_np(descs, centers)
        assign = d.argmin(1)
        for c in range(k):
            sel = descs[assign == c]
            if len(sel):
                centers[c] = _bit_majority(sel)
    return centers.astype(np.uint32)


def train_vocabulary(
    descriptors: np.ndarray, branching: int = 10, depth: int = 4, seed: int = 0, *, device
) -> Vocabulary:
    """Hierarchical k-medians over training descriptors uint32[N, 8] (int32
    words are reinterpreted)."""
    descriptors = np.ascontiguousarray(descriptors)
    if descriptors.dtype == np.int32:
        descriptors = descriptors.view(np.uint32)
    rng = np.random.default_rng(seed)
    k, L = branching, depth
    levels: List[np.ndarray] = []
    groups = [descriptors]
    for d in range(L):
        table = np.zeros((k ** (d + 1), 8), np.uint32)
        next_groups: List[np.ndarray] = []
        for gi, g in enumerate(groups):
            centers = _kmedians(g, k, rng)
            table[gi * k : (gi + 1) * k] = centers
            if len(g):
                assign = _hamming_np(g, centers).argmin(1)
            else:
                assign = np.zeros((0,), np.int64)
            for c in range(k):
                next_groups.append(g[assign == c])
        levels.append(table)
        groups = next_groups

    # idf from training counts (DBoW TF-IDF weighting)
    counts = np.array([len(g) for g in groups], np.float32)
    n_total = max(len(descriptors), 1)
    idf = np.log(n_total / np.maximum(counts, 1.0)).astype(np.float32)
    return from_arrays(levels, idf, k, L, device)


def transform(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Batched tree descent: descriptors int32[..., N, 8] → word ids
    i32[..., N] (−1 for invalid rows).  Replaces
    DBoW3::Vocabulary::transform.  The ±1 dot products are exact in f32 and
    argmin takes the first index on ties, so word ids equal the JAX
    package's exactly."""
    k = vocab.branching
    node = torch.zeros(desc.shape[:-1], dtype=torch.long, device=desc.device)
    sd = unpack_signs(desc)                                              # [..., N, 256]
    ar = torch.arange(k, device=desc.device)
    for d in range(vocab.depth):
        table = vocab.levels[d]                                          # [k^(d+1), 8]
        cands = table[node[..., None] * k + ar]                          # [..., N, k, 8]
        dot = torch.einsum("...b,...kb->...k", sd, unpack_signs(cands))
        best = torch.argmin((256.0 - dot) * 0.5, dim=-1)
        node = node * k + best
    return torch.where(valid, node.to(torch.int32), -1)


def bow_vector(vocab: Vocabulary, word_ids: torch.Tensor) -> torch.Tensor:
    """Word histogram → dense tf-idf L2-normalized vector f32[n_words]
    (cosine scoring in place of DBoW3's L1 score)."""
    W = vocab.n_words
    counts = torch.zeros(W + 1, dtype=torch.float32, device=word_ids.device)
    counts.index_add_(0, torch.where(word_ids >= 0, word_ids, W).long(),
                      torch.ones(word_ids.shape, dtype=torch.float32, device=word_ids.device))
    v = counts[:W] * vocab.idf
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-9)


def load_dbow_text(path: str, device) -> Vocabulary:
    """Parse a DBoW2/DBoW3 text vocabulary (ORBvoc.txt, System.cc:92-95)
    into the array tree.

    Format: first line ``k L scoring weighting``; then one node per line:
    ``parent_id is_leaf d0 … d31 weight`` in depth-first parent order.  Nodes
    are re-laid out into contiguous-children level tables; a parent with
    fewer than k children keeps duplicate filler centroids (its first
    child's descriptor).
    """
    with open(path) as f:
        first = f.readline().split()
        k, L = int(first[0]), int(first[1])
        try:
            data = np.loadtxt(f, dtype=np.float64, ndmin=2)
        except ValueError:
            # tolerant pass: keep only well-formed node lines (≥35 tokens)
            f.seek(0)
            f.readline()
            rows = [ln.split()[:35] for ln in f if len(ln.split()) >= 35]
            data = np.asarray(rows, dtype=np.float64).reshape(-1, 35)
    if data.shape[1] < 35:
        raise ValueError(f"malformed DBoW text vocabulary: {data.shape[1]} columns")
    parents = data[:, 0].astype(np.int64)
    desc_u32 = np.ascontiguousarray(data[:, 2:34].astype(np.uint8)).view(np.uint32)
    weights = data[:, 34].astype(np.float32)

    # children lists grouped by parent, preserving file order (stable sort)
    order = np.argsort(parents, kind="stable")
    sp = parents[order]
    uniq, starts = np.unique(sp, return_index=True)
    bounds = np.append(starts[1:], len(order))
    children = {int(p): order[s:e] for p, s, e in zip(uniq, starts, bounds)}

    levels_np = [np.zeros((k ** (d + 1), 8), np.uint32) for d in range(L)]
    idf = np.zeros((k**L,), np.float32)
    # iterative DFS from the implicit root (node 0) assigning contiguous slots
    stack = [(children.get(0, np.empty(0, np.int64)), 0, 0)]
    while stack:
        node_file_ids, depth, base = stack.pop()
        n_ids = min(len(node_file_ids), k)
        if n_ids:
            levels_np[depth][base:base + n_ids] = desc_u32[node_file_ids[:n_ids]]
            if n_ids < k:  # pad missing children with the first child
                levels_np[depth][base + n_ids:base + k] = desc_u32[node_file_ids[0]]
        if depth + 1 < L:
            for ci in range(n_ids):
                fid = int(node_file_ids[ci])
                stack.append((
                    children.get(fid + 1, np.empty(0, np.int64)),
                    depth + 1, (base + ci) * k,
                ))
        else:
            for ci in range(n_ids):
                idf[base + ci] = weights[node_file_ids[ci]]
    return from_arrays(levels_np, np.maximum(idf, 1e-3), k, L, device)


def save_vocabulary(vocab: Vocabulary, path: str) -> None:
    """Write the JAX package's npz layout (centroid words as uint32)."""
    np.savez_compressed(
        path,
        branching=vocab.branching, depth=vocab.depth,
        idf=vocab.idf.cpu().numpy(),
        **{f"level_{d}": t.cpu().numpy().view(np.uint32) for d, t in enumerate(vocab.levels)},
    )


def load_vocabulary(path: str, device) -> Vocabulary:
    z = np.load(path)
    depth = int(z["depth"])
    return from_arrays([z[f"level_{d}"] for d in range(depth)], z["idf"],
                       int(z["branching"]), depth, device)
