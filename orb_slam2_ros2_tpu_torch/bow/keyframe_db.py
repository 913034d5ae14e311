"""Keyframe database for place recognition — sparse top-words tf-idf rows.

Port of ``orb_slam2_ros2_tpu/bow/keyframe_db.py`` (reference:
src/KeyFrameDB.cc — addKeyFrame :8-36, findRelocKfs :39-173,
findLoopCloseKfs :181-242).  Each keyframe stores its top-``S`` words by
tf-idf weight as a fixed-shape (ids, weights) pair, so memory is O(K·S)
whatever the vocabulary size.  A query scatters its own sparse vector into a
transient dense [W] scratch and every keyframe score is one gather and a row
sum: ``score[k] = Σ_s scratch[word_ids[k, s]] · weights[k, s]`` — the cosine
of L2-normalized tf-idf vectors (in place of DBoW3's L1 score).

Ties: every top-k is the stable ``utils.topk_bounded`` (lower index first,
as ``lax.top_k``); the word sort is stable and its run lengths come from a
two-sided ``searchsorted``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..mapstate.map_state import MapState, kf_index
from ..utils import set_drop, topk_bounded
from .vocabulary import Vocabulary, transform

# minimum vocabulary size for the shared-word prefilter (see
# find_reloc_candidates): below this the rows saturate and word counts stop
# being a place signal
WORD_GATE_MIN_VOCAB = 10_000


class BowVec(NamedTuple):
    """Sparse tf-idf vector: top-S (word id, weight) pairs, L2-normalized."""

    ids: torch.Tensor      # i32[..., S], −1 = empty slot
    weights: torch.Tensor  # f32[..., S]


class KeyFrameDB(NamedTuple):
    """Sparse BoW store: top-S word (id, weight) rows per keyframe slot."""

    word_ids: torch.Tensor  # i32[K, S], −1 = empty
    weights: torch.Tensor   # f32[K, S]

    @staticmethod
    def empty(n_keyframes: int, max_words: int, device) -> "KeyFrameDB":
        return KeyFrameDB(
            word_ids=torch.full((n_keyframes, max_words), -1, dtype=torch.int32, device=device),
            weights=torch.zeros((n_keyframes, max_words), dtype=torch.float32, device=device),
        )

    @property
    def max_words(self) -> int:
        return self.word_ids.shape[1]


def sparse_bow(vocab: Vocabulary, word_ids: torch.Tensor, max_words: int) -> BowVec:
    """Word histogram → top-``max_words`` tf-idf entries, L2-normalized over
    the kept entries; ``word_ids`` is i32[..., N] (leading dims batch).

    Cost is O(N log N) in the descriptor count, not the vocabulary size: the
    word ids are sorted and run-length counted by a two-sided searchsorted,
    so no dense [W] histogram or top-k over W exists."""
    W = vocab.n_words
    N = word_ids.shape[-1]
    s, _ = torch.sort(torch.where(word_ids >= 0, word_ids, W), dim=-1, stable=True)  # W = pad
    lo = torch.searchsorted(s, s, right=False)
    hi = torch.searchsorted(s, s, right=True)
    count = (hi - lo).float()                                    # occurrences
    first = torch.arange(N, device=s.device) == lo               # one per word
    valid = first & (s < W)
    v = torch.where(valid, count * vocab.idf[s.clamp(0, W - 1).long()], 0.0)
    k = min(max_words, N)
    top_w, top_i = topk_bounded(v, k)                            # over [N]
    norm = torch.linalg.vector_norm(top_w, dim=-1, keepdim=True)
    w = torch.where(top_w > 0, top_w / torch.clamp(norm, min=1e-9), 0.0)
    ids = torch.where(top_w > 0, torch.gather(s, -1, top_i).to(torch.int32), -1)
    if k < max_words:  # fewer descriptor slots than row width: pad
        pad = (*ids.shape[:-1], max_words - k)
        ids = torch.cat([ids, torch.full(pad, -1, dtype=torch.int32, device=ids.device)], dim=-1)
        w = torch.cat([w, torch.zeros(pad, dtype=torch.float32, device=w.device)], dim=-1)
    return BowVec(ids=ids, weights=w)


def rebuild(vocab: Vocabulary, state: MapState, max_words: int = 1024,
            chunk: int = 16) -> KeyFrameDB:
    """Recompute every valid keyframe's BoW row — the database refill after
    a map load (System.cc:104-110).

    Keyframes go through ``transform`` in ``chunk``-row batches: the tree
    descent materializes a [rows, N, k, 256] f32 sign tensor per level,
    which over all slots of a full-size map is tens of GB; chunked, the peak
    is chunk/K of that with identical results.  Only the valid slots are
    computed (their ids are read back once: this runs at load time, not in
    a frame); the others keep the empty row they would be masked to."""
    db = KeyFrameDB.empty(state.kf_capacity, max_words, device=state.kf_desc.device)
    for rows in torch.nonzero(state.kf_valid)[:, 0].split(max(1, chunk)):
        v = sparse_bow(vocab, transform(vocab, state.kf_desc[rows], state.kf_feat_valid[rows]), max_words)
        db.word_ids[rows] = v.ids
        db.weights[rows] = v.weights
    return db


def add_keyframe(
    db: KeyFrameDB, vocab: Vocabulary, kf_id, desc: torch.Tensor, valid: torch.Tensor
) -> KeyFrameDB:
    """Compute and store the keyframe's BoW row (KeyFrameDB::addKeyFrame) in
    a new database (``write_row_`` stores in place)."""
    v = sparse_bow(vocab, transform(vocab, desc, valid), db.max_words)
    row = kf_index(kf_id, desc.device)
    return KeyFrameDB(
        word_ids=db.word_ids.index_copy(0, row, v.ids[None]),
        weights=db.weights.index_copy(0, row, v.weights[None]),
    )


def write_row_(db: KeyFrameDB, kf_id, v: BowVec) -> None:
    """Store ``v`` as keyframe ``kf_id``'s row of ``db`` in place: the
    database stays at its addresses, which a captured graph reads and
    writes."""
    row = kf_index(kf_id, v.ids.device)
    db.word_ids.index_copy_(0, row, v.ids[None])
    db.weights.index_copy_(0, row, v.weights[None])


def query_scores(
    db: KeyFrameDB, query: BowVec, kf_valid: torch.Tensor, *, n_words: int
) -> torch.Tensor:
    """Cosine similarity of the query against every keyframe row [K]:
    scatter the query into a dense [W] scratch, gather at each row's ids."""
    scratch = torch.zeros(n_words + 1, dtype=torch.float32, device=query.ids.device)
    scratch = set_drop(scratch, torch.where(query.ids >= 0, query.ids, n_words), query.weights)
    g = scratch[db.word_ids.clamp(0, n_words - 1).long()]          # [K, S]
    s = torch.sum(torch.where(db.word_ids >= 0, g * db.weights, 0.0), dim=1)
    return torch.where(kf_valid, s, 0.0)


def shared_word_counts(
    db: KeyFrameDB, query: BowVec, kf_valid: torch.Tensor, *, n_words: int
) -> torch.Tensor:
    """Shared-word count of the query against every keyframe row [K] — the
    first retrieval stage (KeyFrameDB.cc:39-58).  Perceptually aliased views
    can score a high cosine on few very heavy words, but genuine revisits
    share many words; the 0.8·max gate on this count suppresses the aliased
    candidates."""
    scratch = torch.zeros(n_words + 1, dtype=torch.bool, device=query.ids.device)
    scratch = set_drop(scratch, torch.where(query.ids >= 0, query.ids, n_words), True)
    g = scratch[db.word_ids.clamp(0, n_words - 1).long()] & (db.word_ids >= 0)
    return torch.where(kf_valid, g.to(torch.int32).sum(dim=1).to(torch.int32), 0)


def _group_scores(
    state: MapState, s: torch.Tensor, top_covis: int = 10, top_rows: int = 64
) -> torch.Tensor:
    """Covisibility-group accumulated score (KeyFrameDB.cc:125-173): each
    keyframe's score plus its top-``top_covis`` covisible neighbours'.

    Computed only for the ``top_rows`` highest-scoring keyframes (other rows
    return 0): candidates are selected by own score among group passers, so
    only high-s rows can be picked, and the 0.75·max(gs) threshold can at
    worst be slightly under-estimated (more permissive)."""
    K = s.shape[0]
    R = min(top_rows, K)
    sv, rows = topk_bounded(s, R)                        # high-s keyframes
    rows_c = rows.clamp(0, K - 1)
    covis_rows = state.covis[rows_c] * state.kf_valid.to(torch.int32)[None, :]
    w, ids = topk_bounded(covis_rows, min(top_covis, K))  # [R, top_covis]
    nb_sum = torch.sum(torch.where(w > 0, s[ids.clamp(0, K - 1)], 0.0), dim=1)
    gs_rows = torch.where(sv > 0, sv + nb_sum, 0.0)
    return torch.zeros(K, dtype=s.dtype, device=s.device).scatter_reduce(
        0, rows_c, gs_rows, reduce="amax")


def find_reloc_candidates(
    db: KeyFrameDB,
    state: MapState,
    query: BowVec,
    *,
    n_words: int,
    n_candidates: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relocalization candidates (findRelocKfs, KeyFrameDB.cc:39-173):
    shared-word prefilter at 0.8·max (the minCommonWords gate, :58-76),
    score the survivors, group-accumulate over covisibility, keep groups
    above 0.75·best, return each group's best member.

    The word gate assumes an ORBvoc-class vocabulary (10⁵-10⁶ words), where
    a frame's words are a discriminative place fingerprint; with a tiny
    vocabulary the rows saturate and the count degenerates into a
    texture-frequency signal, so the gate is active only from
    ``WORD_GATE_MIN_VOCAB`` words."""
    s = query_scores(db, query, state.kf_valid, n_words=n_words)
    if n_words >= WORD_GATE_MIN_VOCAB:
        shared = shared_word_counts(db, query, state.kf_valid, n_words=n_words)
        word_ok = shared.float() > 0.8 * shared.max().float()
        s = torch.where(word_ok, s, 0.0)
    gs = _group_scores(state, s)
    th = 0.75 * gs.max()
    ok = (gs >= th) & (s > 0)
    top, ids = topk_bounded(torch.where(ok, s, -1.0), n_candidates)
    return torch.where(top > 0, ids, -1).to(torch.int32), top


def find_loop_candidates(
    db: KeyFrameDB,
    state: MapState,
    query: BowVec,
    query_kf,
    *,
    n_words: int,
    n_candidates: int = 5,
    min_covis_weight: int = 15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop-closure candidates (findLoopCloseKfs, KeyFrameDB.cc:181-242):
    like the relocalization retrieval, but keyframes covisible with the
    query are excluded and candidates must beat the minimum score of the
    query's own neighbourhood.  The shared-word prefilter runs over the
    non-excluded set, under the same vocabulary-size premise."""
    K = state.kf_capacity
    dev = state.covis.device
    s = query_scores(db, query, state.kf_valid, n_words=n_words)
    shared = shared_word_counts(db, query, state.kf_valid, n_words=n_words)
    q = kf_index(query_kf, dev)
    covis_q = state.covis[q][0]

    # min score among the query's covisible neighbours = base threshold
    nb_mask = covis_q * state.kf_valid.to(torch.int32) >= min_covis_weight
    min_nb = torch.where(nb_mask, s, float("inf")).min()
    min_score = torch.where(torch.isfinite(min_nb), min_nb, 0.0)

    excluded = (covis_q > 0) | (torch.arange(K, device=dev) == q) | ~state.kf_valid
    s = torch.where(excluded, 0.0, s)
    if n_words >= WORD_GATE_MIN_VOCAB:
        shared = torch.where(excluded, 0, shared)
        word_ok = shared.float() > 0.8 * shared.max().float()
        s = torch.where(word_ok, s, 0.0)
    gs = _group_scores(state, s)
    th = torch.maximum(0.75 * gs.max(), min_score)
    ok = (gs >= th) & (s >= min_score) & (s > 0)
    top, ids = topk_bounded(torch.where(ok, s, -1.0), n_candidates)
    return torch.where(top > 0, ids, -1).to(torch.int32), top
