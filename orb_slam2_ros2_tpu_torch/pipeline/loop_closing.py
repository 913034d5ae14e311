"""The place-recognition half of the loop closer.

Port of ``LoopCloser.__init__`` / ``grow`` / ``add_keyframe_to_db`` of
``orb_slam2_ros2_tpu/pipeline/loop_closing.py`` (reference
src/LoopClosing.cc, src/KeyFrameDB.cc): the object that owns the BoW
vocabulary and the keyframe database, which relocalization queries.  Loop
detection, Sim3 verification, correction and the essential graph are not
ported yet; their methods raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..bow.keyframe_db import KeyFrameDB, add_keyframe
from ..bow.vocabulary import Vocabulary
from ..config import SLAMConfig
from ..mapstate.map_state import MapState

_UNPORTED = ("detect_async", "detect_frame_async", "detect", "detect_resolve", "compute_sim3",
             "sim3_begin", "sim3_step", "warmup", "correct")


class LoopCloser:
    """Owner of the vocabulary and the keyframe database."""

    def __init__(self, cfg: SLAMConfig, vocab: Vocabulary):
        self.cfg = cfg
        self.vocab = vocab
        self.db = KeyFrameDB.empty(cfg.map.max_keyframes, cfg.bow.max_words_per_query,
                                   device=vocab.device)

    def grow(self, n_keyframes: int) -> None:
        """Re-pad the sparse BoW rows when the map's keyframe capacity grows
        (SLAM._grow); row ids are stable, so existing entries carry over."""
        dK = n_keyframes - self.db.word_ids.shape[0]
        if dK <= 0:
            return
        more = KeyFrameDB.empty(dK, self.db.max_words, device=self.db.word_ids.device)
        self.db = KeyFrameDB(
            word_ids=torch.cat([self.db.word_ids, more.word_ids]),
            weights=torch.cat([self.db.weights, more.weights]),
        )

    def add_keyframe_to_db(self, state: MapState, kf_id: int) -> None:
        self.db = add_keyframe(
            self.db, self.vocab, kf_id,
            state.kf_desc[kf_id], state.kf_feat_valid[kf_id],
        )


def _unported(name: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"LoopCloser.{name}: loop detection, Sim3 verification and correction are not "
            f"ported yet (ROADMAP port queue: loop closing)")

    method.__name__ = name
    return method


for _name in _UNPORTED:
    setattr(LoopCloser, _name, _unported(_name))
