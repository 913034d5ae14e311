"""Carry state between the JAX package and this port.

The JAX package's ``MapState``, ``LocalMap``, ``SlamFrame``, ``StereoFrame``,
``FrameFeatures``, ``Vocabulary``, ``KeyFrameDB``, ``Sim3``,
``PoseGraphProblem``, ``PointBAProblem``, ``GlobalBAProblem`` and
``PendingGBA`` arrive as trees of numpy arrays (its NamedTuples with
numpy leaves, or dicts keyed by field name) and become this package's
NamedTuples of tensors on a device; ``to_numpy`` goes back to nested dicts
of numpy arrays.  uint32 descriptor words are reinterpreted as int32 bit for
bit (and back to uint32 on the way out), vocabulary centroids likewise.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .bow.keyframe_db import KeyFrameDB
from .bow.vocabulary import Vocabulary, from_arrays
from .features.frame import FrameFeatures, StereoFrame
from .geometry.sim3 import Sim3
from .mapstate.local_map import LocalMap
from .mapstate.map_state import MapState
from .pipeline.system import SlamFrame
from .solvers.global_ba import PendingGBA
from .solvers.pcg_ba import GlobalBAProblem, PointBAProblem
from .solvers.pose_graph import PoseGraphProblem

_DESC_FIELDS = frozenset({"desc", "kf_desc", "mp_desc", "levels"})


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _flat(cls, tree, device):
    return cls(*(_tensor(_get(tree, f), device) for f in cls._fields))


def features_to_torch(tree, device) -> FrameFeatures:
    return _flat(FrameFeatures, tree, device)


def stereo_frame_to_torch(tree, device) -> StereoFrame:
    return StereoFrame(
        feats=features_to_torch(_get(tree, "feats"), device),
        right_u=_tensor(_get(tree, "right_u"), device),
        depth=_tensor(_get(tree, "depth"), device),
    )


def slam_frame_to_torch(tree, device) -> SlamFrame:
    return SlamFrame(
        frame=stereo_frame_to_torch(_get(tree, "frame"), device),
        Tcw=_tensor(_get(tree, "Tcw"), device),
        mp_ids=_tensor(_get(tree, "mp_ids"), device),
    )


def map_state_to_torch(tree, device) -> MapState:
    return _flat(MapState, tree, device)


def local_map_to_torch(tree, device) -> LocalMap:
    return _flat(LocalMap, tree, device)


def vocabulary_to_torch(tree, device) -> Vocabulary:
    return from_arrays([np.asarray(t) for t in _get(tree, "levels")], np.asarray(_get(tree, "idf")),
                       _get(tree, "branching"), _get(tree, "depth"), device)


def keyframe_db_to_torch(tree, device) -> KeyFrameDB:
    return _flat(KeyFrameDB, tree, device)


def sim3_to_torch(tree, device) -> Sim3:
    return _flat(Sim3, tree, device)


def pose_graph_problem_to_torch(tree, device) -> PoseGraphProblem:
    sub = {"S_cw", "edge_Sji"}
    return PoseGraphProblem(*(
        sim3_to_torch(_get(tree, f), device) if f in sub else _tensor(_get(tree, f), device)
        for f in PoseGraphProblem._fields))


def point_ba_problem_to_torch(tree, device) -> PointBAProblem:
    return _flat(PointBAProblem, tree, device)


def global_ba_problem_to_torch(tree, device) -> GlobalBAProblem:
    return _flat(GlobalBAProblem, tree, device)


def pending_gba_to_torch(tree, device) -> PendingGBA:
    """The watermarks and the chunk count stay host ints."""
    return PendingGBA(
        prob=global_ba_problem_to_torch(_get(tree, "prob"), device),
        Tcw=_tensor(_get(tree, "Tcw"), device), ptsT=_tensor(_get(tree, "ptsT"), device),
        pt_in_ba=_tensor(_get(tree, "pt_in_ba"), device),
        snap_next_kf=int(_get(tree, "snap_next_kf")), snap_next_mp=int(_get(tree, "snap_next_mp")),
        chunks_done=int(_get(tree, "chunks_done")),
    )


def to_numpy(nt) -> dict:
    """A NamedTuple of tensors (nested) → nested dict of numpy arrays, with
    descriptor and centroid words as uint32 like the JAX package's; a plain
    tuple of tensors becomes a list, host scalars pass through."""
    def leaf(name, v):
        if not torch.is_tensor(v):
            return v
        a = v.detach().cpu().numpy()
        return a.view(np.uint32) if name in _DESC_FIELDS else a

    out = {}
    for name, v in zip(nt._fields, nt):
        if isinstance(v, tuple):
            out[name] = to_numpy(v) if hasattr(v, "_fields") else [leaf(name, t) for t in v]
        else:
            out[name] = leaf(name, v)
    return out
