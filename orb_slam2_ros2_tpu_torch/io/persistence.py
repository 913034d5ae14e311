"""Map persistence: save/load the device-resident map.

Port of ``orb_slam2_ros2_tpu/io/persistence.py`` (the reference serializes
its pointer-web map with a relink pass after load, src/Map.cc:200-381).  The
map is flat arrays, so the checkpoint is a compressed npz of the stores — the
observation index, covisibility and spanning tree are saved verbatim and no
relink pass is needed.  The keyframe database is rebuilt from the stored
descriptors on load (System.cc:104-110).

The file is the JAX package's, field for field: descriptor words are written
as uint32 and read back as int32 bit patterns, so either package loads the
other's map.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..mapstate.map_state import MapState

_DESC_FIELDS = frozenset({"kf_desc", "mp_desc"})


def save_map(path: str, state: MapState, cfg: SLAMConfig) -> None:
    """Write the full map + config snapshot to ``path`` (npz)."""
    arrays = {}
    for f in state._fields:
        a = getattr(state, f).detach().cpu().numpy()
        arrays[f] = a.view(np.uint32) if f in _DESC_FIELDS else a
    arrays["__config__"] = np.frombuffer(
        json.dumps(_cfg_to_dict(cfg)).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_map(path: str, device) -> Tuple[MapState, dict]:
    """Load a map onto ``device``; returns (MapState, config-dict snapshot)."""
    z = np.load(path)
    fields = {}
    for f in MapState._fields:
        if f not in z.files:
            # forward-compat: maps saved before a field existed get its
            # empty-map default (kf_Tcp: identity)
            if f == "kf_Tcp":
                K = z["kf_Tcw"].shape[0]
                fields[f] = torch.eye(4, dtype=torch.float32, device=device).expand(K, 4, 4).clone()
                continue
            raise KeyError(f"map file {path} missing field {f}")
        a = z[f]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        fields[f] = torch.from_numpy(np.array(a)).to(device)
    cfg_dict = json.loads(bytes(z["__config__"].tobytes()).decode()) if "__config__" in z else {}
    return MapState(**fields), cfg_dict


def _cfg_to_dict(cfg: SLAMConfig) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        sub = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(sub)
    return out
