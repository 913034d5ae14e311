"""Plain-text map interop with the reference (port of
``orb_slam2_ros2_tpu/io/txt_map.py``; the files are the JAX package's, byte
for byte).

The reference can persist its map as two text streams in a directory —
``KeyFrames.txt`` + ``MapPoints.txt`` (reference: src/Map.cc:82-162; writers
``operator<<`` at KeyFrame.cc:400-535 and MapPoint.cc:538-556; readers
``readFromStream`` at KeyFrame.cc:231-391 and MapPoint.cc:567-600).  This
module reads/writes that exact line format, converting through the same
``MapData`` message the protobuf path uses (proto_map.state_to_msg /
msg_to_state), so both reference formats share one relink/assembly path.

Line layout per keyframe (KeyFrame.cc:459-535; one header line first):
  header (once):  next_id scale0 scale1 ...
  1: id maxU maxV minU minV
  2: (x y octave angle rightU depth) x N
  3: (32 descriptor bytes as ints) x N
  4: (word_id weight) pairs            — BoW vector
  5: (node_id count feat_ids...) pairs — DBoW3 feature vector
  6: Rcw row-major 9 floats + tcw 3 floats
  7: (kf_id weight) covisibility pairs
  8: children kf ids
  9: loop-edge kf ids
 10: per-keypoint map-point ids (-1 = none)

Per map point (MapPoint.cc:538-556):
  1: id maxDist minDist refKfId refFeatId matchesInTrack inliersInTrack
  2: x y z viewDirX viewDirY viewDirZ
  3: 32 descriptor bytes as ints
"""

from __future__ import annotations

import os

import numpy as np

from ..config import SLAMConfig
from ..mapstate.map_state import MapState
from .proto_map import msg_to_state, state_to_msg


def _fmt(values) -> str:
    out = []
    for v in values:
        if isinstance(v, (int, np.integer)):
            out.append(str(int(v)))
        else:
            out.append(f"{float(v):g}")
    return " ".join(out)


def save_txt_map(dir_path: str, state: MapState, cfg: SLAMConfig, vocab=None) -> None:
    """Write KeyFrames.txt + MapPoints.txt in the reference's stream format
    (Map::saveToTxtFile, Map.cc:82-108)."""
    msg = state_to_msg(state, cfg, vocab)
    os.makedirs(dir_path, exist_ok=True)

    with open(os.path.join(dir_path, "KeyFrames.txt"), "w") as f:
        header = [int(msg.keyframes.next_id)] + list(msg.keyframes.scale_factors)
        f.write(_fmt(header) + "\n")
        for kf in msg.keyframes.keyframes:
            f.write(_fmt([int(kf.id), kf.max_u, kf.max_v, kf.min_u, kf.min_v]) + "\n")
            kp_line = []
            for j, kp in enumerate(kf.keypoints):
                kp_line += [kp.x, kp.y, int(kp.octave), kp.angle,
                            kf.right_u[j], kf.depths[j]]
            f.write(_fmt(kp_line) + "\n")
            desc_line = []
            for d in kf.descriptors:
                desc_line += list(np.frombuffer(d.data, np.uint8)[:32])
            f.write(_fmt(desc_line) + "\n")
            bow_line = []
            for w in sorted(kf.bow_vector.words):
                bow_line += [int(w), kf.bow_vector.words[w]]
            f.write(_fmt(bow_line) + "\n")
            fv_line = []
            for node in kf.feature_vector.nodes:
                fv_line += [int(node.node_id), len(node.feature_ids),
                            *[int(i) for i in node.feature_ids]]
            f.write(_fmt(fv_line) + "\n")
            f.write(_fmt(list(kf.pose.rotation) + list(kf.pose.translation)) + "\n")
            conn_line = []
            for e in kf.connected_kfs:
                conn_line += [int(e.id), int(e.weight)]
            f.write(_fmt(conn_line) + "\n")
            f.write(_fmt([int(c) for c in kf.children_ids]) + "\n")
            f.write(_fmt([int(le) for le in kf.loop_edges]) + "\n")
            f.write(_fmt([int(m) for m in kf.map_points]) + "\n")

    with open(os.path.join(dir_path, "MapPoints.txt"), "w") as f:
        for mp in msg.mappoints.mappoints:
            f.write(_fmt([int(mp.id), mp.max_distance, mp.min_distance,
                          int(mp.ref_kf_id), int(mp.ref_feat_id),
                          int(mp.matches_in_track), int(mp.inliers_in_track)]) + "\n")
            f.write(_fmt([mp.position.x, mp.position.y, mp.position.z,
                          mp.view_direction.x, mp.view_direction.y,
                          mp.view_direction.z]) + "\n")
            f.write(_fmt(list(np.frombuffer(mp.desc.data, np.uint8)[:32])) + "\n")


def load_txt_map(dir_path: str, cfg: SLAMConfig, device) -> MapState:
    """Parse a reference txt map directory into a MapState on ``device``
    (Map::loadFromTxtFile, Map.cc:116-162)."""
    from ..proto import MapData

    msg = MapData()

    with open(os.path.join(dir_path, "KeyFrames.txt")) as f:
        lines = [ln.rstrip("\n") for ln in f]
    if not lines or not lines[0].strip():
        # a zero-keyframe map saved by the reference is an empty file (the
        # header is written inside the first keyframe's operator<<,
        # KeyFrame.cc:459-469) — valid there, so valid here: empty map
        return msg_to_state(msg, cfg, device)
    header = lines[0].split()
    msg.keyframes.next_id = int(float(header[0]))
    msg.keyframes.scale_factors.extend(float(s) for s in header[1:])
    i = 1
    while i < len(lines):
        if not lines[i].strip():  # trailing blank line(s)
            i += 1
            continue
        if i + 10 > len(lines):
            raise ValueError(f"truncated keyframe record at line {i + 1}")
        kf = msg.keyframes.keyframes.add()
        base = lines[i].split()
        kf.id = int(float(base[0]))
        kf.max_u, kf.max_v, kf.min_u, kf.min_v = (float(x) for x in base[1:5])
        kp_tok = lines[i + 1].split()
        for j in range(0, len(kp_tok) - 5, 6):
            kp = kf.keypoints.add()
            kp.x, kp.y = float(kp_tok[j]), float(kp_tok[j + 1])
            kp.octave = int(float(kp_tok[j + 2]))
            kp.angle = float(kp_tok[j + 3])
            kf.right_u.append(float(kp_tok[j + 4]))
            kf.depths.append(float(kp_tok[j + 5]))
        d_tok = lines[i + 2].split()
        for j in range(0, len(d_tok) - 31, 32):
            kf.descriptors.add().data = bytes(
                np.array([int(v) for v in d_tok[j:j + 32]], np.uint8))
        b_tok = lines[i + 3].split()
        for j in range(0, len(b_tok) - 1, 2):
            kf.bow_vector.words[int(b_tok[j])] = float(b_tok[j + 1])
        fv_tok = lines[i + 4].split()
        j = 0
        while j + 1 < len(fv_tok):
            node = kf.feature_vector.nodes.add()
            node.node_id = int(fv_tok[j])
            n = int(fv_tok[j + 1])
            if n < 0:  # corrupt count would otherwise stall the parse loop
                raise ValueError(
                    f"corrupt feature-vector count {n} in KeyFrames.txt line {i + 5}"
                )
            node.feature_ids.extend(int(v) for v in fv_tok[j + 2:j + 2 + n])
            j += 2 + n
        p_tok = [float(x) for x in lines[i + 5].split()]
        kf.pose.rotation.extend(p_tok[:9])
        kf.pose.translation.extend(p_tok[9:12])
        c_tok = lines[i + 6].split()
        for j in range(0, len(c_tok) - 1, 2):
            e = kf.connected_kfs.add()
            e.id, e.weight = int(c_tok[j]), int(c_tok[j + 1])
        kf.children_ids.extend(int(v) for v in lines[i + 7].split())
        kf.loop_edges.extend(int(v) for v in lines[i + 8].split())
        kf.map_points.extend(int(v) for v in lines[i + 9].split())
        i += 10

    with open(os.path.join(dir_path, "MapPoints.txt")) as f:
        mp_lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    for i in range(0, len(mp_lines) - 2, 3):
        base = mp_lines[i].split()
        mp = msg.mappoints.mappoints.add()
        mp.id = int(float(base[0]))
        mp.max_distance, mp.min_distance = float(base[1]), float(base[2])
        mp.ref_kf_id, mp.ref_feat_id = int(float(base[3])), int(float(base[4]))
        mp.matches_in_track = int(float(base[5]))
        mp.inliers_in_track = int(float(base[6]))
        pv = [float(x) for x in mp_lines[i + 1].split()]
        mp.position.x, mp.position.y, mp.position.z = pv[0:3]
        mp.view_direction.x, mp.view_direction.y, mp.view_direction.z = pv[3:6]
        mp.desc.data = bytes(
            np.array([int(v) for v in mp_lines[i + 2].split()[:32]], np.uint8))

    return msg_to_state(msg, cfg, device)
