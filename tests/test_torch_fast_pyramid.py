"""The pyramid-wide FAST+NMS call of the PyTorch port, on the CPU.

``fast_score_nms_pyramid`` scores every level of every image of a
row-stacked canvas in one call (one kernel launch on the card).  On the CPU
it runs the plain version level by level, so these tests hold it to the JAX
package on the same numpy inputs, check on the host the level table through
which the kernel maps its flat grid of tiles onto the canvas, and check that
the extractor calls it once a frame.  The kernel itself is compared with the
plain version by the ``gpu`` test at the end (skipped without a card) and by
``chip_smoke.py``.

Tolerances: FAST, NMS and the table are exact.
"""

import inspect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_frontend import bf16_pair, f32, small_cfg
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu.ops import fast as jfast
from orb_slam2_ros2_tpu.ops.pallas_fast import fast_score_pallas
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu_torch.features import extractor as text
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.ops import fast as tfast
from orb_slam2_ros2_tpu_torch.ops.canvas import canvas_layout, padded_canvas_shape
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TH = 7.0


def pyramid_canvas(h, w, n_levels, batch, seed):
    """Random bf16 levels laid out as the extractor lays them out, each with
    a flat block on its last columns (ring wrap at the level's right edge)
    and a flat block inside (score ties, NMS plateaus).  Returns the JAX
    levels, the torch canvas and its table."""
    rng = np.random.default_rng(seed)
    row_off, _, shapes = canvas_layout(h, w, n_levels, 1.2)
    rows_p, cols_p = padded_canvas_shape(h, w, n_levels, 1.2)
    canvas = torch.zeros((batch * rows_p, cols_p), dtype=torch.bfloat16)
    jlevels = []
    for off, (hl, wl) in zip(row_off.tolist(), shapes):
        a = rng.uniform(0, 255, (batch, hl, wl)).astype(np.float32)
        a[:, hl // 3: hl // 3 + 9, wl - 7:] = 140.0
        a[:, 4:12, 5:20] = 100.0
        ja, ta = bf16_pair(a)
        jlevels.append(ja)
        for b in range(batch):
            canvas[b * rows_p + off: b * rows_p + off + hl, :wl] = ta[b]
    table = tfast.pyramid_table(tuple(row_off.tolist()), tuple(shapes), batch, rows_p, cols_p)
    return jlevels, canvas, table


@pytest.mark.parametrize("nms", [True, False])
def test_pyramid_matches_jax(nms):
    """One call over a 2-image, 4-level canvas equals JAX ``nms3(fast_score)``
    on every pixel of every level, and the Pallas kernel in the interior."""
    jlevels, canvas, table = pyramid_canvas(96, 160, 4, 2, seed=0)
    maps = tfast.fast_score_nms_pyramid(canvas, table, TH, nms=nms)
    assert [tuple(m.shape) for m in maps] == [(2, hl, wl) for hl, wl in table.level_shapes]
    for ja, got in zip(jlevels, maps):
        ref = jfast.fast_score(ja, TH)
        ref = f32(jfast.nms3(ref) if nms else ref)
        got = f32(got)
        np.testing.assert_array_equal(got, ref)
        pal = f32(fast_score_pallas(ja, TH, interpret=True, nms=nms))
        np.testing.assert_array_equal(got[:, 5:-5, 5:-5], pal[:, 5:-5, 5:-5])


def test_pyramid_out_and_one_level_call():
    """Scores written into a caller's buffer are views of it, level by
    level; ``fast_score_nms`` of one [B, H, W] level is the same function."""
    jlevels, canvas, table = pyramid_canvas(60, 100, 3, 2, seed=1)
    out = torch.full((table.out_numel,), -1.0, dtype=torch.bfloat16)
    maps = tfast.fast_score_nms_pyramid(canvas, table, TH, out=out)
    for o, m, (hl, wl) in zip(table.level_out, maps, table.level_shapes):
        assert m.data_ptr() == out[o:].data_ptr()
    assert not (out == -1.0).any()
    for ja, m in zip(jlevels, maps):
        level = torch.from_numpy(f32(ja).copy()).to(torch.bfloat16)
        assert torch.equal(tfast.fast_score_nms(level, TH), m)


def _tile_cover(table):
    """Mirror of the kernel's mapping (csrc/fast_nms.cu locate): tile id →
    (entry, tile row, tile column) through the prefix of tile counts, each
    tile writing the [TILE_H, TILE_W] block at its origin, clipped to its
    map.  Returns, per entry, how often each pixel is written."""
    segs = table.segs
    cover = [np.zeros((h, w), np.int32) for _, h, w, *_ in segs]
    for tid in range(table.n_tiles):
        s = 0
        while s + 1 < len(segs) and segs[s + 1, 4] <= tid:
            s += 1
        _, h, w, tiles_x, start, _ = segs[s]
        ty, tx = divmod(tid - start, tiles_x)
        y0, x0 = ty * tfast.TILE_H, tx * tfast.TILE_W
        assert y0 < h and x0 < w, "a tile with no pixel of its map"
        cover[s][y0:y0 + tfast.TILE_H, x0:x0 + tfast.TILE_W] += 1
    return cover


@pytest.mark.parametrize("case", ["kitti", "small", "one_level_odd", "tiny_levels"])
def test_level_table_covers_every_pixel_once(case):
    """The table of each layout: every pixel of every (image, level) is
    written by exactly one tile, no tile lies wholly outside its map, the
    maps sit inside the canvas without overlapping, and the output offsets
    tile the flat buffer."""
    if case == "kitti":
        _, _, table = pyramid_canvas(376, 1241, 8, 2, seed=2)
    elif case == "small":
        _, _, table = pyramid_canvas(96, 160, 4, 2, seed=3)
    elif case == "one_level_odd":
        table = tfast.pyramid_table((0,), ((77, 131),), 3, 77, 131)
    else:
        _, _, table = pyramid_canvas(40, 70, 5, 1, seed=4)
    for c in _tile_cover(table):
        assert (c == 1).all()
    rows, cols = table.canvas_shape
    used = np.zeros(rows, np.int32)
    offsets = []
    for row_base, h, w, tiles_x, _, out_off in table.segs:
        assert tiles_x == -(-w // tfast.TILE_W) and w <= cols and row_base + h <= rows
        used[row_base:row_base + h] += 1
        offsets.append((out_off, h * w))
    assert used.max() == 1
    offsets.sort()
    assert offsets[0][0] == 0
    for (o, n), (o2, _) in zip(offsets, offsets[1:]):
        assert o + n == o2
    assert offsets[-1][0] + offsets[-1][1] == table.out_numel
    c = table.cstruct
    assert c.n_segs == len(table.segs) and c.tile_start[c.n_segs] == table.n_tiles
    for j, field in enumerate(("row_base", "h", "w", "tiles_x", "tile_start", "out_off")):
        assert list(getattr(c, field)[:c.n_segs]) == table.segs[:, j].tolist()


def test_table_constants_match_the_kernel():
    """The tile size and table capacity the host assumes are the kernel's."""
    src = open(os.path.join(REPO, "orb_slam2_ros2_tpu_torch", "csrc", "fast_nms.cu")).read()
    const = {k: int(v) for k, v in re.findall(r"\b(OUT_W|OUT_H|MAX_SEGS) = (\d+)", src)}
    assert const == {"OUT_W": tfast.TILE_W, "OUT_H": tfast.TILE_H, "MAX_SEGS": tfast.MAX_SEGS}
    fields = re.search(r"struct LevelTable \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"int (\w+)(?:\[|;)", fields)
    assert names == [f for f, _ in tfast._LevelTable._fields_]


def test_pyramid_table_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        tfast.pyramid_table((0,), ((10, 10),), tfast.MAX_SEGS + 1, 10, 10)
    with pytest.raises(ValueError):
        tfast.pyramid_table((0, 8), ((10, 10), (5, 5)), 1, 12, 10)
    _, canvas, table = pyramid_canvas(60, 100, 3, 2, seed=5)
    with pytest.raises(ValueError):
        tfast.fast_score_nms_pyramid(canvas[:-1], table, TH)
    with pytest.raises(ValueError):
        tfast.fast_score_nms_pyramid(canvas.to("meta"), table, TH)


def test_extractor_scores_the_canvas_once_a_frame(monkeypatch):
    """A stereo frame makes one pyramid-wide FAST call over the canvas, with
    the table its frontend built once."""
    calls = []
    real = tfast.fast_score_nms_pyramid

    def counted(canvas, table, threshold, nms=True, out=None):
        calls.append((tuple(canvas.shape), table))
        return real(canvas, table, threshold, nms, out)

    monkeypatch.setattr(tfast, "fast_score_nms_pyramid", counted)
    cfg = small_cfg(tcfg)
    fe = text.make_stereo_frontend(cfg, "cpu")
    r = np.random.default_rng(6)
    img = torch.from_numpy(r.uniform(0, 255, (cfg.camera.height, cfg.camera.width)).astype(np.float32))
    fe(img, img.roll(3, 1), TCam.from_config(cfg.camera, "cpu"))
    assert len(calls) == 1
    assert calls[0][1] is fe.consts.fast_table
    assert calls[0][0] == fe.consts.fast_table.canvas_shape


def test_entry_points_default_to_the_card():
    """``SLAM``, ``SyntheticStereoDataset`` and ``make_stereo_frontend`` run
    on the CUDA device unless the caller names another."""
    for fn in (SLAM.__init__, SyntheticStereoDataset.__init__, text.make_stereo_frontend):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode (run python3 chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nms", [True, False])
def test_pyramid_kernel_equals_plain_on_gpu(cuda_device, nms):
    """One launch over both KITTI pyramids equals the plain version of each
    level, bit for bit."""
    jlevels, canvas, table = pyramid_canvas(376, 1241, 8, 2, seed=7)
    maps = tfast.fast_score_nms_pyramid(canvas.to(cuda_device), table, TH, nms=nms)
    torch.cuda.synchronize()
    for ja, got in zip(jlevels, maps):
        x = torch.from_numpy(f32(ja).copy()).to(torch.bfloat16).to(cuda_device)
        ref = tfast.fast_score(x, TH)
        assert torch.equal(got, tfast.nms3(ref) if nms else ref)
