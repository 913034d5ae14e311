"""Parity of the port's generic frontend ops with the JAX package's, on the
CPU, on seeded numpy inputs.

* ``build_canvas``, ``extract_patches`` and ``extract_rect`` are exact, with
  centres inside, on and past every edge: both follow ``lax.dynamic_slice``,
  whose negative start counts from the far edge before every start is
  clamped into the canvas.
* ``resize_bilinear_matmul`` agrees within one bf16 ulp, on f32 and on bf16
  images (sums in another order; each product rounded once).
* ``fast_score_dispatch`` and ``fast_score_nms_dispatch`` equal the JAX
  dispatchers' CPU path on the whole image, borders included: both are the
  roll formulation (on CUDA the port launches K1, bit-equal to it).
* ``blur_patches`` within 1e-5 of the patches' range; ``hamming_pairs``
  exact on words with the high bit set.
* The BRIEF template override: set from one reference-format file in both
  packages, the template, the rotated LUT, the sampling matrix and the
  descriptors of the same patches are equal; cleared, the seeded template
  and its matrix are back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu.ops import brief as jbrief
from orb_slam2_ros2_tpu.ops import canvas as jcanvas
from orb_slam2_ros2_tpu.ops import fast as jfast
from orb_slam2_ros2_tpu.ops import hamming as jham
from orb_slam2_ros2_tpu.ops import pyramid as jpyr
from orb_slam2_ros2_tpu.ops import stereo as jstereo
from orb_slam2_ros2_tpu_torch.ops import brief as tbrief
from orb_slam2_ros2_tpu_torch.ops import canvas as tcanvas
from orb_slam2_ros2_tpu_torch.ops import fast as tfast
from orb_slam2_ros2_tpu_torch.ops import hamming as tham
from orb_slam2_ros2_tpu_torch.ops import pyramid as tpyr
from orb_slam2_ros2_tpu_torch.ops import stereo as tstereo


def bf16_pair(a: np.ndarray):
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def edge_centres(h: int, w: int, n: int, seed: int) -> np.ndarray:
    """Corners, edges, just past every edge and far outside, plus random
    centres inside."""
    r = np.random.default_rng(seed)
    fixed = [(0, 0), (h - 1, w - 1), (0, w - 1), (h - 1, 0), (-3, 5), (5, -3), (h + 2, w // 2),
             (h // 2, w + 2), (-40, -40), (h + 40, w + 40), (1, 1), (h - 2, w - 2)]
    rand = np.stack([r.integers(0, h, n), r.integers(0, w, n)], 1)
    return np.concatenate([np.array(fixed), rand]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_build_canvas_exact(dtype):
    r = np.random.default_rng(0)
    shapes = jpyr.level_shapes(96, 160, 8, 1.2)
    lv = [r.uniform(0, 255, s).astype(np.float32) for s in shapes]
    _, total, _ = jcanvas.canvas_layout(96, 160, 8, 1.2)
    if dtype == "bf16":
        pairs = [bf16_pair(a) for a in lv]
        jl, tl = [p[0] for p in pairs], [p[1] for p in pairs]
    else:
        jl, tl = [jnp.asarray(a) for a in lv], [torch.from_numpy(a) for a in lv]
    want = jcanvas.build_canvas(jl, 256, total + 40)
    got = tcanvas.build_canvas(tl, 256, total + 40)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("half", [1, 3, 7])
def test_extract_patches_exact(half):
    canvas = np.random.default_rng(1).uniform(0, 255, (40, 70)).astype(np.float32)
    c = edge_centres(40, 70, 64, half)
    want = np.asarray(jcanvas.extract_patches(jnp.asarray(canvas), jnp.asarray(c), half))
    got = tcanvas.extract_patches(torch.from_numpy(canvas), torch.from_numpy(c), half).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hy,hx", [(5, 5), (2, 9), (0, 4)])
def test_extract_rect_exact(hy, hx):
    canvas = np.random.default_rng(2).uniform(0, 255, (33, 61)).astype(np.float32)
    c = edge_centres(33, 61, 64, hy * 10 + hx)
    want = np.asarray(jstereo.extract_rect(jnp.asarray(canvas), jnp.asarray(c), hy, hx))
    got = tstereo.extract_rect(torch.from_numpy(canvas), torch.from_numpy(c), hy, hx).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,out", [((2, 96, 160), (80, 133)), ((77, 130), (40, 200))])
def test_resize_bilinear_matmul_within_one_bf16_ulp(dtype, shape, out):
    img = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    if dtype == "bf16":
        ji, ti = bf16_pair(img)
    else:
        ji, ti = jnp.asarray(img), torch.from_numpy(img)
    want = f32(jpyr.resize_bilinear_matmul(ji, *out))
    got_t = tpyr.resize_bilinear_matmul(ti, *out)
    assert got_t.dtype == ti.dtype
    got = f32(got_t)
    mag = np.maximum(np.abs(want), np.abs(got))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("shape", [(2, 96, 200), (77, 130), (1, 19, 33)])
def test_fast_dispatchers_equal_jax_cpu_path(shape):
    """Whole maps, borders included, with a flat block for ties."""
    r = np.random.default_rng(sum(shape))
    a = r.uniform(0, 255, shape).astype(np.float32)
    a[..., 5:15, 5:25] = 100.0
    ja, ta = bf16_pair(a)
    for jfn, tfn in ((jfast.fast_score_dispatch, tfast.fast_score_dispatch),
                     (jfast.fast_score_nms_dispatch, tfast.fast_score_nms_dispatch)):
        want = f32(jfn(ja, 7.0))
        got = tfn(ta, 7.0)
        assert got.shape == ta.shape and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(got), want)


def test_blur_patches():
    p = np.random.default_rng(4).uniform(0, 255, (17, 48, 64)).astype(np.float32)
    want = np.asarray(jbrief.blur_patches(jnp.asarray(p)))
    got = tbrief.blur_patches(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * 255)
    assert tbrief.PATCH_HALF == jbrief.PATCH_HALF and tbrief.BLUR_PAD == jbrief.BLUR_PAD
    assert tfast.ARC_LEN == jfast.ARC_LEN


def test_hamming_pairs_exact():
    r = np.random.default_rng(5)
    a = r.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    a[0], b[0] = 0xFFFFFFFF, 0          # every bit differs, sign bits included
    a[1], b[1] = 0x80000000, 0x7FFFFFFF
    a[2] = b[2]
    want = np.asarray(jham.hamming_pairs(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_pairs(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == 256 and want[1] == 256 and want[2] == 0
    np.testing.assert_array_equal(tham.hamming_pairs(torch.from_numpy(a.view(np.int32)).reshape(3, 100, 8),
                                                     torch.from_numpy(b.view(np.int32)).reshape(3, 100, 8)).numpy(),
                                  want.reshape(3, 100))


def test_template_override_set_use_clear(tmp_path):
    seeded = tbrief.brief_template(17).copy()
    seeded_matrix = tbrief._pair_difference_matrix(17).copy()
    r = np.random.default_rng(6)
    tpl = r.integers(-13, 14, (256, 4))
    path = tmp_path / "brief_template.txt"
    path.write_text("x1 y1 x2 y2\n" + "\n".join(" ".join(map(str, row)) for row in tpl) + "\n")
    p = r.uniform(0, 255, (64, 48, 64)).astype(np.float32)
    ang = r.uniform(-np.pi, np.pi, 64).astype(np.float32)
    try:
        jbrief.set_template_file(str(path))
        tbrief.set_template_file(str(path))
        np.testing.assert_array_equal(tbrief.brief_template(17), tpl)
        np.testing.assert_array_equal(tbrief.brief_template(17), jbrief.brief_template(17))
        np.testing.assert_array_equal(tbrief.rotated_offset_lut(17), jbrief.rotated_offset_lut(17))
        np.testing.assert_array_equal(tbrief._pair_difference_matrix(17), jbrief._pair_difference_matrix(17))
        d_j = np.asarray(jbrief.describe(jnp.asarray(p), jnp.asarray(ang)))
        d_t = tbrief.describe(torch.from_numpy(p), torch.from_numpy(ang), tbrief.pair_matrix("cpu"))
        np.testing.assert_array_equal(d_t.numpy().view(np.uint32), d_j)
    finally:
        jbrief.clear_template_override()
        tbrief.clear_template_override()
    np.testing.assert_array_equal(tbrief.brief_template(17), seeded)
    np.testing.assert_array_equal(tbrief.brief_template(17), jbrief.brief_template(17))
    np.testing.assert_array_equal(tbrief._pair_difference_matrix(17), seeded_matrix)
