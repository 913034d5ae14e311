"""Parity of the port's one-image extractor (``make_extractor`` /
``extract_features``) with the JAX package's, on the CPU, at 320×192 with
600 features (768 keypoint slots), with and without lens distortion.

The same JAX-rendered image goes through both.  Keypoints (``uv_raw``),
octaves, responses and validity are exact; ``uv`` (undistorted when the
camera has distortion) within f32 rounding; descriptor bits agree within the
1e-3 budget of the stereo frontend (a blurred comparison within rounding of
zero may flip); patches exact on the keypoints both kept.  On the CPU the
kernel wrappers run their plain twins (the ``gpu`` test of
``test_torch_frontend.py`` and ``chip_smoke.py`` hold the kernels to them).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu import features as jfeatures
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu_torch import features as tfeatures
from orb_slam2_ros2_tpu_torch.features import extractor as text
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.ops import fast as tfast
from orb_slam2_ros2_tpu_torch.ops import patches as tpatches

BRIEF_BIT_BUDGET = 1e-3
DIST = dict(k1=-0.12, k2=0.03, p1=5e-4, p2=-3e-4, k3=0.0)


def cfg_of(mod, distorted: bool):
    cam = dict(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192)
    if distorted:
        cam.update(DIST)
    return mod.SLAMConfig(camera=mod.CameraConfig(**cam), orb=mod.ORBConfig(n_features=600, max_keypoints=768))


@pytest.fixture(scope="module")
def image():
    ds = JDataset(cfg_of(jcfg, False).camera, n_frames=3, speed=0.35)
    return np.array(ds.frame(2)[0])


@pytest.fixture(scope="module", params=[False, True], ids=["pinhole", "distorted"])
def both(request, image):
    jc, tc = cfg_of(jcfg, request.param), cfg_of(tcfg, request.param)
    assert tc.camera.has_distortion == request.param
    jf, jp = jfeatures.make_extractor(jc)(jax.numpy.asarray(image), JCam.from_config(jc.camera))
    ext = tfeatures.make_extractor(tc, "cpu")
    launches = (tfast.fast_nms_launches, tpatches.patch_launches)
    tf, tp = ext(torch.from_numpy(image), TCam.from_config(tc.camera, "cpu"))
    assert (tfast.fast_nms_launches, tpatches.patch_launches) == launches  # no kernel on the CPU
    return jax.tree.map(np.asarray, jf), np.asarray(jp), tf, tp


def test_keypoints_exact(both):
    jf, _, tf, _ = both
    assert tf.uv_raw.shape == jf.uv_raw.shape == (768, 2)
    np.testing.assert_array_equal(tf.valid.numpy(), jf.valid)
    assert jf.valid.sum() > 300
    np.testing.assert_array_equal(tf.uv_raw.numpy(), jf.uv_raw)
    np.testing.assert_array_equal(tf.octave.numpy(), jf.octave)
    np.testing.assert_array_equal(tf.response.numpy(), jf.response)
    np.testing.assert_allclose(tf.uv.numpy(), jf.uv, rtol=1e-6, atol=1e-4)


def test_descriptors_and_patches(both):
    jf, jp, tf, tp = both
    v = jf.valid
    np.testing.assert_array_equal(tp.numpy()[v], jp[v])
    np.testing.assert_allclose(tf.angle.numpy()[v], jf.angle[v], atol=1e-3)
    diff = np.unpackbits((tf.desc.numpy().view(np.uint32)[v] ^ jf.desc[v]).view(np.uint8)).sum()
    assert diff / (v.sum() * 256) <= BRIEF_BIT_BUDGET


def test_extract_features_is_one_image_of_the_batch(image):
    """``extract_features`` on one image equals its row of the two-image
    batch (the stereo frontend's constants), bit for bit."""
    cfg = cfg_of(tcfg, False)
    cam = TCam.from_config(cfg.camera, "cpu")
    kw = text._extract_kw(cfg)
    img = torch.from_numpy(image)
    one, p1 = text.extract_features(img, cam, text.frontend_constants(cfg, "cpu", n_images=1), **kw)
    two, p2 = text.extract_features_batch(torch.stack([img, img.flip(1)]), cam,
                                          text.frontend_constants(cfg, "cpu"), **kw)
    for name, a, b in zip(one._fields, one, two):
        assert torch.equal(a, b[0]), name
    assert torch.equal(p1, p2[0])
    with pytest.raises(ValueError):
        text.extract_features_batch(img[None], cam, text.frontend_constants(cfg, "cpu"), **kw)


def test_rgbd_frontend_unchanged_by_the_shared_path(image):
    """The RGB-D frontend now goes through ``extract_features``: its
    features equal the one-image extractor's."""
    cfg = cfg_of(tcfg, False)
    cam = TCam.from_config(cfg.camera, "cpu")
    img = torch.from_numpy(image)
    f_ext, _ = text.make_extractor(cfg, "cpu")(img, cam)
    sf = text.make_rgbd_frontend(cfg, "cpu")(img, torch.full_like(img, 5000.0), cam)
    for name, a, b in zip(f_ext._fields, f_ext, sf.feats):
        assert torch.equal(a, b), name
