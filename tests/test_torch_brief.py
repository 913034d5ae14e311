"""K3, the BRIEF kernel (``orb_slam2_ros2_tpu_torch/csrc/brief.cu``), and its
tables.

K3 scores only the angle bin each keypoint uses, from the nonzero taps of
each column of the folded-blur matrix D, summed in f32 in ascending row
order.  On the CPU: its tables read as taps, scattered back, are
``pair_matrix``'s bf16-rounded D (seeded and file templates), and a torch
emulation of its arithmetic gives ``describe_plain``'s descriptors.  On the
card (``gpu``, skipped without one): K3 equals that emulation bit for bit,
eagerly and replayed from a CUDA graph.

Tolerances: the tables are exact.  The emulation sums in another order than
the dense product, so a bit can differ only where the score lies within f32
rounding of zero: none on random bf16 patches, and on 8-bit patches with flat
areas (exact ties) only bits whose dense score is within 1e-4 of zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam2_ros2_tpu_torch.config import SLAMConfig
from orb_slam2_ros2_tpu_torch.features import extractor as text
from orb_slam2_ros2_tpu_torch.ops import brief

N_COLS = brief.N_ANGLE_BINS * brief.N_PAIRS
N_TAPS = brief.K3_SEGMENTS * brief.K3_TAPS


def k3_taps(k3: brief.K3Tables):
    """(rows int64 [8192, 98], weights f32 [8192, 98]): every column's taps
    in the order K3 sums them, read from its segment words and weight rows
    as K3 reads them (weight-0 taps included)."""
    u = k3.segs.cpu().numpy().astype(np.int64).transpose(0, 2, 1).reshape(N_COLS, brief.K3_SEGMENTS, 1)
    y, x, row = u & 63, (u >> 6) & 63, u >> 12
    halves = k3.weights.cpu().numpy().view(np.uint16).astype(np.uint32) << 16   # [rows, 8] little-endian
    wt = halves.view(np.float32)[row[..., 0], :brief.K3_TAPS]
    rows = y * brief.PATCH_COLS + x + np.arange(brief.K3_TAPS)
    return rows.reshape(N_COLS, N_TAPS), wt.reshape(N_COLS, N_TAPS)


def emulate_k3(patches: torch.Tensor, angles: torch.Tensor, rows, wts) -> torch.Tensor:
    """K3's arithmetic in torch on the patches' device: each bit the f32 sum
    of bf16(patch) × weight over its column's taps, one tap at a time in
    K3's order (each product is exact in f32), tested > 0."""
    n = patches.shape[0]
    dev = patches.device
    flat = patches.reshape(n, -1).to(torch.bfloat16).float()
    cols = (brief.angle_bins(angles).long()[:, None] * brief.N_PAIRS
            + torch.arange(brief.N_PAIRS, device=dev)[None, :])              # [N, 256]
    r, wt = torch.from_numpy(rows).to(dev)[cols], torch.from_numpy(wts).to(dev)[cols]  # [N, 256, 98]
    s = torch.zeros((n, brief.N_PAIRS), dtype=torch.float32, device=dev)
    for k in range(N_TAPS):
        s = s + torch.gather(flat, 1, r[:, :, k]) * wt[:, :, k]
    return brief.pack_bits(s > 0)


def dense_scores(patches, angles, D):
    n = patches.shape[0]
    scores = (patches.reshape(n, -1).to(torch.bfloat16).float() @ D).reshape(n, brief.N_ANGLE_BINS, -1)
    return scores[torch.arange(n), brief.angle_bins(angles).long()]


def differing_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool [N, 256]: where two int32 [N, 8] descriptors differ."""
    x = (a ^ b).long()[..., None] >> torch.arange(32)
    return (x & 1).bool().reshape(a.shape[0], -1)


def file_template(tmp_path):
    rng = np.random.default_rng(5)
    tpl = rng.integers(-brief.TEMPLATE_CLIP, brief.TEMPLATE_CLIP + 1, size=(brief.N_PAIRS, 4))
    tpl[:3] = [[0, 0, 0, 0], [4, -2, 4, -2], [1, 1, 2, 1]]   # coincident points, full and partial overlap
    path = tmp_path / "brief_template.txt"
    np.savetxt(path, tpl, fmt="%d", header="x1 y1 x2 y2")
    return str(path), tpl.astype(np.int32)


@pytest.mark.parametrize("template", ["seeded", "file"])
def test_k3_tables_are_the_pair_matrix(template, tmp_path):
    """K3's tables of the frontend's template, read as taps (zero weights
    dropped), hold each column's nonzero rows in strictly ascending order, at
    most 98, and scattered back they are the CPU frontend's D (pair_matrix's
    bf16-rounded matrix of the same template) bit for bit."""
    cfg, tpl = SLAMConfig(), None
    if template == "file":
        path, tpl = file_template(tmp_path)
        cfg = cfg.replace(orb=dataclasses.replace(cfg.orb, brief_template_path=path))
    D = text.frontend_constants(cfg, "cpu", n_images=1).brief.numpy()
    want = brief.pair_matrix("cpu", None if tpl is None else brief.pair_matrix_for_template(tpl)).numpy()
    assert np.array_equal(D.view(np.uint32), want.view(np.uint32))
    rows, wts = k3_taps(brief.k3_tables("cpu", tpl))
    nz = wts != 0
    assert nz.sum(1).max() <= 98
    r = np.where(nz, rows, -1)
    above = np.maximum.accumulate(r, axis=1)[:, :-1]   # each nonzero tap's row above every earlier one's
    assert np.all((r[:, 1:] == -1) | (r[:, 1:] > above))
    dense = np.zeros_like(D)
    cols = np.broadcast_to(np.arange(N_COLS)[:, None], rows.shape)
    dense[rows[nz], cols[nz]] = wts[nz]
    assert np.array_equal((dense + 0.0).view(np.uint32), (D + 0.0).view(np.uint32))
    assert (D != 0).sum(0).max() == nz.sum(1).max()


@pytest.mark.parametrize("values", ["bf16", "8-bit"])
def test_k3_emulation_equals_dense(values):
    """The emulation of K3's arithmetic against describe_plain (the dense
    product): bit for bit on random bf16 patches; on 8-bit patches with flat
    blocks, any bit that differs has a dense score within 1e-4 of zero."""
    rng = np.random.default_rng(11)
    n = 96
    if values == "bf16":
        p = rng.normal(100.0, 40.0, size=(n, brief.PATCH_ROWS, brief.PATCH_COLS))
    else:
        p = rng.integers(0, 256, size=(n, brief.PATCH_ROWS, brief.PATCH_COLS)).astype(np.float64)
        p[: n // 2, 5:30, 10:40] = 77.0          # flat blocks: exact ties between pairs inside them
        p[n // 4: n // 2] = np.round(p[n // 4: n // 2] / 64.0) * 64.0
    patches = torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16).float()
    angles = torch.from_numpy(rng.uniform(-np.pi, np.pi, n).astype(np.float32))
    D = brief.pair_matrix("cpu")
    got = emulate_k3(patches, angles, *k3_taps(brief.k3_tables("cpu")))
    want = brief.describe_plain(patches, angles, D)
    diff = differing_bits(got, want)
    if values == "bf16":
        assert not diff.any()
    else:
        assert (dense_scores(patches, angles, D)[diff].abs() < 1e-4).all()


def test_describe_on_cpu_is_the_plain_product():
    """On the CPU, operator is the dense D and describe the dense product;
    it launches nothing."""
    rng = np.random.default_rng(3)
    patches = torch.from_numpy(rng.uniform(0, 255, (8, brief.PATCH_ROWS, brief.PATCH_COLS)).astype(np.float32))
    angles = torch.from_numpy(rng.uniform(-np.pi, np.pi, 8).astype(np.float32))
    D, launches = brief.pair_matrix("cpu"), brief.brief_launches
    assert torch.equal(brief.operator("cpu"), D)
    assert torch.equal(brief.describe(patches, angles, brief.operator("cpu")),
                       brief.describe_plain(patches, angles, D))
    assert brief.brief_launches == launches


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode (run python3 chip_smoke.py on the card)")
    return torch.device("cuda")


def rendered_patches(dev, n_images: int = 2):
    """Patches and angles of the first rendered frame of the synthetic
    stereo world, as the stereo frontend gathers them on the card."""
    from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
    from orb_slam2_ros2_tpu_torch.tools._frames import Stages

    cfg = SLAMConfig()
    ds = SyntheticStereoDataset(cfg.camera, n_frames=1, device=dev)
    img_l, img_r = ds.frame(0)[:2]
    st = Stages(cfg, text.frontend_constants(cfg, dev, n_images))
    imgs = torch.stack([img_l, img_r][:n_images]).float()
    return st.orientations(imgs)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random-2048", "random-4096", "rendered-4096", "rendered-2048-file"])
def test_k3_equals_emulation_on_gpu(cuda_device, case, tmp_path):
    kind, n, *file_tpl = case.split("-")
    n = int(n)
    tpl = file_template(tmp_path)[1] if file_tpl else None
    k3 = brief.operator(cuda_device, tpl)
    if kind == "random":
        g = torch.Generator(device=cuda_device)
        g.manual_seed(n)
        patches = torch.rand((n, brief.PATCH_ROWS, brief.PATCH_COLS), generator=g, device=cuda_device) * 255
        patches[: n // 4, 10:30, 10:30] = 77.0
        angles = (torch.rand(n, generator=g, device=cuda_device) * 2 - 1) * np.pi
    else:
        patches, angles = rendered_patches(cuda_device, n // 2048)
    got = brief.describe(patches, angles, k3)
    torch.cuda.synchronize()
    want = emulate_k3(patches, angles, *k3_taps(k3))
    assert torch.equal(got, want), int(differing_bits(got.cpu(), want.cpu()).sum())


@pytest.mark.gpu
def test_k3_in_cuda_graph_on_gpu(cuda_device):
    """Captured and replayed, K3 gives the eager call's bits; the wrapper
    counts one launch an eager call and none under the capture."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(7)
    n = 4096
    k3 = brief.operator(cuda_device)
    patches = torch.rand((n, brief.PATCH_ROWS, brief.PATCH_COLS), generator=g, device=cuda_device) * 255
    angles = (torch.rand(n, generator=g, device=cuda_device) * 2 - 1) * np.pi
    before = brief.brief_launches
    eager = brief.describe(patches, angles, k3)
    assert brief.brief_launches == before + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        brief.describe(patches, angles, k3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = brief.describe(patches, angles, k3)
    assert brief.brief_launches == before + 2
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.equal(eager, emulate_k3(patches, angles, *k3_taps(k3)))
    new = torch.rand((n, brief.PATCH_ROWS, brief.PATCH_COLS), generator=g, device=cuda_device) * 255
    patches.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, brief.describe(new, angles, k3))
