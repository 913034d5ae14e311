"""The port's device mesh (``parallel/mesh.py``) on the CPU: the
counterparts of ``tests/test_mesh.py`` — ``init_distributed`` does nothing
without its variables, one device makes no mesh, the shapes and the point
padding — and the collectives: ``psum`` equals the plain sum of the shards
in slot order and repeats bit for bit, ``all_gather`` equals the
concatenation, ``split`` inverts it."""

import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu.parallel.mesh import ba_mesh as jax_ba_mesh
from orb_slam2_ros2_tpu.parallel.mesh import pad_points_for_mesh as jax_pad
from orb_slam2_ros2_tpu_torch.parallel import mesh as tmesh


def test_init_distributed_noop_without_config(monkeypatch):
    """A single-process run starts no process group."""
    for var in ("SLAM_COORDINATOR", "SLAM_NUM_PROCESSES", "SLAM_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_distributed() == 0
    assert not torch.distributed.is_initialized()


def test_init_distributed_needs_every_variable(monkeypatch):
    monkeypatch.setenv("SLAM_COORDINATOR", "localhost:1")
    monkeypatch.delenv("SLAM_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("SLAM_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="SLAM_NUM_PROCESSES"):
        tmesh.init_distributed()


@pytest.mark.parametrize("n", [2, 8])
def test_ba_mesh_shapes(n):
    assert tmesh.ba_mesh(1, devices=["cpu"]) is None and jax_ba_mesh(1) is None
    m = tmesh.ba_mesh(n, devices=["cpu"] * 8)
    assert m.shape["ba"] == jax_ba_mesh(n).shape["ba"] == n
    assert m.local == list(range(n)) and m.device == torch.device("cpu")
    assert not m.multi_process
    # fewer slots than asked: a smaller mesh, as JAX's devs[:n]
    assert tmesh.ba_mesh(n, devices=["cpu"] * (n - 1)).size == n - 1
    assert tmesh.device_count(["cpu"] * n) == n


@pytest.mark.parametrize("points", [1000, 1001, 7, 8])
def test_pad_points_for_mesh(points):
    assert tmesh.pad_points_for_mesh(points, 8) == jax_pad(points, 8)
    assert tmesh.pad_points_for_mesh(1001, 8) == 1008


@pytest.mark.parametrize("n", [2, 8])
def test_psum_and_all_gather_against_plain(n):
    m = tmesh.ba_mesh(n, devices=["cpu"] * n)
    r = np.random.default_rng(n)
    xs = [torch.from_numpy(r.normal(size=(6, 5)).astype(np.float32)) for _ in range(n)]
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    assert torch.equal(m.psum(xs), total)
    # a repeated psum is bit-equal to the first
    assert torch.equal(m.psum(xs), m.psum(list(xs)))
    assert torch.equal(m.all_gather(xs), torch.cat(xs, dim=-1))
    assert torch.equal(m.all_gather(xs, dim=0), torch.cat(xs, dim=0))
    full = torch.cat(xs, dim=-1)
    assert all(torch.equal(a, b) for a, b in zip(m.split(full), xs))
    assert all(b is full for b in m.broadcast(full))
