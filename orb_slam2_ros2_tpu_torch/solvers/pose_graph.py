"""Sim(3) pose-graph optimization (the essential graph).

Port of ``orb_slam2_ros2_tpu/solvers/pose_graph.py`` (reference
Optimizer::optimizeEssentialGraph, src/Optimizer.cc:746-920): vertices are
the Sim3 poses of all keyframes (the loop keyframe fixed), edges carry the
relative-Sim3 measurement; 20 Gauss-Newton iterations.  The residual of an
edge is e = log(S_meas⁻¹ ∘ (exp(ξj) Sj) ∘ (exp(ξi) Si)⁻¹).

Its Jacobians at ξ = 0 are forward-mode derivatives: ``torch.func.jvp`` of
the residual batched over the edges, ``vmap``-ed over the 14 unit tangents
(the JAX version's ``jax.jacfwd`` per edge; per-edge ``torch.func.jacfwd``
fails — the tangent of ``sqrt(x + c)`` on a 0-d f32 tensor comes out f64).

Two normal-equation solvers behind ``optimize_pose_graph``, chosen by the
vertex count: a dense Cholesky of the (7K)² Hessian up to ``DENSE_MAX_K``
vertices, matrix-free block-Jacobi PCG above.  Where JAX scatter-adds the
per-edge blocks to their vertices, both sum through the edge-vertex
incidence matrix instead (dense H = Aᵀ W A; the PCG's sums are incidence
matrix products): a float ``index_add_`` sums in no fixed order on CUDA, and
the essential graph's rounding would then differ from run to run and
everything tracked after a loop closure with it.  Neither solver reads back
to the host.

With a device mesh (``parallel/mesh.py``) the PCG shards the edges: each
shard linearizes and sums its own, the mesh's ``psum`` joins them, and the
CG on the replicated vertex vectors runs once (JAX
``_gn_step_pcg_sharded``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import sim3

DENSE_MAX_K = 256
# the GN damping and the CG iterations of a solve (JAX optimize_pose_graph)
DAMPING, CG_ITERS = 1e-6, 150


class PoseGraphProblem(NamedTuple):
    S_cw: sim3.Sim3           # [K] current keyframe Sim3 poses (world → cam)
    kf_valid: torch.Tensor    # bool[K]
    kf_fixed: torch.Tensor    # bool[K] (loop KF / gauge anchors)
    edge_i: torch.Tensor      # i32[E]
    edge_j: torch.Tensor      # i32[E]
    edge_Sji: sim3.Sim3       # [E] measured relative pose S_j←i = S_j ∘ S_i⁻¹
    edge_valid: torch.Tensor  # bool[E]
    edge_weight: torch.Tensor  # f32[E]


def _take(S: sim3.Sim3, idx: torch.Tensor) -> sim3.Sim3:
    idx = idx.long()
    return sim3.Sim3(R=S.R[idx], t=S.t[idx], s=S.s[idx])


def make_relative_measurements(S_cw: sim3.Sim3, edge_i, edge_j) -> sim3.Sim3:
    """S_ji = S_j ∘ S_i⁻¹ from current poses (Optimizer.cc:800-870)."""
    return sim3.compose(_take(S_cw, edge_j), sim3.inverse(_take(S_cw, edge_i)))


def _edge_residual(xi_i, xi_j, Si: sim3.Sim3, Sj: sim3.Sim3, Sji_meas: sim3.Sim3):
    """e = log(S_meas⁻¹ ∘ (exp(ξj) Sj) ∘ (exp(ξi) Si)⁻¹) ∈ ℝ⁷, batched."""
    Si_new = sim3.compose(sim3.exp(xi_i), Si)
    Sj_new = sim3.compose(sim3.exp(xi_j), Sj)
    E = sim3.compose(sim3.inverse(Sji_meas), sim3.compose(Sj_new, sim3.inverse(Si_new)))
    return sim3.log(E)


def edge_jacobians(Si: sim3.Sim3, Sj: sim3.Sim3, Sji_meas: sim3.Sim3):
    """Residual at ξ = 0 and its Jacobians w.r.t. ξi and ξj, [E, 7] and
    [E, 7, 7] each (row = residual component, column = tangent)."""
    E = Si.s.shape[0]
    zero = torch.zeros((E, 7), dtype=Si.t.dtype, device=Si.t.device)

    def res(xi_i, xi_j):
        return _edge_residual(xi_i, xi_j, Si, Sj, Sji_meas)

    def along(v):
        return torch.func.jvp(res, (zero, zero), (v[:7].expand(E, 7), v[7:].expand(E, 7)))[1]

    J = torch.func.vmap(along)(torch.eye(14, dtype=zero.dtype, device=zero.device))   # [14, E, 7]
    J = J.permute(1, 2, 0)                                                             # [E, 7, 14]
    return res(zero, zero), J[..., :7], J[..., 7:]


def _linearize(prob: PoseGraphProblem, S: sim3.Sim3):
    """Residual + per-edge Jacobians, masked for invalid edges and fixed
    vertices.  Returns (r [E, 7], Ji [E, 7, 7], Jj [E, 7, 7], w [E])."""
    r, Ji, Jj = edge_jacobians(_take(S, prob.edge_i), _take(S, prob.edge_j), prob.edge_Sji)
    w = prob.edge_valid.to(torch.float32) * prob.edge_weight
    free_i = ~prob.kf_fixed[prob.edge_i.long()] & prob.edge_valid
    free_j = ~prob.kf_fixed[prob.edge_j.long()] & prob.edge_valid
    Ji = torch.where(free_i[:, None, None], Ji, 0.0)
    Jj = torch.where(free_j[:, None, None], Jj, 0.0)
    return r, Ji, Jj, w


def _finish_step(prob: PoseGraphProblem, S: sim3.Sim3, dx: torch.Tensor) -> sim3.Sim3:
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    dx = torch.where((prob.kf_fixed | ~prob.kf_valid)[:, None], 0.0, dx)
    return sim3.compose(sim3.exp(dx), S)


def _incidence(prob: PoseGraphProblem, K: int):
    """Edge → endpoint incidence matrices [K, E] (f32 0/1) of the valid
    edges: ``Oi @ v`` sums per-edge rows into their i vertices."""
    ids = torch.arange(K, device=prob.edge_i.device)[:, None]
    valid = prob.edge_valid[None, :]
    return (((prob.edge_i[None, :] == ids) & valid).to(torch.float32),
            ((prob.edge_j[None, :] == ids) & valid).to(torch.float32))


def _gn_step_dense(prob: PoseGraphProblem, S: sim3.Sim3, damping: float) -> sim3.Sim3:
    K = prob.kf_valid.shape[0]
    D = 7 * K
    r, Ji, Jj, w = _linearize(prob, S)
    E = r.shape[0]

    # H = Aᵀ W A and b = Aᵀ W r with A [7E, 7K] the whole Jacobian (JAX:
    # block scatter-adds of Jiᵀ W Ji, Jjᵀ W Jj, Jiᵀ W Jj and its transpose)
    Oi, Oj = _incidence(prob, K)
    sw = torch.sqrt(w)[:, None, None, None]
    A = sw * (Oi.T[:, None, :, None] * Ji[:, :, None, :] + Oj.T[:, None, :, None] * Jj[:, :, None, :])
    A = A.reshape(7 * E, D)
    H = A.T @ A
    b = A.T @ (torch.sqrt(w)[:, None] * r).reshape(7 * E)

    # anchor fixed/invalid vertices
    anchor = (prob.kf_fixed | ~prob.kf_valid).to(torch.float32)
    H = H + torch.diag(anchor.repeat_interleave(7) * 1e6 + damping)
    L, info = torch.linalg.cholesky_ex(H + 1e-8 * torch.eye(D, dtype=H.dtype, device=H.device))
    dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
    # a failed factorization gives NaN in JAX's cho_factor: no step
    dx = torch.where(info == 0, dx, float("nan"))
    return _finish_step(prob, S, dx.reshape(K, 7))


def _edge_system(prob: PoseGraphProblem, S: sim3.Sim3, K: int):
    """The normal equations' share of the edges of ``prob``, summed onto
    the K vertices through the incidence matrices: ``b`` [K, 7], the block
    diagonal [K, 49] and ``hx(x)`` = the edges' H·x [K, 7]."""
    r, Ji, Jj, w = _linearize(prob, S)
    E = r.shape[0]
    Oi, Oj = _incidence(prob, K)
    gi_idx, gj_idx = prob.edge_i.long(), prob.edge_j.long()
    bi = torch.einsum("eki,e,ek->ei", Ji, w, r)
    bj = torch.einsum("eki,e,ek->ei", Jj, w, r)

    def hx(x):                                                     # x: [K, 7]
        ye = torch.einsum("eij,ej->ei", Ji, x[gi_idx]) + torch.einsum("eij,ej->ei", Jj, x[gj_idx])
        ye = w[:, None] * ye
        gi = torch.einsum("eij,ei->ej", Ji, ye)
        gj = torch.einsum("eij,ei->ej", Jj, ye)
        return Oi @ gi + Oj @ gj

    Hii = torch.einsum("eki,e,ekj->eij", Ji, w, Ji).reshape(E, 49)
    Hjj = torch.einsum("eki,e,ekj->eij", Jj, w, Jj).reshape(E, 49)
    return Oi @ bi + Oj @ bj, Oi @ Hii + Oj @ Hjj, hx


def _pcg(prob: PoseGraphProblem, b, Hd, hx, damping: float, cg_iters: int) -> torch.Tensor:
    """Block-Jacobi PCG on H·dx = −b, H = Σ edges + the anchor diagonal.

    The CG is ``jax.scipy.sparse.linalg.cg(tol=1e-6, maxiter=cg_iters)``:
    it stops once ‖r‖² ≤ 1e-12·‖b‖².  Here all ``cg_iters`` iterations run
    and the iterate freezes, on the device, at the first one that passes the
    test, so no iteration reads back to the host."""
    K = b.shape[0]
    anchor = (prob.kf_fixed | ~prob.kf_valid).to(torch.float32)
    diag = anchor * 1e6 + damping                                  # [K]
    eye7 = torch.eye(7, dtype=b.dtype, device=b.device)
    Hd_inv = torch.linalg.inv_ex(Hd.reshape(K, 7, 7) + (diag + 1e-8)[:, None, None] * eye7).inverse

    def Hx(x):
        return hx(x) + diag[:, None] * x

    def precond(v):
        return torch.einsum("kij,kj->ki", Hd_inv, v)

    rhs = -b
    tol2 = 1e-12 * torch.sum(rhs * rhs)
    x = torch.zeros_like(rhs)
    res = rhs                                                      # rhs − H·0
    p = precond(res)
    gamma = torch.sum(res * p)
    for _ in range(cg_iters):
        active = torch.sum(res * res) > tol2
        Ap = Hx(p)
        alpha = gamma / torch.sum(p * Ap)
        x_n = x + alpha * p
        r_n = res - alpha * Ap
        z_n = precond(r_n)
        gamma_n = torch.sum(r_n * z_n)
        p_n = z_n + (gamma_n / gamma) * p
        x = torch.where(active, x_n, x)
        res = torch.where(active, r_n, res)
        p = torch.where(active, p_n, p)
        gamma = torch.where(active, gamma_n, gamma)
    return x


def _gn_step_pcg(prob: PoseGraphProblem, S: sim3.Sim3, damping: float, cg_iters: int) -> sim3.Sim3:
    """Matrix-free normal-equation solve: H is applied edge by edge and never
    built; the block-Jacobi preconditioner inverts the 7×7 diagonal blocks."""
    b, Hd, hx = _edge_system(prob, S, prob.kf_valid.shape[0])
    return _finish_step(prob, S, _pcg(prob, b, Hd, hx, damping, cg_iters))


def _pad_edges(prob: PoseGraphProblem, n: int) -> PoseGraphProblem:
    """The edge set padded to a multiple of ``n`` with invalid edges (their
    measurement the identity, so that their residual is finite)."""
    pad = (-prob.edge_i.shape[0]) % n
    if not pad:
        return prob
    dev = prob.edge_i.device

    def padt(a, fill=0):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill, dtype=a.dtype, device=dev)])

    ident = sim3.identity((pad,), device=dev)
    return prob._replace(
        edge_i=padt(prob.edge_i), edge_j=padt(prob.edge_j),
        edge_Sji=sim3.Sim3(*(torch.cat([a, b.to(a.dtype)]) for a, b in zip(prob.edge_Sji, ident))),
        edge_valid=padt(prob.edge_valid, False), edge_weight=padt(prob.edge_weight),
    )


def _shard_edges(prob: PoseGraphProblem, mesh) -> list:
    """This process's edge shards of a padded problem, each on its slot's
    device with the vertex arrays replicated there."""
    edges = [mesh.split(a, 0) for a in (prob.edge_i, prob.edge_j, *prob.edge_Sji,
                                        prob.edge_valid, prob.edge_weight)]
    out = []
    for k, dev in enumerate(mesh.local_devices):
        ei, ej, R, t, s, valid, weight = (e[k] for e in edges)
        out.append(PoseGraphProblem(
            S_cw=sim3.Sim3(*(a.to(dev) for a in prob.S_cw)), kf_valid=prob.kf_valid.to(dev),
            kf_fixed=prob.kf_fixed.to(dev), edge_i=ei, edge_j=ej, edge_Sji=sim3.Sim3(R, t, s),
            edge_valid=valid, edge_weight=weight))
    return out


def _gn_step_pcg_sharded(prob: PoseGraphProblem, S: sim3.Sim3, damping: float, cg_iters: int,
                         mesh, shards: list = None) -> sim3.Sim3:
    """Edge-sharded matrix-free GN step (JAX ``_gn_step_pcg_sharded``): each
    shard linearizes its edges and sums them onto the vertices; ``b``, the
    block diagonal and every H·x are joined by the mesh's ``psum``, and the
    PCG on the replicated [K, 7] vertex vectors runs once, on the mesh's
    first local device.  ``shards``, when the caller keeps them across
    steps, are the local edge shards (``_shard_edges``) of ``prob`` padded
    to a multiple of the mesh size (``_pad_edges``).  Returns the step on
    ``prob``'s device."""
    K = prob.kf_valid.shape[0]
    dev = prob.kf_valid.device
    if shards is None:
        prob = _pad_edges(prob, mesh.size)
        shards = _shard_edges(prob, mesh)
    systems = [_edge_system(p, sim3.Sim3(*x), K)
               for p, x in zip(shards, zip(*(mesh.broadcast(a) for a in S)))]
    b = mesh.psum([s[0] for s in systems])
    Hd = mesh.psum([s[1] for s in systems])

    def hx(x):
        return mesh.psum([h(xd) for (_, _, h), xd in zip(systems, mesh.broadcast(x))])

    rep = prob._replace(kf_valid=prob.kf_valid.to(mesh.device), kf_fixed=prob.kf_fixed.to(mesh.device))
    dx = _pcg(rep, b, Hd, hx, damping, cg_iters).to(dev)
    return _finish_step(prob, S, dx)


def gn_step(prob: PoseGraphProblem, S: sim3.Sim3, *, damping: float = DAMPING, cg_iters: int = CG_ITERS,
            dense_max_k: int = DENSE_MAX_K) -> sim3.Sim3:
    """One single-process GN step: dense Cholesky up to ``dense_max_k``
    vertices, matrix-free PCG above."""
    if prob.kf_valid.shape[0] <= dense_max_k:
        return _gn_step_dense(prob, S, damping)
    return _gn_step_pcg(prob, S, damping, cg_iters)


def optimize_pose_graph(
    prob: PoseGraphProblem,
    *,
    iters: int = 20,
    damping: float = DAMPING,
    cg_iters: int = CG_ITERS,
    dense_max_k: int = DENSE_MAX_K,
    mesh=None,
    mesh_axis: str = "ba",
) -> sim3.Sim3:
    """Batched GN over the whole graph; returns the optimized S_cw.  Dense
    Cholesky up to ``dense_max_k`` vertices, matrix-free PCG above; with a
    ``mesh`` (``parallel.mesh.Mesh`` over ``mesh_axis``) always the
    edge-sharded PCG, the edges padded and split once for all iterations."""
    S = prob.S_cw
    if mesh is not None:
        if mesh.axis != mesh_axis:
            raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {mesh_axis!r}")
        prob = _pad_edges(prob, mesh.size)
        shards = _shard_edges(prob, mesh)
        for _ in range(iters):
            S = _gn_step_pcg_sharded(prob, S, damping, cg_iters, mesh, shards)
        return S
    for _ in range(iters):
        S = gn_step(prob, S, damping=damping, cg_iters=cg_iters, dense_max_k=dense_max_k)
    return S
