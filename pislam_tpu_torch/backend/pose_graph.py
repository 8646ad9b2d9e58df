"""Pose-graph optimisation (Gauss-Newton over SE(3) or Sim(3) relative
constraints).

The port of ``pislam_tpu/backend/pose_graph.py``. N pose nodes, M edges with
validity masks; node 0 is gauge-fixed. The normal equations are assembled
densely and solved with ``solve_ex`` (up to 64 nodes), or applied per edge
inside block-Jacobi preconditioned CG; their per-node sums are ba.py's
ordered segment sums. Jacobians come from forward-mode
autodiff of the residual at the identity perturbation, as the JAX package's
``jax.vmap(jax.jacfwd(res))`` (``_edge_jacobians``).

Edge residual (right-perturbation convention):
    r_ij = log( Z_ij^{-1} (X_i^{-1} X_j) )
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from .ba import _pcg, _Segments


class PoseGraph(NamedTuple):
    R: torch.Tensor           # (N, 3, 3)
    t: torch.Tensor           # (N, 3)
    edge_i: torch.Tensor      # (M,) int
    edge_j: torch.Tensor      # (M,) int
    edge_R: torch.Tensor      # (M, 3, 3) measured relative rotation (i -> j)
    edge_t: torch.Tensor      # (M, 3)
    edge_valid: torch.Tensor  # (M,) bool
    node_valid: torch.Tensor  # (N,) bool
    # (M,) per-edge information weights: residual m contributes w_m |r_m|^2;
    # None = all ones
    edge_weight: Optional[torch.Tensor] = None
    # Sim(3) state (optimize(..., sim3=True)): per-node log-scales and
    # per-edge measured relative log-scales; None = zeros
    node_logs: Optional[torch.Tensor] = None   # (N,) log s_i
    edge_logs: Optional[torch.Tensor] = None   # (M,) log s_ij measured


def _edge_weights(g: PoseGraph):
    if g.edge_weight is None:
        return torch.ones(g.edge_i.shape[0], device=g.t.device)
    return g.edge_weight.to(torch.float32)


def _node_logs(g: PoseGraph):
    if g.node_logs is None:
        return torch.zeros(g.R.shape[0], device=g.t.device)
    return g.node_logs.to(torch.float32)


def _edge_logs(g: PoseGraph):
    if g.edge_logs is None:
        return torch.zeros(g.edge_i.shape[0], device=g.t.device)
    return g.edge_logs.to(torch.float32)


def _ends(g: PoseGraph):
    return g.edge_i.long(), g.edge_j.long()


# ---- Sim(3) helpers: elements act as x -> e^ls R x + t -------------------

def _sim3_rel(lsi, Ri, ti, lsj, Rj, tj):
    """X_i^{-1} X_j for Sim3 nodes: (ls, R, t) relative, batched."""
    Rit = Ri.transpose(-1, -2)
    si_inv = torch.exp(-lsi)
    t = si_inv[..., None] * (Rit @ (tj - ti)[..., None])[..., 0]
    return lsj - lsi, Rit @ Rj, t


def _sim3_residual(ls_rel, R_rel, t_rel, ls_z, R_z, t_z):
    """(..., 7) residual of E = Z^{-1} (X_i^{-1} X_j): [t_E, log R_E, ls_E]
    (the JAX package's simplified Sim3 log)."""
    Rzt = R_z.transpose(-1, -2)
    sz_inv = torch.exp(-ls_z)
    R_E = Rzt @ R_rel
    t_E = sz_inv[..., None] * (Rzt @ (t_rel - t_z)[..., None])[..., 0]
    return torch.cat([t_E, se3.so3_log(R_E), (ls_rel - ls_z)[..., None]], dim=-1)


def sim3_edge_residuals(g: PoseGraph):
    """(M, 7) Sim3 twist residuals (masked by edge_valid)."""
    i, j = _ends(g)
    ls = _node_logs(g)
    ls_rel, R_rel, t_rel = _sim3_rel(ls[i], g.R[i], g.t[i], ls[j], g.R[j], g.t[j])
    r = _sim3_residual(ls_rel, R_rel, t_rel, _edge_logs(g), g.edge_R, g.edge_t)
    return r * g.edge_valid[:, None]


def _weighted(g: PoseGraph, jac, r0, D: int):
    """sqrt-information weighting of (J, r), masked by edge_valid; splits J
    into its node-i and node-j blocks."""
    sw = torch.sqrt(_edge_weights(g))
    jac = jac * sw[:, None, None]
    m = g.edge_valid[:, None, None]
    return jac[:, :, :D] * m, jac[:, :, D:] * m, r0 * sw[:, None]


def _edge_jacobians(res, nvar: int, m: int, device):
    """(M, R, nvar) Jacobians at 0 of ``res``: (M, nvar) perturbations ->
    (M, R) residuals, where edge m depends on row m alone. One forward-mode
    pass per perturbation axis, batched by ``torch.func.vmap``, with every
    edge perturbed at once: the JAX package's per-edge ``vmap(jacfwd)``
    would make each edge's scalars 0-dim tensors, where torch's forward mode
    promotes the tangents of operations with Python floats to float64."""
    xi0 = torch.zeros(m, nvar, device=device)
    basis = torch.eye(nvar, device=device)[:, None, :].expand(nvar, m, nvar)
    cols = torch.func.vmap(lambda tan: torch.func.jvp(res, (xi0,), (tan,))[1])(basis)
    return cols.permute(1, 2, 0)


def _perturb(xi, R, t):
    """Left-multiplicative twists (M, 6) applied to poses (M, 3, 3), (M, 3)."""
    dR, dt = se3.se3_exp(xi)
    return dR @ R, (dR @ t[..., None])[..., 0] + dt


def _analytic_jacobians_sim3(g: PoseGraph):
    """Exact J_i, J_j (M, 7, 7) wrt left-multiplicative Sim3 twists
    [rho, w, sigma], and the weighted residual (M, 7)."""
    i, j = _ends(g)
    ls = _node_logs(g)

    def res(xi):
        def perturb(p, ls, R, t):
            sig = p[:, 6]
            dR, dt = se3.se3_exp(p[:, :6])
            return ls + sig, dR @ R, torch.exp(sig)[:, None] * (dR @ t[..., None])[..., 0] + dt
        lsi2, Ri2, ti2 = perturb(xi[:, :7], ls[i], g.R[i], g.t[i])
        lsj2, Rj2, tj2 = perturb(xi[:, 7:], ls[j], g.R[j], g.t[j])
        return _sim3_residual(*_sim3_rel(lsi2, Ri2, ti2, lsj2, Rj2, tj2),
                              _edge_logs(g), g.edge_R, g.edge_t)

    jac = _edge_jacobians(res, 14, i.shape[0], g.t.device)   # (M, 7, 14)
    return _weighted(g, jac, sim3_edge_residuals(g), 7)


def edge_residuals(g: PoseGraph):
    """(M, 6) twist residuals log(Z^{-1} X_i^{-1} X_j)."""
    i, j = _ends(g)
    Rinv, tinv = se3.inverse(g.R[i], g.t[i])
    Rij, tij = se3.compose(Rinv, tinv, g.R[j], g.t[j])
    Zinv_R, Zinv_t = se3.inverse(g.edge_R, g.edge_t)
    Er, Et = se3.compose(Zinv_R, Zinv_t, Rij, tij)
    return se3.se3_log(Er, Et) * g.edge_valid[:, None]


def _analytic_jacobians(g: PoseGraph):
    """Exact J_i, J_j (M, 6, 6) wrt left-multiplicative twists, and the
    weighted residual (M, 6)."""
    i, j = _ends(g)
    Zinv_R, Zinv_t = se3.inverse(g.edge_R, g.edge_t)

    def res(xi):
        Rinv, tinv = se3.inverse(*_perturb(xi[:, :6], g.R[i], g.t[i]))
        Rij, tij = se3.compose(Rinv, tinv, *_perturb(xi[:, 6:], g.R[j], g.t[j]))
        return se3.se3_log(*se3.compose(Zinv_R, Zinv_t, Rij, tij))

    jac = _edge_jacobians(res, 12, i.shape[0], g.t.device)   # (M, 6, 12)
    return _weighted(g, jac, edge_residuals(g), 6)


def _pinned(graph: PoseGraph, n: int):
    return ~graph.node_valid | (torch.arange(n, device=graph.t.device) == 0)


def _node_terms(graph, ji, jj, r, n):
    """The per-edge Jacobian blocks stacked by the node they belong to: the
    (2M,) nodes, the other end of each edge, the (2M, K, D) blocks and the
    (2M, K) residuals, with the node sums as ba.py's ordered segment sums
    (the card repeats itself, where ``index_add_`` adds with atomics)."""
    i, j = _ends(graph)
    ends = torch.cat([i, j])
    return ends, torch.cat([j, i]), torch.cat([ji, jj]), torch.cat([r, r]), _Segments(ends, n)


def _solve_normal_dense(graph, ji, jj, r, damping, n):
    """Assemble + solve the dense (DN, DN) normal equations (D = 6 for SE3,
    7 for Sim3, from the Jacobian blocks)."""
    D = ji.shape[-1]
    dev = ji.device
    ends, others, jac, rr, node = _node_terms(graph, ji, jj, r, n)
    # the (D, D) blocks J_a^T J_a at (a, a) and J_a^T J_c at (a, c)
    pairs = _Segments(torch.cat([ends * n + ends, ends * n + others]), n * n)
    h = pairs.sum(torch.cat([torch.einsum("mki,mkj->mij", jac, jac),
                             torch.einsum("mki,mkj->mij", jac, torch.cat([jj, ji]))]))
    h = h.reshape(n, n, D, D).permute(0, 2, 1, 3).reshape(D * n, D * n)
    b = node.sum(-torch.einsum("mki,mk->mi", jac, rr))

    eye = torch.eye(D * n, device=dev)
    hd = h + damping * eye
    pin = torch.repeat_interleave(_pinned(graph, n), D)
    hd = torch.where(pin[:, None] | pin[None, :], eye, hd)
    bd = torch.where(pin, 0.0, b.reshape(-1))
    return torch.linalg.solve_ex(hd, bd)[0].reshape(n, D)


def _solve_normal_cg(graph, ji, jj, r, damping, n, cg_iters):
    """Matrix-free block-Jacobi PCG on the same normal equations: H x
    applied per edge, the per-node (D, D) diagonal blocks inverted once per
    GN step as the preconditioner."""
    D = ji.shape[-1]
    i, j = _ends(graph)
    dev = ji.device
    pinned = _pinned(graph, n)
    eye = torch.eye(D, device=dev)
    _, _, jac, rr, node = _node_terms(graph, ji, jj, r, n)

    blocks = node.sum(torch.einsum("mki,mkj->mij", jac, jac))
    blocks = torch.where(pinned[:, None, None], eye, blocks + damping * eye)
    binv = torch.linalg.inv_ex(blocks)[0]
    b = node.sum(-torch.einsum("mki,mk->mi", jac, rr))
    b = torch.where(pinned[:, None], 0.0, b).reshape(-1)

    def apply(x_flat):
        x = torch.where(pinned[:, None], 0.0, x_flat.reshape(n, D))
        y = (torch.einsum("mki,mi->mk", ji, x[i])
             + torch.einsum("mki,mi->mk", jj, x[j]))   # (M, K)
        out = node.sum(torch.einsum("mki,mk->mi", jac, torch.cat([y, y])))
        out = out + damping * x
        return torch.where(pinned[:, None], x_flat.reshape(n, D), out).reshape(-1)

    def minv(r_flat):
        return torch.einsum("nij,nj->ni", binv, r_flat.reshape(n, D)).reshape(-1)

    return _pcg(apply, minv, b, cg_iters).reshape(n, D)


def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-4,
             solver: str = "auto", cg_iters: int = 0, sim3: bool = False):
    """Damped GN iterations; node 0 gauge-fixed. Returns (graph, costs).

    solver="auto" uses the dense solve up to 64 nodes and matrix-free
    block-Jacobi PCG above; cg_iters=0 defaults to max(128, N). sim3=True
    optimises over Sim(3): each node carries a log-scale (g.node_logs, zeros
    if absent); convert back to SE(3) poses with t / exp(node_logs). The
    returned per-iteration costs are information-weighted (sum of w |r|^2).
    """
    n = g.R.shape[0]
    if solver == "auto":
        solver = "cg" if n > 64 else "dense"
    if not cg_iters:
        cg_iters = max(128, n)
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown pose-graph solver {solver!r}")
    if sim3 and g.node_logs is None:
        g = g._replace(node_logs=torch.zeros(n, device=g.t.device))

    costs = []
    for _ in range(iters):
        ji, jj, r = _analytic_jacobians_sim3(g) if sim3 else _analytic_jacobians(g)
        if solver == "cg":
            delta = _solve_normal_cg(g, ji, jj, r, damping, n, cg_iters)
        else:
            delta = _solve_normal_dense(g, ji, jj, r, damping, n)
        dR, dt = se3.se3_exp(delta[:, :6])
        Rn = dR @ g.R
        tn = (dR @ g.t[..., None])[..., 0]
        if sim3:
            sig = delta[:, 6]
            g = g._replace(R=Rn, t=torch.exp(sig)[:, None] * tn + dt,
                           node_logs=_node_logs(g) + sig)
            res = sim3_edge_residuals(g)
        else:
            g = g._replace(R=Rn, t=tn + dt)
            res = edge_residuals(g)
        costs.append(torch.sum(_edge_weights(g)[:, None] * res ** 2))
    return g, torch.stack(costs)
