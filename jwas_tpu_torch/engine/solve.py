"""Non-MCMC solution of the mixed-model equations.

Counterpart of jwas_tpu/engine/solve.py: solve (:18) and _solve_sparse
(:124) (solver.jl:7-54). The MME of a model without markers is built on
the host as jwas_tpu builds it and solved on the chain's device (the GPU
unless the caller asks for the CPU), in float64:

- dense (K up to 20,000 for a single trait, and every multi-trait model):
  "Jacobi" (ops/location.py::jacobi), "Gauss-Seidel" (a pass of K6 a sweep
  with its normals zero), "CG" (Jacobi-preconditioned, scipy.sparse.linalg.
  cg's stopping rule) and "Gibbs" (K6 passes, their running mean);
- sparse (a single trait above 20,000 levels, or sparse_location=True):
  the LHS assembled once as scipy CSR (build_MME.jl:300-382), then "Jacobi"
  and "CG" on the device with a CSR tensor; "Gauss-Seidel" as the
  reference runs it, a sparse triangular solve a sweep with scipy on the
  host; "Gibbs" as joint PO-CG draws (ops/sparse_mme.py) and their running
  mean. Fault R4 (ROADMAP.md): jwas_tpu draws in float32 and caps the
  draws at 1,000 (:239-241); here they are float64 with
  double_precision=True and maxiter draws are taken.

solver="default" prints the reference's prompt and returns (names, W, LHS,
RHS) as numpy / scipy objects. solve.last holds the last sparse solve's
path, solver, K, the LHS's nonzeros and, for Jacobi and CG, their
iterations and final relative residual ||b - A x|| / ||b||.
"""

from __future__ import annotations

import numpy as np
import torch

from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace, resolve_device
from jwas_tpu_torch.io.table import Table
from jwas_tpu_torch.models.model import Model
from jwas_tpu_torch.ops.location import gauss_seidel, gibbs_solver, jacobi, symmetric_upper

SOLVERS = ("default", "Jacobi", "Gauss-Seidel", "CG", "Gibbs")
_SOLVER_ERROR = "solver must be 'default', 'Jacobi', 'Gauss-Seidel', 'CG', or 'Gibbs'"


def pcg(matvec, b, d, rtol: float, maxiter: int, x0=None):
    """Jacobi-preconditioned CG for an SPD operator with diagonal d, stopped
    as scipy.sparse.linalg.cg stops: ||r|| <= rtol ||b|| (read once an
    iteration) or after maxiter iterations. Returns (x, iterations,
    relative residual)."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    bnorm = float(torch.linalg.vector_norm(b))
    if bnorm == 0.0:
        return torch.zeros_like(b), 0, 0.0
    z = r / d
    p = z.clone()
    rz = torch.dot(r, z)
    it, res = 0, float(torch.linalg.vector_norm(r)) / bnorm
    while res > rtol and it < maxiter:
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x.add_(alpha * p)
        r.sub_(alpha * Ap)
        it += 1
        res = float(torch.linalg.vector_norm(r)) / bnorm
        if res <= rtol:
            break
        z = r / d
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, it, res


def solve(model: Model, df, *, solver: str = "default", printout_frequency: int = 100,
          tolerance: float = 1e-6, maxiter: int = 5000,
          heterogeneous_residuals: bool = False, double_precision: bool = False,
          sparse_location=None, device="cuda"):
    """Solve the MME without estimating variance components.

    Returns a Table [Name, Estimate] for the iterative solvers, or (names,
    W, LHS, RHS) for solver="default". sparse_location: None (auto: a
    single trait above 20,000 levels), True or False. device: where the
    solvers run (the GPU unless the caller asks for the CPU, as runMCMC).
    The model is consumed, as the reference's is (build a fresh one a
    call)."""
    if solver not in SOLVERS:
        raise ValueError(_SOLVER_ERROR)
    opts = MCMCOptions(heterogeneous_residuals=heterogeneous_residuals,
                       double_precision=double_precision, outputEBV=False,
                       output_heritability=False, output_folder="",
                       sparse_location=sparse_location)
    ws = prepare_workspace(model, df, opts)
    device = resolve_device(device)
    if ws.W_sparse is not None:
        return _solve_sparse(model, ws, solver=solver, tolerance=tolerance,
                             maxiter=maxiter, device=device,
                             double_precision=double_precision)
    W = ws.W
    rinv = ws.rinv if ws.rinv is not None else np.ones(ws.n_obs * ws.n_traits)
    if ws.n_traits == 1:
        LHS = (W * rinv[:, None]).T @ W
        RHS = W.T @ (rinv * ws.y)
    else:
        # W' (R^-1 (x) I_n) W from the trait blocks (jwas_tpu :68-88)
        import scipy.sparse as sp

        t_, n_ = ws.n_traits, ws.n_obs
        Ri = np.linalg.inv(ws.vare0)
        Wb = [sp.csr_matrix(W[s * n_:(s + 1) * n_]) for s in range(t_)]
        yb = ws.y.reshape(t_, n_)
        K = W.shape[1]
        LHS = np.zeros((K, K))
        RHS = np.zeros(K)
        for s in range(t_):
            for u in range(t_):
                if Ri[s, u] == 0.0:
                    continue
                LHS += Ri[s, u] * np.asarray((Wb[s].T @ Wb[u]).todense())
                RHS += Ri[s, u] * (Wb[s].T @ yb[u])
    for grp in ws.re_groups:                     # addVinv, lambda form for one trait
        Gi = np.linalg.inv(grp.G0)
        q = grp.n_levels
        for i, si in enumerate(grp.starts):
            for j, sj in enumerate(grp.starts):
                lam = Gi[i, j] * (float(ws.vare0) if ws.n_traits == 1 else 1.0)
                block = grp.Vinv if grp.Vinv is not None else np.eye(q)
                LHS[si:si + q, sj:sj + q] += block * lam
    names = model.term_names()
    if solver == "default":
        print("To solve the equations, please choose a solver: "
              "'Jacobi', 'Gauss-Seidel', or 'Gibbs'.")
        return names, W, LHS, RHS
    A = symmetric_upper(torch.as_tensor(LHS, dtype=torch.float64).to(device))
    b = torch.as_tensor(RHS, dtype=torch.float64).to(device)
    if solver == "Jacobi":
        x = jacobi(A, b, tolerance=tolerance, maxiter=maxiter)
    elif solver == "Gauss-Seidel":
        x = gauss_seidel(A, b, tolerance=tolerance, maxiter=maxiter)
    elif solver == "CG":
        D = torch.diagonal(A)
        free = D > 0
        Dsafe = torch.where(free, D, torch.ones_like(D))
        A1 = A + torch.diag((~free).to(A.dtype))
        x, _, _ = pcg(lambda v: A1 @ v, torch.where(free, b, 0.0), Dsafe,
                      max(tolerance, 1e-12), maxiter)
        x = torch.where(free, x, 0.0)
    else:
        vare = float(ws.vare0) if ws.n_traits == 1 else None
        x = gibbs_solver(A, b, vare=vare, niter=maxiter)
    return Table({"Name": names, "Estimate": x.cpu().numpy()})


def _solve_sparse(model, ws, *, solver, tolerance, maxiter, device,
                  double_precision=False):
    """The sparse LHS's solve (jwas_tpu/engine/solve.py:124-254): the LHS
    assembled once as scipy CSR, empty fixed-effect equations pinned at 0
    by a unit diagonal (solver.jl:146); Jacobi and CG on device with a CSR
    tensor in float64, Gauss-Seidel's triangular solves with scipy on the
    host as the reference runs them, Gibbs the running mean of maxiter
    joint PO-CG draws (float64 with double_precision: fault R4 repaired)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from jwas_tpu_torch.ops import sparse_mme as sm

    if ws.n_traits != 1:
        raise ValueError("sparse solve supports single-trait models; pass "
                         "sparse_location=False for multi-trait")
    W = ws.W_sparse.tocsr()
    n, K = W.shape
    rinv = ws.rinv if ws.rinv is not None else np.ones(n)
    vare = float(ws.vare0)
    LHS = (W.T @ sp.diags(rinv) @ W).tocsr()
    RHS = W.T @ (rinv * ws.y)
    rr, cc, vv = [], [], []
    for grp in ws.re_groups:
        Gi = np.linalg.inv(grp.G0)
        q = grp.n_levels
        V = sp.coo_matrix(grp.Vinv) if grp.Vinv is not None else sp.coo_matrix(sp.eye(q))
        for i, si in enumerate(grp.starts):
            for j, sj in enumerate(grp.starts):
                lam = Gi[i, j] * vare
                if lam != 0.0:
                    rr.append(V.row + si)
                    cc.append(V.col + sj)
                    vv.append(V.data * lam)
    if rr:
        P = sp.coo_matrix((np.concatenate(vv), (np.concatenate(rr), np.concatenate(cc))),
                          shape=(K, K))
        LHS = (LHS + P).tocsr()
    names = model.term_names()
    if solver == "default":
        print("To solve the equations, please choose a solver: "
              "'Jacobi', 'Gauss-Seidel', 'CG', or 'Gibbs'.")
        return names, W, LHS, RHS
    D = LHS.diagonal()
    free = D > 0
    Dsafe = np.where(free, D, 1.0)
    if not free.all():
        LHS = (LHS + sp.diags((~free).astype(np.float64))).tocsr()
        RHS = np.where(free, RHS, 0.0)
    f64 = torch.float64
    info = solve.last = dict(path="sparse", solver=solver, K=K, lhs_nnz=int(LHS.nnz))
    if solver == "Jacobi":
        A = sm.csr(LHS, f64, device)
        b = torch.as_tensor(RHS, dtype=f64).to(device)
        Dt = torch.as_tensor(Dsafe, dtype=f64).to(device)
        fr = torch.as_tensor(free).to(device)
        x = torch.zeros(K, dtype=f64, device=device)
        it = 0
        for it in range(1, maxiter + 1):
            err = b - sm.spmv(A, x)
            x = torch.where(fr, 0.7 * (err / Dt + x) + 0.3 * x, 0.0)
            if bool(torch.sum(torch.where(fr, err, 0.0) ** 2) / K <= tolerance):
                break
        info.update(iterations=it, relative_residual=float(
            torch.linalg.vector_norm(b - sm.spmv(A, x)) / torch.linalg.vector_norm(b)))
        x = x.cpu().numpy()
    elif solver == "Gauss-Seidel":
        Ltri = sp.tril(LHS, k=0, format="csr")
        Utri = sp.triu(LHS, k=1, format="csr")
        x = np.zeros(K)
        for _ in range(maxiter + 1):
            x = spsolve_triangular(Ltri, RHS - Utri @ x, lower=True, unit_diagonal=False)
            err = RHS - LHS @ x
            if np.sum(err[free] ** 2) / K <= tolerance:
                break
        x = np.where(free, x, 0.0)
    elif solver == "CG":
        A = sm.csr(LHS, f64, device)
        x, it, res = pcg(lambda v: sm.spmv(A, v), torch.as_tensor(RHS, dtype=f64).to(device),
                         torch.as_tensor(Dsafe, dtype=f64).to(device),
                         max(tolerance, 1e-12), maxiter)
        info.update(iterations=it, relative_residual=res)
        x = np.where(free, x.cpu().numpy(), 0.0)
    else:
        from jwas_tpu_torch.engine.state import REGroupCfg

        dtype = f64 if double_precision else torch.float32
        re_cfgs = [REGroupCfg(
            starts=g.starts, n_levels=g.n_levels, df=g.df, has_vinv=g.Vinv is not None,
            random_type=g.random_type, estimate_variance=g.estimate_variance,
            factor_rows=(0 if g.Vinv is None else g.n_levels if g.Vinv_factor is None
                         else g.Vinv_factor.shape[0]))
            for g in ws.re_groups]
        sl = sm.build_sparse_loc(W, ws.rinv, ws.re_groups, re_cfgs, dtype, device)
        gis = [torch.as_tensor(np.linalg.inv(g.G0), dtype=dtype).to(device)
               for g in ws.re_groups]
        chols = [torch.linalg.cholesky(0.5 * (g + g.T)) for g in gis]
        rhs = torch.as_tensor(RHS, dtype=dtype).to(device)
        v = torch.as_tensor(vare, dtype=dtype).to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        tol = 1e-8 if double_precision else 1e-6
        xj = torch.zeros(K, dtype=dtype, device=device)
        mean = torch.zeros(K, dtype=dtype, device=device)
        for it in range(1, int(maxiter) + 1):
            xj = sm.sample_location_po(gen, sl, re_cfgs, rhs, gis, v, chols, x0=xj,
                                       tol=tol, maxiter=500)
            mean += (xj - mean) / it
        x = mean.cpu().numpy().astype(np.float64)
    return Table({"Name": names, "Estimate": x})


solve.last = None
