"""Random-regression (longitudinal) marker sampler: the Legendre basis,
the per-marker Grams and the marker chain (K10).

Counterpart of jwas_tpu/ops/rrm.py: generate_full_phi (:28), a numpy
copy; build_m_phiphi (:48), here over the marker-major (p, nind) store, a
chunk of markers at a time (torch.matmul: a plain product outside any
kernel); _labels (:59); and sweep_rrm_abc (:67, a lax.scan over the
markers, :119 over body :82): one strictly sequential pass over the p
markers, each drawing its c regression coefficients jointly over the
2^c inclusion labels (BayesC, BayesB) or with every coefficient in
(RR-BLUP, BayesL), against the (ntimes, nind) residual grid.

On a CUDA tensor the pass is one launch of the hand-written kernel
csrc/rrm_sweep.cu (K10: a cooperative kernel, each block a slice of the
individuals, one grid-wide exchange a marker; float32 and float64
builds, c = 1..5, ntimes <= 32); on a CPU tensor it is the plain version
sweep_rrm_abc_ref, a loop over the markers. The sweep's draws are inputs
(parity level (b)): a Gumbel (p, 2^c) and normals (p, c), drawn by the
wrapper from the chain's generator when not given, so both versions see
the same draws.
"""

from __future__ import annotations

import numpy as np
import torch

from jwas_tpu_torch import _build

MAX_COEFF = 5        # K10 is instantiated for c = 1..5 (2^c <= 32 labels,
                     # one lane of a warp each)
MAX_TIMES = 32       # a cell's observation mask is a bit of a 32-bit word
_BUILDS = {torch.float32: "jt_rrm_sweep", torch.float64: "jt_rrm_sweep_f64"}


def generate_full_phi(timevec, ncoeff: int = 3) -> np.ndarray:
    """Normalized Legendre polynomial basis (generatefullPhi, RRM.jl:24-39).

    Returns (ntimes, ncoeff) over the sorted unique time points, standardized
    to [-1, 1]; column n is sqrt((2n+1)/2) P_n(q).
    """
    times = np.sort(np.unique(np.asarray(timevec, dtype=np.float64)))
    tmin, tmax = times.min(), times.max()
    q = 2.0 * (times - tmin) / (tmax - tmin) - 1.0 if tmax > tmin else np.zeros_like(times)
    phi = np.empty((len(times), ncoeff))
    for n in range(ncoeff):
        coeffs = np.zeros(n + 1)
        coeffs[n] = 1.0
        phi[:, n] = np.sqrt((2 * n + 1) / 2.0) * np.polynomial.legendre.legval(q, coeffs)
    return phi


def build_m_phiphi(X: torch.Tensor, phi: torch.Tensor, obs_mask: torch.Tensor,
                   chunk: int = 4096) -> torch.Tensor:
    """Per-marker Gram matrices (get_mPhiPhiarray, RRM.jl:43-57): X the
    (p, nind) marker-major store, phi (ntimes, c), obs_mask (ntimes, nind)
    1/0. Returns (p, c, c) with
    mPhiPhi_j = sum_i x_ji^2 (sum_t obs[t, i] phi_t phi_t'), in X's dtype
    on its device, chunk markers at a time (no squared copy of the
    store)."""
    c = phi.shape[1]
    B = torch.einsum("ti,tc,td->icd", obs_mask, phi, phi).reshape(-1, c * c)
    out = torch.empty((X.shape[0], c, c), dtype=X.dtype, device=X.device)
    for j0 in range(0, X.shape[0], chunk):
        xs = X[j0:j0 + chunk]
        out[j0:j0 + chunk] = torch.matmul(xs * xs, B).view(-1, c, c)
    return out


def _labels(ncoeff: int) -> np.ndarray:
    """All 2^c inclusion patterns, bit k = coefficient k. (c is small.)"""
    L = 2**ncoeff
    return np.array(
        [[(s >> k) & 1 for k in range(ncoeff)] for s in range(L)], dtype=np.float64
    )


def draw_sweep_normals(gen: torch.Generator, p: int, c: int, like: torch.Tensor,
                       estimate_delta: bool = True):
    """The sweep's draws from gen: a standard Gumbel (p, 2^c) when the
    labels are drawn (else None), then standard normals (p, c), in like's
    dtype on its device. The Gumbel is -log(-log(u)), u uniform on
    [tiny, 1), as jax.random.gumbel draws it."""
    gumbel = None
    if estimate_delta:
        u = torch.rand((p, 2**c), generator=gen, dtype=like.dtype, device=like.device)
        gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(like.dtype).tiny)))
    zs = torch.randn((p, c), generator=gen, dtype=like.dtype, device=like.device)
    return gumbel, zs


def sweep_rrm_abc_ref(X, phi, mphiphi, obs_mask, alpha, Wgrid, vare, Ginv, log_pi,
                      gumbel, zs, estimate_delta: bool = True):
    """Plain version of K10 (BayesABCRRM!, RRM.jl:59-159; jwas_tpu's body
    :82-116), one pass over the markers in order. X (p, nind); phi
    (ntimes, c); mphiphi (p, c, c); obs_mask (ntimes, nind); alpha (c, p);
    Wgrid (ntimes, nind) with unobserved cells at 0; vare 0-d; Ginv (c, c);
    log_pi (2^c,); gumbel (p, 2^c) (unused without estimate_delta); zs
    (p, c). For marker j with column x and a_old = alpha[:, j]:
    xw = phi' (Wg x) + mpp_j a_old; with estimate_delta, for each label D_l
    lhs_l = (D_l D_l') o mpp_j / vare + Ginv, rhs_l = D_l o xw / vare,
    mu_l = lhs_l^-1 rhs_l and logp_l = -(logdet_l - rhs_l.mu_l) / 2 +
    log_pi_l; the label is argmax(logp + gumbel_j) (the first on a tie);
    without, the one label of ones. b = mu_sel + L_sel'^-1 z_j, a = d o b,
    and Wg += (phi (a_old - a)) x' o obs_mask. The factors do not depend
    on the residual and are made for every marker first, as one batched
    Cholesky. Returns new (alpha, beta, delta, Wgrid); beta is b, delta
    the label's 0/1 pattern, both (c, p) in Wgrid's dtype."""
    p, c = X.shape[0], phi.shape[1]
    dtype, dev = Wgrid.dtype, Wgrid.device
    D = torch.as_tensor(_labels(c), dtype=dtype, device=dev)          # (L, c)
    if estimate_delta:
        lhs = (D[:, :, None] * D[:, None, :])[None] * mphiphi[:, None] / vare + Ginv
    else:
        lhs = (mphiphi / vare + Ginv)[:, None]
        D = D[-1:]
    chol = torch.linalg.cholesky(lhs)                                 # (p, L, c, c)
    logdet = 2.0 * torch.log(torch.abs(torch.diagonal(chol, dim1=2, dim2=3))).sum(2)
    cholT = chol.mT
    Wg = Wgrid.clone()
    a_in = alpha.T.contiguous()
    a_out = torch.empty((p, c), dtype=dtype, device=dev)
    b_out = torch.empty_like(a_out)
    d_out = torch.empty_like(a_out)
    for j in range(p):
        x, a_old = X[j], a_in[j]
        xw = phi.T @ (Wg @ x) + mphiphi[j] @ a_old
        rhs = D * xw / vare                                           # (L, c)
        mu = torch.cholesky_solve(rhs[..., None], chol[j])[..., 0]
        if estimate_delta:
            logp = -0.5 * (logdet[j] - (rhs * mu).sum(1)) + log_pi
            sel = torch.argmax(logp + gumbel[j])
        else:
            sel = 0
        b = mu[sel] + torch.linalg.solve_triangular(
            cholT[j, sel], zs[j][:, None], upper=True)[:, 0]
        a = D[sel] * b
        Wg += torch.outer(phi @ (a_old - a), x) * obs_mask
        a_out[j], b_out[j], d_out[j] = a, b, D[sel]
    return a_out.T.contiguous(), b_out.T.contiguous(), d_out.T.contiguous(), Wg


def sweep_limit_error(nind: int, ntimes: int, c: int, dtype, device):
    """Why K10 cannot take this sweep on device, or None: c above
    MAX_COEFF or ntimes above MAX_TIMES (every device: the port's limits),
    or on a CUDA device a block's slice of the individuals (its columns
    of the grid, its rows of three markers and its mask words) above the
    block's shared memory (jt_rrm_sweep_ctas)."""
    if not 1 <= c <= MAX_COEFF:
        return f"{c} Legendre coefficients (K10 takes 1 to {MAX_COEFF})"
    if not 1 <= ntimes <= MAX_TIMES:
        return f"{ntimes} time points (K10 takes 1 to {MAX_TIMES})"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    with torch.cuda.device(device):
        ctas = _build.library().jt_rrm_sweep_ctas(
            nind, ntimes, c, torch.empty((), dtype=dtype).element_size())
    if ctas == 0:
        return (f"{nind} individuals at {ntimes} time points (a block's slice of "
                f"the grid exceeds its shared memory)")
    if ctas < 0:
        _build.check(-ctas, "sweep_rrm_abc: the device's plan")
    return None


def sweep_rrm_abc(X, phi, mphiphi, obs_mask, alpha, Wgrid, vare, Ginv, log_pi,
                  gen: torch.Generator, estimate_delta: bool = True, gumbel=None,
                  zs=None):
    """One pass of the marker chain (see sweep_rrm_abc_ref; jwas_tpu's
    takes beta and delta too and ignores them). gumbel, zs: the sweep's
    draws (tests inject the JAX package's), else drawn from gen
    (draw_sweep_normals). CUDA tensors launch K10 (and raise if it cannot
    run) with its scratch, a double-buffered (2, ntimes, blocks) buffer of
    the blocks' partial sums and a zeroed arrival counter; CPU tensors take
    the plain version. Returns new (alpha, beta, delta, Wgrid)."""
    p, nind = X.shape
    c = phi.shape[1]
    if gumbel is None and zs is None:
        gumbel, zs = draw_sweep_normals(gen, p, c, Wgrid, estimate_delta)
    if X.device.type == "cpu":
        return sweep_rrm_abc_ref(X, phi, mphiphi, obs_mask, alpha, Wgrid, vare, Ginv,
                                 log_pi, gumbel, zs, estimate_delta)
    if X.device.type != "cuda":
        raise ValueError(f"sweep_rrm_abc: unsupported device {X.device}")
    dtype = Wgrid.dtype
    if p == 0:
        empty = torch.empty((c, 0), dtype=dtype, device=X.device)
        return empty, empty.clone(), empty.clone(), Wgrid.clone()
    if dtype not in _BUILDS:
        raise ValueError(f"sweep_rrm_abc: the grid must be float32 or float64, got {dtype}")
    ntimes, L = phi.shape[0], 2**c
    vare = vare.reshape(1)
    shapes = [("X", X, (p, nind)), ("phi", phi, (ntimes, c)),
              ("mphiphi", mphiphi, (p, c, c)), ("obs_mask", obs_mask, (ntimes, nind)),
              ("alpha", alpha, (c, p)), ("Wgrid", Wgrid, (ntimes, nind)),
              ("vare", vare, (1,)), ("Ginv", Ginv, (c, c)), ("log_pi", log_pi, (L,)),
              ("zs", zs, (p, c))]
    if estimate_delta:
        shapes.append(("gumbel", gumbel, (p, L)))
    for name, t, shape in shapes:
        if (tuple(t.shape) != shape or t.dtype is not dtype or t.device != X.device
                or not t.is_contiguous()):
            raise ValueError(
                f"sweep_rrm_abc: {name} must be a contiguous {dtype} {shape} on "
                f"{X.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    why = sweep_limit_error(nind, ntimes, c, dtype, X.device)
    if why is not None:
        raise ValueError(f"sweep_rrm_abc: {why}")
    lib = _build.library()
    ctas = lib.jt_rrm_sweep_ctas(nind, ntimes, c, X.element_size())
    a_out = torch.empty((c, p), dtype=dtype, device=X.device)
    b_out, d_out = torch.empty_like(a_out), torch.empty_like(a_out)
    W_out = torch.empty_like(Wgrid)
    partial = torch.empty(2 * ntimes * ctas, dtype=dtype, device=X.device)
    counter = torch.zeros(1, dtype=torch.int32, device=X.device)
    err = getattr(lib, _BUILDS[dtype])(
        X.data_ptr(), phi.data_ptr(), mphiphi.data_ptr(), obs_mask.data_ptr(),
        alpha.data_ptr(), Wgrid.data_ptr(), vare.data_ptr(), Ginv.data_ptr(),
        log_pi.data_ptr(), gumbel.data_ptr() if estimate_delta else None, zs.data_ptr(),
        a_out.data_ptr(), b_out.data_ptr(), d_out.data_ptr(), W_out.data_ptr(),
        partial.data_ptr(), counter.data_ptr(), p, nind, ntimes, c,
        int(bool(estimate_delta)), ctas, _build.stream_of(X))
    _build.check(err, "sweep_rrm_abc")
    sweep_rrm_abc.last_grid = (ctas, -(-nind // ctas))
    sweep_rrm_abc.launches += 1
    sweep_rrm_abc.launches_f64 += dtype == torch.float64
    return a_out, b_out, d_out, W_out


sweep_rrm_abc.launches = 0       # every launch
sweep_rrm_abc.launches_f64 = 0   # the float64 build's
sweep_rrm_abc.last_grid = None   # (blocks, individuals a block) of the last launch
