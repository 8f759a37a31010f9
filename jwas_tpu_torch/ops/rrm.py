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
individuals; a chunk of b markers a grid-wide exchange, the chunk's chain
against its cross-Grams, build_rrm_cross_grams and pack_cross_grams, made
once a run; float32 and float64 builds, c = 1..5, ntimes <= 32); on a CPU
tensor it is the plain version sweep_rrm_abc_ref, a loop over the markers.
sweep_rrm_abc_chunked_ref is the kernel's chunk algebra in plain PyTorch
(the tests hold it against sweep_rrm_abc_ref and jwas_tpu). The sweep's
draws are inputs (parity level (b)): a Gumbel (p, 2^c) and normals (p, c),
drawn by the wrapper from the chain's generator when not given, so every
version sees the same draws.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jwas_tpu_torch import _build
from jwas_tpu_torch.ops.grouped import full_precision_matmul

MAX_COEFF = 5        # K10 is instantiated for c = 1..5 (2^c <= 32 labels,
                     # one lane of a warp each)
MAX_TIMES = 32       # a cell's observation mask is a bit of a 32-bit word
MAX_CHUNK = 64       # K10's chunk b: a power of two, at most two markers a lane
_BATCH_BYTES = 1 << 28   # build_rrm_cross_grams' scaled copy of a batch of chunks
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


def build_rrm_cross_grams(X: torch.Tensor, phi: torch.Tensor, obs_mask: torch.Tensor,
                          b: int) -> torch.Tensor:
    """The cross-Grams of K10's chunks: X the (p, nind) marker-major store,
    phi (ntimes, c), obs_mask (ntimes, nind) 1/0, b the chunk (sweep_chunk
    on the card). Returns (ceil(p / b), b, b, c, c) in X's dtype on its
    device: for chunk q and its markers k <= s (the upper triangle), the
    block C_ks = sum_i x_ki x_si B_i with B_i = sum_t obs[t, i] phi_t
    phi_t' (so C_kk is build_m_phiphi's Gram and C_ks = C_sk, each block
    symmetric); zero below the diagonal and for the last chunk's padding
    markers. One torch.bmm a batch of chunks for each of B's c(c+1)/2
    entries, in full float32 (never TF32), the scaled copy of a batch
    within _BATCH_BYTES. A plain product outside any kernel, made once a
    run."""
    p, nind = X.shape
    c = phi.shape[1]
    B = torch.einsum("ti,tc,td->icd", obs_mask, phi, phi)            # (nind, c, c)
    nq = -(-p // b)
    out = torch.zeros((nq, b, b, c, c), dtype=X.dtype, device=X.device)
    upper = torch.triu(torch.ones((b, b), dtype=torch.bool, device=X.device))
    per = max(1, _BATCH_BYTES // max(1, b * nind * X.element_size()))
    with full_precision_matmul():
        for q0 in range(0, nq, per):
            q1 = min(nq, q0 + per)
            xs = X[q0 * b:q1 * b]
            if xs.shape[0] < (q1 - q0) * b:
                xs = torch.cat([xs, xs.new_zeros(((q1 - q0) * b - xs.shape[0], nind))])
            xb = xs.view(q1 - q0, b, nind)
            for a in range(c):
                for d in range(a, c):
                    G = torch.bmm(xb * B[:, a, d], xb.transpose(1, 2)) * upper
                    out[q0:q1, :, :, a, d] = G
                    out[q0:q1, :, :, d, a] = G
    return out


def pack_cross_grams(cross_grams: torch.Tensor) -> torch.Tensor:
    """K10's layout of build_rrm_cross_grams' (chunks, b, b, c, c): for
    each chunk, its b(b-1)/2 pairs k < s in row order (k, then s), each
    the c(c+1)/2 entries a <= d of C_ks in row order and zeros to a whole
    number of 8-byte words (the kernel stages a chunk's pairs into shared
    memory with 8-byte copies, as they lie): (chunks, b(b-1)/2, CS),
    contiguous, in cross_grams' dtype on its device. The chain reads no
    diagonal block (mpp a_old takes that term). Made once a run."""
    nq, b, _, c, _ = cross_grams.shape
    k, s = torch.triu_indices(b, b, offset=1, device=cross_grams.device)
    a, d = torch.triu_indices(c, c, device=cross_grams.device)
    words = 8 // cross_grams.element_size()
    out = cross_grams.new_zeros((nq, k.numel(), -(-a.numel() // words) * words))
    out[:, :, :a.numel()] = cross_grams[:, k, s][:, :, a, d]
    return out


def _chunk_of(packed: torch.Tensor) -> int:
    """The chunk b of packed cross-Grams: b(b-1)/2 pairs a chunk."""
    return (1 + int(round((1 + 8 * packed.shape[1]) ** 0.5))) // 2


def _label_factors(mphiphi, vare, Ginv, c: int, estimate_delta: bool):
    """Every marker's label factors, which do not depend on the residual,
    as one batched Cholesky: (D (labels, c), chol (p, labels, c, c), its
    log-determinants (p, labels))."""
    D = torch.as_tensor(_labels(c), dtype=mphiphi.dtype, device=mphiphi.device)
    if estimate_delta:
        lhs = (D[:, :, None] * D[:, None, :])[None] * mphiphi[:, None] / vare + Ginv
    else:
        lhs = (mphiphi / vare + Ginv)[:, None]
        D = D[-1:]
    chol = torch.linalg.cholesky(lhs)                                 # (p, L, c, c)
    logdet = 2.0 * torch.log(torch.abs(torch.diagonal(chol, dim1=2, dim2=3))).sum(2)
    return D, chol, logdet


def _draw_marker(xw, chol_j, logdet_j, D, vare, log_pi, gumbel_j, z_j, estimate_delta):
    """One marker's label and draw from its statistic xw (c,): (a, b, d)."""
    rhs = D * xw / vare                                               # (L, c)
    mu = torch.cholesky_solve(rhs[..., None], chol_j)[..., 0]
    if estimate_delta:
        logp = -0.5 * (logdet_j - (rhs * mu).sum(1)) + log_pi
        sel = torch.argmax(logp + gumbel_j)
    else:
        sel = 0
    b = mu[sel] + torch.linalg.solve_triangular(
        chol_j[sel].mT, z_j[:, None], upper=True)[:, 0]
    return D[sel] * b, b, D[sel]


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
    D, chol, logdet = _label_factors(mphiphi, vare, Ginv, c, estimate_delta)
    Wg = Wgrid.clone()
    a_in = alpha.T.contiguous()
    a_out = torch.empty((p, c), dtype=dtype, device=dev)
    b_out = torch.empty_like(a_out)
    d_out = torch.empty_like(a_out)
    for j in range(p):
        x, a_old = X[j], a_in[j]
        xw = phi.T @ (Wg @ x) + mphiphi[j] @ a_old
        a, b, d = _draw_marker(xw, chol[j], logdet[j], D, vare, log_pi,
                               gumbel[j] if estimate_delta else None, zs[j], estimate_delta)
        Wg += torch.outer(phi @ (a_old - a), x) * obs_mask
        a_out[j], b_out[j], d_out[j] = a, b, d
    return a_out.T.contiguous(), b_out.T.contiguous(), d_out.T.contiguous(), Wg


def sweep_rrm_abc_chunked_ref(X, phi, mphiphi, cross_grams, obs_mask, alpha, Wgrid, vare,
                              Ginv, log_pi, gumbel, zs, estimate_delta: bool = True):
    """K10's chunk algebra in plain PyTorch (tests only): the same chain as
    sweep_rrm_abc_ref, a chunk of b markers (cross_grams from
    build_rrm_cross_grams, (ceil(p / b), b, b, c, c)) at a time. With W0
    the grid at the chunk's start, marker k's statistic is
    xw_k = (phi' (W0 X_b'))_k + mpp_k a_old_k + acc_k, where acc_k gathers
    C_kj dA_j (dA_j = a_old_j - a_j) from the chunk's earlier markers j as
    they are drawn; the grid takes the chunk's changes at its end,
    Wg += ((phi dA') X_b) o obs_mask. Returns (alpha, beta, delta,
    Wgrid)."""
    p, c = X.shape[0], phi.shape[1]
    b = cross_grams.shape[1]
    dtype, dev = Wgrid.dtype, Wgrid.device
    D, chol, logdet = _label_factors(mphiphi, vare, Ginv, c, estimate_delta)
    Wg = Wgrid.clone()
    a_in = alpha.T.contiguous()
    a_out = torch.empty((p, c), dtype=dtype, device=dev)
    b_out = torch.empty_like(a_out)
    d_out = torch.empty_like(a_out)
    for j0 in range(0, p, b):
        n = min(b, p - j0)
        Xb, Cq = X[j0:j0 + n], cross_grams[j0 // b]
        base = (Wg @ Xb.T).T @ phi + (mphiphi[j0:j0 + n] @ a_in[j0:j0 + n, :, None])[..., 0]
        acc = torch.zeros((n, c), dtype=dtype, device=dev)
        dA = torch.empty((n, c), dtype=dtype, device=dev)
        for k in range(n):
            j = j0 + k
            a, bk, d = _draw_marker(base[k] + acc[k], chol[j], logdet[j], D, vare, log_pi,
                                    gumbel[j] if estimate_delta else None, zs[j],
                                    estimate_delta)
            dA[k] = a_in[j] - a
            acc[k + 1:] += Cq[k, k + 1:n] @ dA[k]
            a_out[j], b_out[j], d_out[j] = a, bk, d
        Wg += ((phi @ dA.T) @ Xb) * obs_mask
    return a_out.T.contiguous(), b_out.T.contiguous(), d_out.T.contiguous(), Wg


def sweep_plan(nind: int, ntimes: int, c: int, dtype, device,
               max_chunk: int = MAX_CHUNK) -> tuple:
    """K10's plan on a CUDA device (jt_rrm_sweep_plan): (blocks,
    individuals a block, chunk b, tile of individuals): b the largest
    power of two <= max_chunk (itself a power of two <= 64) that fits a
    block's shared memory beside its slice of the grid, the tile the
    slice itself where its genotype rows of a chunk fit, else 256 .. 32
    (the rows read in tiles). Blocks 0 when nothing fits. Raises on a CUDA
    error."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = _build.library().jt_rrm_sweep_plan(
            nind, ntimes, c, torch.empty((), dtype=dtype).element_size(), max_chunk, out)
    _build.check(err, "sweep_rrm_abc: the device's plan")
    return tuple(out)


def _shape_error(ntimes: int, c: int):
    if not 1 <= c <= MAX_COEFF:
        return f"{c} Legendre coefficients (K10 takes 1 to {MAX_COEFF})"
    if not 1 <= ntimes <= MAX_TIMES:
        return f"{ntimes} time points (K10 takes 1 to {MAX_TIMES})"
    return None


def _slice_error(nind: int, ntimes: int) -> str:
    return (f"{nind} individuals at {ntimes} time points (a block's slice of the grid "
            f"exceeds its shared memory)")


def sweep_limit_error(nind: int, ntimes: int, c: int, dtype, device):
    """Why K10 cannot take this sweep on device, or None: c above
    MAX_COEFF or ntimes above MAX_TIMES (every device: the port's limits),
    or on a CUDA device a block's slice of the individuals (its columns
    of the grid and its mask words, beside a chunk of one marker) above
    the block's shared memory (sweep_plan): on an H100 80GB HBM3 (132
    blocks) at 10 time points and c = 3, 691,680 individuals in float32
    and 359,436 in float64 (chip_smoke.py phase 2)."""
    why = _shape_error(ntimes, c)
    if (why is None and torch.device(device).type == "cuda"
            and sweep_plan(nind, ntimes, c, dtype, device)[0] == 0):
        why = _slice_error(nind, ntimes)
    return why


def sweep_chunk(nind: int, ntimes: int, c: int, dtype, device,
                max_chunk: int = MAX_CHUNK) -> int:
    """K10's chunk b on a CUDA device (sweep_plan's): the cross-Grams are
    built for it (a smaller max_chunk serves a timing of smaller chunks).
    Raises where sweep_limit_error refuses the shape."""
    why = _shape_error(ntimes, c)
    if why is None:
        ctas, _, b, _ = sweep_plan(nind, ntimes, c, dtype, device, max_chunk)
        if ctas:
            return b
        why = _slice_error(nind, ntimes)
    raise ValueError(f"sweep_rrm_abc: {why}")


def _launch(X, phi, mphiphi, cross_grams, obs_mask, alpha, Wgrid, vare, Ginv, log_pi,
            gumbel, zs, estimate_delta: bool, probe: int = 0):
    """One launch of K10 on CUDA tensors (the shapes are the caller's
    checks) on the plan (sweep_plan, made once here) for cross_grams'
    chunk b: raises where the plan refuses the shape or takes another b.
    Returns (alpha, beta, delta, Wgrid). probe != 0 skips parts of each
    chunk (bits: 1 its steps, 2 the wait on the counter, 4 the loads of
    the blocks' partials, 8 the next chunk's inputs made during the chain;
    csrc/rrm_sweep.cu) and leaves the outputs undefined: chip_smoke.py
    times the exchange and the step apart with it."""
    p, nind = X.shape
    ntimes, c = phi.shape
    dtype = Wgrid.dtype
    b = _chunk_of(cross_grams)
    ctas, slice_, planned, xt = sweep_plan(nind, ntimes, c, dtype, X.device, b)
    if ctas == 0:
        raise ValueError(f"sweep_rrm_abc: {_slice_error(nind, ntimes)}")
    if planned != b:
        raise ValueError(f"sweep_rrm_abc: cross_grams {tuple(cross_grams.shape)} are packed for "
                         f"a chunk of {b}, which K10 cannot take here (sweep_chunk: {planned})")
    a_out = torch.empty((c, p), dtype=dtype, device=X.device)
    b_out, d_out = torch.empty_like(a_out), torch.empty_like(a_out)
    W_out = torch.empty_like(Wgrid)
    partial = torch.empty(2 * ctas * c * b, dtype=dtype, device=X.device)
    counter = torch.zeros(1, dtype=torch.int32, device=X.device)
    err = getattr(_build.library(), _BUILDS[dtype])(
        X.data_ptr(), phi.data_ptr(), mphiphi.data_ptr(), cross_grams.data_ptr(),
        obs_mask.data_ptr(), alpha.data_ptr(), Wgrid.data_ptr(), vare.data_ptr(),
        Ginv.data_ptr(), log_pi.data_ptr(), gumbel.data_ptr() if estimate_delta else None,
        zs.data_ptr(), a_out.data_ptr(), b_out.data_ptr(), d_out.data_ptr(), W_out.data_ptr(),
        partial.data_ptr(), counter.data_ptr(), p, nind, ntimes, c, int(bool(estimate_delta)),
        ctas, slice_, b, xt, probe, _build.stream_of(X))
    _build.check(err, "sweep_rrm_abc")
    sweep_rrm_abc.last_grid = (ctas, slice_, b, xt)
    return a_out, b_out, d_out, W_out


def sweep_rrm_abc(X, phi, mphiphi, obs_mask, alpha, Wgrid, vare, Ginv, log_pi,
                  gen: torch.Generator, estimate_delta: bool = True, gumbel=None,
                  zs=None, cross_grams=None):
    """One pass of the marker chain (see sweep_rrm_abc_ref; jwas_tpu's
    takes beta and delta too and ignores them). gumbel, zs: the sweep's
    draws (tests inject the JAX package's), else drawn from gen
    (draw_sweep_normals). CUDA tensors launch K10 (and raise if it cannot
    run) with its scratch, a double-buffered (2, blocks, c, b) buffer of
    the blocks' partial sums and a zeroed arrival counter; they need
    cross_grams, pack_cross_grams(build_rrm_cross_grams(X, phi, obs_mask,
    sweep_chunk(...))), which a chain makes once (a chunk below
    sweep_chunk's, a power of two, serves as well). CPU tensors take the
    plain version and ignore cross_grams. Returns new (alpha, beta, delta,
    Wgrid)."""
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
    why = _shape_error(ntimes, c)
    if why is not None:
        raise ValueError(f"sweep_rrm_abc: {why}")
    b = _chunk_of(cross_grams) if cross_grams is not None and cross_grams.dim() == 3 else 0
    if b < 1 or b > MAX_CHUNK or b & (b - 1):
        raise ValueError("sweep_rrm_abc: K10 needs cross_grams packed for a chunk it can take "
                         "(build_rrm_cross_grams at sweep_chunk's b, pack_cross_grams), got "
                         f"{None if cross_grams is None else tuple(cross_grams.shape)}")
    words = 8 // X.element_size()
    vare = vare.reshape(1)
    shapes = [("X", X, (p, nind)), ("phi", phi, (ntimes, c)),
              ("mphiphi", mphiphi, (p, c, c)), ("obs_mask", obs_mask, (ntimes, nind)),
              ("alpha", alpha, (c, p)), ("Wgrid", Wgrid, (ntimes, nind)),
              ("vare", vare, (1,)), ("Ginv", Ginv, (c, c)), ("log_pi", log_pi, (L,)),
              ("zs", zs, (p, c)),
              ("cross_grams", cross_grams,
               (-(-p // b), b * (b - 1) // 2, -(-(c * (c + 1) // 2) // words) * words))]
    if estimate_delta:
        shapes.append(("gumbel", gumbel, (p, L)))
    for name, t, shape in shapes:
        if (tuple(t.shape) != shape or t.dtype is not dtype or t.device != X.device
                or not t.is_contiguous()):
            raise ValueError(
                f"sweep_rrm_abc: {name} must be a contiguous {dtype} {shape} on "
                f"{X.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = _launch(X, phi, mphiphi, cross_grams, obs_mask, alpha, Wgrid, vare, Ginv, log_pi,
                  gumbel, zs, estimate_delta)
    sweep_rrm_abc.launches += 1
    sweep_rrm_abc.launches_f64 += dtype == torch.float64
    return out


sweep_rrm_abc.launches = 0       # every launch
sweep_rrm_abc.launches_f64 = 0   # the float64 build's
sweep_rrm_abc.last_grid = None   # the last launch's plan (blocks, individuals a block, chunk b,
                                 # tile of individuals: below the second, rows read in tiles)
