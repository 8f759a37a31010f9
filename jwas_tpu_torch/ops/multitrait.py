"""Multi-trait marker samplers: the marker updates of BayesC / BayesB's
samplers I and II and of RR-BLUP / BayesL, their plain inner chains, the
group-sequential sweeps over a dense store, and multi-trait GBLUP.

Counterpart of jwas_tpu/ops/multitrait.py: _take_logpi (:38, a global
(2^t,) log pi or one row a marker, take_log_pi), pattern_index and all_patterns (:46-56), the marker updates
_mt_abc_marker_update_I (:64) and _mt_abc_marker_update_II (:274), and
the blocked sweeps mt_abc_blocks_I (:162) / mt_abc_blocks_II (:308) walked
over groups as jwas_tpu/engine/mcmc_mt.py:263-299 walks them through
grouped_dense_sweep. The exact forms mt_abc_exact_I / _II (:230, :370) are
the same grouped sweep over a store of one block a group with nreps = 1
(ops/dense.py), their panels served in marker order by
ops/dense.py::sweep_draws.

The kernels run the chain on a window schedule (32 markers of a block
evaluated together); ops/inner_rounds.py::mt_abc_inner_rounds_window_ref
models it and equals mt_abc_inner_rounds_ref bit for bit.

RR-BLUP / BayesL: _mt_c0l_marker_update (:414) as mt_c0l_marker_update_ref,
the chain of mt_c0l_blocks (:436, its scan :467) as
mt_c0l_inner_rounds_ref, the plain version of K9 (csrc/mt_c0l_rounds.cu:
every slab draw changes an effect, so the chain is serial; the trait loop
runs as a per-marker affine map, mt_c0l_constants, whose constants do not
depend on the chain), and the grouped sweep
sweep_blocks_mt_c0l_grouped; the exact form mt_c0l_exact (:478) is that
sweep over a store of one block a group with nreps = 1. GBLUP: mt_gblup
(:508), batched t x t algebra over the pseudo-markers, no chain.

A joint inclusion pattern s = sum_k delta_k 2^k (bit k = trait k) indexes
log_pi, (2^t,). Marker state is (t, p_pad) as in the JAX package; a group
round gathers it into the kernels' block-major layout (gb, t, b).

The plain versions do their arithmetic one operation at a time, in the
order of the CUDA kernels K7 and K8 (csrc/mt_inner_rounds.cu), which round
every product and sum on its own (no fused multiply-add): on the card the
kernel and its plain version give the same bits. Sampler II's (t, t)
algebra is a Cholesky factorisation of each pattern's LHS (its inverse and
log-determinant), where the JAX package takes LU; the draw uses the
Cholesky factor of the inverse, as the reference does (:299), so the same
normals give the same effects.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from jwas_tpu_torch.ops import inner_rounds as ir
from jwas_tpu_torch.ops import grouped as gr

MAX_TRAITS = 8          # K7, K8 and K9 are instantiated for t = 2..8
MAX_PRIOR_TRAITS = 4    # K7 and K8 with a per-marker prior for t = 2..4
MAX_BLOCK = 2048        # and take b <= 256 threads x 8 markers a thread
KERNEL_OF = {"I": "K7", "II": "K8", "C0L": "K9"}   # sampler -> its chain
SCRATCH_SHARE = 0.25    # their constants' scratch: at most this of the card


def pattern_index(delta):
    """(t, ...) 0/1 indicators -> integer pattern index, bit k = trait k."""
    t = delta.shape[0]
    w = (2 ** torch.arange(t, device=delta.device)).reshape((t,) + (1,) * (delta.dim() - 1))
    return (w * delta.to(torch.int64)).sum(0)


def all_patterns(t: int, dtype=torch.float32, device=None):
    """(2^t, t) matrix of the patterns in canonical order."""
    s = torch.arange(2 ** t, device=device)
    return ((s[:, None] >> torch.arange(t, device=device)[None, :]) & 1).to(dtype)


def log_pattern_prior(pi, dtype):
    """log of the (2^t,) pattern priors, clipped to [1e-12, 1] first."""
    return torch.log(torch.clamp(pi.to(dtype), 1e-12, 1.0))


def take_log_pi(log_pi, idx):
    """The pattern priors log_pi[idx] (B,): a global (2^t,) log_pi or one
    row a marker (B, 2^t) (_take_logpi, GlobalPiPrior /
    MarkerSpecificPiPrior, MTBayesABC.jl:6-18)."""
    if log_pi.dim() == 2:
        return log_pi.gather(1, idx[:, None])[:, 0]
    return log_pi[idx]


def _ginv_entry(Ginv, a: int, c: int):
    """Ginv[a, c]: a 0-d tensor of a shared (t, t) Ginv, a (B,) one of a
    per-locus (B, t, t)."""
    return Ginv[a, c] if Ginv.dim() == 2 else Ginv[:, a, c]


def mt_marker_update_I_ref(w, beta, delta, alpha, xpx, Rinv, Ginv, log_pi, u, z):
    """Sampler I's trait loop for one marker of each of B blocks
    (_mt_abc_marker_update_I, MTBayesABC.jl:85-120).

    w, beta, delta, alpha, u, z: (B, t); xpx: (B,); Rinv (t, t); Ginv
    (t, t) or per-locus (B, t, t); log_pi (2^t,) or one row a marker
    (B, 2^t). Trait k, in order: its
    inclusion from the two-state log-odds with the pattern prior at the
    other traits' current indicators, then its effect from the included or
    excluded conditional, given the other traits' current effects.
    Returns new (beta, delta, alpha), (B, t)."""
    t = w.shape[1]
    beta = list(beta.unbind(1))
    delta = list(delta.unbind(1))
    alpha = list(alpha.unbind(1))
    w = w.unbind(1)
    one = torch.ones((), dtype=xpx.dtype, device=xpx.device)
    for k in range(t):
        nok = [m for m in range(t) if m != k]
        g_kk = _ginv_entry(Ginv, k, k)
        acc0 = c12 = None
        for m in nok:
            g_km = _ginv_entry(Ginv, k, m)
            gb = g_km * beta[m]
            term = (g_km + xpx * delta[m] * Rinv[k, m]) * beta[m]
            acc0 = gb if acc0 is None else acc0 + gb
            c12 = term if c12 is None else c12 + term
        rhs0 = -acc0
        c11 = g_kk + Rinv[k, k] * xpx
        inv_lhs0 = one / g_kk
        g_hat0 = rhs0 * inv_lhs0
        inv_lhs1 = one / c11
        rw = w[0] * Rinv[0, k]
        for m in range(1, t):
            rw = rw + w[m] * Rinv[m, k]
        g_hat1 = (rw - c12) * inv_lhs1
        idx0 = sum(delta[m].to(torch.int64) * (1 << m) for m in nok)
        lp0, lp1 = take_log_pi(log_pi, idx0), take_log_pi(log_pi, idx0 + (1 << k))
        log_d0 = -0.5 * (torch.log(g_kk) - g_hat0 * g_hat0 * g_kk) + lp0
        log_d1 = -0.5 * (torch.log(c11) - g_hat1 * g_hat1 * c11) + lp1
        prob1 = one / (one + torch.exp(log_d0 - log_d1))
        inc = u[:, k] < prob1
        beta[k] = torch.where(inc, g_hat1 + z[:, k] * torch.sqrt(inv_lhs1),
                              g_hat0 + z[:, k] * torch.sqrt(inv_lhs0))
        delta[k] = inc.to(xpx.dtype)
        alpha[k] = torch.where(inc, beta[k], 0.0 * one)
    return torch.stack(beta, 1), torch.stack(delta, 1), torch.stack(alpha, 1)


def _cholesky(A: List[List[torch.Tensor]]):
    """Lower Cholesky factor of a symmetric positive definite (t, t) matrix
    held as nested lists of equally shaped tensors, one operation at a
    time in K8's order."""
    t = len(A)
    L = [[None] * t for _ in range(t)]
    for j in range(t):
        s = A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, t):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    return L


def _spd_inverse(L):
    """(inverse, log-determinant) of L L' from its Cholesky factor L: the
    inverse as Linv' Linv, exactly symmetric, the log-determinant as
    2 sum log L_ii."""
    t = len(L)
    Li = [[None] * t for _ in range(t)]
    for c in range(t):
        Li[c][c] = 1.0 / L[c][c]
        for i in range(c + 1, t):
            s = L[i][c] * Li[c][c]
            for k in range(c + 1, i):
                s = s + L[i][k] * Li[k][c]
            Li[i][c] = -s / L[i][i]
    inv = [[None] * t for _ in range(t)]
    for a in range(t):
        for c in range(t):
            k0 = max(a, c)
            s = Li[k0][a] * Li[k0][c]
            for k in range(k0 + 1, t):
                s = s + Li[k][a] * Li[k][c]
            inv[a][c] = s
    ld = torch.log(L[0][0])
    for i in range(1, t):
        ld = ld + torch.log(L[i][i])
    return inv, 2.0 * ld


def mt_marker_update_II_ref(w, xpx, Rinv, Ginv, log_pi, gum, z):
    """Sampler II's joint update over the 2^t patterns for one marker of
    each of B blocks (_mt_abc_marker_update_II, MTBayesABC.jl:165-209).

    w, z: (B, t); xpx (B,); Rinv (t, t); Ginv (t, t) or per-locus
    (B, t, t); log_pi (2^t,) or one row a marker (B, 2^t); gum (B, 2^t)
    Gumbel noise. Pattern s has
    LHS D_s Rinv D_s xpx + Ginv and rhs D_s Rinv w; its log weight is
    -(logdet - rhs' g_hat) / 2 + log pi_s, g_hat = LHS^-1 rhs. The pattern
    is the first argmax of log weight + Gumbel, and beta = g_hat +
    chol(LHS^-1) z. Returns new (beta, delta, alpha), (B, t)."""
    B, t = w.shape
    S = 1 << t
    dev = w.device
    pat = all_patterns(t, torch.bool, dev)                   # (S, t)
    wl = w.unbind(1)
    rw = []
    for i in range(t):
        acc = wl[0] * Rinv[0, i]
        for j in range(1, t):
            acc = acc + wl[j] * Rinv[j, i]
        rw.append(acc)
    zero = torch.zeros((), dtype=w.dtype, device=dev)
    both = [[(pat[:, a] & pat[:, c])[:, None] for c in range(t)] for a in range(t)]
    lhs = [[torch.where(both[a][c], Rinv[a, c] * xpx + _ginv_entry(Ginv, a, c),
                        _ginv_entry(Ginv, a, c).expand(B)).expand(S, B)
            for c in range(t)] for a in range(t)]                  # (S, B) each
    rhs = [torch.where(pat[:, i, None], rw[i], zero) for i in range(t)]
    inv, logdet = _spd_inverse(_cholesky(lhs))
    g = []
    for a in range(t):
        acc = inv[a][0] * rhs[0]
        for c in range(1, t):
            acc = acc + inv[a][c] * rhs[c]
        g.append(acc)
    quad = rhs[0] * g[0]
    for a in range(1, t):
        quad = quad + rhs[a] * g[a]
    lp = log_pi.T if log_pi.dim() == 2 else log_pi[:, None]
    score = -0.5 * (logdet - quad) + lp + gum.T                   # (S, B)
    which = torch.argmax(score, dim=0)                            # (B,)
    cols = torch.arange(B, device=dev)
    C = _cholesky([[inv[a][c][which, cols] for c in range(t)] for a in range(t)])
    zl = z.unbind(1)
    beta = []
    for a in range(t):
        acc = C[a][0] * zl[0]
        for c in range(1, a + 1):
            acc = acc + C[a][c] * zl[c]
        beta.append(g[a][which, cols] + acc)
    beta = torch.stack(beta, 1)
    delta = pat[which].to(w.dtype)
    return beta, delta, beta * delta


def mt_abc_inner_rounds_ref(sampler: str, grams, xpx, valid, alpha, beta,
                            delta, rhs, Rinv, Ginv, log_pi, draw_a, zs,
                            nreps: int):
    """Plain version of K7 (sampler "I": draw_a the uniforms us) and K8
    ("II": draw_a the Gumbel panel gum): nreps rounds of each block's chain
    of b dependent marker steps, all gb blocks at once.

    grams (gb, b, b); xpx, valid (gb, b); alpha, beta, delta, rhs
    (gb, t, b), updated in place and returned; Rinv (t, t); Ginv (t, t) or
    (gb, b, t, t); log_pi (2^t,) or one row a marker (gb, b, 2^t); us, zs
    (nreps b, t, gb); gum
    (nreps b, 2^t, gb). Step j: w = rhs_j + xpx_j a_old, the marker update,
    alpha and delta masked by valid (beta is not), then rhs += (a_old -
    a_new) times Gram row j."""
    b = grams.shape[1]
    per_locus = Ginv.dim() == 4
    for s in range(nreps * b):
        j = s % b
        a_old = alpha[:, :, j].clone()
        x_j = xpx[:, j]
        w = rhs[:, :, j] + x_j[:, None] * a_old
        g_j = Ginv[:, j] if per_locus else Ginv
        lp_j = log_pi[:, j] if log_pi.dim() == 3 else log_pi
        if sampler == "I":
            b_new, d_new, a_new = mt_marker_update_I_ref(
                w, beta[:, :, j], delta[:, :, j], a_old, x_j, Rinv, g_j,
                lp_j, draw_a[s].T, zs[s].T)
        else:
            b_new, d_new, a_new = mt_marker_update_II_ref(
                w, x_j, Rinv, g_j, lp_j, draw_a[s].T, zs[s].T)
        v = valid[:, j, None]
        a_new = a_new * v
        beta[:, :, j] = b_new
        delta[:, :, j] = d_new * v
        alpha[:, :, j] = a_new
        rhs.add_((a_old - a_new)[:, :, None] * grams[:, j, None, :])
    return alpha, beta, delta, rhs


def _blocked(x, t: int, gb: int, b: int):
    """(t, G) group slice -> (gb, t, b) contiguous."""
    return x.reshape(t, gb, b).transpose(0, 1).contiguous()


def sweep_blocks_mt_abc_grouped(gm, alpha, beta, delta, ycorr, R, ginv, pi,
                                gen: Optional[torch.Generator],
                                sampler: str = "I", nreps: int = 1,
                                sync_every: Optional[int] = None,
                                draws: Optional[Callable] = None):
    """Group-sequential multi-trait BayesC / BayesB sweep over a dense
    store (mt_abc_blocks_I / _II under grouped_dense_sweep).

    alpha, beta, delta (t, p_pad) and ycorr (t, n_obs) in the store's
    dtype are updated in place and returned. R (t, t) residual covariance;
    ginv (t, t) inverse marker-effect covariance (BayesC) or (p_pad, t, t)
    one a locus (BayesB); pi (2^t,) pattern priors, or (p_pad, 2^t) one row
    a marker (2-trait annotated BayesC; t <= MAX_PRIOR_TRAITS, the padding's
    rows [1, 0, ...]). Round r of group g takes
    its panels from draws(g, r, reps) when given (tests inject the JAX
    package's): for sampler "I" (us, zs), for "II" (gum, zs), each
    (reps b, t or 2^t, gb); else from gen, in group and round order. A
    round gathers the group's state into (gb, t, b), runs K7 or K8 on its
    (gb, t, b) rhs, and scatters it back."""
    if sampler not in ("I", "II"):
        raise ValueError(f"sampler must be 'I' or 'II', got {sampler!r}")
    t = alpha.shape[0]
    nblocks, b, _ = gm.grams.shape
    gb = nblocks // gm.ngroups
    G = gb * b
    dtype = alpha.dtype
    # the kernels read row-major (t, t) matrices: torch.linalg.inv returns
    # column-major ones on a CUDA device
    Rinv = torch.linalg.inv(R).contiguous()
    ginv = ginv.contiguous()
    log_pi = log_pattern_prior(pi, dtype)
    per_marker = log_pi.dim() == 2
    per_locus = ginv.dim() == 3
    xpx_b, valid_b = gm.xpx.view(nblocks, b), gm.valid.view(nblocks, b)
    kernel = ir.mt_abc_inner_rounds_I if sampler == "I" else ir.mt_abc_inner_rounds_II
    if draws is None:
        f = dict(dtype=dtype, device=ycorr.device)

        def draws(g, r, reps):
            if sampler == "I":
                a = torch.rand((reps * b, t, gb), generator=gen, **f)
            else:
                a = gr.gumbel_panel((reps * b, 1 << t, gb), gen, ycorr.device, dtype)
            return a, torch.randn((reps * b, t, gb), generator=gen, **f)

    def round_fn(g, r, reps, rhs):
        cols = slice(g * G, (g + 1) * G)
        blk = slice(g * gb, (g + 1) * gb)
        a_g = _blocked(alpha[:, cols], t, gb, b)
        a_start = a_g.clone()
        b_g = _blocked(beta[:, cols], t, gb, b)
        d_g = _blocked(delta[:, cols], t, gb, b)
        g_g = ginv[cols].view(gb, b, t, t) if per_locus else ginv
        lp_g = log_pi[cols].view(gb, b, 1 << t) if per_marker else log_pi
        rhs_g = rhs.view(gb, b, t).transpose(1, 2).contiguous()
        draw_a, zs = draws(g, r, reps)
        kernel(gm.grams[blk], xpx_b[blk], valid_b[blk], a_g, b_g, d_g, rhs_g,
               Rinv, g_g, lp_g, draw_a, zs, reps)
        for state, new in ((alpha, a_g), (beta, b_g), (delta, d_g)):
            state[:, cols] = new.transpose(0, 1).reshape(t, G)
        return (a_start - a_g).transpose(1, 2).reshape(G, t)

    gr.walk_groups(gm, ycorr, nreps, sync_every, round_fn)
    return alpha, beta, delta, ycorr


# ------------------------------------------------------ RR-BLUP / BayesL


def mt_c0l_constants(xpx, Rinv, Ginv, gamma, valid):
    """A marker's constants of the RR-BLUP / BayesL update as an affine map,
    as K9's prologue computes them, for xpx, gamma and valid of shape (...).

    With Lhs = xpx Rinv + Ginv / gamma = D + L + U (its diagonal, strictly
    lower and strictly upper parts) and T = D + L, the reference's trait
    loop (for k in order: a[k] = (Rhs_k - sum_m Lhs[k, m] a[m]) / Lhs_kk +
    a[k] + z_k sqrt(1 / Lhs_kk), Rhs = Rinv (rhs + xpx a_old)) is exactly
    T a_new = Rinv rhs + (xpx Rinv - U) a_old + e o z with e_k = Lhs_kk
    sqrt(1 / Lhs_kk). Returns (P, Q, S), each (..., t, t): P = T^-1 Rinv,
    Q = T^-1 (xpx Rinv - U) (above the diagonal -Ginv / gamma), S = T^-1
    diag(e), each by forward substitution (row k: the right-hand side,
    minus Lhs[k, q] X[q] for q < k in order, over Lhs_kk) and multiplied by
    valid, so that a padding marker's effect is 0. Then a_new = P rhs + c
    with c = Q a_old + S z (mt_c0l_marker_update_ref)."""
    t = Rinv.shape[0]
    x_rinv = xpx[..., None, None] * Rinv
    g_gam = Ginv / gamma[..., None, None]
    lhs = x_rinv + g_gam
    one = torch.ones((), dtype=lhs.dtype, device=lhs.device)
    diag = torch.diagonal(lhs, dim1=-2, dim2=-1)
    e = diag * torch.sqrt(torch.div(one, diag))
    upper = torch.ones(t, t, dtype=torch.bool, device=lhs.device).triu(1)

    def solve(B):                       # T X = B, row by row
        X = []
        for k in range(t):
            acc = B[..., k, :]
            for q in range(k):
                acc = acc - lhs[..., k, q, None] * X[q]
            X.append(acc / diag[..., k, None])
        return torch.stack(X, -2)

    v = valid[..., None, None]
    P = solve(Rinv.expand(lhs.shape))
    Q = solve(torch.where(upper, -g_gam, x_rinv))
    S = solve(torch.diag_embed(e))
    return P * v, Q * v, S * v


def mt_c0l_offset(Q, S, alpha, z):
    """c = Q a_old + S z for one marker of each of B blocks: Q, S (B, t, t),
    alpha and z (B, t); c_k = (sum_m Q[k, m] a[m]) + (sum_m S[k, m] z[m]),
    each sum in ascending m. Returns (B, t)."""
    t = alpha.shape[1]
    out = []
    for k in range(t):
        qa = Q[:, k, 0] * alpha[:, 0]
        sz = S[:, k, 0] * z[:, 0]
        for m in range(1, t):
            qa = qa + Q[:, k, m] * alpha[:, m]
            sz = sz + S[:, k, m] * z[:, m]
        out.append(qa + sz)
    return torch.stack(out, 1)


def mt_c0l_marker_update_ref(rhs, alpha, P, Q, S, z):
    """The multi-trait RR-BLUP / BayesL update of one marker of each of B
    blocks (_mt_c0l_marker_update, MTBayesC0L.jl:31-50, with w = rhs + xpx
    a_old) as the affine map of mt_c0l_constants: a_new_k = (sum_m P[k, m]
    rhs[m], ascending m) + c_k, c = mt_c0l_offset(Q, S, alpha, z).

    rhs, alpha, z: (B, t); P, Q, S (B, t, t). Returns the new alpha, (B, t)
    (0 where the constants carry valid 0)."""
    return mt_c0l_map(P, rhs, mt_c0l_offset(Q, S, alpha, z))


def mt_c0l_map(P, rhs, c):
    """The chain's part of a step: a_new_k = (sum_m P[k, m] rhs[m],
    ascending m) + c_k; P (B, t, t), rhs and c (B, t)."""
    t = rhs.shape[1]
    out = []
    for k in range(t):
        acc = P[:, k, 0] * rhs[:, 0]
        for m in range(1, t):
            acc = acc + P[:, k, m] * rhs[:, m]
        out.append(acc + c[:, k])
    return torch.stack(out, 1)


def mt_c0l_inner_rounds_ref(grams, xpx, valid, alpha, rhs, Rinv, Ginv, gamma, zs,
                            nreps: int):
    """Plain version of K9: nreps rounds of each block's chain of b
    dependent RR-BLUP / BayesL marker steps, all gb blocks at once, in the
    layout of mt_abc_inner_rounds_ref.

    grams (gb, b, b); xpx, valid, gamma (gb, b) (gamma ones for RR-BLUP);
    alpha, rhs (gb, t, b), updated in place and returned; Rinv, Ginv
    (t, t); zs (nreps b, t, gb). Step j: the affine map of
    mt_c0l_marker_update_ref on rhs_j (valid folded into its constants),
    then rhs += (a_old - a_new) times Gram row j."""
    b = grams.shape[1]
    P, Q, S = mt_c0l_constants(xpx, Rinv, Ginv, gamma, valid)    # (gb, b, t, t) each
    for s in range(nreps * b):
        j = s % b
        a_old = alpha[:, :, j].clone()
        a_new = mt_c0l_marker_update_ref(rhs[:, :, j], a_old, P[:, j], Q[:, j], S[:, j],
                                         zs[s].T)
        alpha[:, :, j] = a_new
        rhs.add_((a_old - a_new)[:, :, None] * grams[:, j, None, :])
    return alpha, rhs


def sweep_blocks_mt_c0l_grouped(gm, alpha, ycorr, R, ginv, gamma,
                                gen: Optional[torch.Generator], nreps: int = 1,
                                sync_every: Optional[int] = None,
                                draws: Optional[Callable] = None):
    """Group-sequential multi-trait RR-BLUP / BayesL sweep over a dense
    store (mt_c0l_blocks under grouped_dense_sweep).

    alpha (t, p_pad) and ycorr (t, n_obs) in the store's dtype are updated
    in place and returned. R (t, t) residual covariance; ginv (t, t)
    inverse marker-effect covariance; gamma (p_pad,) BayesL's local
    shrinkage (None: RR-BLUP, every gamma 1). Round r of group g takes its
    (reps b, t, gb) normal panel from draws(g, r, reps) -> (zs,) when given
    (tests inject the JAX package's), else from gen, in group and round
    order. A round gathers the group's alpha into (gb, t, b), runs K9 on
    its (gb, t, b) rhs, and scatters it back."""
    t = alpha.shape[0]
    nblocks, b, _ = gm.grams.shape
    gb = nblocks // gm.ngroups
    G = gb * b
    dtype = alpha.dtype
    # K9 reads row-major (t, t) matrices: torch.linalg.inv returns
    # column-major ones on a CUDA device
    Rinv = torch.linalg.inv(R).contiguous()
    ginv = ginv.contiguous()
    xpx_b, valid_b = gm.xpx.view(nblocks, b), gm.valid.view(nblocks, b)
    gamma_b = (torch.ones((nblocks, b), dtype=dtype, device=alpha.device)
               if gamma is None else gamma.view(nblocks, b))
    if draws is None:
        def draws(g, r, reps):
            return (torch.randn((reps * b, t, gb), generator=gen, dtype=dtype,
                                device=ycorr.device),)

    def round_fn(g, r, reps, rhs):
        cols = slice(g * G, (g + 1) * G)
        blk = slice(g * gb, (g + 1) * gb)
        a_g = _blocked(alpha[:, cols], t, gb, b)
        a_start = a_g.clone()
        rhs_g = rhs.view(gb, b, t).transpose(1, 2).contiguous()
        (zs,) = draws(g, r, reps)
        ir.mt_c0l_inner_rounds(gm.grams[blk], xpx_b[blk], valid_b[blk], a_g, rhs_g,
                               Rinv, ginv, gamma_b[blk].contiguous(), zs, reps)
        alpha[:, cols] = a_g.transpose(0, 1).reshape(t, G)
        return (a_start - a_g).transpose(1, 2).reshape(G, t)

    gr.walk_groups(gm, ycorr, nreps, sync_every, round_fn)
    return alpha, ycorr


# ------------------------------------------------------------------- GBLUP


def mt_gblup(gm, alpha, ycorr, R, varg, gen: Optional[torch.Generator], z=None):
    """Multi-trait GBLUP on the eigenbasis (jwas_tpu's mt_gblup, GBLUP.jl:
    52-72): every pseudo-marker's (t,) effect drawn jointly, one batched
    (t, t) inverse and Cholesky factor over the m pseudo-markers, exact
    because L is orthogonal.

    gm: a GBLUPMarkers (L (n_obs, m), D (m,), rinv); alpha (t, m) and ycorr
    (t, n_obs) are updated in place and returned; R, varg (t, t). ycorr +=
    L alpha; RHS = (L' diag(rinv) ycorr') R^-1 (m, t); lhs_i = R^-1 rinv_i
    + varg^-1 / D_i (rinv[:m], the reference's pairing of a pseudo-marker
    with an observation's weight); Sigma = lhs^-1 symmetrised; alpha =
    Sigma RHS + chol(Sigma) z; ycorr -= L alpha. z (m, t) standard normals
    (tests inject the JAX package's), else drawn from gen."""
    from jwas_tpu_torch.ops.grouped import full_precision_matmul

    t, m = alpha.shape
    L, D = gm.L, gm.D
    rv = (torch.ones(ycorr.shape[1], dtype=alpha.dtype, device=alpha.device)
          if gm.rinv is None else gm.rinv)
    iR0 = torch.linalg.inv(R)
    iGM = torch.linalg.inv(varg)
    with full_precision_matmul():
        ycorr += alpha @ L.T
        RHS = (L.T @ (ycorr * rv).T) @ iR0                        # (m, t)
        lhs = iR0 * rv[:m, None, None] + iGM / D[:, None, None]
        sigma = torch.linalg.inv(lhs)
        sigma = 0.5 * (sigma + sigma.transpose(-1, -2))
        mu = torch.einsum("mij,mj->mi", sigma, RHS)
        if z is None:
            z = torch.randn((m, t), generator=gen, dtype=alpha.dtype, device=alpha.device)
        chol = torch.linalg.cholesky(sigma)
        alpha.copy_((mu + torch.einsum("mij,mj->mi", chol, z)).T)
        ycorr -= alpha @ L.T
    return alpha, ycorr


def check_traits(t: int) -> None:
    """K7, K8 and K9 are instantiated for 2 to MAX_TRAITS traits."""
    if not 2 <= t <= MAX_TRAITS:
        raise NotImplementedError(
            f"{t} traits: the multi-trait marker chains (samplers I and II, K7 and "
            f"K8; RR-BLUP and BayesL, K9) run 2 to {MAX_TRAITS} traits; more is "
            f"not ported (ROADMAP.md: samplers I and II above 8 traits)")


def check_prior_traits(t: int) -> None:
    """K7 and K8 take a per-marker pattern prior for 2 to MAX_PRIOR_TRAITS
    traits (csrc/mt_inner_rounds_pm.cu)."""
    if t > MAX_PRIOR_TRAITS:
        raise NotImplementedError(
            f"a per-marker pattern prior at {t} traits: samplers I and II (K7, K8) "
            f"take one for 2 to {MAX_PRIOR_TRAITS} traits; more is not ported "
            f"(ROADMAP.md: a per-marker pattern prior above 4 traits)")


def check_block_size(b: int) -> None:
    """K7, K8 and K9 take blocks of up to MAX_BLOCK markers
    (csrc/mt_inner_rounds.cu and csrc/mt_c0l_rounds.cu: kThreads x
    kMaxRows)."""
    if b > MAX_BLOCK:
        raise NotImplementedError(
            f"blocks of {b} markers: the multi-trait marker chains (K7, K8, K9) take "
            f"up to {MAX_BLOCK} (an int fast_blocks up to {MAX_BLOCK}; the default "
            f"block size passes it above ~4.2 million records); more is not ported "
            f"(ROADMAP.md: samplers I and II above 2,048 markers a block)")


def scratch_values(sampler: str, t: int, b: int, nblocks: int) -> int:
    """Values of the constants' scratch of a K7 / K8 / K9 call on nblocks
    blocks of b markers: K7 and K8 (csrc/mt_inner_rounds.cu) nblocks x
    ceil(b / 32) windows of 32 markers, E values a marker: t (8 + 3 (t - 1))
    for sampler I, 2^t (t (t + 1) + 1) for sampler II; K9 ("C0L",
    csrc/mt_c0l_rounds.cu) 3 t t a marker (its affine map's P, Q and S,
    mt_c0l_constants)."""
    if sampler == "C0L":
        return nblocks * b * 3 * t * t
    e = t * (8 + 3 * (t - 1)) if sampler == "I" else (1 << t) * (t * (t + 1) + 1)
    return nblocks * -(-b // 32) * 32 * e


def check_scratch(sampler: str, t: int, b: int, gb: int, itemsize: int,
                  budget: int) -> None:
    """A group round's K7 / K8 / K9 call on gb blocks allocates its
    constants' scratch (scratch_values); it may take SCRATCH_SHARE of the
    card's memory (budget bytes, grouped.hbm_budget)."""
    nbytes = scratch_values(sampler, t, b, gb) * itemsize
    if nbytes > SCRATCH_SHARE * budget:
        raise NotImplementedError(
            f"sampler {sampler} at {t} traits, blocks of {b} markers and {gb} blocks a "
            f"group: {KERNEL_OF[sampler]}'s constants' scratch would take "
            f"{nbytes / 1e9:.3g} GB, above {SCRATCH_SHARE:g} of the card's "
            f"{budget / 1e9:.3g} GB; a smaller fast_blocks or fewer traits fit; more "
            f"is not ported (ROADMAP.md: samplers I and II with a scratch above a "
            f"quarter of the card)")
