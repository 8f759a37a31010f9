"""The location parameters' LHS and their single-site Gibbs pass (K6).

Counterpart of jwas_tpu/engine/mcmc.py:86-106 (assemble_lhs_lambda),
jwas_tpu/ops/location.py:18-37 (gibbs_pass_lambda, a lax.scan over the K
location parameters) and :42-60 (gibbs_pass_general, the multi-trait pass:
K6 with vare 1), and of the multi-trait LHS of jwas_tpu/engine/mcmc_mt.py:
177-199 (MTLocationPieces, assemble_lhs_mt), and the solvers of solve
(jacobi :63, gauss_seidel :80: a K6 pass with its normals zero,
gibbs_solver :97: K6 passes and their running mean). On a CUDA tensor the
pass is one launch of the
hand-written kernel csrc/gibbs_pass.cu (K6: a wavefront over the SMs, one
block a slice of S = 160 parameters, the slices' products handed on
through a scratch buffer; float32 and float64 builds, K up to 20,480); on
a CPU tensor it is the plain version, a loop over the parameters. The K
standard normals are drawn by the wrapper from the chain's generator, so
both versions see the same draws. gibbs_pass_lambda_sliced_ref is the
plain version in the kernel's order of work, for the tests.

The LHS is kept exactly symmetric (W'R^-1W with its upper triangle copied
down, each Vinv likewise, G^-1 symmetrised), so row i, which the kernel
reads with unit stride, equals the column A[:, i] that the JAX package and
the plain version read, bit for bit.
"""

from __future__ import annotations

import torch

from jwas_tpu_torch import _build

_BUILDS = {torch.float32: "jt_gibbs_pass", torch.float64: "jt_gibbs_pass_f64"}


def symmetric_upper(M: torch.Tensor) -> torch.Tensor:
    """M with its strict lower triangle replaced by the transpose of its
    strict upper one: exactly symmetric, whatever order of summation made
    M."""
    return torch.triu(M) + torch.triu(M, 1).T


def assemble_lhs_lambda(re_groups, WtW, Vinv, vc, vare):
    """LHS = W'R^-1W + for each group and each pair (i, j) of its terms
    G^-1[i, j] vare Vinv (or G^-1[i, j] vare I, an i.i.d. group) added to
    the (q, q) block at the terms' starts (addVinv, random_effects.jl:
    218-238). WtW and every Vinv are exactly symmetric (symmetric_upper),
    and G^-1 is symmetrised, so the LHS is. vc: a (k, k) covariance a
    group; vare: a 0-d tensor. Returns a new tensor; no host sync."""
    LHS = WtW.clone()
    for g, grp in enumerate(re_groups):
        Gi = torch.linalg.inv_ex(vc[g])[0]
        lam = 0.5 * (Gi + Gi.T) * vare
        q = grp.n_levels
        for i, si in enumerate(grp.starts):
            for j, sj in enumerate(grp.starts):
                block = LHS[si:si + q, sj:sj + q]
                if grp.has_vinv:
                    block.add_(Vinv[g] * lam[i, j])
                else:
                    block.diagonal().add_(lam[i, j])
    return LHS


def gibbs_pass_lambda_ref(A, x, b, vare, zs):
    """Plain version of K6: one pass of
    x_i ~ N((b_i - A[:, i]'x) / A_ii + x_i, vare / A_ii) in order, skipping
    zero diagonals (solver.jl:143-151), with the K standard normals zs.
    1 / A_ii and zs_i sqrt(vare / A_ii) are elementwise and computed for
    every row first; the loop does the dependent part, on views made once
    (the loop is bound by the cost of an operation). Returns a new x."""
    diag = torch.diagonal(A)
    safe = diag != 0.0
    one = torch.ones((), dtype=x.dtype, device=x.device)
    inv_lhs = torch.where(safe, one / torch.where(safe, diag, one), 0.0 * one)
    noise = zs * torch.sqrt(inv_lhs * vare)
    x = x.clone()
    x_i, cols = x.unbind(), A.unbind(1)
    inv_i, b_i, noise_i = inv_lhs.unbind(), b.unbind(), noise.unbind()
    for i in torch.nonzero(safe).flatten().tolist():
        x_i[i].copy_(inv_i[i] * (b_i[i] - torch.dot(cols[i], x)) + x_i[i] + noise_i[i])
    return x


def gibbs_pass_lambda_sliced_ref(A, x, b, vare, zs, S: int):
    """The plain pass in K6's order of work: slices of S rows in order;
    for slice p, the sum of each row with x is its diagonal block's upper
    triangle times the old x_p, plus the later slices' products with their
    old x and the earlier slices' with their new x; then the forward
    substitution inside the slice, each new x_i added into the later rows'
    sums. The same function as gibbs_pass_lambda_ref; only the order of
    the sums differs. Returns a new x."""
    diag = torch.diagonal(A)
    safe = diag != 0.0
    one = torch.ones((), dtype=x.dtype, device=x.device)
    inv_lhs = torch.where(safe, one / torch.where(safe, diag, one), 0.0 * one)
    noise = zs * torch.sqrt(inv_lhs * vare)
    K = x.shape[0]
    new = x.clone()
    for r0 in range(0, K, S):
        r1 = min(r0 + S, K)
        blk = A[r0:r1, r0:r1]
        c = (torch.triu(blk) @ x[r0:r1] + A[r0:r1, r1:] @ x[r1:]
             + A[r0:r1, :r0] @ new[:r0])
        for i in range(r1 - r0):
            if safe[r0 + i]:
                new[r0 + i] = (inv_lhs[r0 + i] * (b[r0 + i] - c[i]) + x[r0 + i]
                               + noise[r0 + i])
            c[i + 1:] += blk[i + 1:, i] * new[r0 + i]
    return new


def gibbs_pass_lambda(A, x, b, vare, gen: torch.Generator, zs=None):
    """One Gibbs pass over the location parameters (see
    gibbs_pass_lambda_ref). With residual weights A is W'R^-1W (plus the
    random effects' blocks) and b W'R^-1 ycorr. zs: the pass's K standard
    normals (tests inject the JAX package's), else drawn from gen. CUDA
    tensors launch K6 (and raise if it cannot run) with its scratch, a
    (P, K) buffer of the slices' products and P * P zeroed flags, P =
    ceil(K / S) blocks; the launch shape (S, P) is kept in
    gibbs_pass_lambda.last_grid. CPU tensors take the plain version.
    Returns a new x."""
    K = x.shape[0]
    if zs is None:
        zs = torch.randn(K, generator=gen, dtype=x.dtype, device=x.device)
    if A.device.type == "cpu":
        return gibbs_pass_lambda_ref(A, x, b, vare, zs)
    if A.device.type != "cuda":
        raise ValueError(f"gibbs_pass_lambda: unsupported device {A.device}")
    vare = vare.reshape(1)
    if A.dtype not in _BUILDS:
        raise ValueError(f"gibbs_pass_lambda: A must be float32 or float64, got {A.dtype}")
    for name, t, shape in (("A", A, (K, K)), ("x", x, (K,)), ("b", b, (K,)),
                           ("zs", zs, (K,)), ("vare", vare, (1,))):
        if (tuple(t.shape) != shape or t.dtype is not A.dtype
                or t.device != A.device or not t.is_contiguous()):
            raise ValueError(
                f"gibbs_pass_lambda: {name} must be a contiguous {A.dtype} "
                f"{shape} on {A.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.library()
    if not 0 < K <= lib.jt_gibbs_pass_max_k():
        raise ValueError(f"gibbs_pass_lambda: K = {K} location parameters; the "
                         f"kernel takes 1 to {lib.jt_gibbs_pass_max_k()}")
    S = lib.jt_gibbs_pass_slice()
    P = -(-K // S)
    out = torch.empty_like(x)
    partial = torch.empty((P, K), dtype=A.dtype, device=A.device)
    flags = torch.zeros(P * P, dtype=torch.int32, device=A.device)
    err = getattr(lib, _BUILDS[A.dtype])(
        A.data_ptr(), x.data_ptr(), b.data_ptr(), zs.data_ptr(), vare.data_ptr(),
        out.data_ptr(), partial.data_ptr(), flags.data_ptr(), K, _build.stream_of(A))
    _build.check(err, "gibbs_pass_lambda")
    gibbs_pass_lambda.last_grid = (S, P)
    gibbs_pass_lambda.launches += 1
    gibbs_pass_lambda.launches_f64 += A.dtype == torch.float64
    return out


gibbs_pass_lambda.launches = 0       # every launch
gibbs_pass_lambda.launches_f64 = 0   # the float64 build's
gibbs_pass_lambda.last_grid = None   # (S, P) of the last launch


def gibbs_pass_general(A, x, b, gen: torch.Generator, zs=None):
    """One single-site Gibbs pass over the general (multi-trait) mixed
    model equations, x_i ~ N((b_i - A[:, i]'x) / A_ii + x_i, 1 / A_ii)
    (solver.jl:154-162): gibbs_pass_lambda with vare 1, so K6 on the card.
    A is exactly symmetric (assemble_lhs_mt). Returns a new x."""
    one = torch.ones(1, dtype=x.dtype, device=x.device)
    return gibbs_pass_lambda(A, x, b, one, gen, zs)


def pass_limit(device, dtype=torch.float32) -> int:
    """The largest K the location pass takes on device: on a CUDA device
    K6's limit, read from the kernel library for the device (its 20,480,
    or fewer where the card cannot hold the cooperative launch's blocks at
    once); none (0) on the CPU, whose plain version takes any K."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    with torch.cuda.device(device):
        k = _build.library().jt_gibbs_pass_device_max_k(
            torch.empty((), dtype=dtype).element_size())
    if k < 0:
        _build.check(-k, "gibbs_pass_lambda: the device's limit")
    return int(k)


class MTLocationPieces:
    """The multi-trait location LHS W'R^-1W from pieces fixed at set-up.

    W is the stacked (t n, K) design: trait a's rows (a n .. a n + n - 1)
    have entries only in its own columns cols[a], a contiguous range. An
    observation's residual precision is Ri_p rinv_i, with Ri_p (t, t) of
    its missing pattern p. So for each pattern p and trait pair a <= c the
    piece C_pac = W_a[rows_p, cols_a]' diag(rinv) W_c[rows_p, cols_c] is
    fixed, and LHS[cols_a, cols_c] = sum_p Ri_p[a, c] C_pac: one product a
    trait pair an iteration, in place of jwas_tpu's einsum over every
    record (mcmc_mt.py:181). Only the pairs a pattern observes are kept.
    When the pieces would take more than budget bytes (use_pieces False),
    assemble computes each block from W directly:
    (W_a[:, cols_a] * (Ri[pattern_idx, a, c] rinv))' W_c[:, cols_c]."""

    def __init__(self, W, t: int, cols, patterns, pattern_idx, rinv,
                 budget: int):
        n = W.shape[0] // t
        self.t, self.n, self.K = t, n, W.shape[1]
        self.cols = [slice(int(a), int(c)) for a, c in cols]
        self.W = W
        self.pattern_idx = pattern_idx
        self.rinv = rinv
        obs = patterns > 0                                      # (P, t)
        self.pairs = [(a, c) for a in range(t) for c in range(a, t)]
        widths = [sl.stop - sl.start for sl in self.cols]
        need = sum(int((obs[:, a] & obs[:, c]).sum()) * widths[a] * widths[c]
                   for a, c in self.pairs) * W.element_size()
        self.use_pieces = need <= budget
        self.piece_bytes = need
        self.pieces = {}
        if not self.use_pieces:
            return
        for a, c in self.pairs:
            ps = torch.nonzero(obs[:, a] & obs[:, c]).flatten()
            if ps.numel() == 0:
                continue
            Ca = []
            for p in ps.tolist():
                rows = torch.nonzero(pattern_idx == p).flatten()
                Wa = W[a * n + rows, self.cols[a]]
                Wc = W[c * n + rows, self.cols[c]]
                if rinv is not None:
                    Wa = Wa * rinv[rows, None]
                Ca.append((Wa.T @ Wc).reshape(-1))
            self.pieces[(a, c)] = (ps, torch.stack(Ca, 1))      # (Ka Kc, P_ac)

    def assemble(self, Ri_pat, re_groups=(), Vinv=(), vc=()):
        """LHS (K, K) for the (P, t, t) pattern precisions Ri_pat, plus each
        random-effect group's G^-1[i, j] Vinv (or G^-1[i, j] I) at its terms'
        starts (no residual-variance factor, mcmc_mt.py:183-197); exactly
        symmetric (symmetric_upper), as K6 reads rows. From the pieces when
        they are kept, else from W (assemble_from_W)."""
        if not self.use_pieces:
            return self.assemble_from_W(Ri_pat, re_groups, Vinv, vc)
        LHS = torch.zeros((self.K, self.K), dtype=self.W.dtype, device=self.W.device)
        for a, c in self.pairs:
            if (a, c) not in self.pieces:
                continue
            ca, cc = self.cols[a], self.cols[c]
            ps, C = self.pieces[(a, c)]
            LHS[ca, cc] = torch.mv(C, Ri_pat[ps, a, c]).view(ca.stop - ca.start,
                                                             cc.stop - cc.start)
        return self._finish(LHS, re_groups, Vinv, vc)

    def assemble_from_W(self, Ri_pat, re_groups=(), Vinv=(), vc=()):
        """assemble's LHS with each block computed from W:
        (W_a[:, cols_a] * (Ri[pattern_idx, a, c] rinv))' W_c[:, cols_c]."""
        W, n = self.W, self.n
        LHS = torch.zeros((self.K, self.K), dtype=W.dtype, device=W.device)
        Ri_n = Ri_pat[self.pattern_idx]                           # (n, t, t)
        for a, c in self.pairs:
            ca, cc = self.cols[a], self.cols[c]
            r = Ri_n[:, a, c] if self.rinv is None else Ri_n[:, a, c] * self.rinv
            LHS[ca, cc] = (W[a * n:(a + 1) * n, ca] * r[:, None]).T @ W[c * n:(c + 1) * n, cc]
        return self._finish(LHS, re_groups, Vinv, vc)

    @staticmethod
    def _finish(LHS, re_groups, Vinv, vc):
        """The upper blocks mirrored, and the random effects' G^-1 blocks."""
        LHS = symmetric_upper(LHS)
        for g, grp in enumerate(re_groups):
            Gi = torch.linalg.inv_ex(vc[g])[0]
            Gi = 0.5 * (Gi + Gi.T)
            q = grp.n_levels
            for i, si in enumerate(grp.starts):
                for j, sj in enumerate(grp.starts):
                    block = LHS[si:si + q, sj:sj + q]
                    if grp.has_vinv:
                        block.add_(Vinv[g] * Gi[i, j])
                    else:
                        block.diagonal().add_(Gi[i, j])
        return LHS


def jacobi(A, b, x0=None, p: float = 0.7, tolerance: float = 1e-6, maxiter: int = 1000):
    """Damped Jacobi iteration (solver.jl:59-78; jwas_tpu/ops/location.py:63)
    on A's device: x <- p ((b - A x) / diag(A) + x) + (1 - p) x until
    sum((b - A x)^2) / n <= tolerance (x the iterate before the update),
    one read of the test an iteration. A: a dense tensor (the sparse path
    runs its own loop, engine/solve.py). Returns x."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    D = torch.diagonal(A)
    n = b.shape[0]
    for _ in range(maxiter):
        err = b - A @ x
        x = p * (err / D + x) + (1 - p) * x
        if bool(torch.sum(err * err) / n <= tolerance):
            break
    return x




def gauss_seidel(A, b, x0=None, tolerance: float = 1e-6, maxiter: int = 1000):
    """Gauss-Seidel iteration (solver.jl:80-102; jwas_tpu/ops/location.py:80):
    each sweep x_i += (b_i - A[:, i]'x) / A_ii in order is one pass of K6
    with its normals zero (a zero diagonal's x_i stays), until
    sum((b - A x)^2) / n <= tolerance, at most maxiter + 1 sweeps. A: a
    dense (K, K) tensor, exactly symmetric (symmetric_upper). Returns x."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    zs = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    n = b.shape[0]
    for _ in range(maxiter + 1):
        x = gibbs_pass_lambda(A, x, b, one, None, zs=zs)
        err = b - A @ x
        if bool(torch.sum(err * err) / n <= tolerance):
            break
    return x


def gibbs_solver(A, b, vare=None, niter: int = 5000, seed: int = 0):
    """Multi-pass Gibbs returning the running mean of the passes
    (solver.jl:105-140; jwas_tpu/ops/location.py:97): niter passes of K6,
    x_i ~ N((b_i - A[:, i]'x) / A_ii + x_i, vare / A_ii) (vare None: 1,
    the general form), the normals from a generator seeded with seed on
    A's device. A: dense, exactly symmetric. Returns the mean."""
    gen = torch.Generator(device=A.device)
    gen.manual_seed(int(seed))
    v = torch.ones((), dtype=b.dtype, device=b.device) if vare is None else torch.as_tensor(
        float(vare), dtype=b.dtype).to(b.device)
    x = torch.zeros_like(b)
    mean = torch.zeros_like(b)
    for it in range(1, int(niter) + 1):
        x = gibbs_pass_lambda(A, x, b, v, gen)
        mean += (x - mean) / it
    return mean
