"""The location parameters' LHS and their single-site Gibbs pass (K6).

Counterpart of jwas_tpu/engine/mcmc.py:86-106 (assemble_lhs_lambda) and
jwas_tpu/ops/location.py:18-37 (gibbs_pass_lambda, a lax.scan over the K
location parameters). On a CUDA tensor the pass is one launch of the
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
