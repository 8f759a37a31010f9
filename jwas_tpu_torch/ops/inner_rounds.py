"""Fast-blocks inner rounds (BayesC and BayesR): CUDA kernels and their
plain versions.

BayesC: counterpart of jwas_tpu/ops/pallas_sweep.py:243
(abc_inner_rounds_pallas, with the kernel bodies _abc_kernel :68 and
_abc_kernel_resident :162) and of the XLA scan of
jwas_tpu/ops/grouped.py:532-568; the CUDA kernel is csrc/abc_inner_rounds.cu.
BayesR: counterpart of pallas_sweep.py:412 (bayesr_inner_rounds_pallas, with
the kernel body _bayesr_kernel_resident :327) and of the XLA scan of
grouped.py:684-719; the CUDA kernel is csrc/bayesr_inner_rounds.cu. Each
kernel keeps the Gram tile in shared memory when it fits, its own
launch-time choice.

Both kernels run the chain on the window schedule of csrc/smem_plan.cuh:
the 32 markers of a warp evaluate together, the null steps before the first
marker whose effect changes are committed at once, and a window's changes
reach the other rows at its end. abc_inner_rounds_window_ref and
bayesr_inner_rounds_window_ref model that schedule in plain PyTorch; they
equal the step-by-step plain versions bit for bit, which is what lets the
kernels keep the sequential chain's result.

Each kernel has a float32 and a float64 build (runMCMC's
double_precision); a call takes the build of its grams' dtype, and every
floating-point argument must have that dtype.

The multi-trait chains (samplers I and II, K7 and K8 of
csrc/mt_inner_rounds.cu, counterparts of the lax.scan chains of
jwas_tpu/ops/multitrait.py:214 and :354) have their plain versions in
ops/multitrait.py; their layouts are (gb, t, b) for the state and rhs and
(nreps * b, t or 2^t, gb) for the draws. They run the same window schedule
with d a vector of t values a marker; mt_abc_inner_rounds_window_ref
models it. The multi-trait RR-BLUP / BayesL chain (K9 of
csrc/mt_c0l_rounds.cu, counterpart of the lax.scan of
jwas_tpu/ops/multitrait.py:467) is serial (every step changes an effect):
its step is a per-marker affine map, runs of 32 markers a warp hand d on
by shuffle and through a ring of tagged slots, in the same layouts; its
plain version is ops/multitrait.py::mt_c0l_inner_rounds_ref and
mt_c0l_inner_rounds_window_ref models its schedule.

Layouts are block-major, unlike the JAX package's j-major ones:
grams (nblocks, b, b) with grams[k, j] = row j of block k's Gram;
per-marker tiles (nblocks, b), a view of the flat (p_pad,) arrays (BayesR
log class priors (nblocks, b, 4)); draws (nreps * b, nblocks), BayesR's
Gumbel panel (nreps * b, nblocks, 4), exactly as the JAX sweeps draw them.
"""

from __future__ import annotations

import torch

from jwas_tpu_torch import _build
from jwas_tpu_torch.ops import markers as mk
from jwas_tpu_torch.ops import multitrait as mt


def abc_inner_rounds_ref(grams, xpx, var_eff, log_pi, log_pi_comp, alpha,
                         beta, delta, rhs, us, zs, inv_vare, nreps: int):
    """Plain PyTorch version of the kernel: same math, same update order.

    Updates alpha, beta, delta and rhs in place (the kernel's contract, which
    saves four tile copies per round) and returns them.
    """
    b = grams.shape[1]
    inv_vare = inv_vare.reshape(())
    # the round constants of the update, computed once as the kernel does
    k = mk.abc_constants(xpx, var_eff, inv_vare)
    # column views, sliced once: the loop is bound by per-op overhead
    k_j = [mk.ABCConstants(*c) for c in zip(*(x.unbind(1) for x in k))]
    cols = [x.unbind(1) for x in (xpx, log_pi, log_pi_comp, alpha, beta,
                                  delta, rhs)]
    xpx_j, lp_j, lpc_j, alpha_j, beta_j, delta_j, rhs_j = cols
    gram_j = grams.unbind(1)
    for t, (u, z) in enumerate(zip(us.unbind(0), zs.unbind(0))):
        j = t % b
        a_old = alpha_j[j].clone()
        a_new, b_new, inc = mk.abc_update(rhs_j[j], a_old, xpx_j[j], inv_vare,
                                          k_j[j], lp_j[j], lpc_j[j], u, z)
        alpha_j[j].copy_(a_new)
        beta_j[j].copy_(b_new)
        delta_j[j].copy_(inc)
        rhs.add_((a_old - a_new)[:, None] * gram_j[j])
    return alpha, beta, delta, rhs


_BUILDS = {torch.float32: "", torch.float64: "_f64"}


def _check_cuda_args(what, tensors, shapes, int_names=("delta",)):
    """Device, dtype, shape and contiguity of a kernel's arguments; shapes
    maps each name that is not a (nblocks, b) tile to its shape. Every
    floating-point argument has the grams' dtype, float32 or float64.
    Returns the suffix of the build's C entry point."""
    grams = tensors["grams"]
    dev = grams.device
    tile = grams.shape[:2]
    if grams.dtype not in _BUILDS:
        raise ValueError(f"{what}: grams must be float32 or float64, got {grams.dtype}")
    for name, t in tensors.items():
        want = shapes.get(name, tile)
        dtype = torch.int32 if name in int_names else grams.dtype
        if (t.shape != want or t.dtype is not dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} {tuple(want)} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if grams.data_ptr() % 16:
        raise ValueError(f"{what}: grams must be 16-byte aligned")
    return _BUILDS[grams.dtype]


def abc_inner_rounds(grams, xpx, var_eff, log_pi, log_pi_comp, alpha, beta,
                     delta, rhs, us, zs, inv_vare, nreps: int):
    """Run nreps rounds of the within-block spike-slab chain on every block.

    CUDA tensors launch the kernel (and raise if it cannot run); CPU tensors
    take abc_inner_rounds_ref. alpha, beta, delta, rhs are updated in place
    and returned. inv_vare is a 1-element tensor, so no host sync is needed.
    """
    if grams.device.type == "cpu":
        return abc_inner_rounds_ref(grams, xpx, var_eff, log_pi, log_pi_comp,
                                    alpha, beta, delta, rhs, us, zs, inv_vare,
                                    nreps)
    if grams.device.type != "cuda":
        raise ValueError(f"abc_inner_rounds: unsupported device {grams.device}")
    nblocks, b, _ = grams.shape
    args = dict(grams=grams, xpx=xpx, var_eff=var_eff, log_pi=log_pi,
                log_pi_comp=log_pi_comp, alpha=alpha, beta=beta, delta=delta,
                rhs=rhs, us=us, zs=zs, inv_vare=inv_vare)
    build = _check_cuda_args("abc_inner_rounds", args, {
        "grams": (nblocks, b, b), "us": (nreps * b, nblocks),
        "zs": (nreps * b, nblocks), "inv_vare": (1,)})
    lib = _build.library()
    err = getattr(lib, "jt_abc_inner_rounds" + build)(
        *(t.data_ptr() for t in args.values()), b, nblocks, nreps,
        _build.stream_of(grams),
    )
    _build.check(err, "abc_inner_rounds")
    abc_inner_rounds.launches += 1
    abc_inner_rounds.launches_f64 += build == "_f64"
    return alpha, beta, delta, rhs


abc_inner_rounds.launches = 0       # every launch
abc_inner_rounds.launches_f64 = 0   # the float64 build's


def gram_resident(b: int, nreps: int, method: str = "BayesC",
                  dtype=torch.float32) -> bool:
    """Whether the method's kernel keeps the b x b Gram tile of dtype in
    shared memory on the current CUDA device (otherwise it reads row j from
    global memory/L2)."""
    fn = {"BayesC": "jt_abc_resident", "BayesR": "jt_bayesr_resident"}[method]
    itemsize = torch.empty((), dtype=dtype).element_size()
    r = getattr(_build.library(), fn)(b, nreps, itemsize)
    if r < 0:
        _build.check(-r, f"{method} inner rounds shared-memory plan")
    return bool(r)


def bayesr_inner_rounds_ref(grams, xpx, log_pi, alpha, delta, rhs, gumbel,
                            zs, inv_vare, sigma_sq, nreps: int):
    """Plain PyTorch version of the BayesR kernel: same math, same update
    order. Updates alpha, delta and rhs in place and returns them."""
    b = grams.shape[1]
    inv_vare = inv_vare.reshape(())
    k = mk.bayesr_constants(xpx, inv_vare, sigma_sq)
    k_j = [mk.BayesRConstants(*c) for c in zip(*(x.unbind(1) for x in k))]
    xpx_j, lp_j, alpha_j, delta_j, rhs_j = (
        x.unbind(1) for x in (xpx, log_pi, alpha, delta, rhs))
    gram_j = grams.unbind(1)
    for t, (g, z) in enumerate(zip(gumbel.unbind(0), zs.unbind(0))):
        j = t % b
        a_old = alpha_j[j].clone()
        a_new, klass = mk.bayesr_update(rhs_j[j], a_old, xpx_j[j], inv_vare,
                                        k_j[j], lp_j[j], g, z)
        alpha_j[j].copy_(a_new)
        delta_j[j].copy_(klass)
        rhs.add_((a_old - a_new)[:, None] * gram_j[j])
    return alpha, delta, rhs


def bayesr_inner_rounds(grams, xpx, log_pi, alpha, delta, rhs, gumbel, zs,
                        inv_vare, sigma_sq, nreps: int):
    """Run nreps rounds of the within-block BayesR chain on every block.

    CUDA tensors launch the kernel (and raise if it cannot run); CPU tensors
    take bayesr_inner_rounds_ref. alpha, delta (class labels 0..3) and rhs
    are updated in place and returned. inv_vare and sigma_sq are 1-element
    tensors, so no host sync is needed.
    """
    if grams.device.type == "cpu":
        return bayesr_inner_rounds_ref(grams, xpx, log_pi, alpha, delta, rhs,
                                       gumbel, zs, inv_vare, sigma_sq, nreps)
    if grams.device.type != "cuda":
        raise ValueError(f"bayesr_inner_rounds: unsupported device {grams.device}")
    nblocks, b, _ = grams.shape
    args = dict(grams=grams, xpx=xpx, log_pi=log_pi, alpha=alpha,
                delta=delta, rhs=rhs, gumbel=gumbel, zs=zs,
                inv_vare=inv_vare, sigma_sq=sigma_sq)
    build = _check_cuda_args("bayesr_inner_rounds", args, {
        "grams": (nblocks, b, b), "log_pi": (nblocks, b, 4),
        "gumbel": (nreps * b, nblocks, 4), "zs": (nreps * b, nblocks),
        "inv_vare": (1,), "sigma_sq": (1,)})
    quad = 4 * grams.element_size()      # a marker's four class values
    if gumbel.data_ptr() % quad or log_pi.data_ptr() % quad:
        raise ValueError(f"bayesr_inner_rounds: gumbel and log_pi must be "
                         f"{quad}-byte aligned")
    lib = _build.library()
    err = getattr(lib, "jt_bayesr_inner_rounds" + build)(
        *(t.data_ptr() for t in args.values()), b, nblocks, nreps,
        _build.stream_of(grams),
    )
    _build.check(err, "bayesr_inner_rounds")
    bayesr_inner_rounds.launches += 1
    bayesr_inner_rounds.launches_f64 += build == "_f64"
    return alpha, delta, rhs


bayesr_inner_rounds.launches = 0
bayesr_inner_rounds.launches_f64 = 0


def _mt_inner_rounds(sampler, grams, xpx, valid, alpha, beta, delta, rhs,
                     Rinv, Ginv, log_pi, draw_a, zs, nreps: int, wrapper):
    if grams.device.type == "cpu":
        return mt.mt_abc_inner_rounds_ref(sampler, grams, xpx, valid, alpha,
                                          beta, delta, rhs, Rinv, Ginv, log_pi,
                                          draw_a, zs, nreps)
    what = f"mt_abc_inner_rounds_{sampler}"
    if grams.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {grams.device}")
    nblocks, b, _ = grams.shape
    t = alpha.shape[1]
    mt.check_traits(t)
    mt.check_block_size(b)
    per_locus = Ginv.dim() == 4
    per_marker = log_pi.dim() == 3
    if per_marker:
        mt.check_prior_traits(t)
    state = (nblocks, t, b)
    args = dict(grams=grams, xpx=xpx, valid=valid, alpha=alpha, beta=beta,
                delta=delta, rhs=rhs, Rinv=Rinv, Ginv=Ginv, log_pi=log_pi,
                draw_a=draw_a, zs=zs)
    build = _check_cuda_args(what, args, {
        "grams": (nblocks, b, b), "alpha": state, "beta": state, "delta": state,
        "rhs": state, "Rinv": (t, t),
        "Ginv": (nblocks, b, t, t) if per_locus else (t, t),
        "log_pi": (nblocks, b, 1 << t) if per_marker else (1 << t,),
        "draw_a": (nreps * b, t if sampler == "I" else 1 << t, nblocks),
        "zs": (nreps * b, t, nblocks)}, int_names=())
    scratch = torch.empty(mt.scratch_values(sampler, t, b, nblocks),
                          dtype=grams.dtype, device=grams.device)
    lib = _build.library()
    err = getattr(lib, f"jt_mt_inner_rounds_{sampler}{'_pm' * per_marker}{build}")(
        *(x.data_ptr() for x in args.values()), scratch.data_ptr(), t, b, nblocks,
        nreps, int(per_locus), _build.stream_of(grams))
    _build.check(err, what)
    wrapper.launches += 1
    wrapper.launches_f64 += build == "_f64"
    wrapper.launches_pm += per_marker
    return alpha, beta, delta, rhs


def mt_abc_inner_rounds_I(grams, xpx, valid, alpha, beta, delta, rhs, Rinv,
                          Ginv, log_pi, us, zs, nreps: int):
    """Run nreps rounds of multi-trait sampler I's chain (K7) on every
    block: grams (gb, b, b); xpx, valid (gb, b); alpha, beta, delta, rhs
    (gb, t, b), updated in place and returned; Rinv (t, t); Ginv (t, t) or
    (gb, b, t, t); log_pi (2^t,), or (gb, b, 2^t) one row a marker (the
    kernel's per-marker instantiation, csrc/mt_inner_rounds_pm.cu, t <= 4);
    us, zs (nreps b, t, gb); delta and valid hold 0 or 1. CUDA tensors
    launch the kernel on a scratch tensor of its constants
    (ops/multitrait.py::scratch_values) and raise if it cannot run (2 <= t
    <= 8, b <= 2048); CPU tensors take the plain version
    (ops/multitrait.py::mt_abc_inner_rounds_ref)."""
    return _mt_inner_rounds("I", grams, xpx, valid, alpha, beta, delta, rhs,
                            Rinv, Ginv, log_pi, us, zs, nreps,
                            mt_abc_inner_rounds_I)


def mt_abc_inner_rounds_II(grams, xpx, valid, alpha, beta, delta, rhs, Rinv,
                           Ginv, log_pi, gum, zs, nreps: int):
    """Sampler II's chain (K8), as mt_abc_inner_rounds_I with the Gumbel
    panel gum (nreps b, 2^t, gb) in place of the uniforms."""
    return _mt_inner_rounds("II", grams, xpx, valid, alpha, beta, delta, rhs,
                            Rinv, Ginv, log_pi, gum, zs, nreps,
                            mt_abc_inner_rounds_II)


def mt_c0l_inner_rounds(grams, xpx, valid, alpha, rhs, Rinv, Ginv, gamma, zs,
                        nreps: int):
    """Run nreps rounds of the multi-trait RR-BLUP / BayesL chain (K9,
    csrc/mt_c0l_rounds.cu) on every block: grams (gb, b, b); xpx, valid,
    gamma (gb, b) (gamma ones for RR-BLUP, valid 0 or 1); alpha, rhs
    (gb, t, b), updated in place and returned; Rinv, Ginv (t, t),
    row-major; zs (nreps b, t, gb). CUDA tensors launch the kernel on a
    scratch tensor of its constants (ops/multitrait.py::scratch_values) and
    raise if it cannot run (2 <= t <= 8, b <= 2048); CPU tensors take the
    plain version (ops/multitrait.py::mt_c0l_inner_rounds_ref)."""
    if grams.device.type == "cpu":
        return mt.mt_c0l_inner_rounds_ref(grams, xpx, valid, alpha, rhs, Rinv, Ginv,
                                          gamma, zs, nreps)
    what = "mt_c0l_inner_rounds"
    if grams.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {grams.device}")
    nblocks, b, _ = grams.shape
    t = alpha.shape[1]
    mt.check_traits(t)
    mt.check_block_size(b)
    state = (nblocks, t, b)
    args = dict(grams=grams, xpx=xpx, valid=valid, alpha=alpha, rhs=rhs, Rinv=Rinv,
                Ginv=Ginv, gamma=gamma, zs=zs)
    build = _check_cuda_args(what, args, {
        "grams": (nblocks, b, b), "alpha": state, "rhs": state, "Rinv": (t, t),
        "Ginv": (t, t), "zs": (nreps * b, t, nblocks)}, int_names=())
    scratch = torch.empty(mt.scratch_values("C0L", t, b, nblocks),
                          dtype=grams.dtype, device=grams.device)
    lib = _build.library()
    err = getattr(lib, f"jt_mt_c0l_inner_rounds{build}")(
        *(x.data_ptr() for x in args.values()), scratch.data_ptr(), t, b, nblocks,
        nreps, _build.stream_of(grams))
    _build.check(err, what)
    mt_c0l_inner_rounds.launches += 1
    mt_c0l_inner_rounds.launches_f64 += build == "_f64"
    return alpha, rhs


for _k in (mt_abc_inner_rounds_I, mt_abc_inner_rounds_II, mt_c0l_inner_rounds):
    _k.launches = 0          # every launch
    _k.launches_f64 = 0      # the float64 build's
for _k in (mt_abc_inner_rounds_I, mt_abc_inner_rounds_II):
    _k.launches_pm = 0       # the per-marker prior's


# ------------------------------------------------ the window schedule, plain


def _window_schedule(grams, rhs, nreps: int, window: int, evaluate, commit,
                     stats=None):
    """The schedule of csrc/smem_plan.cuh::run_chain on all blocks at once
    (and of the multi-trait chain of csrc/mt_inner_rounds.cu, where d is a
    vector of t values a marker).

    evaluate(rep, sl) -> (d, candidate): the candidate update of the
    markers in slice sl from the current state, d = a_old - a_new of shape
    (nblocks, len(sl)), or (nblocks, len(sl), t) with rhs (nblocks, t, b);
    commit(sl, mask, candidate) makes it the state where mask is set. A
    marker changes where d (any of its t values) is not 0. Within a window
    each block commits the markers up to its first changing one, adds
    d * Gram row to the window's rhs and evaluates the rest again; at the
    window's end the changes reach the other rows, in order. rhs is updated
    in place. stats, when given, receives the counts of windows,
    evaluations and changes, summed over the blocks.
    """
    nblocks, b, _ = grams.shape
    rhs3 = rhs if rhs.dim() == 3 else rhs[:, None, :]     # a view: writes reach rhs
    blocks = torch.arange(nblocks, device=grams.device)
    count = dict(windows=0, evaluations=0, changes=0)
    for rep in range(nreps):
        for j0 in range(0, b, window):
            sl = slice(j0, min(b, j0 + window))
            nact = sl.stop - j0
            lanes = torch.arange(nact, device=grams.device)
            pos = torch.zeros(nblocks, dtype=torch.long, device=grams.device)
            live = torch.ones(nblocks, dtype=torch.bool, device=grams.device)
            handed = []
            count["windows"] += nblocks
            while bool(live.any()):
                count["evaluations"] += int(live.sum())
                d, cand = evaluate(rep, sl)
                d = d if d.dim() == 3 else d[..., None]
                todo = live[:, None] & (lanes >= pos[:, None])
                changing = todo & (d != 0).any(dim=2)
                moved = changing.any(dim=1)
                first = torch.where(moved, changing.to(torch.int8).argmax(dim=1),
                                    nact)
                commit(sl, todo & (lanes <= first[:, None]), cand)
                j = j0 + first.clamp(max=nact - 1)
                d_f = d[blocks, j - j0][:, :, None]
                row = grams[blocks, j][:, None, :]
                rhs3[:, :, sl] = torch.where(moved[:, None, None],
                                             rhs3[:, :, sl] + d_f * row[:, :, sl],
                                             rhs3[:, :, sl])
                handed.append((moved, d_f, row))
                count["changes"] += int(moved.sum())
                pos = first + 1
                live = moved & (pos < nact)
            other = torch.ones(b, dtype=torch.bool, device=grams.device)
            other[sl] = False
            for moved, d_f, row in handed:
                rhs3[:, :, other] = torch.where(
                    moved[:, None, None],
                    rhs3[:, :, other] + d_f * row[:, :, other],
                    rhs3[:, :, other])
    if stats is not None:
        stats.update(count)


def abc_inner_rounds_window_ref(grams, xpx, var_eff, log_pi, log_pi_comp,
                                alpha, beta, delta, rhs, us, zs, inv_vare,
                                nreps: int, window: int = 32, stats=None):
    """abc_inner_rounds_ref on the kernel's window schedule: same arguments,
    same in-place contract, the same result bit for bit."""
    b = grams.shape[1]
    inv_vare = inv_vare.reshape(())
    k = mk.abc_constants(xpx, var_eff, inv_vare)

    def evaluate(rep, sl):
        t = slice(rep * b + sl.start, rep * b + sl.stop)
        cand = mk.abc_update(
            rhs[:, sl], alpha[:, sl], xpx[:, sl], inv_vare,
            mk.ABCConstants(*(c[:, sl] for c in k)), log_pi[:, sl],
            log_pi_comp[:, sl], us[t].T, zs[t].T)
        return alpha[:, sl] - cand[0], cand

    def commit(sl, mask, cand):
        for state, new in zip((alpha, beta, delta), cand):
            state[:, sl] = torch.where(mask, new.to(state.dtype), state[:, sl])

    _window_schedule(grams, rhs, nreps, window, evaluate, commit, stats)
    return alpha, beta, delta, rhs


def bayesr_inner_rounds_window_ref(grams, xpx, log_pi, alpha, delta, rhs,
                                   gumbel, zs, inv_vare, sigma_sq, nreps: int,
                                   window: int = 32, stats=None):
    """bayesr_inner_rounds_ref on the kernel's window schedule: same
    arguments, same in-place contract, the same result bit for bit."""
    nblocks, b, _ = grams.shape
    inv_vare = inv_vare.reshape(())
    k = mk.bayesr_constants(xpx, inv_vare, sigma_sq)

    def evaluate(rep, sl):
        t = slice(rep * b + sl.start, rep * b + sl.stop)
        a_new, klass = mk.bayesr_update(
            rhs[:, sl].reshape(-1), alpha[:, sl].reshape(-1),
            xpx[:, sl].reshape(-1), inv_vare,
            mk.BayesRConstants(*(c[:, sl].reshape(-1, 3) for c in k)),
            log_pi[:, sl].reshape(-1, 4),
            gumbel[t].transpose(0, 1).reshape(-1, 4), zs[t].T.reshape(-1))
        a_new, klass = a_new.view(nblocks, -1), klass.view(nblocks, -1)
        return alpha[:, sl] - a_new, (a_new, klass)

    def commit(sl, mask, cand):
        for state, new in zip((alpha, delta), cand):
            state[:, sl] = torch.where(mask, new, state[:, sl])

    _window_schedule(grams, rhs, nreps, window, evaluate, commit, stats)
    return alpha, delta, rhs


def mt_abc_inner_rounds_window_ref(sampler: str, grams, xpx, valid, alpha, beta,
                                   delta, rhs, Rinv, Ginv, log_pi, draw_a, zs,
                                   nreps: int, window: int = 32, stats=None):
    """ops/multitrait.py::mt_abc_inner_rounds_ref on the window schedule of
    K7 and K8 (csrc/mt_inner_rounds.cu): same arguments, same in-place
    contract, the same result bit for bit. A window's markers of every
    block evaluate together, their t values of d = a_old - a_new each."""
    nblocks, t, b = alpha.shape
    per_locus = Ginv.dim() == 4

    def evaluate(rep, sl):
        n = sl.stop - sl.start
        steps = slice(rep * b + sl.start, rep * b + sl.stop)

        def flat(x):                     # (nblocks, t, n) -> (nblocks n, t)
            return x.transpose(1, 2).reshape(nblocks * n, -1)

        a_old = alpha[:, :, sl]
        x = xpx[:, sl].reshape(-1)
        w = flat(rhs[:, :, sl]) + x[:, None] * flat(a_old)
        g = Ginv[:, sl].reshape(-1, t, t) if per_locus else Ginv
        lp = log_pi[:, sl].reshape(nblocks * n, -1) if log_pi.dim() == 3 else log_pi
        draws = draw_a[steps].permute(2, 0, 1).reshape(nblocks * n, -1)
        z = zs[steps].permute(2, 0, 1).reshape(nblocks * n, t)
        if sampler == "I":
            cand = mt.mt_marker_update_I_ref(w, flat(beta[:, :, sl]),
                                             flat(delta[:, :, sl]), flat(a_old), x,
                                             Rinv, g, lp, draws, z)
        else:
            cand = mt.mt_marker_update_II_ref(w, x, Rinv, g, lp, draws, z)
        b_new, d_new, a_new = (c.reshape(nblocks, n, t).transpose(1, 2) for c in cand)
        v = valid[:, None, sl]
        a_new = a_new * v
        return (a_old - a_new).transpose(1, 2), (a_new, b_new, d_new * v)

    def commit(sl, mask, cand):
        for state, new in zip((alpha, beta, delta), cand):
            state[:, :, sl] = torch.where(mask[:, None, :], new, state[:, :, sl])

    _window_schedule(grams, rhs, nreps, window, evaluate, commit, stats)
    return alpha, beta, delta, rhs


# ------------------------------------------- K9's run schedule, plain

C0L_RING = 128     # slots of K9's ring of the steps' d (csrc/mt_c0l_rounds.cu: kRing)


def mt_c0l_layout(b: int):
    """K9's threads a CTA and markers a thread (rows) for blocks of b
    markers: one thread a marker up to 256, then 2, 4 or 8 (b <= 2,048)."""
    threads = min(-(-b // 32) * 32, 256)
    rows = 1
    while rows * threads < b:
        rows *= 2
    return threads, rows


def mt_c0l_inner_rounds_window_ref(grams, xpx, valid, alpha, rhs, Rinv, Ginv, gamma,
                                   zs, nreps: int, nbuf=None, ring: int = C0L_RING,
                                   seed: int = 0, stats=None):
    """ops/multitrait.py::mt_c0l_inner_rounds_ref on K9's schedule
    (csrc/mt_c0l_rounds.cu): same arguments, same in-place contract, the
    same result bit for bit.

    Thread i of a CTA owns markers i, i + T, ... (mt_c0l_layout), their
    rhs values its own. A run is 32 consecutive markers of a rep (the last
    one of a rep may be shorter), owned by one warp: lane l steps marker
    j0 + l on its own registers, the warp shuffles its d to every lane and
    each adds d G[j][i] to its rhs of that row at once; the warp then
    publishes d in a ring of `ring` slots. The warp's inputs for the run
    (P, c = Q a_old + S z, a_old, Gram blocks) are staged in one of nbuf
    buffers (2 to a buffer a warp; run u in buffer u mod nbuf) once the
    run u - nbuf is over. Every other warp adds the ring's d's to its rhs
    values lazily, strictly in ascending steps, as they come: the owner of
    the next run, its run set up first, on that run's row alone (its other
    rows after its own run); the rest on all their rows. A warp publishes
    how many steps all its rows have taken, and a run starts only when
    every warp has taken the steps whose slots it will overwrite.

    The warps are generators, interleaved in a random order from `seed`,
    each at a random speed: the result must not depend on it. It raises if
    a warp reads a slot that was overwritten, stages over a buffer in use,
    or all of them wait (a deadlock). stats, when given, receives the
    counts of runs, waits and back-pressure stalls."""
    import random

    gb, t, b = alpha.shape
    P, Q, S = mt.mt_c0l_constants(xpx, Rinv, Ginv, gamma, valid)
    nt, R = mt_c0l_layout(b)
    nwarps = nt // 32
    nruns = -(-b // 32)
    total = nreps * nruns
    most = max(nwarps, 2)
    nbuf = most if nbuf is None else nbuf
    if not 2 <= nbuf <= most or ring < 96:
        raise ValueError(f"nbuf {nbuf} (2..{most}), ring {ring} (>= 96)")
    slots = {}                 # slot -> (step, d (gb, t))
    done = [0] * nwarps        # steps every row of a warp has taken
    published = [0]            # steps whose d is out
    count = dict(runs=0, waits=0, stalls=0)
    buffers = {}               # buffer -> staged run

    def run_of(v):
        rep, rho = divmod(v, nruns)
        j0 = 32 * rho
        return rep * b + j0, j0, min(32, b - j0), rho % nwarps, rho // nwarps

    def owned(w, r):
        idx = w * 32 + r * nt + torch.arange(32, device=grams.device)
        return idx[idx < b]

    def apply(w, r, s, d):
        idx = owned(w, r)
        if len(idx):
            rhs[:, :, idx] += d[:, :, None] * grams[:, s % b, idx][:, None, :]

    def read(s):
        while True:
            got = slots.get(s % ring)
            if got is not None and got[0] == s:
                return got[1]
            if got is not None and got[0] > s:
                raise AssertionError(f"the slot of step {s} was overwritten")
            count["waits"] += 1
            yield

    def have(s):
        got = slots[s % ring]
        if got[0] != s:
            raise AssertionError(f"the slot of step {s} holds step {got[0]}")
        return got[1]

    def stage(u):
        s0, j0, n, _, _ = run_of(u)
        if u >= nbuf and published[0] < sum(run_of(u - nbuf)[:3:2]):
            raise AssertionError(f"run {u} staged over run {u - nbuf}, still running")
        idx = slice(j0, j0 + n)
        a_old = alpha[:, :, idx].transpose(1, 2).reshape(gb * n, t)
        z = zs[s0:s0 + n].permute(2, 0, 1).reshape(gb * n, t)
        c = mt.mt_c0l_offset(Q[:, idx].reshape(-1, t, t), S[:, idx].reshape(-1, t, t),
                             a_old, z)
        buffers[u % nbuf] = dict(run=u, c=c.view(gb, n, t), a_old=a_old.view(gb, n, t))

    def warp(w):
        own = [u for u in range(total) if run_of(u)[3] == w]
        k, applied, staged = 0, 0, set()

        def prefetch(last):
            if k < len(own) and own[k] not in staged and own[k] - nbuf <= last:
                stage(own[k])
                staged.add(own[k])

        prefetch(-1)
        for v in range(total):
            s0, j0, n, wv, r = run_of(v)
            nxt = own[k] if k < len(own) else None
            if wv == w:
                if v not in staged:
                    stage(v)
                    staged.add(v)
                while min(done) < s0 + n - ring:
                    count["stalls"] += 1
                    yield
                for l in range(n):
                    st = buffers[v % nbuf]
                    if st["run"] != v:
                        raise AssertionError(f"run {v}'s buffer was staged over")
                    i = j0 + l
                    a_new = mt.mt_c0l_map(P[:, i], rhs[:, :, i], st["c"][:, l])
                    d = st["a_old"][:, l] - a_new
                    alpha[:, :, i] = a_new
                    old = slots.get((s0 + l) % ring)
                    if old is not None and min(done) <= old[0]:
                        raise AssertionError(f"step {s0 + l} overwrote step {old[0]}, "
                                             "still unread")
                    slots[(s0 + l) % ring] = (s0 + l, d)
                    published[0] = s0 + l + 1
                    apply(w, r, s0 + l, d)
                    yield
                for r2 in range(R):
                    if r2 != r:
                        for s in range(applied, s0 + n):
                            apply(w, r2, s, have(s))
                applied = done[w] = s0 + n
                count["runs"] += 1
                k += 1
            elif nxt == v + 1:
                # the next run is set up before this one ends
                if nxt not in staged:
                    stage(nxt)
                    staged.add(nxt)
                s0n, _, nn, _, r_next = run_of(nxt)
                while min(done) < s0n + nn - ring:
                    count["stalls"] += 1
                    yield
                for l in range(n):
                    d = yield from read(s0 + l)
                    apply(w, r_next, s0 + l, d)
                if R == 1:
                    applied = done[w] = s0 + n
            else:
                for r2 in range(R):
                    for l in range(n):
                        d = yield from read(s0 + l)
                        apply(w, r2, s0 + l, d)
                applied = done[w] = s0 + n
            prefetch(v)
        if applied != nreps * b:
            raise AssertionError(f"warp {w} took {applied} of {nreps * b} steps")

    rng = random.Random(seed)
    live = [warp(w) for w in range(nwarps)]
    # uneven speeds: some warps run far more often than others
    speed = {id(g): rng.random() ** 4 + 1e-3 for g in live}
    idle = 0
    while live:
        g = rng.choices(live, [speed[id(x)] for x in live])[0]
        before = (published[0], sum(done))
        try:
            next(g)
        except StopIteration:
            live.remove(g)
        idle = 0 if (published[0], sum(done)) != before else idle + 1
        if idle > 1000 * nwarps + 10_000:
            raise AssertionError("K9's schedule deadlocked: every warp waits")
    if stats is not None:
        stats.update(count)
    return alpha, rhs
