"""Arrays of the JAX package -> the port's tensors.

For tests that make both packages compute from identical parameters: the
grouped store and its statistics as jwas_tpu builds them (numpy-converted
GroupedPackedMarkers fields, with j-major Gram tiles (b, b, nblocks)) become
a GroupedPackedMarkers of this package with block-major Grams
(nblocks, b, b) over the (p_pad, bpm) store; jwas_tpu's dense MarkerBlocks
(X (n, p_pad), j-major Grams) becomes a DenseMarkers over the marker-major
(p, n) store; GBLUP's L, D and output map (STData.X, .xpx, .out_geno)
become a GBLUPMarkers (eigenvectors have arbitrary signs, so a test gives
both packages the same ones); chain-state arrays (BayesL's gamma_l among
them) become flat tensors; the random-effect state (the groups' configs,
W'R^-1W, each group's dense Vinv and covariance) becomes the port's; the
multi-trait chain's state and data (mt_state_from_jax, mt_data_from_jax;
BayesL's gamma_l, SEM's Lambda, GBLUP's eigenbasis among them)
become the port's MTChainState and MTData; the latent traits' and the
annotations' data and state (latent_data_from_jax, latent_state_from_jax:
liab, thresholds, the categories, the censoring bounds, A, the probit
coefficients and their variance, a per-marker pi) come across to either
engine; the random-regression model's data, configuration and state
(rrm_data_from_jax, rrm_state_from_jax) become the port's RRMCfg, RRMData
and RRMState.
"""

from __future__ import annotations

import numpy as np
import torch

from jwas_tpu_torch.engine.state import REGroupCfg
from jwas_tpu_torch.ops.dense import DenseMarkers
from jwas_tpu_torch.ops.gblup import GBLUPMarkers, build_gblup_markers
from jwas_tpu_torch.ops.grouped import GroupedPackedMarkers, GroupFetcher
from jwas_tpu_torch.ops.location import symmetric_upper


def from_jax_arrays(store, means, valid, xpx, grams, n_obs: int,
                    row_perm=None, *, device="cpu", **state):
    """Returns (gm, state): state maps each keyword to a tensor on device
    (from_jax_state, in float32)."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    ngroups, G, bpm = np.shape(store)
    gm = GroupedPackedMarkers(
        fetch=GroupFetcher(t(store, torch.uint8).view(ngroups * G, bpm), G,
                           device, ngroups),
        means=t(means),
        row_perm=None if row_perm is None else t(row_perm, torch.int64),
        xpx=t(xpx),
        # j-major grams[j, r, k] -> block-major [k, j, r]
        grams=t(np.ascontiguousarray(np.transpose(np.asarray(grams), (2, 0, 1)))),
        valid=t(valid),
        n_obs=int(n_obs),
    )
    return gm, from_jax_state(device=device, **state)


def from_jax_state(*, device="cpu", dtype=torch.float32, **arrays):
    """Chain-state arrays (alpha, delta, gamma_l, ...) -> tensors on device:
    int arrays become int32, the rest dtype."""
    out = {}
    for name, x in arrays.items():
        x = np.array(x)
        out[name] = torch.as_tensor(
            x, dtype=torch.int32 if x.dtype.kind in "iu" else dtype).to(device)
    return out


def from_jax_gblup(L, D, out_geno=None, *, rinv=None, device="cpu",
                   dtype=torch.float32) -> GBLUPMarkers:
    """jwas_tpu's GBLUP chain data (L = Z_t V (n, n), D, the output map
    (Z_o G V) / D or None for the training rows' L) -> a GBLUPMarkers in
    dtype with the given inverse residual weights."""
    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    return build_gblup_markers(t(L), t(D), None if out_geno is None else t(out_geno),
                               rinv=None if rinv is None else t(rinv))


def from_jax_marker_blocks(X, xpx, grams, valid, group_blocks: int, *,
                           rinv=None, device="cpu", dtype=torch.float32):
    """jwas_tpu's MarkerBlocks fields (X (n, p_pad) over the training rows,
    j-major grams (b, b, nblocks), xpx, valid; numpy or JAX arrays) ->
    a DenseMarkers in dtype whose store is X's real columns marker-major,
    (p, n), with groups of group_blocks blocks (0: one group), the
    identity row order and the given inverse residual weights. The padding
    markers' xpx becomes 1, as the port keeps it."""
    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    valid_t = t(valid)
    p = int(valid_t.sum().item())
    X = np.asarray(X)
    b, _, nblocks = np.shape(grams)
    gb = int(group_blocks) or nblocks
    xpx_t = torch.where(valid_t > 0, t(xpx), torch.ones_like(valid_t))
    return DenseMarkers(
        X=t(np.ascontiguousarray(X[:, :p].T)), G=b * gb, row_perm=None,
        rinv=None if rinv is None else t(rinv), xpx=xpx_t,
        grams=t(np.ascontiguousarray(np.transpose(np.asarray(grams), (2, 0, 1)))),
        valid=valid_t, n_obs=X.shape[0])


def from_jax_random_effects(re_groups, WtRinvW, Vinv, vc, *, device="cpu",
                            dtype=torch.float32):
    """jwas_tpu's random-effect state (its EngineCfg.re_groups, STData's
    WtRinvW and Vinv, ChainState's vc; numpy or JAX arrays) -> the port's
    (REGroupCfg tuple, W'R^-1W, Vinv tuple, vc tuple) in dtype on device.
    W'R^-1W and each Vinv are made exactly symmetric (symmetric_upper), as
    engine/mcmc.py::make_data makes them; an identity group's (0, 0) Vinv
    becomes None. estimate_variance is True: jwas_tpu's step draws every
    group (fault R10)."""
    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    cfg = tuple(REGroupCfg(starts=tuple(g.starts), n_levels=g.n_levels, df=g.df,
                           has_vinv=g.has_vinv, random_type=g.random_type,
                           estimate_variance=True) for g in re_groups)
    Vt = tuple(symmetric_upper(t(v)) if g.has_vinv else None
               for g, v in zip(re_groups, Vinv))
    return cfg, symmetric_upper(t(WtRinvW)), Vt, tuple(t(v) for v in vc)


def _opt(x, dtype, device):
    """An optional array -> a tensor; None or an empty array -> None."""
    if x is None or np.size(x) == 0:
        return None
    return torch.as_tensor(np.array(x), dtype=dtype).to(device)


def latent_data_from_jax(data, *, device="cpu", dtype=torch.float32) -> dict:
    """jwas_tpu's STData / MTData latent and annotation fields
    (category_obs, cens_lower, cens_upper, anno_A; numpy or JAX arrays,
    None where absent) -> the port's fields of the same names: the
    categories int64, the rest dtype. Use as data._replace(**...)."""
    return dict(category_obs=_opt(data.category_obs, torch.int64, device),
                cens_lower=_opt(data.cens_lower, dtype, device),
                cens_upper=_opt(data.cens_upper, dtype, device),
                anno_A=_opt(data.anno_A, dtype, device))


def latent_state_from_jax(state, *, device="cpu", dtype=torch.float32) -> dict:
    """jwas_tpu's ChainState / MTChainState liab, thresholds, ann_coeffs,
    ann_var and pi (a per-marker (p_pad,) or (p_pad, 4) one among them)
    -> tensors in dtype; an absent or empty one -> None (pi is kept).
    Use as state._replace(**...)."""
    out = {k: _opt(getattr(state, k), dtype, device)
           for k in ("liab", "thresholds", "ann_coeffs", "ann_var")}
    out["pi"] = torch.as_tensor(np.array(state.pi), dtype=dtype).to(device)
    return out


def mt_state_from_jax(state, *, seed: int = 0, device="cpu", dtype=torch.float32):
    """jwas_tpu's MTChainState (numpy or JAX arrays) -> the port's
    MTChainState in dtype on device, with a generator seeded with seed
    (the key is JAX's own). gamma_l (BayesL's local shrinkage; ones for the
    other methods, which ignore it) comes across; Lambda when SEM has
    edges, else None; the latent and annotation state as
    latent_state_from_jax gives it."""
    from jwas_tpu_torch.engine.state import MTChainState

    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lam = np.asarray(state.Lambda)
    return MTChainState(gen=gen, sol=t(state.sol), alpha=t(state.alpha),
                        beta=t(state.beta), delta=t(state.delta), ycorr=t(state.ycorr),
                        R=t(state.R), varg=t(state.varg), pi=t(state.pi),
                        vc=tuple(t(v) for v in state.vc), gamma_l=t(state.gamma_l),
                        Lambda=t(lam) if lam.size else None,
                        **{k: v for k, v in latent_state_from_jax(
                            state, device=device, dtype=dtype).items() if k != "pi"})


def mt_data_from_jax(data, re_groups, trait_cols, *, group_blocks: int = 0,
                     ebv_rows=None, gblup: bool = False, device="cpu",
                     dtype=torch.float32, budget: int = 1 << 30):
    """jwas_tpu's MTData (W3 (t, n, K), rinv, y, the dense MarkerBlocks
    fields X, xpx, grams, valid, Vinv, vc_scale, patterns, pattern_idx,
    scale_R, marker_scale; numpy or JAX arrays) and its cfg.re_groups ->
    the port's MTData in dtype on device. trait_cols: each trait's
    (first, end) location column (engine/mcmc_mt.py::trait_columns of the
    model); group_blocks: blocks a group of the dense store (0: one group;
    an X of no columns: no markers); ebv_rows: the output IDs' columns of
    the store (None: no EBVs from the markers); gblup: X and xpx are
    GBLUP's L and D (from_jax_gblup, the output map out_geno); budget:
    bytes of the LHS pieces (0: the route from W)."""
    from jwas_tpu_torch.engine.mcmc import NoMarkers
    from jwas_tpu_torch.engine.mcmc_mt import MTData
    from jwas_tpu_torch.ops.location import MTLocationPieces

    def t(x, dt=dtype):
        return torch.as_tensor(np.array(x), dtype=dt).to(device)

    W3 = np.asarray(data.W3)
    nt, n, K = W3.shape
    rinv = t(data.rinv)
    if gblup:
        gm = from_jax_gblup(data.X, data.xpx, data.out_geno,
                            rinv=None if data.rinv is None else np.asarray(data.rinv),
                            device=device, dtype=dtype)
    elif np.shape(data.X)[1] and np.shape(data.grams)[0]:
        gm = from_jax_marker_blocks(data.X, data.xpx, data.grams, data.valid,
                                    group_blocks, rinv=np.asarray(data.rinv),
                                    device=device, dtype=dtype)
    else:
        empty = torch.zeros(0, dtype=dtype, device=device)
        gm = NoMarkers(xpx=empty, valid=empty, rinv=rinv, n_obs=n)
    W = t(W3.reshape(nt * n, K))
    patterns = t(data.patterns)
    idx = t(data.pattern_idx, torch.int64)
    return MTData(
        W=W, lhs=MTLocationPieces(W, nt, trait_cols, patterns, idx, rinv, budget),
        y=t(data.y), gm=gm, rinv=rinv, patterns=patterns, pattern_idx=idx,
        pattern_rows=tuple(torch.nonzero(idx == k).flatten()
                           for k in range(patterns.shape[0])),
        scale_R=t(data.scale_R), marker_scale=t(data.marker_scale),
        ebv_rows=None if ebv_rows is None else t(ebv_rows, torch.int64), out_W=None,
        Vinv=tuple(symmetric_upper(t(v)) if g.has_vinv else None
                   for g, v in zip(re_groups, data.Vinv)),
        vc_scale=tuple(t(v) for v in data.vc_scale))


def rrm_data_from_jax(data, cfg, *, device="cpu", dtype=torch.float32):
    """jwas_tpu's RRMData (dense W (n_obs, K), WtW, y, X (nind, p), phi,
    mphiphi, obs_mask, time_idx, ind_idx, Vinv, vc_scale; numpy or JAX
    arrays) and its RRMCfg -> the port's (RRMCfg, RRMData) in dtype on
    device: W and W' as CSR, W'W and each Vinv exactly symmetric, X
    marker-major (p, nind), each observation's grid cell
    time_idx * nind + ind_idx. The groups draw their covariance, as
    jwas_tpu's step does (fault R10)."""
    import dataclasses

    import scipy.sparse as sp

    from jwas_tpu_torch.engine.mcmc_rrm import RRMCfg, RRMData
    from jwas_tpu_torch.ops.sparse_mme import csr

    def t(x, dt=dtype):
        return torch.as_tensor(np.array(x), dtype=dt).to(device)

    W = sp.csr_matrix(np.asarray(data.W, dtype=np.float64))
    nind = np.shape(data.obs_mask)[1]
    cell = (np.asarray(data.time_idx, dtype=np.int64) * nind
            + np.asarray(data.ind_idx, dtype=np.int64))
    groups = tuple(REGroupCfg(starts=tuple(g.starts), n_levels=g.n_levels, df=g.df,
                              has_vinv=g.has_vinv, random_type=g.random_type,
                              estimate_variance=True) for g in cfg.re_groups)
    port_cfg = RRMCfg(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(RRMCfg)
                         if f.name != "re_groups"}, re_groups=groups)
    return port_cfg, RRMData(
        W=csr(W, dtype, device), Wt=csr(W.T.tocsr(), dtype, device),
        WtW=symmetric_upper(t(data.WtW)),
        X=t(np.ascontiguousarray(np.asarray(data.X).T)), phi=t(data.phi),
        mphiphi=t(data.mphiphi), obs_mask=t(data.obs_mask),
        cell=torch.as_tensor(cell).to(device),
        Vinv=tuple(symmetric_upper(t(v)) if g.has_vinv else None
                   for g, v in zip(cfg.re_groups, data.Vinv)),
        vc_scale=tuple(t(v) for v in data.vc_scale))


def rrm_state_from_jax(state, *, seed: int = 0, device="cpu", dtype=torch.float32):
    """jwas_tpu's RRMState (numpy or JAX arrays) -> the port's RRMState in
    dtype on device, with a generator seeded with seed (the key is JAX's
    own)."""
    from jwas_tpu_torch.engine.mcmc_rrm import RRMState

    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return RRMState(gen=gen, sol=t(state.sol), alpha=t(state.alpha), beta=t(state.beta),
                    delta=t(state.delta), ycorr=t(state.ycorr), vare=t(state.vare),
                    varg=t(state.varg), pi=t(state.pi),
                    marker_scale=t(state.marker_scale), vc=tuple(t(v) for v in state.vc))
