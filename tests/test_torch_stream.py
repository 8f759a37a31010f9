"""Where the store lives: resident, hybrid and streamed groups, the short
last group, the offload decision and the memory guard, against jwas_tpu.

On the CPU a streamed group is read from the host store in place (the
card's ring of staging buffers is tested in tests/test_torch_cuda.py), and
the hybrid split copies the leading groups apart, so these chains exercise
the fetcher's split. Data: numpy seed 0, n = 150 (phenotyped in shuffled
order), p = 1,000 with missing codes, fast_blocks = 8 -> b = 8, gb = 7,
G = 56: 18 groups, the last of them 48 markers.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import jwas_tpu
from jwas_tpu.ops import grouped as jgr
from jwas_tpu.utils import memory as jmem
import jwas_tpu_torch as jt
from jwas_tpu_torch.ops import grouped as gr
from jwas_tpu_torch.utils import memory as tmem

N, P = 150, 1000
PRIORS = dict(vare0=1.0, scale_R=0.5, df_R=4.0, marker_var0=0.01,
              marker_scale0=0.005, df_marker=4.0)
KEYS = ("alpha", "ebv", "vare", "varg", "pi", "model_frequency")


@pytest.fixture(scope="module")
def data():
    jax.config.update("jax_enable_x64", False)
    rng = np.random.default_rng(0)
    codes = rng.binomial(2, rng.uniform(0.1, 0.9, P)[None, :], size=(N, P))
    codes = codes.astype(np.uint8)
    codes[rng.random((N, P)) < 0.02] = 3
    store = jt.Packed2BitStore(
        obs_ids=[f"i{k}" for k in range(N)], marker_ids=[f"m{j}" for j in range(P)],
        packed=torch.from_numpy(jt.pack_codes(codes)),
        means=np.array([c[c < 3].mean() for c in codes.T]),
        allele_freq=np.array([c[c < 3].mean() / 2 for c in codes.T]), n_obs=N,
        n_markers=P, has_missing=True)
    obs = list(rng.permutation(store.obs_ids))
    y = rng.normal(size=N).astype(np.float32)
    return dict(store=store, obs=obs, y=y)


def _chain(gm, y, method, **kw):
    return jt.run_st(gm, y, **PRIORS, method=method, chain_length=48, seed=3, **kw)


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in KEYS)


def test_hybrid_and_streamed_chains_equal_the_resident_chain(data, monkeypatch):
    """k = 0, 9 and all 18 groups on the device (the split set through
    JWAS_HBM_BYTES, as a user sets it): BayesC, BayesB and BayesR chains
    equal the resident chain bit for bit; the resident store is the
    caller's tensor, used in place."""
    store, obs, y = data["store"], data["obs"], data["y"]
    res = jt.setup_markers(store, obs, "cpu", fast_blocks=8)
    assert (res.grams.shape[1], res.ngroups, res.fetch.G) == (8, 18, 56)
    assert res.store.data_ptr() == store.packed.data_ptr()
    assert res.fetch.dev is store.packed and res.fetch.resident == 18
    want = {m: _chain(res, y, m) for m in ("BayesC", "BayesB", "BayesR")}
    bpm = store.packed.shape[1]
    for k in (0, 9, 18):
        monkeypatch.setenv("JWAS_HBM_BYTES", str(gr.hybrid_budget(k, 18, 56, 8, bpm)))
        gm = jt.setup_markers(store, obs, "cpu", fast_blocks=8, host_offload=True)
        assert gm.fetch.resident == k and gm.ngroups == 18
        assert torch.equal(gm.grams, res.grams) and torch.equal(gm.xpx, res.xpx)
        if 0 < k < 18:            # the leading groups copied apart
            assert gm.fetch.dev.data_ptr() != store.packed.data_ptr()
            assert gm.fetch.dev.shape[0] == k * 56
        for method, ref in want.items():
            assert _same(_chain(gm, y, method), ref), (k, method)


def test_short_last_group_equals_the_padded_layout(data):
    """p = 1,000 is no multiple of G = 56: the store stays (1000, bpm), the
    chain state p_pad = 1,008. The same chain over a store padded with zero
    rows (the layout every earlier version built) is equal bit for bit, for
    each method and with a sync every 3 sweeps. The store is used in place;
    only its short last group is served from a zero-padded copy."""
    store, obs, y = data["store"], data["obs"], data["y"]
    gm = jt.setup_markers(store, obs, "cpu", fast_blocks=8)
    assert tuple(gm.store.shape) == (P, (N + 3) // 4) and gm.valid.shape[0] == 1008
    assert gm.store.data_ptr() == store.packed.data_ptr()
    last = gm.fetch.rows(17)
    assert last.shape[0] == 56 and not last[P - 17 * 56:].any()
    assert torch.equal(last[:P - 17 * 56], store.packed[17 * 56:])
    assert gm.fetch.rows(16).data_ptr() == store.packed[16 * 56].data_ptr()
    padded = torch.zeros((1008, gm.store.shape[1]), dtype=torch.uint8)
    padded[:P] = store.packed
    gmp = gm._replace(fetch=gr.GroupFetcher(padded, 56, "cpu", 18))
    grams, xpx = gr.grouped_stats(gmp.fetch, gm.means, gm.valid, gm.row_perm, 8, N)
    assert torch.equal(grams, gm.grams) and torch.equal(xpx, gm.xpx)
    for method in ("BayesC", "BayesB", "BayesR"):
        for kw in ({}, dict(sync_every=3)):
            assert _same(_chain(gm, y, method, **kw), _chain(gmp, y, method, **kw)), (
                method, kw)
    v = torch.from_numpy(np.random.default_rng(1).normal(size=1008).astype(np.float32))
    assert torch.equal(gr.grouped_matvec(gm, v), gr.grouped_matvec(gmp, v))
    w = torch.from_numpy(y)
    assert torch.equal(gr.grouped_rhs(gm, w), gr.grouped_rhs(gmp, w))


def test_plan_device_groups_and_offload_match_jax(monkeypatch):
    """plan_device_groups over a grid of shapes, Gram bytes, budgets and
    cushions, and with no budget (JWAS_HBM_BYTES, else 16e9 where no card
    reports its memory); hybrid_budget gives the budget of each split; the
    offload decision: True and False as given,
    "auto" off on the CPU, anything else refused."""
    for ngroups in (1, 7, 121, 128):
        for G, bpm in ((56, 38), (17_408, 12_500), (16_384, 12_500)):
            for grams in (0, 10**6, 1_146_000_000):
                for budget in (0, 10**9, 8 * 10**9, 80 * 10**9, 85_000_000_000):
                    for cushion in (0, 7 << 29):
                        args = (ngroups, G, bpm, grams, budget, cushion)
                        assert (gr.plan_device_groups(*args)
                                == jgr.plan_device_groups(*args)), args
        for k in range(ngroups + 1):           # hybrid_budget inverts the plan
            for G, bpm, b in ((56, 38, 8), (16_384, 12_500, 128)):
                budget = gr.hybrid_budget(k, ngroups, G, b, bpm)
                assert gr.plan_device_groups(ngroups, G, bpm, ngroups * G * b * 4,
                                             budget) == k
    for env in (None, "4e9", "20e9"):
        if env is None:
            monkeypatch.delenv("JWAS_HBM_BYTES", raising=False)
        else:
            monkeypatch.setenv("JWAS_HBM_BYTES", env)
        if not torch.cuda.is_available():
            args = (128, 16_384, 12_500, 10**9)
            assert gr.plan_device_groups(*args) == jgr.plan_device_groups(*args), env
    for flag in (True, False):
        assert gr.resolve_host_offload(flag, 10**12, "cpu") is flag
    assert gr.resolve_host_offload("auto", 10**12, "cpu") is False
    with pytest.raises(ValueError, match="host_offload_genotypes"):
        gr.resolve_host_offload("yes", 1, "cpu")


def test_memory_guard_policies_and_estimate(data, tmp_path):
    """The estimate beside jwas_tpu's at the north-star shape (N = 50,000,
    P = 2,097,152, b = gb = 128): the same store and Gram bytes and design;
    jwas_tpu adds its dense (n_out, p) output matrix (fault R7), the port
    its decode tile, and when streamed the ring in place of the store.
    Then the policies and their errors, directly and through runMCMC."""
    n, p, b, gb = 50_000, 2_097_152, 128, 128
    ref = jmem.estimate_marker_memory(n_obs=n, n_markers=p, block_size=b, n_out=n,
                                      n_loc=1, packed=True)
    est = tmem.estimate_marker_memory(n, p, b, gb, n_loc=1)
    assert est.bytes_genotypes == ref.bytes_genotypes == p * 12_500
    assert est.bytes_grams == ref.bytes_grams == p * b * 4
    assert est.bytes_design == ref.bytes_design
    assert est.bytes_output == 0 and ref.bytes_output == n * p * 4   # R7: 419 GB
    assert est.bytes_staging == 0 and est.bytes_decode <= 1 << 30
    assert ref.bytes_total - est.bytes_total == ref.bytes_output - est.bytes_decode
    streamed = tmem.estimate_marker_memory(n, p, b, gb, n_loc=1, resident_groups=0)
    assert streamed.bytes_genotypes == 0
    assert streamed.bytes_staging == gr.RING_DEPTH * b * gb * 12_500
    half = tmem.estimate_marker_memory(n, p, b, gb, n_loc=1, resident_groups=64)
    assert half.bytes_genotypes == 64 * b * gb * 12_500

    for mod in (jmem, tmem):
        e = mod.MarkerMemoryEstimate(10, 10, 10, 10) if mod is jmem else \
            mod.MarkerMemoryEstimate(10, 10, 0, 0, 20)
        with pytest.raises(ValueError, match="memory_guard must be"):
            mod.check_marker_memory_guard(e, policy="sometimes")
        with pytest.raises(MemoryError):
            mod.check_marker_memory_guard(e, policy="error", total_bytes=30)
        with pytest.warns(UserWarning, match="exceeds"):
            mod.check_marker_memory_guard(e, policy="warn", total_bytes=30)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mod.check_marker_memory_guard(e, policy="off", total_bytes=30)
            mod.check_marker_memory_guard(e, policy="error", total_bytes=10**6)

    store = data["store"]
    table = jt.Table({"ID": np.array(data["obs"], dtype=object), "y": data["y"]})
    model = lambda: jt.build_model("y = intercept + geno",  # noqa: E731
                                   genotypes=jt.get_genotypes(store))
    run = dict(device="cpu", chain_length=16, fast_blocks=8, output_folder="",
               printout_model_info=False)
    with pytest.raises(ValueError, match="memory_guard must be"):
        jt.runMCMC(model(), table, memory_guard="sometimes", **run)
    with pytest.raises(MemoryError, match="exceeds"):
        jt.runMCMC(model(), table, memory_guard="error", memory_guard_ratio=1e-9, **run)
    out = jt.runMCMC(model(), table, memory_guard="off", memory_guard_ratio=1e-9, **run)
    assert np.isfinite(out["EBV_y"].EBV).all()


def test_host_offload_through_runmcmc(data):
    """runMCMC(host_offload_genotypes=True) on the CPU equals the resident
    run bit for bit; "auto" keeps the store in place on the CPU."""
    store, y = data["store"], data["y"]
    table = jt.Table({"ID": np.array(data["obs"], dtype=object), "y": y})
    run = dict(device="cpu", chain_length=48, fast_blocks=8, output_folder="",
               printout_model_info=False, seed=2)
    outs = {}
    for flag in (False, True, "auto"):
        model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
            store, method="BayesB"))
        outs[flag] = jt.runMCMC(model, table, host_offload_genotypes=flag, **run)
    for flag in (True, "auto"):
        for key in ("EBV_y", "marker effects geno", "marker effects variances geno"):
            assert np.array_equal(outs[flag][key].Estimate if key != "EBV_y"
                                  else outs[flag][key].EBV,
                                  outs[False][key].Estimate if key != "EBV_y"
                                  else outs[False][key].EBV), (flag, key)
