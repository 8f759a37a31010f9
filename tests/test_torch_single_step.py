"""The port's single-step layer (jwas_tpu_torch/engine/single_step.py and
its set-up in runMCMC) against jwas_tpu's (tests/test_single_step.py).

(a) The partitioned A^-1 (A_nn, A_ng, the ID orders, F_nn) equals
    jwas_tpu's to 1e-12; F_nn' F_nn = A_nn.
(b) The imputed store: both solver branches (splu up to SPLU_MAX_NN,
    lowered here to force the blocked CG; chunks of 1, 7 or 64 and all
    markers)
    give, column for column, jwas_tpu's imputed rows of the data's
    individuals to 1e-9 (float64 store); the blocked CG alone equals
    jwas_tpu's on the reference test's A_nn block. Fault R14: the port's
    store holds only those rows, (p, n_rows), never the (nn + ng, p)
    matrix of every pedigree animal that jwas_tpu fills first.
(c) J, the epsilon column and terms, the epsilon random effect (Vinv =
    A_nn, its names and factor F_nn), the EBVs' terms and the workspace's
    store columns against jwas_tpu's workspace genotypes (1e-6, float32).
(d) get_Hi at weights 0 and 1, apy_partition and apy_g_inverse against
    jwas_tpu's (1e-8); the errors of tests/test_single_step.py.
(e) Single- and 2-trait SSBR chains on famdata at the reference's 600
    sweeps (120 burn-in; the 2-trait chain at a quarter of that): EBV
    accuracy of every individual and of the
    non-genotyped ones within 0.05 of jwas_tpu's on the same data and
    seeds (JWAS_ACC, measured with `python tests/test_torch_single_step.py
    reference`, PYTHONPATH=.:tests), and above the reference test's floors.
"""

import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import jwas_tpu
import jwas_tpu_torch as jt
from jwas_tpu.io.datasets import simulate_pedigree_genomic_data
from jwas_tpu_torch.io.table import as_table

# jwas_tpu's accuracies on (e)'s data and seeds (the "reference" command): single-trait
# (all, non-genotyped), 2-trait (y1 all, y1 non-genotyped, y2 all, y2 non)
# (the 2-trait chain at MT_SHORTER; at full length 0.9117, 0.8283, 0.9145,
# 0.8405)
JWAS_ACC = {"st": (0.8729, 0.8049), "mt": (0.8935, 0.8082, 0.9106, 0.8330)}
ACC_MARGIN = 0.05
# the 2-trait chain runs 150 sweeps (burn-in 30), a quarter of the
# reference's: its exact sweep steps a marker at a time through K7's plain
# version (~1 ms a step here), 131 s at full length (ROADMAP.md Queue 3)
MT_SHORTER = 4


@pytest.fixture(scope="module")
def famdata():
    return simulate_pedigree_genomic_data(n_founders=60, n_gen=3, n_per_gen=120, p=200,
                                          n_qtl=20, h2=0.5, seed=11)


def _genotyped(famdata, frac=0.6, seed=21):
    rng = np.random.default_rng(seed)
    ids = famdata["ids"]
    return set(rng.choice(ids, size=int(frac * len(ids)), replace=False))


def _both(famdata, genotyped, eq="y = intercept + geno", storage="f32"):
    """The same single-step model in both packages: (jwas model, port
    model, jwas pedigree, port pedigree)."""
    gdf = famdata["genotypes"]
    gdf = gdf[gdf["ID"].isin(genotyped)]
    jped = jwas_tpu.get_pedigree(famdata["pedigree"])
    tped = jt.get_pedigree(as_table(famdata["pedigree"]))
    jg = jwas_tpu.get_genotypes(gdf, method="BayesC", name="geno",
                                double_precision=storage == "f64")
    tg = jt.get_genotypes(as_table(gdf), method="BayesC", name="geno", storage=storage,
                          device="cpu")
    jm, tm = jwas_tpu.build_model(eq, genotypes=jg), jt.build_model(eq, genotypes=tg)
    jm.ped, tm.ped = jped, tped
    return jm, tm, jped, tped


def test_partitioned_a_inverse_matches_jwas_tpu(famdata):
    from jwas_tpu.engine.single_step import _partitioned_a_inverse as jpart

    from jwas_tpu_torch.engine.single_step import _partitioned_a_inverse

    ids = famdata["ids"]
    jm, tm, _, _ = _both(famdata, set(ids[::2]))
    ref, got = jpart(jm), _partitioned_a_inverse(tm)
    assert got[2] == ref[2] and got[3] == ref[3]
    for a, b in ((got[0], ref[0]), (got[1], ref[1]), (got[4], ref[4])):
        np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((got[4].T @ got[4]).toarray(), got[0].toarray(), atol=1e-10)


def _jwas_m_ped(jm):
    from jwas_tpu.engine.single_step import _impute_genotypes as jimp
    from jwas_tpu.engine.single_step import _partitioned_a_inverse as jpart
    from scipy.sparse.linalg import splu

    Ai_nn, Ai_ng, nn_ids, g_ids, _ = jpart(jm)
    return jimp(jm.M[0], splu(Ai_nn.tocsc()), Ai_ng, g_ids), nn_ids + g_ids


@pytest.mark.parametrize("branch", ["splu", "blocked CG"])
def test_imputed_store_rows_match_jwas_tpu_fault_r14(famdata, branch, monkeypatch):
    """Each column of the port's imputed store is jwas_tpu's imputed row of
    that individual (float64 stores, 1e-9), whichever solver and chunk; the
    store has one column a data row (R14: no (nn + ng, p) matrix)."""
    from jwas_tpu_torch.engine import single_step as ss

    ids = famdata["ids"]
    jm, tm, _, _ = _both(famdata, set(ids[::2]), storage="f64")
    M_ped, order = _jwas_m_ped(jm)
    row = {s: i for i, s in enumerate(order)}
    want = list(famdata["phenotypes"]["ID"])[::3] + [ids[1], ids[0]]
    if branch == "blocked CG":
        monkeypatch.setattr(ss, "SPLU_MAX_NN", 0)
    Ai_nn, Ai_ng, nn_ids, g_ids, _ = ss._partitioned_a_inverse(tm)
    info = ss.CGInfo()
    solve = ss._make_nn_solver(Ai_nn, "cpu", info)
    chunks = (1, 7) if branch == "splu" else (64,)      # a CG a chunk: ~0.1 s each
    for chunk in chunks + (tm.M[0].n_markers,):
        store = ss._impute_genotypes(tm.M[0], solve, Ai_ng, g_ids, nn_ids, want, chunk)
        assert tuple(store.shape) == (tm.M[0].n_markers, len(want))
        np.testing.assert_allclose(store.numpy().T, M_ped[[row[s] for s in want]],
                                   rtol=1e-9, atol=1e-9)
    assert (info.iterations > 0) == (branch == "blocked CG")
    assert info.worst < 1e-10


def test_blocked_cg_matches_jwas_tpu():
    """The blocked CG on tests/test_single_step.py:246-265's A_nn block
    (a 2,000-animal pedigree's leading 1,500 rows, 7 right-hand sides)
    equals jwas_tpu's blocked CG and splu to 1e-8."""
    from jwas_tpu.engine.single_step import _blocked_cg_spd as jcg
    from scipy.sparse.linalg import splu

    from jwas_tpu_torch.engine.single_step import _blocked_cg_spd
    from jwas_tpu_torch.ops.sparse_mme import csr

    rng = np.random.default_rng(3)
    n = 2000
    ids = [f"c{i}" for i in range(n)]
    sire = ["missing" if i < 20 else ids[int(rng.integers(max(i - 200, 0), i))]
            for i in range(n)]
    dam = ["missing" if i < 20 else ids[int(rng.integers(max(i - 200, 0), i))]
           for i in range(n)]
    ped = jt.get_pedigree(jt.Table({"ID": np.array(ids, dtype=object),
                                    "S": np.array(sire, dtype=object),
                                    "D": np.array(dam, dtype=object)}),
                          missingstring=("missing",))
    sub = ped.a_inverse().tocsc()[:1500, :1500].tocsc()
    B = rng.normal(size=(1500, 7))
    got = _blocked_cg_spd(csr(sub, torch.float64, "cpu"), torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, jcg(sub.tocsr(), B), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got, splu(sub).solve(B), rtol=1e-6, atol=1e-8)


def test_j_epsilon_and_workspace_match_jwas_tpu(famdata):
    """runMCMC's single-step set-up in both packages: the J column, the
    epsilon column, the added terms, the epsilon group (Vinv = A_nn, names,
    factor F_nn, G the genetic variance), the EBVs' terms and the training
    rows' store columns against jwas_tpu's workspace genotypes."""
    from jwas_tpu.engine.setup import MCMCOptions as JOpts
    from jwas_tpu.engine.setup import prepare_workspace as jprep

    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace

    genotyped = _genotyped(famdata)
    jm, tm, jped, tped = _both(famdata, genotyped)
    jm.ped = tm.ped = None
    kw = dict(single_step_analysis=True, output_folder="")
    jws = jprep(jm, famdata["phenotypes"], JOpts(pedigree=jped, **kw))
    tws = prepare_workspace(tm, as_table(famdata["phenotypes"]), MCMCOptions(pedigree=tped, **kw))
    assert tws.obs_ids == jws.obs_ids
    assert [t.trm_str for t in tm.terms] == [t.trm_str for t in jm.terms]
    assert tm.ped_term_vec == jm.ped_term_vec == ["y:J", "y:ϵ"]
    np.testing.assert_allclose(np.asarray(tws.df["J"], dtype=float), jws.df["J"].to_numpy(),
                               rtol=1e-10, atol=1e-10)
    assert list(tws.df["ϵ"]) == list(jws.df["ϵ"])
    np.testing.assert_allclose(tws.W, jws.W, rtol=1e-10, atol=1e-10)
    (tg,), (jg,) = tws.re_groups, jws.re_groups
    assert tg.starts == jg.starts and tg.n_levels == jg.n_levels
    np.testing.assert_allclose(tg.Vinv, jg.Vinv, atol=1e-12)
    np.testing.assert_allclose(tg.G0, jg.G0, rtol=1e-12)
    np.testing.assert_allclose(tm.random_effects[0].Vinv_factor.toarray(),
                               jm.random_effects[0].Vinv_factor.toarray(), atol=1e-12)
    assert tm.term_dict["y:ϵ"].names == jm.term_dict["y:ϵ"].names
    g = tws.geno
    cols = [g.obs_ids.index(s) for s in tws.obs_ids]
    np.testing.assert_allclose(g.dense[:, cols].T.numpy(), jws.geno.genotypes,
                               rtol=1e-6, atol=1e-6)
    assert tws.ssbr["nongenotyped"] == len(famdata["ids"]) - len(genotyped)


def test_get_hi_and_apy_match_jwas_tpu(famdata):
    """get_Hi at weight_for_G 0 (Hi = Ai) and 1, apy_partition and
    apy_g_inverse against jwas_tpu's."""
    from jwas_tpu.engine import single_step as jss

    from jwas_tpu_torch.engine import single_step as ss

    rng = np.random.default_rng(4)
    ids = famdata["ids"]
    genotyped = set(rng.choice(ids, size=len(ids) // 2, replace=False))
    jm, tm, jped, tped = _both(famdata, genotyped)
    for w in (0.0, 1.0):
        Hj, oj = jss.get_Hi(jped, jm.M[0], weight_for_G=w)
        Ht, ot = ss.get_Hi(tped, tm.M[0], weight_for_G=w)
        assert ot == oj
        np.testing.assert_allclose(Ht.toarray(), Hj.toarray(), rtol=1e-6, atol=1e-6)
    perm = np.array([tped.id_index[s] for s in ot])
    Ai = tped.a_inverse()[perm][:, perm]
    np.testing.assert_allclose(ss.get_Hi(tped, tm.M[0], weight_for_G=0.0)[0].toarray(),
                               Ai.toarray(), atol=1e-6)
    geno_ids, core = ids[::2], ids[::2][:20]
    assert ss.apy_partition(tped, geno_ids, core) == jss.apy_partition(jped, geno_ids, core)
    with pytest.raises(ValueError, match="core IDs not genotyped"):
        ss.apy_partition(tped, geno_ids, [ids[1]])
    c, m = 30, 40
    B = rng.normal(size=(c, c))
    Gcc = B @ B.T + np.eye(c)
    Gcn = rng.normal(size=(c, m)) * 0.3
    G = np.block([[Gcc, Gcn], [Gcn.T, Gcn.T @ np.linalg.solve(Gcc, Gcn)
                                + np.diag(rng.uniform(0.5, 1.5, m))]])
    for core_idx in (np.arange(c), np.arange(c + m), np.arange(0, c + m, 3)):
        np.testing.assert_allclose(ss.apy_g_inverse(G, core_idx),
                                   jss.apy_g_inverse(G, core_idx), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(ss.apy_g_inverse(G, np.arange(c)), np.linalg.inv(G), atol=1e-8)


def test_ssbr_errors():
    """tests/test_single_step.py::test_ssbr_errors and the validation rules
    single-step reaches: a genotyped individual outside the pedigree, no
    pedigree, GBLUP, no genetic variance."""
    fam = simulate_pedigree_genomic_data(n_founders=10, n_gen=1, n_per_gen=10, p=20,
                                         n_qtl=5, seed=4)
    ped = jt.get_pedigree(as_table(fam["pedigree"]))
    gdf = fam["genotypes"].copy()
    gdf.loc[gdf.index[-1], "ID"] = "stranger"
    pheno = as_table(fam["phenotypes"])

    def run(geno, **kw):
        model = jt.build_model("y = intercept + geno", genotypes=geno)
        jt.runMCMC(model, pheno, device="cpu", chain_length=5, single_step_analysis=True,
                   output_folder="", printout_model_info=False, **kw)

    def geno(**kw):
        return jt.get_genotypes(as_table(gdf), name="geno", MAF=0.0, device="cpu", **kw)

    with pytest.raises(ValueError, match="pedigree"):
        run(geno(method="BayesC"), pedigree=ped)
    with pytest.raises(ValueError, match="A pedigree is required"):
        run(geno(method="BayesC"))
    with pytest.raises(ValueError, match="SSGBLUP"):
        run(geno(method="GBLUP", G=1.0), pedigree=ped)
    gdf.loc[gdf.index[-1], "ID"] = fam["genotypes"]["ID"].iloc[-1]
    with pytest.raises(ValueError, match="genetic variance"):
        run(geno(method="BayesC", G=0.01, G_is_marker_variance=True), pedigree=ped)


def _accuracy(ebv_table, truth, ids, non):
    ebv = dict(zip(list(ebv_table["ID"]), np.asarray(ebv_table["EBV"], dtype=float)))
    acc = np.corrcoef([ebv[s] for s in ids], [truth[s] for s in ids])[0, 1]
    acc_n = np.corrcoef([ebv[s] for s in non], [truth[s] for s in non])[0, 1]
    return float(acc), float(acc_n)


def _mt_pheno(famdata):
    """tests/test_single_step.py::test_mt_ssbr_end_to_end's 2 traits."""
    rng = np.random.default_rng(5)
    ids = famdata["ids"]
    ph = famdata["phenotypes"].copy()
    bv = pd.Series(np.asarray(famdata["true_bv"]), index=ids)
    y2 = 0.8 * bv.loc[ph["ID"]].to_numpy() + rng.normal(0, bv.std() * 0.9, len(ph))
    ph = ph.rename(columns={ph.columns[1]: "y1"})
    ph["y2"] = y2
    genotyped = set(rng.choice(ids, size=int(0.6 * len(ids)), replace=False))
    return ph, genotyped, dict(zip(ids, famdata["true_bv"]))


def chain_accuracy(pkg, famdata, mt=False):
    """The reference tests' SSBR chains (600 sweeps, burn-in 120, seed 3;
    the 2-trait one at a quarter of that, MT_SHORTER) in one package;
    returns the accuracies (all, non-genotyped) a trait."""
    if mt:
        pheno, genotyped, truth = _mt_pheno(famdata)
        eq, traits = "y1 = intercept + geno\ny2 = intercept + geno", ("y1", "y2")
    else:
        pheno, genotyped = famdata["phenotypes"], _genotyped(famdata)
        truth = dict(zip(famdata["ids"], famdata["true_bv"]))
        eq, traits = "y = intercept + geno", ("y",)
    jm, tm, jped, tped = _both(famdata, genotyped, eq)
    jm.ped = tm.ped = None
    cut = MT_SHORTER if mt else 1
    kw = dict(chain_length=600 // cut, burnin=120 // cut, seed=3, single_step_analysis=True,
              output_folder="", printout_model_info=False)
    if pkg == "port":
        out = jt.runMCMC(tm, as_table(pheno), device="cpu", pedigree=tped, **kw)
    else:
        out = jwas_tpu.runMCMC(jm, pheno, pedigree=jped, **kw)
    ids = [s for s in famdata["ids"]]
    non = [s for s in ids if s not in genotyped]
    accs = []
    for t in traits:
        accs.extend(_accuracy(out[f"EBV_{t}"], truth, ids, non))
    return tuple(accs), out


def test_single_trait_ssbr_chain_matches_jwas_tpu(famdata):
    """Single-trait SSBR BayesC (dense location path, K6): accuracy of all
    individuals and of the non-genotyped within ACC_MARGIN of jwas_tpu's
    and above the reference test's 0.55 / 0.4; J and epsilon in the
    location table."""
    acc, out = chain_accuracy("port", famdata)
    assert acc[0] > 0.55 and acc[1] > 0.4, acc
    assert all(a >= r - ACC_MARGIN for a, r in zip(acc, JWAS_ACC["st"])), (acc, JWAS_ACC)
    effs = set(zip(list(out["location parameters"]["Trait"]),
                   list(out["location parameters"]["Effect"])))
    assert ("y", "J") in effs and ("y", "ϵ") in effs


def test_two_trait_ssbr_chain_matches_jwas_tpu(famdata):
    """2-trait SSBR (tests/test_single_step.py::test_mt_ssbr_end_to_end) at
    a quarter of its length (MT_SHORTER): J and epsilon a trait, accuracy a
    trait within ACC_MARGIN of jwas_tpu's at the same length and above the
    reference's 0.35 (all) / 0.25 (non-genotyped)."""
    acc, out = chain_accuracy("port", famdata, mt=True)
    effs = set(zip(list(out["location parameters"]["Trait"]),
                   list(out["location parameters"]["Effect"])))
    for t in ("y1", "y2"):
        assert (t, "J") in effs and (t, "ϵ") in effs
    assert acc[0] > 0.35 and acc[1] > 0.25 and acc[2] > 0.35 and acc[3] > 0.25, acc
    assert all(a >= r - ACC_MARGIN for a, r in zip(acc, JWAS_ACC["mt"])), (acc, JWAS_ACC)


def test_sparse_single_step_chain(famdata, monkeypatch):
    """Single-trait SSBR forced onto the sparse path (sparse_location=True):
    epsilon's normals have the pedigree's length (factor_rows), the CG
    counts a draw a sweep, and the accuracy is within ACC_MARGIN of the
    dense path's jwas_tpu accuracy (200 sweeps, burn-in 40)."""
    genotyped = _genotyped(famdata)
    _, tm, _, tped = _both(famdata, genotyped)
    tm.ped = None
    out = jt.runMCMC(tm, as_table(famdata["phenotypes"]), device="cpu", pedigree=tped,
                     chain_length=200, burnin=40, seed=3, single_step_analysis=True,
                     sparse_location=True, output_folder="", printout_model_info=False)
    ids = list(famdata["ids"])
    acc = _accuracy(out["EBV_y"], dict(zip(ids, famdata["true_bv"])), ids,
                    [s for s in ids if s not in genotyped])
    assert out["_location_cg"]["solves"] == 200 and out["_location_cg"]["not_converged"] == 0
    assert acc[0] > 0.55 and acc[1] > 0.4, acc
    assert all(a >= r - ACC_MARGIN for a, r in zip(acc, JWAS_ACC["st"])), (acc, JWAS_ACC)


if __name__ == "__main__" and sys.argv[1:] == ["reference"]:
    fam = simulate_pedigree_genomic_data(n_founders=60, n_gen=3, n_per_gen=120, p=200,
                                         n_qtl=20, h2=0.5, seed=11)
    print("st", chain_accuracy("jwas_tpu", fam)[0])
    print("mt", chain_accuracy("jwas_tpu", fam, mt=True)[0])
