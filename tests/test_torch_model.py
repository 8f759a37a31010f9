"""The model layer against jwas_tpu: get_genotypes, build_model,
prepare_workspace, validate_args, and the options the port refuses.

One data set (numpy seed 5) holds every case at once: genotypes with
missing codes and rare markers that QC drops, phenotypes in shuffled order
with missing values, missing factor levels, IDs without genotypes
(dropped) and genotyped IDs without phenotypes (output only). jwas_tpu gets
a pandas DataFrame; the port gets the same DataFrame and the same CSV read
as a Table.
"""

import os
import re

import jax
import numpy as np
import pandas as pd
import pytest

import jwas_tpu
from jwas_tpu.engine.setup import MCMCOptions as RefOptions
from jwas_tpu.engine.setup import prepare_workspace as ref_prepare
from jwas_tpu.engine.validation import validate_args as ref_validate
import jwas_tpu_torch as jt
from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace
from jwas_tpu_torch.engine.validation import validate_args

PRIORS = ("vare0", "scale_R", "marker_var0", "marker_scale0")


def write_data(folder, seed=5, n=120, p=200, n_pheno=100, n_extra=10):
    """Genotype and phenotype CSVs; returns their paths."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.05, 0.95, p)
    freqs[:6] = 0.002                       # rare: dropped at MAF 0.01
    codes = rng.binomial(2, freqs, size=(n, p)).astype(float)
    codes[rng.random((n, p)) < 0.01] = 9.0  # missing_value
    ids = [f"id{i}" for i in range(n)]
    geno = os.path.join(folder, "geno.csv")
    pd.DataFrame(codes.astype(int), columns=[f"m{j}" for j in range(p)]).assign(
        ID=ids)[["ID"] + [f"m{j}" for j in range(p)]].to_csv(geno, index=False)
    pid = ids[:n_pheno] + [f"nogeno{i}" for i in range(n_extra)]
    m = len(pid)
    y = np.round(rng.normal(10, 2, m), 3).astype(object)
    y[rng.choice(m, 6, replace=False)] = None
    herd = rng.integers(1, 6, m).astype(object)
    herd[rng.choice(m, 5, replace=False)] = None
    sex = rng.choice(["M", "F"], m).astype(object)
    sex[rng.choice(m, 4, replace=False)] = None
    age = np.round(rng.uniform(1, 5, m), 2)
    order = rng.permutation(m)
    pheno = os.path.join(folder, "pheno.csv")
    pd.DataFrame({"ID": np.array(pid)[order], "y": y[order], "herd": herd[order],
                  "sex": sex[order], "age": age[order]}).to_csv(pheno, index=False)
    return geno, pheno


CASES = {
    "intercept": dict(eq="y = intercept + geno"),
    "covariate": dict(eq="y = intercept + herd + age + geno", cov="age"),
    "interaction": dict(eq="y = intercept + herd*sex + geno"),
    "bayesc_pi": dict(eq="y = intercept + sex + geno", geno=dict(Pi=0.95)),
    "fixed_pi": dict(eq="y = intercept + geno", geno=dict(estimatePi=False)),
    "bayesr": dict(eq="y = intercept + herd + geno", geno=dict(method="BayesR")),
    "bayesr_pi": dict(eq="y = intercept + geno",
                      geno=dict(method="BayesR", Pi=[0.9, 0.05, 0.03, 0.02])),
    "prediction": dict(eq="y = intercept + herd + geno",
                       opts=dict(prediction_equation="herd")),
    "output_ids": dict(eq="y = intercept + sex + geno", output=True),
    "marker_variance": dict(eq="y = intercept + geno",
                            geno=dict(G=0.01, G_is_marker_variance=True)),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    jax.config.update("jax_enable_x64", False)
    folder = str(tmp_path_factory.mktemp("model"))
    geno, pheno = write_data(folder)
    ref_store = jwas_tpu.prepare_packed_genotypes(
        geno, MAF=0.01, save_path=os.path.join(folder, "store"))
    return dict(geno=geno, pheno=pheno, df=pd.read_csv(pheno),
                table=jt.read_csv(pheno), ref_store=ref_store,
                store_path=os.path.join(folder, "store"))


def _models(pkg, data, case, source):
    kw = dict(CASES[case].get("geno", {}))
    g = pkg.get_genotypes(source, storage="2bit", name="geno", **kw)
    model = pkg.build_model(CASES[case]["eq"], genotypes=g)
    if "cov" in CASES[case]:
        pkg.set_covariate(model, CASES[case]["cov"])
    if CASES[case].get("output"):
        pkg.outputEBV(model, ["id3", "id110", "nogeno1", "id50", "id117"])
    return model


def _same_workspace(ours, ref):
    assert ours.model.term_names() == ref.model.term_names()
    assert ours.obs_ids == ref.obs_ids and ours.output_ids == ref.output_ids
    np.testing.assert_array_equal(ours.W, ref.W)
    np.testing.assert_array_equal(ours.y, ref.y)
    np.testing.assert_array_equal(ours.y_mask, ref.y_mask)
    for k in PRIORS:
        np.testing.assert_allclose(getattr(ours, k), getattr(ref, k), rtol=1e-12)
    assert (ours.df_R, ours.df_marker) == (ref.df_R, ref.df_marker)
    np.testing.assert_allclose(ours.pi0, ref.pi0, rtol=1e-12)
    assert ours.prediction_terms == ref.prediction_terms
    for k, x in ref.output_X.items():
        np.testing.assert_array_equal(ours.output_X[k], x)
    store = ours.geno.packed_store
    assert [store.obs_ids[i] for i in ours.output_store_rows] == ours.output_ids


def test_workspace_matches_jwas_tpu(data):
    for case in CASES:
        opts = dict(CASES[case].get("opts", {}), output_folder="",
                    printout_model_info=False)
        ref = ref_prepare(_models(jwas_tpu, data, case, data["ref_store"]),
                          data["df"], RefOptions(**opts))
        assert ref.n_obs < 100 and len(ref.output_ids) != ref.n_obs
        for df in (data["df"], data["table"]):
            store = jt.Packed2BitStore.load(data["store_path"])
            ours = prepare_workspace(_models(jt, data, case, store), df,
                                     MCMCOptions(**opts))
            _same_workspace(ours, ref)


def test_get_genotypes_from_csv_and_store(data):
    ref = jwas_tpu.get_genotypes(data["geno"], storage="2bit")
    ours = jt.get_genotypes(data["geno"], storage="2bit")
    for g in (ours, jt.get_genotypes(jt.Packed2BitStore.load(data["store_path"]))):
        assert g.marker_ids == ref.marker_ids and g.obs_ids == ref.obs_ids
        assert g.n_markers == ref.n_markers < 200
        s, r = g.packed_store, ref.packed_store
        np.testing.assert_array_equal(s.packed, r.packed)
        np.testing.assert_array_equal(s.means, r.means)
        np.testing.assert_array_equal(s.allele_freq, r.allele_freq)
        assert s.has_missing is r.has_missing is True
        assert g.sum2pq == ref.sum2pq
    unfiltered = jt.get_genotypes(data["geno"], storage="2bit", quality_control=False)
    assert unfiltered.n_markers == 200
    rt = jt.get_genotypes(data["geno"], storage="2bit", method="BayesR")
    np.testing.assert_array_equal(rt.pi, jwas_tpu.get_genotypes(
        data["geno"], storage="2bit", method="BayesR").pi)


BAD = {
    "chain_length": dict(chain_length=0),
    "burnin": dict(chain_length=10, burnin=10),
    "n_chains": dict(n_chains=0),
    "double_precision": dict(double_precision=True),
    "single_step": dict(single_step_analysis=True),
    "rrm": dict(RRM=np.ones((3, 2))),
    "heterogeneous": dict(heterogeneous_residuals=True),
    "causal": dict(causal_structure=np.zeros((1, 1))),
    "rebuild": dict(),
}


def test_validate_args_gives_jwas_tpu_errors(data):
    for name, opts in BAD.items():
        errors = []
        for pkg, opts_cls, validate in ((jwas_tpu, RefOptions, ref_validate),
                                        (jt, MCMCOptions, validate_args)):
            store = (data["ref_store"] if pkg is jwas_tpu
                     else jt.Packed2BitStore.load(data["store_path"]))
            model = pkg.build_model("y = intercept + geno",
                                    genotypes=pkg.get_genotypes(store, storage="2bit"))
            if name == "rebuild":
                model.mme_pos = 7                 # a model that already ran
            with pytest.raises(Exception) as e:
                validate(model, opts_cls(**opts))
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1], name


UNPORTED = {
    "n_chains": 2, "mesh": object(), "checkpoint_frequency": 10, "resume": True,
    "use_pallas": False,
}
# options jwas_tpu rejects on the 2-bit store: its ValueError comes first
REJECTED = {
    "double_precision": (True, "supports Float32 only"),
    "heterogeneous_residuals": (True, "does not support heterogeneous residuals"),
    "single_step_analysis": (True, "does not support single-step analysis"),
    "RRM": (np.ones((2, 2)), "does not support random regression model"),
    "causal_structure": (np.eye(1), "only allowed in multi-trait"),
}


def test_unported_options_raise_naming_themselves(data):
    """Options the port does not run yet raise NotImplementedError naming
    themselves; those jwas_tpu rejects raise its ValueError, through
    runMCMC, in both packages. sparse_location=True runs (the sparse
    location path: one PO-CG draw a sweep)."""
    run = dict(chain_length=8, printout_model_info=False, output_folder="")
    model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
        jt.Packed2BitStore.load(data["store_path"])))
    out = jt.runMCMC(model, data["table"], device="cpu", sparse_location=True, **run)
    assert out["_location_cg"]["solves"] >= 1
    for option, value in UNPORTED.items():
        model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
            jt.Packed2BitStore.load(data["store_path"])))
        with pytest.raises(NotImplementedError, match=option):
            jt.runMCMC(model, data["table"], device="cpu", **run, **{option: value})
    for option, (value, message) in REJECTED.items():
        for pkg in (jwas_tpu, jt):
            store = (data["ref_store"] if pkg is jwas_tpu
                     else jt.Packed2BitStore.load(data["store_path"]))
            model = pkg.build_model("y = intercept + geno",
                                    genotypes=pkg.get_genotypes(store, storage="2bit"))
            kw = dict(device="cpu") if pkg is jt else {}
            with pytest.raises(ValueError, match=message):
                pkg.runMCMC(model, data["table"] if pkg is jt else data["df"],
                            **kw, **run, **{option: value})
    # jwas_tpu's runMCMC(double_precision=True) turned x64 on (fault R8)
    jax.config.update("jax_enable_x64", False)


def test_unported_model_features_raise(data):
    store = jt.Packed2BitStore.load(data["store_path"])
    # several equations build a multi-trait model (ported, engine/mcmc_mt.py)
    assert jt.build_model("y = intercept\nz = intercept").n_models == 2
    # latent traits and annotations are ported: the model records the
    # traits' types, the annotations go through jwas_tpu's checks, and the
    # 2-bit store refuses annotations as jwas_tpu's does
    for kw, tt in ((dict(censored_trait=["y"]), "censored"),
                   (dict(categorical_trait=["y"]), "categorical")):
        assert jt.build_model("y = intercept", **kw).traits_type == [tt]
    with pytest.raises(ValueError, match="storage='2bit'"):
        jt.get_genotypes(store, annotations=np.eye(200, 2))
    from jwas_tpu_torch.engine.setup import normalize_method
    for storage in ("f32", "f64", "int8"):
        for method in ("RR-BLUP", "BayesA", "BayesL", "GBLUP"):
            ref = jwas_tpu.get_genotypes(data["geno"], storage=storage, method=method)
            ours = jt.get_genotypes(data["geno"], storage=storage, method=method,
                                    device="cpu")
            assert isinstance(ours, jt.io.genotypes.Genotypes)
            assert (ours.method, ours.n_markers) == (ref.method, ref.n_markers)
            normalize_method(ours, jt.build_model("y = intercept"))
            assert (ours.method, ours.pi, ours.estimate_pi) == (
                "BayesB" if method == "BayesA" else method, 0.0, False)
        with pytest.raises(ValueError) as ref_err:
            jwas_tpu.get_genotypes(data["geno"], storage=storage, annotations=np.ones((200, 1)))
        with pytest.raises(ValueError, match=re.escape(str(ref_err.value)[:30])):
            jt.get_genotypes(data["geno"], storage=storage, device="cpu",
                             annotations=np.ones((200, 1)))
    assert jt.get_genotypes(store, method="BayesB").method == "BayesB"
    for method in ("BayesA", "RR-BLUP", "BayesL", "GBLUP"):
        with pytest.raises(ValueError, match="BayesC/BayesB/BayesR only"):
            jt.get_genotypes(store, method=method)
    with pytest.raises(ValueError, match="length-4"):
        jt.get_genotypes(store, method="BayesR", Pi=[0.5, 0.5])
    g2 = jt.get_genotypes(store, name="g2")
    with pytest.raises(ValueError, match="R2"):
        jt.build_model("y = intercept + geno + g2",
                       genotypes=[jt.get_genotypes(store), g2])
