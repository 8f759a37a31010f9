"""The port's annotation priors (ops/annotations.py, annotated runMCMC)
against jwas_tpu/ops/annotations.py and tests/test_annotations.py.

Draws replayed (parity level (b) of ROADMAP.md): each function of the
port takes its draws from a `draws` object; JaxDraws gives it jwas_tpu's,
from the function's own keys in its own split order (a probit step's key
split into liabilities, coefficients' normals and the slope variance's
gamma; BayesR's and the 2-trait tree's key split into three steps). The
coordinate Gibbs pass, the slope variance and the three updates (annotated
BayesC's probit, BayesR's nested probits, 2-trait BayesC's tree probit with
its per-marker (p_pad, 4) prior) equal jwas_tpu's at rtol 1e-5 / atol 1e-6
in float32 and 1e-10 / 1e-12 in float64; the padding's rows are pinned.

Chains (parity level (c)): the single-trait models of
tests/test_annotations.py through jt.runMCMC on the CPU, on its data and
seeds, with its assertions (accuracy, a slope above 0.3, the pi tables), at
a quarter of its chain lengths and burn-ins (SHORTER: the port's CPU plain
versions take one Python-level step a marker, and the reference's lengths
cost the suite minutes), and its validation cases; its 2-trait model is
tests/test_torch_annotations_mt.py's (a file of its own, so that the chains
spread over the test workers).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops import annotations as jan
from jwas_tpu_torch.ops import annotations as an
from test_annotations import _anno_sim

import jwas_tpu_torch as jt

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-10, atol=1e-12)}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
SHORTER = 4     # the reference tests' chain lengths and burn-ins over this


@contextlib.contextmanager
def x64(dtype):
    jax.config.update("jax_enable_x64", dtype == torch.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _t(x, dtype):
    return torch.as_tensor(np.array(x), dtype=dtype)


class JaxDraws:
    """jwas_tpu's draws of _probit_step (k_l, k_c, k_v = split(key, 3)):
    truncated_normal(k_l, a, b), normal(k_c, (k,)), gamma(k_v, (k + 1) / 2);
    steps: 1 (the key is the step's) or 3 (split(key, 3), one a step)."""

    def __init__(self, key, steps, dtype):
        keys = [key] if steps == 1 else list(jax.random.split(key, 3))
        self.keys = [jax.random.split(k, 3) for k in keys]
        self.dtype = dtype

    def liability(self, s, a, b):
        z = jax.random.truncated_normal(self.keys[s][0], jnp.asarray(a.numpy()),
                                        jnp.asarray(b.numpy()), shape=a.shape,
                                        dtype=JDT[self.dtype])
        return _t(z, self.dtype)

    def normals(self, s, k, like):
        return _t(jax.random.normal(self.keys[s][1], (k,), dtype=JDT[self.dtype]), self.dtype)

    def gamma(self, s, shape, like):
        return _t(jax.random.gamma(self.keys[s][2], shape), self.dtype)


def _design(rng, p_pad, p, k):
    A = np.zeros((p_pad, k + 1))
    A[:p, 0] = 1.0
    A[:p, 1:] = np.column_stack([rng.integers(0, 2, p), rng.normal(size=(p, k - 1))])
    valid = (np.arange(p_pad) < p).astype(np.float64)
    return A, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coordinate_gibbs_and_slope_variance_match_jax(dtype):
    rng = np.random.default_rng(1)
    A, valid = _design(rng, 256, 240, 3)
    active = valid * (rng.uniform(size=256) < 0.7)
    resid = rng.normal(size=256) * active
    coeffs = rng.normal(size=4) * 0.3
    key = jax.random.PRNGKey(2)
    with x64(dtype):
        J = lambda x: jnp.asarray(x, JDT[dtype])  # noqa: E731
        jc, jr = jan._coordinate_gibbs(key, J(A), J(resid), J(coeffs), J(0.8), J(active))
        zs = jax.random.normal(key, (4,), dtype=JDT[dtype])
        jv = jan._slope_variance(key, jc)
        gamma = jax.random.gamma(key, 2.5)
    pc, pr = an.coordinate_gibbs(_t(A, dtype), _t(resid, dtype), _t(coeffs, dtype),
                                 _t(0.8, dtype), _t(active, dtype), _t(zs, dtype))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TOL[dtype])
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), **TOL[dtype])
    pv = an.slope_variance(pc, _t(gamma, dtype))
    np.testing.assert_allclose(float(pv), float(jv), **TOL[dtype])


UPDATES = {"BayesC": (jan.anno_bayesc_update, an.anno_bayesc_update, 1),
           "BayesR": (jan.anno_bayesr_update, an.anno_bayesr_update, 3),
           "2-trait BayesC": (jan.anno_bayesc_mt_update, an.anno_bayesc_mt_update, 3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", list(UPDATES))
def test_annotation_updates_match_jax_on_its_draws(model, dtype):
    """The whole update from one key: coefficients, slope variances and the
    per-marker prior (BayesC (p_pad,) P(excluded); BayesR's nested and the
    tree's (p_pad, 4) rebuilds), p = 240 real markers of p_pad = 256."""
    jfn, pfn, steps = UPDATES[model]
    rng = np.random.default_rng(3)
    p_pad, p, k = 256, 240, 3
    A, valid = _design(rng, p_pad, p, k)
    if model == "BayesC":
        delta = (rng.uniform(size=p_pad) < 0.3).astype(np.int32) * valid.astype(np.int32)
        coeffs, var = rng.normal(size=k + 1) * 0.3, np.asarray(1.0)
    elif model == "BayesR":
        delta = rng.integers(0, 4, p_pad) * valid.astype(np.int64)
        coeffs, var = rng.normal(size=(k + 1, 3)) * 0.3, np.ones(3)
    else:
        delta = (rng.uniform(size=(2, p_pad)) < 0.4).astype(np.float64) * valid
        coeffs, var = rng.normal(size=(k + 1, 3)) * 0.3, np.ones(3)
    key = jax.random.PRNGKey(4)
    with x64(dtype):
        J = lambda x: jnp.asarray(x, JDT[dtype])  # noqa: E731
        jc, jv, jpi = jfn(key, J(A), jnp.asarray(delta), J(coeffs), J(var), J(valid))
        pc, pv, ppi = pfn(_t(A, dtype), torch.as_tensor(delta), _t(coeffs, dtype),
                          _t(var, dtype), _t(valid, dtype), JaxDraws(key, steps, dtype))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TOL[dtype])
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL[dtype])
    np.testing.assert_allclose(ppi.numpy(), np.asarray(jpi), **TOL[dtype])
    pad = ppi.numpy()[p:]
    if model == "BayesC":
        assert (pad == 1.0).all()
    else:
        assert (pad == [1.0, 0.0, 0.0, 0.0]).all()
        np.testing.assert_allclose(ppi.numpy().sum(1), 1.0, rtol=1e-5)
    assert not np.allclose(pc.numpy(), coeffs)


def test_annotated_bayesc():
    geno_df, pheno, bv, anno = _anno_sim()
    geno = jt.get_genotypes(geno_df, method="BayesC", Pi=0.9, estimatePi=True,
                            annotations=anno, name="geno", device="cpu")
    model = jt.build_model("y = intercept + geno", genotypes=geno)
    out = jt.runMCMC(model, pheno, device="cpu", chain_length=800 // SHORTER, burnin=200 // SHORTER, seed=6,
                     output_folder="", printout_model_info=False)
    acc = np.corrcoef(np.asarray(out["EBV_y"].EBV, dtype=np.float64), bv)[0, 1]
    assert acc > 0.7, f"AnnoBayesC EBV accuracy {acc:.3f}"
    coeffs = out["annotation coefficients geno"]
    slope = float(np.asarray(coeffs.Estimate)[list(coeffs.Annotation).index("Annotation_1")])
    assert slope > 0.3, f"annotation slope {slope:.3f} should be clearly positive"
    pi = float(out["pi_geno"].Estimate[0])
    assert 0.0 < pi < 1.0


def test_annotated_bayesr():
    geno_df, pheno, bv, anno = _anno_sim(seed=32)
    geno = jt.get_genotypes(geno_df, method="BayesR", annotations=anno, name="geno",
                            device="cpu")
    model = jt.build_model("y = intercept + geno", genotypes=geno)
    out = jt.runMCMC(model, pheno, device="cpu", chain_length=800 // SHORTER, burnin=200 // SHORTER, seed=7,
                     output_folder="", printout_model_info=False)
    acc = np.corrcoef(np.asarray(out["EBV_y"].EBV, dtype=np.float64), bv)[0, 1]
    assert acc > 0.7, f"AnnoBayesR EBV accuracy {acc:.3f}"
    c = out["annotation coefficients geno"]
    s1 = (np.asarray(c.Annotation) == "Annotation_1") & (np.asarray(c.Step) == 1)
    assert float(np.asarray(c.Estimate)[s1][0]) > 0.3
    pi = dict(zip(out["pi_geno"].pi, np.asarray(out["pi_geno"].Estimate, dtype=np.float64)))
    assert pi["class0"] > 0.5          # most markers stay excluded
    assert abs(sum(pi.values()) - 1.0) < 0.02


def test_annotation_validation():
    geno_df, pheno, bv, anno = _anno_sim(n=50, p=40, n_qtl=5, seed=33)
    with pytest.raises(ValueError, match='method="BayesC" or method="BayesR"'):
        jt.get_genotypes(geno_df, method="RR-BLUP", annotations=anno, name="geno",
                         device="cpu")
    with pytest.raises(ValueError, match="must match the number of raw markers"):
        jt.get_genotypes(geno_df, method="BayesC", annotations=anno[:10], name="geno",
                         device="cpu")
    with pytest.raises(ValueError, match="constant column"):
        jt.get_genotypes(geno_df, method="BayesC", annotations=np.ones((40, 1)),
                         device="cpu")
    # a table whose first column holds the marker IDs is aligned by them
    ids = [str(c) for c in geno_df.columns[1:]]
    table = jt.Table({"marker_id": np.array(ids[::-1], dtype=object),
                      "a": anno[::-1, 0]})
    g = jt.get_genotypes(geno_df, method="BayesC", annotations=table, device="cpu",
                         quality_control=False)
    np.testing.assert_array_equal(g.annotations[:, 0], anno[:, 0])
