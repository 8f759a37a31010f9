"""tests/test_annotations.py's 2-trait annotated BayesC through jt.runMCMC
on the CPU (parity level (c) of ROADMAP.md): its packaged data, seed and
exact sweep, with its assertions (accuracy a trait above 0.5, the step-1
slope of the active signal above 0.1 and above the noise column's, the
joint-state pi table summing to 1), at a quarter of its chain length and
burn-in (SHORTER). The chain runs K7's plain version with a per-marker
pattern prior one marker step at a time, ~0.8 ms a step on one core: the
reference's 500 sweeps of 964 markers take seven minutes; a file of its
own, so that it runs beside the others on the test workers."""

import numpy as np

import jwas_tpu_torch as jt

SHORTER = 4     # the reference test's chain length and burn-in over this


def test_annotated_mt_bayesc_two_traits():
    """tests/test_annotations.py's 2-trait annotated BayesC (the tree
    probit, samplers I's K7 plain version with a per-marker prior) on its
    packaged data, seed and chain, with its assertions."""
    import pandas as pd

    from jwas_tpu.io.datasets import _simulated_annotations

    data = _simulated_annotations()
    anno = data["annotations_mt"]
    pi0 = {(0.0, 0.0): 0.9, (1.0, 0.0): 0.03, (0.0, 1.0): 0.03, (1.0, 1.0): 0.04}
    geno = jt.get_genotypes(
        data["genotypes"], np.eye(2), method="BayesC", estimatePi=True, name="geno",
        annotations=anno[["active_signal", "pleiotropy_signal", "direction_signal",
                          "random_signal"]].to_numpy(), Pi=pi0, device="cpu")
    model = jt.build_model("y1 = intercept + geno\ny2 = intercept + geno", np.eye(2),
                           genotypes=geno)
    out = jt.runMCMC(model, data["phenotypes_mt"], device="cpu", chain_length=500 // SHORTER,
                     burnin=100 // SHORTER, output_samples_frequency=10, seed=3, output_folder="",
                     printout_model_info=False)
    geno_mat = data["genotypes"].iloc[:, 1:].to_numpy(dtype=np.float64)
    ids = [str(s) for s in data["genotypes"]["ID"]]
    for ti, col in ((0, "true_effect_y1"), (1, "true_effect_y2")):
        bv = pd.Series(geno_mat @ data["truth_mt"][col].to_numpy(np.float64), index=ids)
        ebv = out[f"EBV_y{ti + 1}"]
        acc = np.corrcoef(np.asarray(ebv.EBV, dtype=np.float64),
                          bv.loc[[str(s) for s in ebv.ID]].to_numpy())[0, 1]
        assert acc > 0.5, f"trait {ti + 1} accuracy {acc:.3f}"
    c = out["annotation coefficients geno"]
    step1 = {a: float(e) for a, s, e in zip(c.Annotation, c.Step, c.Estimate) if s == 1}
    assert step1["Annotation_1"] > 0.1                 # active_signal
    assert step1["Annotation_1"] > abs(step1["Annotation_4"])  # > random noise
    pi_tab = np.asarray(out["pi_geno"].Estimate, dtype=np.float64)
    assert abs(pi_tab.sum() - 1.0) < 0.05
