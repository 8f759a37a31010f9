"""prepare_packed_genotypes(low_memory=True) against jwas_tpu's.

A genotype CSV in tmp_path (numpy seed 8: 203 individuals, so the last
byte of a marker holds three codes; 150 markers, some rare enough for the
MAF filter, missing values as 9 and as empty fields), converted in chunks
of 24 rows (and 10, cut to 8: chunks stay 4-row aligned). The port must
write the same bytes, means, allele frequencies, IDs and missing flag as
jwas_tpu, return the store as a read-only memmap of the written file, and
raise jwas_tpu's errors.
"""

import os

import numpy as np
import pandas as pd
import pytest

import jwas_tpu
import jwas_tpu_torch as jt


def _csv(folder):
    rng = np.random.default_rng(8)
    n, p = 203, 150
    freqs = rng.uniform(0.05, 0.95, p)
    freqs[:5] = 0.003
    codes = rng.binomial(2, freqs, size=(n, p)).astype(object)
    codes[rng.random((n, p)) < 0.01] = 9
    codes[rng.random((n, p)) < 0.005] = None
    df = pd.DataFrame(codes, columns=[f"snp{j}" for j in range(p)])
    df.insert(0, "ID", [f"a{i}" for i in range(n)])
    path = os.path.join(folder, "geno.csv")
    df.to_csv(path, index=False)
    return path


@pytest.mark.parametrize("chunk_rows", [24, 10])
def test_low_memory_packing_matches_jwas_tpu(tmp_path, chunk_rows):
    csv = _csv(str(tmp_path))
    for maf in (0.0, 0.01):
        ref = jwas_tpu.prepare_packed_genotypes(
            csv, low_memory=True, MAF=maf, chunk_rows=chunk_rows,
            save_path=str(tmp_path / f"ref{maf}"))
        out = jt.prepare_packed_genotypes(
            csv, low_memory=True, MAF=maf, chunk_rows=chunk_rows,
            save_path=str(tmp_path / f"port{maf}"))
        assert isinstance(out.packed, np.memmap) and out.packed.mode == "r"
        assert out.packed.filename == str(tmp_path / f"port{maf}.j2b")
        np.testing.assert_array_equal(np.asarray(out.packed), np.asarray(ref.packed))
        np.testing.assert_array_equal(out.means, ref.means)
        np.testing.assert_array_equal(out.allele_freq, ref.allele_freq)
        assert out.obs_ids == ref.obs_ids and out.marker_ids == ref.marker_ids
        assert (out.n_obs, out.n_markers, out.has_missing) == (
            ref.n_obs, ref.n_markers, ref.has_missing)
        assert (out.n_markers < 150) == (maf > 0)
        # the in-memory converter agrees, and the files load back
        mem = jt.prepare_packed_genotypes(csv, MAF=maf)
        np.testing.assert_array_equal(mem.packed, np.asarray(out.packed))
        back = jt.Packed2BitStore.load(str(tmp_path / f"port{maf}"), mmap=True)
        np.testing.assert_array_equal(np.asarray(back.packed), np.asarray(ref.packed))
        assert not os.path.exists(str(tmp_path / f"port{maf}.j2b.tmp"))


def test_low_memory_errors_match_jwas_tpu(tmp_path):
    csv = _csv(str(tmp_path))
    table = jt.read_csv(csv)
    for pkg, frame in ((jwas_tpu, pd.read_csv(csv)), (jt, table)):
        with pytest.raises(TypeError, match="requires a genotype file path"):
            pkg.prepare_packed_genotypes(frame, low_memory=True,
                                         save_path=str(tmp_path / "x"))
        with pytest.raises(ValueError, match="requires save_path"):
            pkg.prepare_packed_genotypes(csv, low_memory=True)
        with pytest.raises(RuntimeError, match="disk_guard_ratio"):
            pkg.prepare_packed_genotypes(csv, low_memory=True, disk_guard_ratio=0.0,
                                         save_path=str(tmp_path / "x"))
    # a low-memory store runs through runMCMC, copied to the chain's device
    store = jt.prepare_packed_genotypes(csv, low_memory=True, MAF=0.01,
                                        save_path=str(tmp_path / "run"))
    rng = np.random.default_rng(2)
    pheno = jt.Table({"ID": np.array(store.obs_ids, dtype=object),
                      "y": rng.normal(size=store.n_obs)})
    model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(store))
    out = jt.runMCMC(model, pheno, device="cpu", chain_length=16, fast_blocks=8,
                     output_folder="", printout_model_info=False)
    assert np.isfinite(out["EBV_y"].EBV).all() and len(out["EBV_y"]) == store.n_obs
