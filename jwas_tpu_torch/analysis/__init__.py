"""Post-processing of a run: window GWAS, convergence diagnostics, LOOCV, lsmeans."""
