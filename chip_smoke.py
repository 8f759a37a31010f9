#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jwas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. the card (nvidia-smi name and power limit), the nvcc build of the
     kernels under jwas_tpu_torch/csrc/ and the g++ build of its host C++
     (csrc/pedigree.cpp, checked on a small pedigree);
  2. each kernel against its plain PyTorch version on identical inputs on
     the card, with the tolerance stated, both times and the kernel's bound
     (the larger of its bytes over 3.35 TB/s and its operations over
     67 TFLOP/s float32, H100 SXM); the chain kernels K1 and K3 also in the
     main path's three regimes at its shape (every step changes an effect,
     almost none does, the default BayesR class prior from alpha = 0), with
     ns a dependent step, the share of the steps that changed an effect and
     the evaluations a window of 32 markers, and at ragged and large block
     sizes; the dense path's shapes (K1 with nblocks = 1 at b = 256, the
     exact sweep's chunks, and at a ragged b = 160; K1 and K3 at b = 256
     over 23 blocks with 8 reps, a dense group's round) and the float64
     builds of K1/K2 and K3 at b = 136 (resident tile) and b = 256
     (global), against float64 plain versions; K1 in RR-BLUP's and
     BayesL's regime (every marker in the slab: zero uniforms, pi 1e-10,
     per-marker variances, padding held at 0 by log(1 - pi) = -inf) at
     phase 8a's round, a resident tile, a single block and in float64;
     K6, the location parameters' Gibbs pass, at phase 9a's LHS (K =
     19,902: W'W of its design plus the A^-1 blocks of its pedigree with a
     2 x 2 G and the herds' identity blocks), phase 5's (K = 102) and a
     random K = 2,000, in float32 and float64, with its launch shape (S, P),
     ns a dependent step and, beside it, the library yardstick: the pass as
     one lower-triangular solve (torch.linalg.solve_triangular plus its
     torch.mv), held against the plain version too; then at the ragged
     edges of its slices (K = 1, 33, S - 1, S + 1, 20,480, zero diagonals
     at a slice's first and last rows); every K6 check launches twice and
     demands the same x bit for bit; K7 and K8, the multi-trait samplers
     I and II, at phase 10a's round (t = 3, b = 256 over 23 blocks, 8
     reps) in float32 and float64, dense (a third of the indicators on)
     and sparse (the all-out pattern at prior 0.99), timed, with ns a
     dependent step, the window model's counts and the step floor at
     t = 3; then at t = 2 (one block), 4, 5 and 8, a per-locus Ginv, a
     ragged b with a short last group's padding, b = 300 and 1,040 (two
     and eight markers a thread): alpha, beta, delta and rhs bit for bit
     the sequential plain version, a second launch bit for bit, padding
     at 0; K7 and K8 with a per-marker pattern prior (one (2^t,) row a
     marker, csrc/mt_inner_rounds_pm.cu) at t = 2 and 3, b = 40, 256, 300
     and 2,048 (padding at 0 and not), both builds, bit for bit, rows
     equal to a global prior giving the global form's bits, and timed
     beside the global form at t = 2 and 3 at phase 10a's round; the
     registers and spills of every K7 / K8 / K9 instantiation (phase 1); K9, the multi-trait RR-BLUP / BayesL chain, at phase 11a's
     round (t = 3, b = 256 over 23 blocks, 8 reps) for RR-BLUP and BayesL
     in float32 and float64, timed, with ns a dependent step, its byte
     bound and its library yardstick (the Gibbs pass as a batched
     torch.linalg.solve_triangular on D + L of each block's (b t, b t)
     matrix plus a torch.bmm, 8 passes), held against the plain version
     too; then at t = 2 (one block), 4, 5 and 8, a ragged b = 136 with a
     short last group's padding, b = 300, 700 and 2,048: alpha and rhs bit
     for bit the plain version, a second launch bit for bit, padding at 0;
     K10, the random-regression marker chain, at phase 14's shape (nind
     10,000 and a ragged 9,999, 10 test days, c = 3, p = 256, the same
     draws fed to both) for BayesC's labels and the RR-BLUP form, at c = 1
     and 5, at one block of 37 individuals, and at p ragged against its
     chunk b (4 b + 1, 37 < b; float64 c = 5 over two chunks and a ragged
     third), and above phase 14's herd (40,000, 100,000 at c = 5, 300,000
     and the most individuals it takes: its genotype rows read in tiles
     of individuals, chunks down to b = 1; the plan asserted), float32
     and float64: alpha and beta within rtol 1e-5, atol
     1e-6, the grid within rtol 1e-4, atol 1e-5 (float64: 1e-10 / 1e-12,
     1e-9 / 1e-11), delta equal on >= 99.9% of the markers (float64: all),
     a second launch bit for bit, the plain version's ms at p = 256; then
     K10 alone at phase 14's full shape (p = 50,000, X 2.0 GB in float32):
     ms a sweep, ns a marker, its byte bound, the chunk b, the
     cross-Grams' build seconds and bytes, the probes (a chunk's exchange
     and fixed cost, the wait and the partials' loads in it, the next
     chunk's inputs alone, the chain's ns a marker), the most individuals
     it takes at 10 time points (raises below the first design's 547,000
     / 283,000), and the registers and spills of its ten instantiations;
  3. the main paths at full width: a 2-bit store of N = 50,000 x
     P = 2,097,152 generated on the device, its Gram tiles, then run_st
     (single-trait, b = 128, gb = 128, nreps = 128, sync_every = 8) for
     three outer iterations of BayesC and then of BayesR on the same store
     and Grams, with the launch count of every kernel in each path;
  4. a statistical check: a small simulation run through run_st, BayesC
     on the card and on the CPU (plain versions, in a worker process started
     before the build and stopped at the end; 256 sweeps: 1,024 until
     phase 11, 512 until phase 13 came; 192 fell below the floor), BayesR on the card (1,024); EBV accuracy must hold. Then runMCMC on the same data through a Table:
     its EBVs must equal run_st's on the card;
  5. runMCMC, the user's entry point, at full width: phase 3's device store
     (its Gram tiles freed) as a Packed2BitStore, 45,000 of its 50,000
     individuals phenotyped in shuffled order with a 100-level herd factor
     and an age covariate, the other 5,000 prediction candidates;
     y = intercept + herd + age + geno, BayesC, fast_blocks = 128, three
     outer iterations, result and sample files written to a temporary
     folder. Set-up and chain seconds, peak memory, launches, samples, EBV
     accuracy of candidates and training individuals, herd estimates
     against the true herd effects;
  6. (a) runMCMC BayesB on phase 5's data at runMCMC's default block size
     (b = 136, gb = 128: 121 groups, the last one short and served from a
     zero-padded copy of its rows), three outer iterations on the same
     device store, used in place, peak memory within store + Grams + 4 GB;
     (b) BayesC through runMCMC on phase 3's problem at fast_blocks = 128,
     the store resident, then streamed from a pinned host copy with no group
     and with half of the groups on the card, each of the two twice, in the
     order streamed, hybrid, hybrid, streamed, two outer iterations each
     (three until phase 14 came): the chains equal bit for bit;
     seconds per outer iteration, the copies' GB/s and, from a profiled
     chain of the first streamed and the first hybrid run, the device's
     busy share and the share of the copies' device time during which a
     kernel ran;
  7. dense genotypes at full width, N = 50,000 x P = 100,000 (the JWAS
     calibration row of BASELINE.md): Binomial(2, f) scores generated on
     the device as int8, phase 5's design (45,000 phenotyped in shuffled
     order, herd, age, 5,000 candidates) with a 'weights' column
     ~ U(0.5, 2), get_genotypes(storage="f32") writing the 20 GB
     marker-major store on the card, then runMCMC: (a) BayesC, fast_blocks
     = True, heterogeneous_residuals (b = 256, gb = 23: 17 groups, 544
     rounds an outer iteration, K1's global-memory Gram branch), three
     outer iterations; (b) BayesR on the same store (K3 at b = 256); (c) the
     exact sweep (fast_blocks = False: 391 single-block groups of K1 with
     nblocks = 1 and one rep, the last one zero-padded),
     20 sweeps; (d) the float32 store freed, a float64 store of 40 GB and
     double_precision = True: BayesC for two outer iterations and BayesR
     for one (the float64 builds of K1 and K3). Each run: seconds by part
     and per window, peak memory within store + Grams + 4 GB, launches,
     EBV accuracy of candidates and training rows, the output IDs' EBVs
     against X alpha computed directly. Beside them the dense GEMVs of a
     round (torch.mv over a group's 1.18 GB slab) against their byte bound;
  8. the other single-trait methods on dense genotypes: (a) phase 7's
     20 GB float32 store and design without the weights, runMCMC RR-BLUP,
     BayesL and BayesA at fast_blocks = True (b = 256, gb = 23: K1 with
     every marker in the slab for the first two, BayesB's sweep with pi 0
     for BayesA), three outer iterations each, then RR-BLUP's exact sweep
     for 10 sweeps, each with run_dense's checks; (b) GBLUP on the first
     20,000 individuals: get_genotypes(method="GBLUP") builds the
     relationship matrix from their 100,000 markers on the card and frees
     the store, runMCMC with 18,000 of them phenotyped (float64 eigh of
     their block in the workspace) for 200 iterations: seconds of the
     matrix, the eigh, L and the output map, a window and an iteration,
     peak memory, EBV accuracy, and the EBVs against the output map times
     alpha;
  9. random effects and the pedigree: (a) the animal model beside the
     markers, y = intercept + age + herd + ID + dam + geno with the herd
     i.i.d. and "ID dam" on a pedigree of 9,900 (900 founders, 6
     generations of 1,500, drawn as jwas_tpu's _drop_pedigree draws them),
     genotypes of the last five generations (7,500) gene-dropped on the
     card at P = 2,097,152 and packed into the 2-bit store (3.9 GB), 6,500
     phenotyped and 1,000 candidates of the last generation, K = 19,902;
     runMCMC BayesC at its default block size for three outer iterations,
     result files written: get_pedigree, A^-1, workspace, store and Grams,
     chain seconds, K6's ms a pass and share, launches, peak memory, EBV
     accuracy; the EBVs equal out_W sol + X alpha, every covariance sample
     finite and positive definite; (b) pedigree BLUP without genotypes,
     y = intercept + age + herd + ID on a pedigree of 19,800, 16,000
     phenotyped, u ~ N(0, A) by the Mendelian recursion, K = 19,902, 100
     iterations profiled: ms an iteration, busy and K6's shares, accuracy;
     (c) a statistical check: a pedigree of 1,000, 600 genotyped at
     p = 2,000, "ID dam" and an i.i.d. herd, BayesC from pi = 0.99, 250
     sweeps (2,000 until phase 10, 1,000 until phase 13, 300 until phase 14
     came: the depth cuts keep the script's time) at fast_blocks = 8 on the card and on the CPU: the card's EBV
     accuracy within 0.05 of the
     CPU's, the 2 x 2 covariances' posterior means side by side. Every path
     above launches K6 for its location pass;
 10. multi-trait: phase 7's 20 GB float32 store made again with 3 traits
     (h2 0.5, 0.4, 0.3, genetic correlation 0.5, residual 0.2, 10% of
     each trait missing: 7 missing patterns), 45,000 phenotyped, 5,000
     candidates, y1..y3 = intercept + herd + age + geno (K = 306), two
     outer iterations of runMCMC (three until phase 14 came) at
     fast_blocks = True (b = 256, gb = 23) each: (a) BayesC, sampler I (K7), with the result files, and the
     location LHS assembly's device ms from the pieces and from W; (b)
     sampler II (K8); (c) BayesB (one 3 x 3 covariance a locus) and the
     mega-trait BayesC (K1 a trait); each: seconds by part and a window,
     peak memory within store + Grams + 4 GB, launches, the candidates'
     EBV accuracy a trait. (d) A 3-trait animal model yt = intercept +
     herd + ID on a pedigree of 6,000 with a 3 x 3 G, K = 18,303, 20
     iterations: ms an iteration by part (LHS assembly, K6, the rest),
     the LHS both ways, accuracy. (e) 3 traits at n = 2,000 x p = 2,000,
     150 sweeps (1,000 until phase 11, 500 until phase 13, 200 until phase
     14 came) at
     fast_blocks = 8 on the card and on the CPU: the
     card's accuracy within 0.05 of the CPU's on each trait; then the
     float64 builds of K7 and K8 for 64 sweeps each;
 11. multi-trait RR-BLUP, BayesL, SEM and GBLUP: on phase 10's store and
     design (before it is freed), two windows of 256 sweeps each (three
     until phase 14 came) at
     fast_blocks = True: (a) RR-BLUP (K9) with update_priors_frequency =
     256, result files written; (b) BayesL (K9, a gamma a marker); (c) SEM:
     BayesC sampler I (K7) with y1 -> y2, y1 -> y3, y2 -> y3 on the same
     genetic values with no missing record and independent residuals
     (the lambda draw reads R's diagonal), the phenotypes made recursive
     with lambda = (0.5, 0.3, -0.2): lambda beside the truth, overall =
     direct + indirect in its tables and their seconds at P = 100,000;
     each: seconds by part and a window, peak memory within store + Grams +
     4 GB, launches (K9's equal to K7's in 10a), the candidates' accuracy a
     trait. (d) Multi-trait GBLUP on the first 20,000 individuals (18,000
     phenotyped; reduced from N as phase 8b is), 200 iterations: the
     relationship matrix, the eigh and ms an iteration. (e) Multi-trait
     BayesL at n = 2,000 x p = 2,000, 150 sweeps (500 until phase 13,
     200 until phase 14 came) at fast_blocks = 8 on the
     card and on the CPU, the card's accuracy within 0.05 of the CPU's on
     each trait; then 64 sweeps of K9's float64 build;
 12. latent traits and annotations on phase 10's store and genetic values
     (45,000 phenotyped, herd and age, 5,000 candidates, h2 0.5, two
     windows of 256 sweeps (three until phase 14 came) at fast_blocks =
     True): (a) single-trait binary
     BayesC, prevalence 0.2; (b) a 4-category trait (cut at the 0.3, 0.6,
     0.85 quantiles of the liability), then a censored one (the top 40%
     right-censored); (c) annotated BayesC and BayesR with 4 annotations,
     the first marking 20% of the markers, every QTL among them; (d)
     2-trait annotated BayesC (h2 0.5 / 0.4, 10% missing) with sampler I
     then II, K7 and K8 with a per-marker prior; (e) 3 traits, continuous,
     binary and 4-category, sampler I, R's binary entry by Korsgaard's
     draw. Each: seconds a window, peak memory, launches, the candidates'
     accuracy a trait, the latent step's and the annotation update's
     device ms, host ms and device operations an iteration (CUDA events;
     torch.profiler on the first call); vare exactly 1 for a categorical
     trait, R_bb 1 within 1e-5, the first annotation's slope. (f) A
     statistical check at n = 2,000 x p = 2,000, 150 sweeps (500 until
     phase 13, 300 until phase 14 came) at fast_blocks = 8 on the card and on the CPU of
     (a)'s, (c)'s BayesC, (d)'s sampler I and (e)'s models, the card
     within 0.05 of the CPU on each trait; then 64 float64 sweeps of (d)'s
     model with samplers I and II;
 13. the sparse location path, solve and single-step, on a generational
     pedigree of 100,000 animals (tests/integration/test_ssbr_scale.py's
     design: 2,000 a generation, parents from the two before;
     get_pedigree timed), u ~ N(0, A) through hAi: (a) y = intercept + ID
     with 30,000 phenotyped (tests/test_sparse_mme.py's 100,001-level
     design): solve with CG and with Jacobi on the card (seconds,
     iterations, relative residual, BLUP accuracy; CG against Jacobi r
     >= 0.999 and accuracy >= 0.55 raise), then runMCMC of the model for
     3 windows of 32 sweeps (cut from 256 for the script's time, from 64
     when phase 14 came) on the
     sparse path: a sweep's device ms,
     PO-CG iterations, device operations and an iteration's byte bound,
     fault R3's counters, two 8-sweep chains of one seed bit for bit;
     (b) single-step BayesC at full width: the youngest 20,000 genotyped
     at P = 50,000 (Binomial(2, f) on the card, 50 QTL), 10,000 of them
     and 40,000 non-genotyped phenotyped (y = intercept + herd + geno,
     100 herds, h2 0.5 split between 0.6 u and the markers), EBVs for the
     other 10,000 genotyped and the non-genotyped phenotyped; K = 80,102
     (epsilon's 80,000 levels: the sparse path on its own), the imputed
     60,000 x 50,000 store (12 GB), the exact sweep as the gated test runs
     it (K1 with nblocks = 1 at b = 256, its global Gram branch; the
     blocked schedule diverged here: ssbr_genotypes), 3 windows of 8
     sweeps (cut from 256 for the script's time): seconds by part (pedigree, A^-1 partition,
     imputation with its CG iterations and worst residual, J, workspace,
     store, chain, results), a window, a PO-CG draw's ms, iterations and
     operations against K1's and the GEMVs', K1's launches, peak memory;
     raises if K1 never launched, the imputation's residual > 1e-6, a
     draw is not finite, the chain's peak > store + 4 GB or an accuracy
     < 0.3; (c) 13b's generator at 5,000 animals, 1,000 genotyped, p =
     2,000 (700 genotyped and 1,300 others phenotyped), pi held at 0.98
     (ssbr_genotypes), 300 sweeps (500 until phase 14 came) at
     fast_blocks = 8 on the card and on
     the CPU:
     single-trait SSBR on the sparse path (K1) and 2-trait SSBR on the
     dense path (K6, K7; on the generator's first 2,000 animals, 800
     non-genotyped phenotyped, K = 2,044: at 5,000 animals, K = 8,044,
     the CPU's plain location pass took ~1.5 s an outer iteration), the
     card within 0.05 of the CPU;
 14. random regression (RRM), tests/test_rrm.py's _rrm_sim scaled up: (a)
     10,000 animals x 10 test days, 15% of the cells unrecorded (~85,000
     records), P = 50,000 Binomial(2, f) markers made on the card into a
     2.0 GB float32 store, c = 3 (Legendre order 2), 50 QTL with c-vector
     effects, noise sd = sd(U), a permanent-environment effect of sd 0.8
     sd(U); y = intercept + time + ID + geno with time a covariate and ID
     i.i.d. (test_rrm_with_iid_random_effect's model, K = 10,002), BayesC,
     3 windows of 128 sweeps (32 until K10's chunked design), files
     written: seconds by part (data, Phi, mPhiPhi and K10's cross-Grams,
     workspace, chain, results), a window's seconds, an outer
     iteration's device ms by part (K10's call, K6's pass, the LHS, the
     rest; CUDA events), K10's ns a marker step against its bound, peak
     memory, the trajectory EBVs' accuracy against the simulated U; raises
     if K10 or K6 never launched, a posterior mean is not finite, the peak
     exceeds X + W + W'W + 4 GB or the accuracy is below 0.55
     (tests/test_rrm.py:84's floor); (b) the card against the CPU at
     _rrm_sim's shape (250 animals, p = 100, 5 days, c = 2, 600 sweeps)
     with BayesC, and test_rrm_with_pedigree_polygenic_effect's model
     at its 200 sweeps (RR-BLUP, ID on a pedigree of 150, p = 60, 4
     days): the card's trajectory accuracy within 0.05 of the CPU's; then 100 float64 sweeps
     of the BayesC model on the card (K10's and K6's float64 builds).
 15. GWAS, the diagnostics and several chains: (a) at N = 50,000 x P = 100,000
     (JWAS's calibration row), a 2-bit store made on the card, 0.1% QTL,
     phase 5's design (45,000 phenotyped, herd, age, 5,000 candidates):
     runMCMC BayesC at its default block size (b = 136) with n_chains = 2,
     output_chain_samples and output_marker_samples, 45 outer iterations,
     5 burnt in (40 samples a chain); GWAS(file) (model frequencies), GWAS
     over 1 Mb windows of a 10-chromosome map (100 markers a window) with
     local EBVs and the variance proportions, and the window correlations
     of chain 1's and chain 2's marker-effect files; PSRF_per_parameter of
     the chains' residual variances and first 1,000 marker effects; LOOCV's
     eBV branch on 2,000 candidates x 2,000 markers in float64 on the card.
     Seconds by part (the chains, writing the files, reading them, BV, the
     windows, the correlation, PSRF), BV's TFLOP/s, GWAS's peak memory, the
     PSRF table, the candidates' pooled EBV accuracy; raises if K2, K4, K5
     or K6 never launched, a result is not finite, numSNP does not sum to
     P, a WPPA leaves [0, 1], the local EBVs summed over the windows miss
     X mean(alpha) (64 candidates decoded directly) by more than 1e-4
     relative, the QTL windows' mean WPPA is not above the others', a
     window among the 3 largest estimate_cov has estimate_cor <= 0.5, or
     GWAS's peak exceeds the store + 1 GB + 4 GB; (b) on phase 3's
     north-star store, before it is freed (run after phase 6b): runMCMC
     BayesC from pi = 0.999 (fast_blocks = 128; from pi = 0 the blocked
     chain at p = 42 n gave EBVs uncorrelated with the truth on the card)
     with the marker samples, 13 outer
     iterations, 5 burnt in, then GWAS with 1 Mb windows over 20
     chromosomes and local EBVs: seconds by part with the file's writing and
     reading apart, BV's TFLOP/s, the same checks where they apply, above
     all the peak (no dense (n, p) matrix); (c) phase 4's data (2,000 x
     8,192) through a short runMCMC on the card (20 samples), then GWAS on
     the card and on the CPU (fixed windows, sliding ones over the first
     1,024 markers, local EBVs, the correlation of the file and a rolled
     copy): prGenVar
     within rtol 1e-4, atol 1e-6, WPPA equal but where a proportion lies
     within 1e-5 of the threshold, local EBVs within 1e-4; LOOCV's two
     branches within 1e-8 relative; tests/test_multichain.py:10's model,
     three chains of 600 sweeps on the card: EBV accuracy > 0.85, vare's
     PSRF in (0.8, 1.3).

Then one JSON line with the kernels, the card's line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Imports torch and numpy and the port; never jax or jwas_tpu.
"""

import bisect
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ATOL_GEMV = 1e-4      # x sqrt(n): an f32 sum of n terms of size ~1
RTOL_GEMV = 1e-4
DELTA_AGREE = 0.999   # K1: inclusion indicators equal on >= 99.9% of markers
# EBV accuracy of jwas_tpu.runMCMC on the phase-4 data, measured on the CPU
# with seed 5 at 1,024 sweeps (burn-in 256), was 0.7043 (seeds 6, 7: 0.6982,
# 0.7119); the floor is that minus 0.1. Phase 4's BayesC chains run
# PHASE4_SWEEPS (burn-in a quarter) to keep the script's time; both paths
# print their accuracy beside the floor
ACC_FLOOR = 0.6043
PHASE4_SWEEPS = 256
ACC_MARGIN = 0.05     # kernel path may trail the plain path by at most this
# EBV accuracy of jwas_tpu.runMCMC BayesR (storage='2bit', default class
# prior) on the phase-4 data, measured on the CPU with the same chain
# settings, seeds 5, 6, 7: 0.9327, 0.9389, 0.9490; the floor is the lowest
# minus 0.1
ACC_FLOOR_BAYESR = 0.8327
RTOL_RUNMCMC = 1e-5   # phase 4: runMCMC's EBVs against run_st's, same chain
# phase 5: the posterior mean EBV (float32 sums of 2M terms a sample)
# against X times the posterior mean effects in float64, relative to the
# largest of them
RTOL_DIRECT_EBV = 1e-3
PHASE5_KEYS = ("location parameters", "residual variance", "marker effects geno",
               "marker effects variances geno", "pi_geno", "EBV_y",
               "genetic_variance", "heritability")

K6 = "gibbs_pass_lambda"     # the location pass: every path launches it
REPLACES = {
    "abc_inner_rounds": "jwas_tpu/ops/pallas_sweep.py:68",
    "bayesr_inner_rounds": "jwas_tpu/ops/pallas_sweep.py:327",
    "packed_rhs": "jwas_tpu/ops/pallas_packed_gemv.py:55",
    "packed_matvec": "jwas_tpu/ops/pallas_packed_gemv.py:105",
    "abc_inner_rounds_f64": "jwas_tpu/ops/pallas_sweep.py:68",
    "bayesr_inner_rounds_f64": "jwas_tpu/ops/pallas_sweep.py:327",
    # not a Pallas kernel: the lax.scan of gibbs_pass_lambda (:18-37)
    "gibbs_pass_lambda": "jwas_tpu/ops/location.py:18",
    "gibbs_pass_lambda_f64": "jwas_tpu/ops/location.py:18",
    # not Pallas kernels: the lax.scan chains of the multi-trait samplers
    # (mt_abc_blocks_I :162, its scan :214; mt_abc_blocks_II :308, :354)
    "mt_abc_inner_rounds_I": "jwas_tpu/ops/multitrait.py:214",
    "mt_abc_inner_rounds_I_f64": "jwas_tpu/ops/multitrait.py:214",
    "mt_abc_inner_rounds_II": "jwas_tpu/ops/multitrait.py:354",
    "mt_abc_inner_rounds_II_f64": "jwas_tpu/ops/multitrait.py:354",
    # not a Pallas kernel: the lax.scan of mt_c0l_blocks (:436, its scan
    # :467; the exact form's :498)
    "mt_c0l_inner_rounds": "jwas_tpu/ops/multitrait.py:467",
    "mt_c0l_inner_rounds_f64": "jwas_tpu/ops/multitrait.py:467",
    # not a Pallas kernel: the lax.scan of sweep_rrm_abc (:67, its scan :119
    # over body :82)
    "sweep_rrm_abc": "jwas_tpu/ops/rrm.py:67",
    "sweep_rrm_abc_f64": "jwas_tpu/ops/rrm.py:67",
}
SOURCES = {
    "abc_inner_rounds": "jwas_tpu_torch/csrc/abc_inner_rounds.cu",
    "bayesr_inner_rounds": "jwas_tpu_torch/csrc/bayesr_inner_rounds.cu",
    "packed_rhs": "jwas_tpu_torch/csrc/packed_gemv.cu",
    "packed_matvec": "jwas_tpu_torch/csrc/packed_gemv.cu",
    "abc_inner_rounds_f64": "jwas_tpu_torch/csrc/abc_inner_rounds.cu",
    "bayesr_inner_rounds_f64": "jwas_tpu_torch/csrc/bayesr_inner_rounds.cu",
    "gibbs_pass_lambda": "jwas_tpu_torch/csrc/gibbs_pass.cu",
    "gibbs_pass_lambda_f64": "jwas_tpu_torch/csrc/gibbs_pass.cu",
    "mt_abc_inner_rounds_I": "jwas_tpu_torch/csrc/mt_inner_rounds.cu",
    "mt_abc_inner_rounds_I_f64": "jwas_tpu_torch/csrc/mt_inner_rounds.cu",
    "mt_abc_inner_rounds_II": "jwas_tpu_torch/csrc/mt_inner_rounds.cu",
    "mt_abc_inner_rounds_II_f64": "jwas_tpu_torch/csrc/mt_inner_rounds.cu",
    "mt_c0l_inner_rounds": "jwas_tpu_torch/csrc/mt_c0l_rounds.cu",
    "mt_c0l_inner_rounds_f64": "jwas_tpu_torch/csrc/mt_c0l_rounds.cu",
    "sweep_rrm_abc": "jwas_tpu_torch/csrc/rrm_sweep.cu",
    "sweep_rrm_abc_f64": "jwas_tpu_torch/csrc/rrm_sweep.cu",
}


_T0 = time.perf_counter()


def say(*args):
    """Print a line; a phase's heading ("== ...") with the script's seconds
    so far."""
    if args and str(args[0]).startswith("== "):
        args = args + (f"[{time.perf_counter() - _T0:.1f} s]",)
    print(*args, flush=True)


HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12             # float32 outside the tensor cores
F64_FLOPS = 34e12             # float64 outside the tensor cores


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over iters calls, after one warm-up.
    The device first spins ~10 ms while the host queues the launches, so a
    short kernel's time is the device's and not the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 2


def chain_bounds(inp, written, b, nblocks, nreps):
    """Roofline bound of one inner-rounds call (every input read once, the
    updated arrays written once; a step's rank-1 update of 2 b operations
    and ~20 for the marker itself, at the float32 or float64 peak). The
    chain of nreps * b dependent steps keeps a call far above it: the line
    prints the measured time a step."""
    nbytes = sum(t.numel() * t.element_size() for t in inp.values())
    nbytes += sum(inp[k].numel() * inp[k].element_size() for k in written)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    flops = F64_FLOPS if inp["grams"].dtype == torch.float64 else F32_FLOPS
    t_ops = nreps * b * nblocks * (2 * b + 20) / flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


K1_REGIMES = {
    # pi0 (the sweep clamps it to [1e-10, 1], ops/grouped.py), effects start at 0
    "mixed": (0.9, False),     # random effects, a third of the steps change one
    "dense": (0.0, False),     # every marker is included: every step changes
    "sparse": (0.999, True),   # from alpha = 0: almost no step changes
    "c0l": (0.0, False),       # RR-BLUP / BayesL (ops/grouped.py::
                               # sweep_blocks_c0l_grouped): all-zero uniforms,
                               # the last 3 markers padding (pi 1, log(1 - pi)
                               # = -inf, zero Gram rows, xpx 1), kept at 0
}


def k1_inputs(n, b, nblocks, nreps, seed, dev, regime="mixed", per_marker=False):
    """Random Gram tiles of n-observation blocks and a chain state of one of
    K1_REGIMES; per_marker: one variance a marker (BayesB, or BayesL's
    var_g gamma_j), else 0.02 for every marker."""
    pi0, from_zero = K1_REGIMES[regime]
    c0l = regime == "c0l"
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((nblocks, b, n), generator=g, device=dev)
    if c0l:
        x[-1, -3:] = 0.0
    grams = torch.bmm(x, x.transpose(1, 2))
    xpx = torch.diagonal(grams, dim1=1, dim2=2).contiguous()
    rhs = torch.bmm(x, torch.randn((nblocks, n, 1), generator=g, device=dev))[..., 0]
    alpha = 0.1 * torch.randn((nblocks, b), generator=g, device=dev)
    if from_zero:
        alpha.zero_()
    pi = torch.clamp(torch.full((nblocks, b), pi0, device=dev), 1e-10, 1.0)
    log_pi, log_pi_comp = torch.log(pi), torch.log1p(-pi + 1e-12)
    us = torch.rand((nreps * b, nblocks), generator=g, device=dev)
    if c0l:
        xpx[-1, -3:], alpha[-1, -3:], log_pi[-1, -3:] = 1.0, 0.0, 0.0
        log_pi_comp[-1, -3:] = -float("inf")
        us.zero_()
    return dict(
        grams=grams, xpx=xpx,
        var_eff=(0.005 + 0.03 * torch.rand((nblocks, b), generator=g, device=dev)
                 if per_marker else torch.full((nblocks, b), 0.02, device=dev)),
        log_pi=log_pi, log_pi_comp=log_pi_comp,
        alpha=alpha, beta=alpha.clone(),
        delta=(alpha != 0).to(torch.int32),
        rhs=rhs.contiguous(),
        us=us,
        zs=torch.randn((nreps * b, nblocks), generator=g, device=dev),
        inv_vare=torch.tensor([1.0 / 1.3], device=dev),
    )


def window_stats(window_ref, inp, outs, plain, nreps):
    """Share of the steps that changed an effect and evaluations a window,
    counted by the plain model of the kernels' schedule (ops/inner_rounds.py)
    on the same inputs; its outputs must equal the step-by-step plain
    version's, `plain`, to the last bit."""
    w = {k: v.clone() for k, v in inp.items()}
    stats = {}
    window_ref(**w, nreps=nreps, stats=stats)
    for k in outs:
        if not torch.equal(w[k], plain[k]):
            raise AssertionError(f"window model and plain version part in {k}")
    nblocks, b = inp["xpx"].shape
    return dict(changed_share=stats["changes"] / (nreps * b * nblocks),
                evals_per_window=stats["evaluations"] / stats["windows"])


def chain_line(rec, ms, plain, stats, steps):
    """The timing part of a K1/K3 line; fills rec."""
    rec.update(ms=ms, plain_ms=plain, step_ns=ms * 1e6 / steps)
    line = (f"; kernel {ms:.4f} ms ({rec['step_ns']:.1f} ns a dependent step), "
            f"plain {plain:.2f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    if stats:
        rec.update(stats)
        line += (f"; {stats['changed_share']:.2%} of the steps changed an "
                 f"effect, {stats['evals_per_window']:.2f} evaluations a window")
    return line


def as_dtype(inp, dtype):
    """The inputs with every floating-point tensor in dtype."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in inp.items()}


def check_k1(n, b, nblocks, nreps, dev, time_it, regime="mixed", per_marker=False,
             dtype=torch.float32):
    from jwas_tpu_torch.ops.inner_rounds import (abc_inner_rounds,
                                                 abc_inner_rounds_ref,
                                                 abc_inner_rounds_window_ref,
                                                 gram_resident)

    inp = as_dtype(k1_inputs(n, b, nblocks, nreps, 7, dev, regime, per_marker), dtype)
    fresh = lambda: {k: v.clone() for k, v in inp.items()}  # noqa: E731
    a = fresh()
    abc_inner_rounds(**a, nreps=nreps)
    r = fresh()
    abc_inner_rounds_ref(**r, nreps=nreps)
    torch.cuda.synchronize()
    same = a["delta"] == r["delta"]
    agree = same.float().mean().item()
    ok_blocks = same.all(dim=1)          # blocks whose chains never parted
    err = 0.0
    for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("beta", 1e-5, 1e-6),
                             ("rhs", 1e-4, 1e-5)):
        x, y = a[name][ok_blocks], r[name][ok_blocks]
        err = max(err, (x - y).abs().max().item())
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol)
    if agree < DELTA_AGREE:
        raise AssertionError(f"K1 b={b}: delta agreement {agree:.5f} < {DELTA_AGREE}")
    if regime == "c0l" and not (bool((a["alpha"][-1, -3:] == 0).all())
                                and int(a["delta"].sum()) == nblocks * b - 3):
        raise AssertionError(f"K1 c0l b={b}: a padding marker moved or a real one "
                             f"left the slab")
    line = (f"K1 {regime}{' per-marker var_eff' if per_marker else ''} "
            f"{str(dtype).replace('torch.', '')} b={b} nblocks={nblocks} reps={nreps} "
            f"gram={'resident' if gram_resident(b, nreps, dtype=dtype) else 'global'}: "
            f"delta agree {agree:.6f}, max |err| {err:.3g} "
            f"(alpha/beta rtol 1e-5 atol 1e-6, rhs rtol 1e-4 atol 1e-5)")
    rec = None
    if time_it:
        a = fresh()
        ms = cuda_ms(lambda: abc_inner_rounds(**a, nreps=nreps), 20)
        t = fresh()
        plain = cuda_ms(lambda: abc_inner_rounds_ref(**t, nreps=nreps), 1)
        rec = dict(max_abs_err=err,
                   **chain_bounds(inp, ("alpha", "beta", "delta", "rhs"), b,
                                  nblocks, nreps))
        stats = None
        if regime != "mixed":
            stats = window_stats(abc_inner_rounds_window_ref, inp,
                                 ("alpha", "beta", "delta", "rhs"), r, nreps)
        line += chain_line(rec, ms, plain, stats, nreps * b)
    say(line)
    return rec


def k3_inputs(n, b, nblocks, nreps, seed, dev, from_zero=False):
    """Random Gram tiles of n-observation blocks, the default class prior,
    a few markers in each slab class (none when from_zero: every effect
    starts at 0, as a chain does), and the last 3 markers padding (zero
    Gram rows, xpx 1, rhs 0, class prior [1, 0, 0, 0])."""
    from jwas_tpu_torch.engine.mcmc import DEFAULT_BAYESR_PI
    from jwas_tpu_torch.ops.grouped import gumbel_panel

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((nblocks, b, n), generator=g, device=dev)
    x[-1, -3:] = 0.0
    grams = torch.bmm(x, x.transpose(1, 2))
    xpx = torch.diagonal(grams, dim1=1, dim2=2).contiguous()
    xpx[-1, -3:] = 1.0
    rhs = torch.bmm(x, torch.randn((nblocks, n, 1), generator=g, device=dev))[..., 0]
    pi = torch.tensor(DEFAULT_BAYESR_PI, device=dev).expand(nblocks, b, 4).clone()
    pi[-1, -3:] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    cum = torch.cumsum(torch.tensor(DEFAULT_BAYESR_PI, device=dev), 0)
    u = torch.rand((nblocks, b), generator=g, device=dev)
    delta = (u[..., None] > cum[:3]).sum(-1).to(torch.int32)
    delta[-1, -3:] = 0
    if from_zero:
        delta.zero_()
    alpha = torch.where(delta > 0, 0.1 * torch.randn((nblocks, b), generator=g,
                                                      device=dev), 0.0)
    return dict(
        grams=grams, xpx=xpx, log_pi=torch.log(torch.clamp(pi, 1e-12, 1.0)),
        alpha=alpha, delta=delta, rhs=rhs.contiguous(),
        gumbel=gumbel_panel((nreps * b, nblocks, 4), g, dev),
        zs=torch.randn((nreps * b, nblocks), generator=g, device=dev),
        inv_vare=torch.tensor([1.0 / 1.3], device=dev),
        # class 3 (variance sigma^2) explains ~n / 1.3 * sigma^2 of a
        # marker's rhs variance: a few percent land in classes 1-3
        sigma_sq=torch.tensor([0.5 / n], device=dev),
    )


def check_k3(n, b, nblocks, nreps, dev, time_it, from_zero=False, dtype=torch.float32):
    from jwas_tpu_torch.ops.inner_rounds import (bayesr_inner_rounds,
                                                 bayesr_inner_rounds_ref,
                                                 bayesr_inner_rounds_window_ref,
                                                 gram_resident)

    inp = as_dtype(k3_inputs(n, b, nblocks, nreps, 9, dev, from_zero), dtype)
    fresh = lambda: {k: v.clone() for k, v in inp.items()}  # noqa: E731
    a = fresh()
    bayesr_inner_rounds(**a, nreps=nreps)
    r = fresh()
    bayesr_inner_rounds_ref(**r, nreps=nreps)
    torch.cuda.synchronize()
    same = a["delta"] == r["delta"]
    agree = same.float().mean().item()
    ok_blocks = same.all(dim=1)          # blocks whose chains never parted
    err = 0.0
    for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("rhs", 1e-4, 1e-5)):
        x, y = a[name][ok_blocks], r[name][ok_blocks]
        err = max(err, (x - y).abs().max().item())
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol)
    if agree < DELTA_AGREE:
        raise AssertionError(f"K3 b={b}: class agreement {agree:.5f} < {DELTA_AGREE}")
    if not ((a["delta"][-1, -3:] == 0).all() and (a["alpha"][-1, -3:] == 0).all()):
        raise AssertionError(f"K3 b={b}: a padded marker left class 0")
    exact = all(torch.equal(a[k], r[k]) for k in ("alpha", "delta", "rhs"))
    shares = torch.bincount(a["delta"].view(-1).long(), minlength=4).float()
    shares = (shares / shares.sum()).tolist()
    line = (f"K3 {'from alpha = 0 ' if from_zero else ''}"
            f"{str(dtype).replace('torch.', '')} b={b} nblocks={nblocks} reps={nreps} "
            f"gram={'resident' if gram_resident(b, nreps, 'BayesR', dtype) else 'global'}: "
            f"class agree {agree:.6f}, max |err| {err:.3g} (alpha rtol 1e-5 "
            f"atol 1e-6, rhs rtol 1e-4 atol 1e-5; bit for bit: {exact}); class "
            f"shares {', '.join(f'{x:.4f}' for x in shares)}")
    rec = None
    if time_it:
        a = fresh()
        ms = cuda_ms(lambda: bayesr_inner_rounds(**a, nreps=nreps), 20)
        t = fresh()
        plain = cuda_ms(lambda: bayesr_inner_rounds_ref(**t, nreps=nreps), 1)
        rec = dict(max_abs_err=err,
                   **chain_bounds(inp, ("alpha", "delta", "rhs"), b, nblocks,
                                  nreps))
        stats = None
        if from_zero:
            stats = window_stats(bayesr_inner_rounds_window_ref, inp,
                                 ("alpha", "delta", "rhs"), r, nreps)
        line += chain_line(rec, ms, plain, stats, nreps * b)
    say(line)
    return rec


def check_gemv(n, G, dev, missing, permuted, time_it):
    """K4 and K5 against their plain versions on one tile: K4 with the
    missing-code table and, on a tile without code 3, also without it; K5
    with none, 95%, 99.9% and all of v zero. A last slab of K4 is ragged
    whenever ceil(n / 4) is no multiple of 128 (or 64), as at every shape
    here."""
    from jwas_tpu_torch.ops import packed_gemv as pg
    from jwas_tpu_torch.ops.grouped import _decode_codes, store_order, unpad

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    bpm = (n + 3) // 4
    codes = torch.randint(0, 4 if missing else 3, (G, bpm, 4), generator=g,
                          device=dev, dtype=torch.uint8)
    codes.view(G, -1)[:, n:] = 0     # sub-byte padding, as the packer writes
    rows = (codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4)
            | (codes[..., 3] << 6))
    del codes
    means = 2.0 * torch.rand(G, generator=g, device=dev)
    perm = torch.randperm(n, generator=g, device=dev) if permuted else None
    w = torch.randn(n, generator=g, device=dev)
    v_full = torch.randn(G, generator=g, device=dev)
    keep = torch.rand(G, generator=g, device=dev)
    w_pad = store_order(w, 4 * bpm, perm)
    atol = ATOL_GEMV * n ** 0.5

    def err_of(got, want):
        torch.testing.assert_close(got, want, rtol=RTOL_GEMV, atol=atol)
        return (got - want).abs().max().item()

    rhs_p = pg.packed_rhs_ref(rows, means, w_pad)
    flags = (True,) if missing else (False, True)
    err_rhs = max(err_of(pg.packed_rhs(rows, means, w_pad, f), rhs_p)
                  for f in flags)
    vs = {share: torch.where(keep >= share, v_full, torch.zeros_like(v_full))
          for share in (*pg.ZERO_SHARES, 1.0)}
    err_mv = max(err_of(unpad(pg.packed_matvec(rows, means, v), n, perm),
                        unpad(pg.packed_matvec_ref(rows, means, v), n, perm))
                 for v in vs.values())
    say(f"K4/K5 n={n} G={G} missing={missing} row_perm={permuted}: "
        f"max |err| X'w {err_rhs:.3g} (missing table {flags}), Xv {err_mv:.3g} "
        f"(v zero shares {list(vs)}) (rtol {RTOL_GEMV}, atol "
        f"{ATOL_GEMV}*sqrt(n) = {atol:.3g})")
    if not time_it:
        return None

    # the yardstick no path calls: one torch.mv on the decoded float32 tile
    m = means[:, None]
    x = _decode_codes(rows, n, perm).to(torch.float32)
    x = torch.where(x == 3.0, m, x) - m
    err_of(torch.mv(x, w), rhs_p)
    mv_ms = {"packed_rhs": cuda_ms(lambda: torch.mv(x, w), 5),
             "packed_matvec": cuda_ms(lambda: torch.mv(x.T, v_full), 5)}
    del x
    out = {}
    ms = cuda_ms(lambda: pg.packed_rhs(rows, means, w_pad, False), 20)
    out["packed_rhs"] = dict(
        max_abs_err=err_rhs, ms=ms,
        ms_missing_table=cuda_ms(lambda: pg.packed_rhs(rows, means, w_pad, True), 20),
        plain_ms=cuda_ms(lambda: pg.packed_rhs_ref(rows, means, w_pad), 3),
        bound_ms=pg.bound_ms(G, bpm, G))
    sparse = {}
    for share in pg.ZERO_SHARES:
        v = vs[share]
        nnz = int((v != 0).sum())
        sparse[f"{share:.1%}"] = dict(
            nnz=nnz, ms=cuda_ms(lambda: pg.packed_matvec(rows, means, v), 20),
            bound_ms=pg.bound_ms(G, bpm, nnz))
    dense = sparse.pop(f"{pg.ZERO_SHARES[0]:.1%}")
    out["packed_matvec"] = dict(
        max_abs_err=err_mv, ms=dense["ms"],
        plain_ms=cuda_ms(lambda: pg.packed_matvec_ref(rows, means, v_full), 3),
        bound_ms=dense["bound_ms"], zero_rows=sparse)
    for name, rec in out.items():
        rec.update(bound_by="bytes", library_ms=None, decoded_mv_ms=mv_ms[name])
        say(f"  {name}: kernel {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"(bytes; {rec['bound_ms'] / rec['ms']:.1%} of it reached), plain "
            f"{rec['plain_ms']:.3f} ms; no PyTorch call takes the packed tile "
            f"(library_ms null), torch.mv on the decoded float32 tile "
            f"{mv_ms[name]:.3f} ms")
    say(f"  packed_rhs with the missing-code table: "
        f"{out['packed_rhs']['ms_missing_table']:.4f} ms")
    for share, r in sparse.items():
        say(f"  packed_matvec, {share} of v zero ({r['nnz']} rows read): kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of it reached)")
    return out


# K6 against its plain version: the dot product of a row with x sums K
# terms in another order than the plain version's torch.dot, and the
# difference passes through K dependent steps of a Gauss-Seidel pass, a
# contraction on the positive definite LHS; max |err| is held to this
# tolerance times max |x| of the plain result (float32: K^(1/2) ulp of a
# dot product is ~1e-5 relative at K = 2e4, the pass keeps it there)
K6_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def check_k6(label, A, x, b, zs, vare, time_it):
    """K6 (ops/location.py::gibbs_pass_lambda) against its plain version on
    the card, with the same draws zs, and a second launch on the same
    inputs equal bit for bit; the launch shape (S, P). With time_it, its
    time (5 passes), the plain version's (one pass), its bound (the LHS's
    bytes read once, and x, b, zs; or K (2K + 10) operations at the type's
    peak) and the library yardstick's time (k6_triangular: torch.mv, the
    right-hand side and torch.linalg.solve_triangular, the triangles built
    outside the timed window), held against the plain version too."""
    from jwas_tpu_torch.ops.location import gibbs_pass_lambda, gibbs_pass_lambda_ref

    K, dtype = x.shape[0], A.dtype
    if not torch.equal(A, A.T):
        raise AssertionError(f"K6 {label}: the LHS is not exactly symmetric")
    got = gibbs_pass_lambda(A, x, b, vare, None, zs=zs)
    grid = gibbs_pass_lambda.last_grid
    again = gibbs_pass_lambda(A, x, b, vare, None, zs=zs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = gibbs_pass_lambda_ref(A, x, b, vare, zs)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = K6_RTOL[dtype] * scale
    name = str(dtype).replace("torch.", "")
    line = (f"K6 {label} {name} K={K} (S, P) = {grid}: max |err| {err:.3g} (tolerance "
            f"{tol:.3g}: rtol {K6_RTOL[dtype]} x max |x| {scale:.3g}); a second launch "
            f"{'equal' if torch.equal(got, again) else 'DIFFERENT'} bit for bit")
    if not (err <= tol and bool(torch.isfinite(got).all()) and torch.equal(got, again)
            and grid[1] == -(-K // grid[0])):
        raise AssertionError(line)
    rec = None
    if time_it:
        ms = cuda_ms(lambda: gibbs_pass_lambda(A, x, b, vare, None, zs=zs), 5)
        solve = k6_triangular(A, x, b, vare, zs)
        lib_err = (solve() - want).abs().max().item()
        if not lib_err <= tol:
            raise AssertionError(f"K6 {label}: the triangular solve's max |err| {lib_err:.3g}")
        lib_ms = cuda_ms(solve, 5)
        del solve
        t_bytes = (A.numel() + 4 * K) * A.element_size() / HBM_BYTES_PER_S * 1e3
        t_ops = K * (2 * K + 10) / (F64_FLOPS if dtype == torch.float64
                                    else F32_FLOPS) * 1e3
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=lib_ms, library_max_abs_err=lib_err,
                   step_ns=ms * 1e6 / K, K=K, grid=list(grid))
        line += (f"; kernel {ms:.4f} ms ({rec['step_ns']:.1f} ns a dependent step), "
                 f"library (solve_triangular + mv) {lib_ms:.4f} ms (max |err| {lib_err:.3g}), "
                 f"plain {plain:.1f} ms, bound {rec['bound_ms']:.4f} ms "
                 f"({rec['bound_by']}; {rec['bound_ms'] / ms:.2%} of it reached)")
    say(line)
    return rec


def k6_triangular(A, x, b, vare, zs):
    """The pass as one lower-triangular solve, K6's library yardstick (the
    port never calls it): (D + L) x_new = b - U x + sqrt(vare diag A) o zs,
    D, L and U A's diagonal and strict lower and upper triangles; a row with
    a zero diagonal becomes an identity row with right-hand side x_i. The
    triangles, the noise and that right-hand side are built here, outside
    any timing; the returned function does the rest: one torch.mv, the
    right-hand side and torch.linalg.solve_triangular."""
    diag = torch.diagonal(A)
    zero = diag == 0
    DL, U = torch.tril(A), torch.triu(A, 1)
    DL[zero] = 0.0
    DL.diagonal()[zero] = 1.0
    U[zero] = 0.0
    noise = torch.where(zero, 0.0, torch.sqrt(vare * diag) * zs)
    b0 = torch.where(zero, x, b)

    def solve():
        rhs = b0 - torch.mv(U, x) + noise
        return torch.linalg.solve_triangular(DL, rhs[:, None], upper=False)[:, 0]

    return solve


def k6_vectors(A, seed):
    """x, b, zs and vare for a pass over A: x ~ N(0, 1/2), b = A x_true
    with x_true ~ N(0, 1), standard normal draws, vare 1."""
    g = torch.Generator(device=A.device)
    g.manual_seed(seed)
    K = A.shape[0]

    def normal():
        return torch.randn(K, generator=g, device=A.device, dtype=torch.float64).to(A.dtype)

    x, x_true, zs = 0.5 ** 0.5 * normal(), normal(), normal()
    return x, A @ x_true, zs, torch.ones((), dtype=A.dtype, device=A.device)


def phase5_lhs(dev, dtype, n=45_000, n_herds=100, seed=5):
    """The location LHS of phase 5's design (intercept, 100 herds, age over
    45,000 records): W'W, K = 102, exactly symmetric."""
    from jwas_tpu_torch.ops.location import symmetric_upper

    rng = np.random.default_rng(seed)
    W = np.zeros((n, n_herds + 2))
    W[:, 0] = 1.0
    W[np.arange(n), 1 + rng.integers(0, n_herds, n)] = 1.0
    W[:, -1] = np.round(rng.uniform(1.0, 5.0, n), 2)
    W = torch.as_tensor(W, dtype=dtype, device=dev)
    return symmetric_upper(W.T @ W)


def phase9a_lhs(dev, dtype, **design):
    """The location LHS of phase 9a's model (intercept, age, 100 i.i.d.
    herds, ID and dam over the 9,900-animal pedigree with a 2 x 2 G, K =
    19,902) at its priors, without the markers: runMCMC's workspace and
    ops/location.py::assemble_lhs_lambda, in dtype on the card."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine import mcmc as em
    from jwas_tpu_torch.engine.setup import MCMCOptions
    from jwas_tpu_torch.ops.location import assemble_lhs_lambda

    ped_cols, rec = phase9a_design(**design)
    ped = jt.get_pedigree(ped_cols)
    table = rec["table"]
    table["y"] = np.random.default_rng(3).normal(size=len(table))
    model = jt.build_model("y = intercept + age + herd + ID + dam")
    jt.set_covariate(model, "age")
    jt.set_random(model, "herd", 0.1)
    jt.set_random(model, "ID dam", ped, PHASE9A_G)
    opts = MCMCOptions(printout_model_info=False, output_folder="",
                       double_precision=dtype == torch.float64)
    ws = em.prepare_workspace(model, table, opts, device=dev)
    cfg, data, state = em._build_st_data_and_state(ws, opts, dev)
    return assemble_lhs_lambda(cfg.re_groups, data.WtW, data.Vinv, state.vc, state.vare)


def phase2_k6(dev, **design):
    """K6 at the location LHS of phase 9a (K = 19,902, float32 and
    float64) and of phase 5 (K = 102), then at a random K = 2,000 and at
    the ragged edges of its slices (K = 1, 33, S - 1, S + 1 and the
    largest, 20,480, with zero diagonals at a slice's first and last
    rows). design: phase9a_design's sizes (a rehearsal's)."""
    from jwas_tpu_torch import _build

    recs = {}
    A64 = phase9a_lhs(dev, torch.float64, **design)
    for dtype, name in ((torch.float32, K6), (torch.float64, K6 + "_f64")):
        A = A64.to(dtype)
        recs[name] = check_k6("9a's LHS", A, *k6_vectors(A, 11), time_it=True)
        del A
    del A64
    for dtype, name in ((torch.float32, K6), (torch.float64, K6 + "_f64")):
        A = phase5_lhs(dev, dtype)
        recs[name]["at_K102"] = check_k6("phase 5's LHS", A, *k6_vectors(A, 12), time_it=True)
    A = random_spd_lhs(dev)
    for dtype, name in ((torch.float32, K6), (torch.float64, K6 + "_f64")):
        recs[name]["at_K2000"] = check_k6("a random SPD LHS", A.to(dtype),
                                          *k6_vectors(A.to(dtype), 13), time_it=True)
    S, K_max = _build.library().jt_gibbs_pass_slice(), _build.library().jt_gibbs_pass_max_k()
    ragged = {1: (), 33: (0, 32), S - 1: (0, S - 2), S + 1: (S - 1, S),
              K_max: (S, 2 * S - 1, K_max - 1)}      # K: zero rows
    for K, rows in ragged.items():
        A = random_spd_lhs(dev, K=K, seed=K)
        for r in rows:
            A[r, :] = 0.0
            A[:, r] = 0.0
        for dtype in (torch.float32, torch.float64):
            check_k6("a ragged K", A.to(dtype), *k6_vectors(A.to(dtype), 15), time_it=False)
    del A
    torch.cuda.empty_cache()
    return recs


def random_spd_lhs(dev, K=2_000, seed=14):
    """A positive definite, exactly symmetric K x K LHS: W'W of a random
    incidence design with four ones a row, plus a diagonal."""
    from jwas_tpu_torch.ops.location import symmetric_upper

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    W = torch.zeros((2 * K, K), dtype=torch.float64, device=dev)
    W.scatter_(1, torch.randint(0, K, (2 * K, 4), generator=g, device=dev), 1.0)
    D = torch.rand(K, generator=g, device=dev, dtype=torch.float64)
    return symmetric_upper(W.T @ W + torch.diag(0.5 + D))


def mt_inputs(t, b, nblocks, nreps, sampler, per_locus, seed, dev,
              dtype=torch.float32, n_padding=3, regime="dense", per_marker=False):
    """K7 / K8 inputs: Gram tiles of 4b-observation blocks, the last
    n_padding markers of the last block padding (valid 0, zero Gram rows,
    xpx 1; a short last group's), random covariances (Ginv shared or one a
    locus) and the draws of nreps rounds: uniforms for sampler I, Gumbels
    for II. regime "dense": random pattern priors, a third of the
    indicators on (most steps change an effect); "sparse": the all-out
    pattern at prior 0.99 from alpha = 0, 4% of the markers with an effect
    of sd 0.5 in the data (few steps change one). per_marker: log_pi
    (nblocks, b, 2^t), one row a marker, the regime's prior reweighted at
    random (2-trait annotated BayesC's form; the padding's row [1, 0, ..]
    clipped to 1e-12)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f = dict(generator=g, device=dev, dtype=torch.float64)
    x = torch.randn((nblocks, b, 4 * b), **f)
    if n_padding:
        x[-1, -n_padding:] = 0.0
    grams = x @ x.transpose(1, 2)
    xpx = torch.diagonal(grams, dim1=1, dim2=2).clone()
    valid = torch.ones((nblocks, b), device=dev, dtype=torch.float64)
    if n_padding:
        xpx[-1, -n_padding:], valid[-1, -n_padding:] = 1.0, 0.0
    rhs = x @ torch.randn((nblocks, 4 * b, t), **f)
    beta = 0.05 * torch.randn((nblocks, t, b), **f)
    delta = (torch.rand((nblocks, t, b), **f) < 0.3).double() * valid[:, None]
    A = torch.randn((t, t), **f)
    B = torch.randn((t, t), **f)
    eye = torch.eye(t, device=dev, dtype=torch.float64)
    Ginv = torch.linalg.inv(0.002 * (B @ B.T / t + eye))
    if per_locus:
        Ginv = Ginv * (0.5 + 1.5 * torch.rand((nblocks, b, 1, 1), **f))
    pi = torch.rand(2 ** t, **f) + 0.2
    if regime == "sparse":
        qtl = torch.rand((nblocks, b, 1), **f) < 0.04
        rhs += grams @ (qtl * 0.5 * torch.randn((nblocks, b, t), **f))
        delta.zero_()
        pi = torch.full((2 ** t,), 0.01 / (2 ** t - 1), device=dev, dtype=torch.float64)
        pi[0] = 0.99
    log_pi = torch.log(pi / pi.sum())
    if per_marker:
        rows = (pi / pi.sum()) * (0.3 + 2.7 * torch.rand((nblocks, b, 2 ** t), **f))
        rows = rows / rows.sum(-1, keepdim=True)
        pad = torch.full((2 ** t,), 1e-12, device=dev, dtype=torch.float64)
        pad[0] = 1.0
        rows[valid == 0] = pad
        log_pi = torch.log(rows)
    u = torch.rand((nreps * b, t if sampler == "I" else 2 ** t, nblocks), **f)
    inp = dict(grams=grams, xpx=xpx, valid=valid, alpha=beta * delta, beta=beta,
               delta=delta, rhs=rhs.transpose(1, 2), Rinv=torch.linalg.inv(A @ A.T / t + eye),
               Ginv=Ginv, log_pi=log_pi,
               draw_a=u if sampler == "I" else -torch.log(-torch.log(u)),
               zs=torch.randn((nreps * b, t, nblocks), **f))
    return {k: v.to(dtype).contiguous() for k, v in inp.items()}


def mt_bounds(inp, nreps):
    """Roofline bound of one K7 / K8 call: every input read once, the state
    and rhs written once; operations: a step's rank-t rhs update (2 t b) and
    the marker update (sampler I ~30 t, sampler II ~2^t (t^3 + 10 t^2)),
    at the float32 or float64 peak. The chain of nreps b dependent steps
    keeps a call far above it."""
    nblocks, t, b = inp["alpha"].shape
    nbytes = sum(v.numel() * v.element_size() for v in inp.values())
    nbytes += sum(inp[k].numel() * inp[k].element_size()
                  for k in ("alpha", "beta", "delta", "rhs"))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    marker = 30 * t if inp["draw_a"].shape[1] == t else 2 ** t * (t ** 3 + 10 * t * t)
    flops = F64_FLOPS if inp["grams"].dtype == torch.float64 else F32_FLOPS
    t_ops = nreps * b * nblocks * (2 * t * b + marker) / flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


# The dependent operations of one step in which an effect changes, at t = 3,
# counted from csrc/mt_inner_rounds.cu. K7 (MtMarkers::eval_I): a trait's
# chain from the previous trait's beta and delta: the product and sum of
# c12, rw - c12, two products to g_hat1^2 c11, the log-density's sub,
# product and add, log_d0 - log_d1, its scaling by log2(e), the fused
# u (1 + e) and its two compares, the select (14 adds, products, compares
# or selects) and one ex2 (the inclusion test of included(), whose exact
# expf and division run only near the threshold); three traits, then w and
# rw (5), a_new, d and its test (3), the axpy (2): 52 of them, 3 ex2, a
# ballot and a shuffle. K8 (eval_II): w and rw (5), a pattern's g (3), its
# quadratic form (3) and score (4), the argmax tree's 3 compare-and-selects
# (6), the chosen factor's load from shared memory, C z (3), g + C z, the
# pattern mask, valid, d and its test (5), the axpy (2): 36, one load, a
# ballot and a shuffle. K9 ("c0l", csrc/mt_c0l_rounds.cu): the owner's rhs
# takes the last d (2), the affine map's t products and t - 1 sums of a
# trait and + c (4), d = a_old - a_new (1): 7, and d's shuffle to the next
# lane. Hopper's latencies in cycles, float32 / float64: an
# add, product, compare or select 4 / 8; ex2 (MUFU, float32 in both) 20; a
# shared-memory load 30; a shuffle or ballot 30.
MT_STEP_OPS = {"I": dict(arith=52, mufu=3, lds=0, warp=2),
               "II": dict(arith=36, mufu=0, lds=1, warp=2),
               "c0l": dict(arith=7, mufu=0, lds=0, warp=1)}
MT_LATENCY = {torch.float32: dict(arith=4, mufu=20, lds=30, warp=30),
              torch.float64: dict(arith=8, mufu=20, lds=30, warp=30)}


def sm_clock_mhz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def mt_step_floor_ns(sampler, dtype, clock_mhz):
    """The latency of one changing step's dependent operations at t = 3
    (MT_STEP_OPS x MT_LATENCY; sampler "I", "II" or "c0l" for K9) at the SM
    clock, in ns."""
    lat = MT_LATENCY[dtype]
    cycles = sum(n * lat[op] for op, n in MT_STEP_OPS[sampler].items())
    return cycles / clock_mhz * 1e3


def check_mt(sampler, t, b, nblocks, nreps, dev, time_it=False, per_locus=False,
             dtype=torch.float32, n_padding=3, regime="dense", per_marker=False,
             window=True):
    """K7 (sampler "I") or K8 ("II") against its sequential plain version
    (ops/multitrait.py::mt_abc_inner_rounds_ref) on the card: alpha, beta,
    delta and rhs equal bit for bit, a second launch equal bit for bit,
    padding markers at 0. time_it: the kernel's device ms (CUDA events), the
    plain version's ms (host clock around the synchronised call that the
    check compares with), ns a dependent step, the byte bound, the step
    floor at t = 3 (mt_step_floor_ns) and the window model's counts
    (ops/inner_rounds.py::mt_abc_inner_rounds_window_ref, which must equal
    the plain version bit for bit too; window=False leaves it out). per_marker:
    the per-marker prior's instantiation (csrc/mt_inner_rounds_pm.cu), its
    launch counted."""
    import functools

    from jwas_tpu_torch.ops import inner_rounds as ir
    from jwas_tpu_torch.ops.multitrait import mt_abc_inner_rounds_ref

    kernel = ir.mt_abc_inner_rounds_I if sampler == "I" else ir.mt_abc_inner_rounds_II
    what = f"K{7 if sampler == 'I' else 8}"
    inp = mt_inputs(t, b, nblocks, nreps, sampler, per_locus, 11 + t, dev, dtype,
                    n_padding, regime, per_marker)
    fresh = lambda: {k: v.clone() for k, v in inp.items()}  # noqa: E731
    state = ("alpha", "beta", "delta", "rhs")

    def run(a):
        return kernel(*(a[k] for k in ("grams", "xpx", "valid", "alpha", "beta",
                                       "delta", "rhs", "Rinv", "Ginv", "log_pi",
                                       "draw_a", "zs")), nreps)

    outs = []
    pm0 = kernel.launches_pm
    for _ in range(2):
        a = fresh()
        run(a)
        outs.append(a)
    if kernel.launches_pm - pm0 != (2 if per_marker else 0):
        raise AssertionError(f"{what}: the per-marker instantiation ran "
                             f"{kernel.launches_pm - pm0} times of {2 * per_marker}")
    r = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mt_abc_inner_rounds_ref(sampler, **r, nreps=nreps)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3   # a host-bound loop of launches
    a = outs[0]
    err = max((a[k] - r[k]).abs().max().item() for k in state)
    label = (f"{what} sampler {sampler} {str(dtype).replace('torch.', '')} t={t} b={b} "
             f"nblocks={nblocks} reps={nreps}{' per-locus Ginv' if per_locus else ''}"
             f"{' per-marker prior' if per_marker else ''}"
             f"{' padding ' + str(n_padding) if n_padding else ''} {regime}")
    for k in state:
        if not torch.equal(outs[0][k], outs[1][k]):
            raise AssertionError(f"{label}: a second launch gave another {k}")
        if not torch.equal(a[k], r[k]):
            raise AssertionError(f"{label}: {k} differs from the plain version's "
                                 f"(max |err| {(a[k] - r[k]).abs().max().item():.3g}, "
                                 f"{int((a[k] != r[k]).sum())} values)")
    if n_padding and (a["alpha"][-1, :, -n_padding:].any()
                      or a["delta"][-1, :, -n_padding:].any()):
        raise AssertionError(f"{label}: a padding marker moved")
    label += (f": bit for bit the plain version ({float(a['delta'].mean()):.3f} of the "
              f"indicators on)")
    rec = None
    if time_it:
        k_in = fresh()
        ms = cuda_ms(lambda: run(k_in), 5)
        model = functools.partial(ir.mt_abc_inner_rounds_window_ref, sampler)
        stats = window_stats(model, inp, state, r, nreps) if window else None
        rec = dict(max_abs_err=err, **mt_bounds(inp, nreps))
        label += chain_line(rec, ms, plain, stats, nreps * b)
        # modelled, not measured: on this line only, not in the kernels line
        label += (f"; step floor at t = 3 "
                  f"{mt_step_floor_ns(sampler, dtype, sm_clock_mhz()):.1f} ns")
    say(label)
    return rec


def mt_registers(log):
    """K7 / K8 / K9 instantiations in nvcc's -Xptxas -v output (_build.build_log):
    [(kernel, dtype, t, rows a thread or None for the pre-pass, registers,
    spill store bytes, spill load bytes)]; kernel "K7" / "K8", or "K7 pm" /
    "K8 pm" for the per-marker prior's chain."""
    import re
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"(mt_chain|consts_II|consts_I)I([fd])Li(\d)E"
                          r"(?:Lb([01])E(?:Lb([01])E)?Li(\d+)E)?", name)
            c = re.search(r"c0l_(?:chainI([fd])Li(\d)ELi(\d+)E|constsI([fd])Li(\d)E)", name)
            if c:
                chain = c.group(1) is not None
                dt, t = (c.group(1), c.group(2)) if chain else (c.group(4), c.group(5))
                rows.append(("K9", {"f": "float32", "d": "float64"}[dt], int(t),
                             int(c.group(3)) if chain else None, int(m.group(1))) + spills)
            elif k:
                kernel = ("K8" if k.group(4) == "1" or k.group(1) == "consts_II" else "K7")
                kernel += " pm" if k.group(5) == "1" else ""
                rows.append((kernel, {"f": "float32", "d": "float64"}[k.group(2)],
                             int(k.group(3)), int(k.group(6)) if k.group(6) else None,
                             int(m.group(1))) + spills)
            name = None
    return sorted(rows, key=lambda r: (r[0], r[1], r[2], r[3] or 0))


def phase2_mt(dev):
    """K7 and K8 at phase 10a's shape (t = 3, b = 256 over 23 blocks, a
    round of 8 reps) in float32 and float64, dense and sparse, timed; then
    in both builds at t = 2 (a single block, the exact form's chunk), 4 and 5
    (per-locus Ginv), 8, a ragged b = 136 with a short last group's padding,
    b = 300 (two markers a thread), b = 700 (four) and b = 1,040 (eight),
    each bit for bit."""
    recs = {}
    for sampler in ("I", "II"):
        name = f"mt_abc_inner_rounds_{sampler}"
        for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
            rec = check_mt(sampler, 3, 256, 23, 8, dev, time_it=True, dtype=dtype)
            rec["regimes"] = {"sparse": check_mt(sampler, 3, 256, 23, 8, dev, time_it=True,
                                                 dtype=dtype, regime="sparse")}
            recs[name + suffix] = rec
        for dtype in (torch.float32, torch.float64):
            check_mt(sampler, 2, 256, 1, 1, dev, dtype=dtype, n_padding=0)
            check_mt(sampler, 4, 40, 6, 2, dev, per_locus=True, dtype=dtype)
            check_mt(sampler, 5, 72, 3, 2, dev, per_locus=True, dtype=dtype)
            check_mt(sampler, 8, 40, 2, 1, dev, dtype=dtype)
            check_mt(sampler, 3, 136, 8, 3, dev, per_locus=True, dtype=dtype,
                     n_padding=17)
            check_mt(sampler, 2, 300, 2, 2, dev, dtype=dtype, n_padding=5, regime="sparse")
            check_mt(sampler, 3, 700, 1, 1, dev, per_locus=True, dtype=dtype, n_padding=9)
            check_mt(sampler, 3, 1040, 1, 1, dev, per_locus=True, dtype=dtype)
        # the per-marker prior (2-trait annotated BayesC, phase 12d): t = 2
        # and 3 at b = 40, 256, 300 and 2,048, padding at 0 and not, both
        # builds; rows all equal to a global prior give the global form's
        # bits; its time beside the global form's at phase 10a's round
        for dtype in (torch.float32, torch.float64):
            for t, b, nblocks, nreps, n_padding in ((2, 40, 6, 2, 3), (3, 40, 3, 2, 0),
                                                    (2, 256, 4, 1, 0), (3, 256, 2, 1, 3),
                                                    (2, 300, 2, 1, 5), (3, 300, 1, 1, 0),
                                                    (2, 2048, 1, 1, 0)):
                check_mt(sampler, t, b, nblocks, nreps, dev, dtype=dtype,
                         n_padding=n_padding, per_marker=True)
            check_mt_equal_rows(sampler, dev, dtype)
        rec = recs[name]
        rec["per_marker"] = {}
        for t in (2, 3):
            # the global form at t = 3 is the float32 record timed above
            glob = rec if t == 3 else check_mt(sampler, t, 256, 23, 8, dev, time_it=True,
                                               window=False)
            pm = check_mt(sampler, t, 256, 23, 8, dev, time_it=True, per_marker=True,
                          window=False)
            rec["per_marker"][f"t{t}"] = dict(
                ms=pm["ms"], global_ms=glob["ms"], plain_ms=pm["plain_ms"],
                bound_ms=pm["bound_ms"], bound_by=pm["bound_by"],
                max_abs_err=pm["max_abs_err"])
            say(f"  K{7 if sampler == 'I' else 8} t={t} at phase 10a's round: per-marker "
                f"prior {pm['ms']:.4f} ms, global {glob['ms']:.4f} ms "
                f"({pm['ms'] / glob['ms'] - 1:+.1%})")
    return recs


def check_mt_equal_rows(sampler, dev, dtype, t=3, b=256, nblocks=3, nreps=2):
    """K7 / K8 with a per-marker prior whose rows all equal the global
    vector: the global form's bits, both launches on the card."""
    from jwas_tpu_torch.ops import inner_rounds as ir

    kernel = ir.mt_abc_inner_rounds_I if sampler == "I" else ir.mt_abc_inner_rounds_II
    inp = mt_inputs(t, b, nblocks, nreps, sampler, False, 29, dev, dtype)
    names = ("grams", "xpx", "valid", "alpha", "beta", "delta", "rhs", "Rinv", "Ginv",
             "log_pi", "draw_a", "zs")
    glob = {k: v.clone() for k, v in inp.items()}
    pm = {k: v.clone() for k, v in inp.items()}
    pm["log_pi"] = inp["log_pi"].expand(nblocks, b, 2 ** t).contiguous()
    kernel(*(glob[k] for k in names), nreps)
    kernel(*(pm[k] for k in names), nreps)
    for k in ("alpha", "beta", "delta", "rhs"):
        if not torch.equal(glob[k], pm[k]):
            raise AssertionError(f"K{7 if sampler == 'I' else 8} {dtype}: per-marker rows "
                                 f"equal to the global prior changed {k}")
    say(f"K{7 if sampler == 'I' else 8} sampler {sampler} {str(dtype).replace('torch.', '')} "
        f"t={t} b={b}: per-marker rows equal to the global prior give its bits")


def k9_inputs(t, b, nblocks, nreps, bayesl, seed, dev, dtype=torch.float32, n_padding=3):
    """K9 inputs: mt_inputs' Gram tiles, rhs, covariances and normals
    (padding markers included), every real marker's effect random (RR-BLUP
    and BayesL have no indicators) and gamma ones (RR-BLUP) or U(0.2, 3)
    a real marker, 1 for padding (BayesL)."""
    inp = mt_inputs(t, b, nblocks, nreps, "I", False, seed, dev, torch.float64,
                    n_padding)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    valid = inp["valid"]
    gamma = torch.ones_like(valid)
    if bayesl:
        gamma = torch.where(valid > 0, 0.2 + 2.8 * torch.rand(
            valid.shape, generator=g, device=dev, dtype=torch.float64), 1.0)
    out = dict(grams=inp["grams"], xpx=inp["xpx"], valid=valid,
               alpha=inp["beta"] * valid[:, None, :], rhs=inp["rhs"], Rinv=inp["Rinv"],
               Ginv=inp["Ginv"], gamma=gamma, zs=inp["zs"])
    return {k: v.to(dtype).contiguous() for k, v in out.items()}


def k9_bounds(inp, nreps):
    """Roofline bound of one K9 call: the Gram tile, the state, xpx,
    valid, gamma and the draws read once, alpha and rhs written once;
    operations: a step's rank-t rhs update (2 t b) and its marker update
    (2 t^2 for Rinv w, 2 t^2 for the trait loop's sums, ~6 t more), at the
    float32 or float64 peak."""
    nblocks, t, b = inp["alpha"].shape
    nbytes = sum(v.numel() * v.element_size() for v in inp.values())
    nbytes += sum(inp[k].numel() * inp[k].element_size() for k in ("alpha", "rhs"))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    flops = F64_FLOPS if inp["grams"].dtype == torch.float64 else F32_FLOPS
    t_ops = nreps * b * nblocks * (2 * t * b + 4 * t * t + 6 * t) / flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def k9_triangular(inp, nreps):
    """K9's library yardstick (the port never calls it): one Gibbs pass
    over a block in marker-then-trait order is a lower-triangular solve on
    D + L of the block's (b t, b t) matrix M = G (x) Rinv + blockdiag(Ginv /
    gamma_j), right-hand side (I (x) Rinv) (rhs + G alpha) - U alpha_old +
    sqrt(diag M) o z. M's triangles, that fixed part and the noise are built
    here, outside any timing; the returned function runs nreps times one
    batched torch.bmm (U alpha) and one batched
    torch.linalg.solve_triangular over the blocks, and returns alpha
    (gb, t, b). Holds only without padding (valid all 1)."""
    grams, Rinv, Ginv = inp["grams"], inp["Rinv"], inp["Ginv"]
    nblocks, t, b = inp["alpha"].shape
    eye = torch.eye(b, dtype=grams.dtype, device=grams.device)
    M = torch.einsum("kij,pq->kipjq", grams, Rinv).reshape(nblocks, b * t, b * t)
    M += torch.einsum("ij,kj,pq->kipjq", eye, 1.0 / inp["gamma"], Ginv).reshape(
        nblocks, b * t, b * t)
    DL, U = torch.tril(M), torch.triu(M, 1)
    a0 = inp["alpha"].transpose(1, 2).reshape(nblocks, b * t, 1)
    r = inp["rhs"].transpose(1, 2) + torch.bmm(grams, inp["alpha"].transpose(1, 2))
    fixed = (r @ Rinv.T).reshape(nblocks, b * t, 1)
    sd = torch.sqrt(torch.diagonal(M, dim1=1, dim2=2))[..., None]
    zs = inp["zs"].view(nreps, b, t, nblocks).permute(0, 3, 1, 2).reshape(
        nreps, nblocks, b * t, 1)
    noise = [fixed + sd * z for z in zs]

    def solve():
        a = a0
        for rep in range(nreps):
            a = torch.linalg.solve_triangular(DL, noise[rep] - torch.bmm(U, a), upper=False)
        return a.view(nblocks, b, t).transpose(1, 2)

    return solve


def check_k9(t, b, nblocks, nreps, dev, bayesl=False, time_it=False,
             dtype=torch.float32, n_padding=3):
    """K9 (ops/inner_rounds.py::mt_c0l_inner_rounds) against its plain
    version (ops/multitrait.py::mt_c0l_inner_rounds_ref) on the card:
    alpha and rhs equal bit for bit, a second launch equal bit for bit,
    padding markers at 0. time_it: the kernel's device ms (CUDA events),
    the plain version's ms (host clock around the synchronised call), ns a
    dependent step, the byte bound, the step floor at t = 3
    (mt_step_floor_ns "c0l") and the library yardstick's ms (k9_triangular,
    held against the plain version to K6_RTOL of the largest effect)."""
    from jwas_tpu_torch.ops.inner_rounds import mt_c0l_inner_rounds
    from jwas_tpu_torch.ops.multitrait import mt_c0l_inner_rounds_ref

    inp = k9_inputs(t, b, nblocks, nreps, bayesl, 31 + t, dev, dtype, n_padding)
    fresh = lambda: {k: v.clone() for k, v in inp.items()}  # noqa: E731
    order = ("grams", "xpx", "valid", "alpha", "rhs", "Rinv", "Ginv", "gamma", "zs")
    outs = []
    for _ in range(2):
        a = fresh()
        mt_c0l_inner_rounds(*(a[k] for k in order), nreps)
        outs.append(a)
    r = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mt_c0l_inner_rounds_ref(*(r[k] for k in order), nreps)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    a = outs[0]
    label = (f"K9 {'BayesL' if bayesl else 'RR-BLUP'} {str(dtype).replace('torch.', '')} "
             f"t={t} b={b} nblocks={nblocks} reps={nreps}"
             f"{' padding ' + str(n_padding) if n_padding else ''}")
    for k in ("alpha", "rhs"):
        if not torch.equal(outs[0][k], outs[1][k]):
            raise AssertionError(f"{label}: a second launch gave another {k}")
        if not torch.equal(a[k], r[k]):
            raise AssertionError(f"{label}: {k} differs from the plain version's "
                                 f"(max |err| {(a[k] - r[k]).abs().max().item():.3g}, "
                                 f"{int((a[k] != r[k]).sum())} values)")
    if n_padding and a["alpha"][-1, :, -n_padding:].any():
        raise AssertionError(f"{label}: a padding marker moved")
    label += ": bit for bit the plain version"
    rec = None
    if time_it:
        k_in = fresh()
        ms = cuda_ms(lambda: mt_c0l_inner_rounds(*(k_in[k] for k in order), nreps), 5)
        rec = dict(max_abs_err=0.0, **k9_bounds(inp, nreps))
        label += chain_line(rec, ms, plain, None, nreps * b)
        # modelled, not measured: on this line only, not in the kernels line
        label += (f"; step floor at t = 3 "
                  f"{mt_step_floor_ns('c0l', dtype, sm_clock_mhz()):.1f} ns")
        if not n_padding:
            solve = k9_triangular(inp, nreps)
            lib_err = (solve() - r["alpha"]).abs().max().item()
            tol = K6_RTOL[dtype] * max(1.0, r["alpha"].abs().max().item()) * 100
            if not lib_err <= tol:
                raise AssertionError(f"{label}: the triangular solve's max |err| "
                                     f"{lib_err:.3g} > {tol:.3g}")
            rec.update(library_ms=cuda_ms(solve, 3), library_max_abs_err=lib_err)
            del solve
            label += (f"; library (bmm + solve_triangular, {nreps} passes) "
                      f"{rec['library_ms']:.4f} ms (max |err| {lib_err:.3g})")
        else:
            rec["library_ms"] = None
    say(label)
    return rec


def phase2_k9(dev):
    """K9 at phase 11a's round (t = 3, b = 256 over 23 blocks, a round of
    8 reps, no padding) for RR-BLUP and BayesL in float32 and float64,
    timed with the yardstick; then bit for bit at t = 2 (a single block,
    the exact form's chunk), 4, 5 and 8, a ragged b = 136 with a short last
    group's padding, b = 300, 700 and 2,048 (two, four and eight markers a
    thread) and b = 264 (a warp owning two runs in a row)."""
    recs = {}
    for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
        rec = check_k9(3, 256, 23, 8, dev, time_it=True, dtype=dtype, n_padding=0)
        rec["regimes"] = {"BayesL": check_k9(3, 256, 23, 8, dev, bayesl=True,
                                             time_it=True, dtype=dtype, n_padding=0)}
        recs["mt_c0l_inner_rounds" + suffix] = rec
        check_k9(3, 256, 23, 2, dev, bayesl=True, dtype=dtype)
        check_k9(2, 256, 1, 1, dev, dtype=dtype, n_padding=0)
        check_k9(4, 40, 6, 2, dev, bayesl=True, dtype=dtype)
        check_k9(5, 72, 3, 2, dev, dtype=dtype)
        check_k9(8, 40, 2, 1, dev, bayesl=True, dtype=dtype)
        check_k9(3, 136, 8, 3, dev, bayesl=True, dtype=dtype, n_padding=17)
        check_k9(2, 300, 2, 2, dev, dtype=dtype, n_padding=5)
        check_k9(3, 700, 1, 1, dev, bayesl=True, dtype=dtype, n_padding=9)
        check_k9(3, 2048, 1, 1, dev, dtype=dtype)
        # nine runs a rep over eight warps: warp 0 owns the last run of a
        # rep and the first of the next
        check_k9(2, 264, 1, 2, dev, bayesl=True, dtype=dtype, n_padding=5)
    return recs


# ---------------------------------------------------------------- K10

K10_RTOL = {torch.float32: (1e-5, 1e-6, 1e-4, 1e-5),    # alpha / beta rtol, atol;
            torch.float64: (1e-10, 1e-12, 1e-9, 1e-11)}  # the grid's rtol, atol


def rrm_inputs(nind, ntimes, c, p, seed, dev, dtype=torch.float32, miss=0.15,
               estimate_delta=True):
    """A K10 call at a test-day shape: Binomial(2, f) genotypes centered,
    marker-major (p, nind), f ~ U(0.1, 0.9); the Legendre basis over
    ntimes days; miss of the cells unobserved; a residual grid of unit
    variance (0 where unobserved), coefficients from N(0, 0.01), vare 1, a
    c x c marker covariance 0.01 (I + 0.3 off the diagonal), a random prior
    over the labels; the sweep's draws from a generator of seed."""
    from jwas_tpu_torch.ops.rrm import build_m_phiphi, draw_sweep_normals, generate_full_phi

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f = 0.1 + 0.8 * torch.rand((p, 1), generator=g, device=dev, dtype=torch.float64)
    codes = ((torch.rand((p, nind), generator=g, device=dev, dtype=torch.float64) < f).to(dtype)
             + (torch.rand((p, nind), generator=g, device=dev, dtype=torch.float64) < f).to(dtype))
    X = codes - codes.mean(1, keepdim=True)
    del codes
    phi = torch.as_tensor(generate_full_phi(np.arange(ntimes), c), dtype=dtype).to(dev)
    mask = (torch.rand((ntimes, nind), generator=g, device=dev) >= miss).to(dtype)
    varg = 0.01 * (0.7 * torch.eye(c, dtype=torch.float64) + 0.3)
    L = 2**c
    pi = torch.softmax(torch.randn(L, generator=g, device=dev, dtype=torch.float64), 0)
    gumbel, zs = draw_sweep_normals(g, p, c, X, estimate_delta)
    return dict(
        X=X, phi=phi, mphiphi=build_m_phiphi(X, phi, mask), obs_mask=mask,
        alpha=(0.1 * torch.randn((c, p), generator=g, device=dev, dtype=torch.float64)).to(dtype),
        Wgrid=torch.randn((ntimes, nind), generator=g, device=dev, dtype=dtype) * mask,
        vare=torch.ones((), dtype=dtype, device=dev),
        Ginv=torch.linalg.inv(varg).to(dtype).to(dev).contiguous(),
        log_pi=torch.log(pi).to(dtype), gumbel=gumbel, zs=zs)


K10_ORDER = ("X", "phi", "mphiphi", "obs_mask", "alpha", "Wgrid", "vare", "Ginv", "log_pi")


def k10_bounds(inp):
    """K10's bound: every input read once (X, the Grams, the grid, the
    mask, the draws, alpha) and alpha, beta, delta and the grid written
    once, over 3.35 TB/s; or a step's operations, 4 ntimes nind for the
    grid's update and the next partial sum plus ~2^c (c^3 + 4 c^2) for the
    labels, over the type's peak."""
    p, nind = inp["X"].shape
    ntimes, c = inp["phi"].shape
    nbytes = sum(t.numel() * t.element_size() for t in inp.values() if t is not None)
    nbytes += (3 * c * p + ntimes * nind) * inp["X"].element_size()
    flops = F64_FLOPS if inp["X"].dtype == torch.float64 else F32_FLOPS
    ops = p * (4 * ntimes * nind + 2**c * (c**3 + 4 * c * c))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)


def k10_cross_grams(inp, dev, max_chunk=64):
    """K10's chunk b for the call's shape (sweep_chunk, at most
    max_chunk), its cross-Grams built and packed (build_rrm_cross_grams,
    pack_cross_grams) and the seconds they took."""
    from jwas_tpu_torch.ops.rrm import build_rrm_cross_grams, pack_cross_grams, sweep_chunk

    nind = inp["X"].shape[1]
    ntimes, c = inp["phi"].shape
    b = sweep_chunk(nind, ntimes, c, inp["X"].dtype, dev, max_chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg = pack_cross_grams(build_rrm_cross_grams(inp["X"], inp["phi"], inp["obs_mask"], b))
    torch.cuda.synchronize()
    return b, cg, time.perf_counter() - t0


def check_k10(nind, ntimes, c, p, dev, dtype=torch.float32, estimate_delta=True, seed=41,
              max_chunk=64):
    """K10 (ops/rrm.py::sweep_rrm_abc) against its plain version
    (sweep_rrm_abc_ref) on the card, the same draws fed to both: alpha and
    beta within rtol 1e-5, atol 1e-6 and the grid within rtol 1e-4, atol
    1e-5 (tests/test_pallas_sweep.py:42-45) in float32, 1e-10 / 1e-12 and
    1e-9 / 1e-11 in float64; delta equal on >= DELTA_AGREE of the markers
    in float32, on all in float64; a second launch equal bit for bit; the
    plain version's ms (host clock around the synchronised call); the
    chunk b (at most max_chunk), the cross-Grams' build seconds and
    bytes."""
    from jwas_tpu_torch.ops.rrm import sweep_rrm_abc, sweep_rrm_abc_ref

    inp = rrm_inputs(nind, ntimes, c, p, seed, dev, dtype, estimate_delta=estimate_delta)
    args = [inp[k] for k in K10_ORDER]
    b, cg, cg_s = k10_cross_grams(inp, dev, max_chunk)
    kw = dict(estimate_delta=estimate_delta, gumbel=inp["gumbel"], zs=inp["zs"], cross_grams=cg)
    got = sweep_rrm_abc(*args, None, **kw)
    grid = sweep_rrm_abc.last_grid
    again = sweep_rrm_abc(*args, None, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sweep_rrm_abc_ref(*args, inp["gumbel"], inp["zs"], estimate_delta)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    rtol, atol, grtol, gatol = K10_RTOL[dtype]
    name = str(dtype).replace("torch.", "")
    label = (f"K10 {'BayesC' if estimate_delta else 'RR-BLUP'} {name} nind={nind} "
             f"ntimes={ntimes} c={c} p={p} (blocks, individuals a block, chunk b, tile of "
             f"individuals) = {grid}")
    agree = (got[2] == want[2]).all(0).double().mean().item()
    need = DELTA_AGREE if dtype == torch.float32 else 1.0
    errs = [(got[k] - want[k]).abs().max().item() for k in range(4)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = same and agree >= need and all(bool(torch.isfinite(t).all()) for t in got)
    if agree == 1.0:
        ok = ok and all(torch.allclose(got[k], want[k], rtol=rtol, atol=atol) for k in (0, 1))
        ok = ok and torch.allclose(got[3], want[3], rtol=grtol, atol=gatol)
    cg_bytes = cg.numel() * cg.element_size()
    label += (f": delta agreement {agree:.5f} (need {need}), max |err| alpha {errs[0]:.3g}, "
              f"beta {errs[1]:.3g}, grid {errs[3]:.3g} (rtol / atol {rtol} / {atol}, grid "
              f"{grtol} / {gatol}); a second launch {'equal' if same else 'DIFFERENT'} bit "
              f"for bit; plain {plain:.1f} ms; cross-Grams {cg_bytes / 1e6:.2f} MB in "
              f"{cg_s:.4f} s")
    if not ok:
        raise AssertionError(label)
    say(label)
    return dict(max_abs_err=max(errs[0], errs[1]), grid_max_abs_err=errs[3],
                delta_agreement=agree, plain_ms=plain, plain_p=p, chunk=b, grid=grid)


def time_k10(nind, ntimes, c, p, dev, dtype, seed=51, max_chunk=64):
    """K10 alone at a full shape: device ms a sweep (3 launches after a
    warm-up), ns a marker, its bound; two launches equal bit for bit, every
    output finite; the chunk b (at most max_chunk), the cross-Grams' build
    seconds and bytes (beside the bound, not in it); and the probes (ops/rrm.py::_launch's bits): a
    chunk's fixed cost without its chain and without the next chunk's
    inputs (the update, the partial sums, the exchange), of it the wait on
    the counter and the loads of the blocks' partials, the next chunk's
    inputs alone, and the chain's ns a marker (the sweep less the fixed
    cost, over p)."""
    from jwas_tpu_torch.ops import rrm

    inp = rrm_inputs(nind, ntimes, c, p, seed, dev, dtype)
    args = [inp[k] for k in K10_ORDER]
    b, cg, cg_s = k10_cross_grams(inp, dev, max_chunk)
    kw = dict(gumbel=inp["gumbel"], zs=inp["zs"], cross_grams=cg)
    a, b2 = rrm.sweep_rrm_abc(*args, None, **kw), rrm.sweep_rrm_abc(*args, None, **kw)
    if not (all(torch.equal(x, y) for x, y in zip(a, b2))
            and all(bool(torch.isfinite(x).all()) for x in a)):
        raise AssertionError(f"K10 at nind={nind} p={p}: two launches differ or a draw "
                             f"is not finite")
    del a, b2
    ms = cuda_ms(lambda: rrm.sweep_rrm_abc(*args, None, **kw), 3)
    probe = {bits: cuda_ms(lambda: rrm._launch(args[0], args[1], args[2], cg, *args[3:],
                                               inp["gumbel"], inp["zs"], True, bits), 3)
             for bits in (1, 9, 11, 15)}
    nq = -(-p // b)
    rec = dict(ms=ms, step_ns=ms * 1e6 / p, chunk=b, cross_gram_s=cg_s,
               cross_gram_bytes=cg.numel() * cg.element_size(),
               chunk_us=probe[9] * 1e3 / nq, wait_us=(probe[9] - probe[11]) * 1e3 / nq,
               loads_us=(probe[11] - probe[15]) * 1e3 / nq,
               prepare_us=(probe[1] - probe[9]) * 1e3 / nq,
               chain_ns=(ms - probe[9]) * 1e6 / p, **k10_bounds(inp))
    del inp, args, cg
    torch.cuda.empty_cache()
    return rec


def k10_registers(log):
    """K10's instantiations in nvcc's -Xptxas -v output: [(dtype, c,
    registers, spill store bytes, spill load bytes)]."""
    import re
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"rrm_sweep_kernelI([fd])Li(\d)E", name)
            if k:
                rows.append(({"f": "float32", "d": "float64"}[k.group(1)], int(k.group(2)),
                             int(m.group(1))) + spills)
            name = None
    return sorted(rows)


def k10_edge(ntimes, c, dtype, dev):
    """The most individuals K10 takes on this card at ntimes and c
    (ops/rrm.py::sweep_limit_error, bisected)."""
    from jwas_tpu_torch.ops.rrm import sweep_limit_error

    lo, hi = 64, 1 << 24
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if sweep_limit_error(mid, ntimes, c, dtype, dev) is None:
            lo = mid
        else:
            hi = mid - 1
    return lo


# K10 above phase 14's herd (nind, ntimes, c, p; nind None: the most
# individuals K10 takes, k10_edge): a block's genotype rows of a chunk
# beyond its shared memory, so read in tiles of individuals; the last two
# with a chunk b below phase 14's herd's (on an H100: 32 and 1 in float32,
# 8 and 1 in float64), p ragged against b
K10_LARGE = ((40_000, 10, 3, 130), (100_000, 10, 5, 37), (300_000, 10, 3, 40),
             (None, 10, 3, 5))


def check_k10_large(dev, dtype, estimate_delta=True, seed=70):
    """check_k10 at K10_LARGE's herds; raises unless each launch's plan
    read the rows in tiles (its tile below the slice) and the last two
    took a chunk b below the one at 10,000 individuals. Returns the
    records."""
    from jwas_tpu_torch.ops.rrm import sweep_chunk

    recs = []
    for i, (nind, ntimes, c, p) in enumerate(K10_LARGE):
        nind = nind or k10_edge(ntimes, c, dtype, dev)
        rec = check_k10(nind, ntimes, c, p, dev, dtype, estimate_delta, seed=seed + i)
        _, slice_, b, xt = rec["grid"]
        if xt >= slice_ or (i >= 2 and b >= sweep_chunk(10_000, ntimes, c, dtype, dev)):
            raise AssertionError(f"K10 at nind={nind} c={c}: plan {rec['grid']} does not read "
                                 f"the rows in tiles or keeps the chunk of 10,000 individuals")
        recs.append(dict(rec, nind=nind))
    return recs


def phase2_k10(dev, nind=10_000, ntimes=10, p=50_000):
    """K10 at phase 14's shape, c = 3, p = 256 markers (and a ragged nind
    - 1), BayesC and RR-BLUP, float32 and float64; c = 1 and c = 5; p
    ragged against the chunk b (4 b + 1 and 37 < b; float64 c = 5 over
    two chunks and a ragged third); above phase 14's herd, the rows read
    in tiles and smaller chunks (check_k10_large); then timed at phase
    14's full shape
    (p = 50,000: X 2.0 GB in float32) in both builds: ms a sweep, ns a
    marker, the bound, the cross-Grams, the probes (time_k10); the plain
    version's ms at p = 256; the most individuals it takes at 10 time
    points (no fewer than the first design's); registers and spills of
    every instantiation."""
    from jwas_tpu_torch import _build
    from jwas_tpu_torch.ops.rrm import sweep_chunk

    recs = {}
    for dtype, name in ((torch.float32, "sweep_rrm_abc"), (torch.float64, "sweep_rrm_abc_f64")):
        rec = check_k10(nind, ntimes, 3, 256, dev, dtype)
        rec["regimes"] = {"RR-BLUP": check_k10(nind, ntimes, 3, 256, dev, dtype,
                                               estimate_delta=False)}
        check_k10(nind - 1, ntimes, 3, 256, dev, dtype, seed=42)
        check_k10(nind - 1, ntimes, 3, 256, dev, dtype, estimate_delta=False, seed=43)
        for c in (1, 5):
            check_k10(nind, ntimes, c, 256, dev, dtype, seed=44 + c)
            check_k10(nind - 1, ntimes, c, 256, dev, dtype, estimate_delta=False, seed=46 + c)
        check_k10(37, 3, 2, 64, dev, dtype, seed=50)            # one block, n < 64
        b = rec["chunk"]
        check_k10(nind, ntimes, 3, 4 * b + 1, dev, dtype, seed=52)         # p ragged against b
        check_k10(nind, ntimes, 3, 37, dev, dtype, estimate_delta=False, seed=53)   # p < b
        if dtype == torch.float64:
            b5 = sweep_chunk(nind, ntimes, 5, dtype, dev)
            check_k10(nind, ntimes, 5, 2 * b5 + 7, dev, dtype, seed=54)
        # above phase 14's herd: the rows read in tiles, smaller chunks
        rec["large_herds"] = [dict(nind=r["nind"], grid=r["grid"])
                              for r in check_k10_large(dev, dtype)]
        check_k10_large(dev, dtype, estimate_delta=False, seed=80)
        rec.update(time_k10(nind, ntimes, 3, p, dev, dtype))
        rec["full_shape"] = dict(nind=nind, ntimes=ntimes, c=3, p=p)
        say(f"K10 {name} at phase 14's shape (nind {nind}, ntimes {ntimes}, c 3, p {p}, "
            f"chunk b = {rec['chunk']}): {rec['ms']:.3f} ms a sweep, {rec['step_ns']:.1f} ns "
            f"a marker, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
            f"{rec['bound_ms'] / rec['ms']:.2%} of it reached); cross-Grams "
            f"{rec['cross_gram_bytes'] / 1e6:.1f} MB built in {rec['cross_gram_s']:.4f} s "
            f"(beside the bound, not in it); plain {rec['plain_ms']:.1f} ms at p = 256")
        say(f"K10 {name} probes: a chunk's exchange and fixed cost {rec['chunk_us']:.2f} us "
            f"(the wait on the counter {rec['wait_us']:.2f}, the loads of the blocks' partials "
            f"{rec['loads_us']:.2f}), the next chunk's inputs alone {rec['prepare_us']:.2f} us "
            f"(hidden by the chain), the chain {rec['chain_ns']:.1f} ns a marker")
        recs[name] = rec
        torch.cuda.empty_cache()
    for (dtype, name), first in zip(((torch.float32, "sweep_rrm_abc"),
                                      (torch.float64, "sweep_rrm_abc_f64")), (547_000, 283_000)):
        edge = k10_edge(ntimes, 3, dtype, dev)
        say(f"K10 {name}: the most individuals it takes at {ntimes} time points, c = 3: {edge:,} "
            f"(the first design's: {first:,})")
        if edge < first:
            raise AssertionError(f"K10 {name} refuses {first} individuals, which its first "
                                 f"design took")
        recs[name]["edge_individuals"] = edge
    regs = k10_registers(_build.build_log)
    for dtype, c, r, st, ld in regs:
        say(f"K10 {dtype} c={c}: {r} registers, {st} / {ld} bytes spill stores / loads")
    for name, dt in (("sweep_rrm_abc", "float32"), ("sweep_rrm_abc_f64", "float64")):
        recs[name]["registers"] = {str(c): dict(registers=r, spill_stores=st, spill_loads=ld)
                                   for d, c, r, st, ld in regs if d == dt}
    return recs


def phase2(dev):
    say("== phase 2: kernels against their plain versions on the card")
    check_k1(64, 8, 256, 3, dev, time_it=False)    # tests/test_pallas_sweep.py:21
    recs = {"abc_inner_rounds": check_k1(512, 128, 128, 8, dev, time_it=True)}
    # the path's two BayesC regimes at its shape: pi0 = 0 and pi0 = 0.999
    regimes = {r: check_k1(512, 128, 128, 8, dev, time_it=True, regime=r)
               for r in ("dense", "sparse")}
    recs["abc_inner_rounds"]["regimes"] = regimes
    check_k1(512, 256, 64, 2, dev, time_it=True)   # global-memory Gram branch
    check_k1(512, 152, 128, 2, dev, time_it=False)  # a last window of 24
    # BayesB at runMCMC's default block size (phase 6): b = 136
    check_k1(512, 136, 128, 2, dev, time_it=False, per_marker=True)
    check_k1(256, 1040, 2, 1, dev, time_it=False)   # 4 markers a thread
    check_k3(64, 8, 256, 3, dev, time_it=False)
    recs["bayesr_inner_rounds"] = check_k3(512, 128, 128, 8, dev, time_it=True)
    # the path's BayesR regime: the default class prior from alpha = 0
    recs["bayesr_inner_rounds"]["regimes"] = {
        "from_zero": check_k3(512, 128, 128, 8, dev, time_it=True,
                              from_zero=True)}
    check_k3(512, 256, 64, 2, dev, time_it=True)   # global-memory Gram branch
    check_k3(512, 152, 128, 2, dev, time_it=False)
    check_k3(256, 1040, 2, 1, dev, time_it=False)
    # the dense path (phase 7): a dense group's K1 and K3 (b = 256, 23
    # blocks, a round of 8 reps), the exact sweep's chunks (nblocks = 1, one
    # rep; and a ragged single block), and the float64 builds against
    # float64 plain versions at a resident (b = 136) and a global (b = 256)
    # tile
    f64 = torch.float64
    recs["abc_inner_rounds"]["regimes"]["dense_group"] = check_k1(
        512, 256, 23, 8, dev, time_it=True, regime="dense")
    recs["abc_inner_rounds"]["regimes"]["exact_chunk"] = check_k1(
        512, 256, 1, 1, dev, time_it=True, regime="dense")
    check_k1(512, 160, 1, 1, dev, time_it=False)
    recs["bayesr_inner_rounds"]["regimes"]["dense_group"] = check_k3(
        512, 256, 23, 8, dev, time_it=True, from_zero=True)
    recs["abc_inner_rounds_f64"] = check_k1(512, 256, 23, 8, dev, time_it=True,
                                            dtype=f64)
    check_k1(512, 136, 64, 2, dev, time_it=False, per_marker=True, dtype=f64)
    check_k1(512, 256, 1, 1, dev, time_it=False, regime="dense", dtype=f64)
    recs["bayesr_inner_rounds_f64"] = check_k3(512, 256, 23, 8, dev, time_it=True,
                                               from_zero=True, dtype=f64)
    check_k3(512, 136, 64, 2, dev, time_it=False, dtype=f64)
    # RR-BLUP / BayesL (phase 8a): K1 with every marker in the slab, zero
    # uniforms and BayesL's per-marker variances, at 8a's group round
    # (global tile), a resident tile, the exact sweep's single block and
    # the float64 build
    recs["abc_inner_rounds"]["regimes"]["c0l_group"] = check_k1(
        512, 256, 23, 8, dev, time_it=True, regime="c0l", per_marker=True)
    check_k1(512, 128, 64, 2, dev, time_it=False, regime="c0l", per_marker=True)
    check_k1(512, 256, 1, 1, dev, time_it=False, regime="c0l")
    check_k1(512, 136, 64, 2, dev, time_it=False, regime="c0l", per_marker=True,
             dtype=f64)
    recs.update(check_gemv(50_000, 16_384, dev, missing=False, permuted=False,
                           time_it=True))
    check_gemv(50_000, 16_384, dev, missing=True, permuted=True, time_it=False)
    # runMCMC's default block size (phase 6a): G = 136 * 128
    check_gemv(50_000, 17_408, dev, missing=False, permuted=True, time_it=False)
    check_gemv(1_001, 4_096, dev, missing=True, permuted=True, time_it=False)
    check_gemv(4_000, 1_023, dev, missing=False, permuted=False, time_it=False)
    recs.update(phase2_k6(dev))
    recs.update(phase2_mt(dev))
    recs.update(phase2_k9(dev))
    recs.update(phase2_k10(dev))
    return recs


# ---------------------------------------------------------------- phase 3


def device_store(n, p, seed, dev):
    """Binomial(2, f) codes, f ~ U(0.1, 0.9), packed 4 per byte on the
    device (the generator of bench.py's north-star mode)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bpm = (n + 3) // 4
    freqs = 0.1 + 0.8 * torch.rand(p, generator=g, device=dev)
    q0 = (1.0 - freqs) ** 2
    q01 = q0 + 2.0 * freqs * (1.0 - freqs)
    packed = torch.empty((p, bpm), dtype=torch.uint8, device=dev)
    sub = 2048
    for c0 in range(0, p, sub):
        c1 = min(p, c0 + sub)
        u = torch.rand((c1 - c0, 4 * bpm), generator=g, device=dev)
        codes = ((u > q0[c0:c1, None]).to(torch.uint8)
                 + (u > q01[c0:c1, None]).to(torch.uint8))
        codes[:, n:] = 0
        c = codes.view(c1 - c0, bpm, 4)
        packed[c0:c1] = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    return packed, freqs


def default_priors(y, sum2pq, pi0=0.0, df=4.0, method="BayesC"):
    """The priors jwas_tpu's prepare_workspace derives for y = intercept +
    geno: h2 = 0.5 split of the phenotypic variance (setup.py:163-277).
    BayesR's marker variance is sigma^2 = genetic variance /
    (sum2pq * sum_k gamma_k pi_k) (setup.py:234-239), pi0 0 meaning the
    default class prior."""
    from jwas_tpu_torch.io.genotypes import bayesr_pi
    from jwas_tpu_torch.ops.markers import BAYESR_GAMMA

    var = float(np.var(y, ddof=1))
    vare0 = 0.5 * var
    if method == "BayesR":
        pi0 = bayesr_pi(pi0)
        denom = sum2pq * float(np.dot(BAYESR_GAMMA, pi0))
    else:
        denom = (1.0 - pi0) * sum2pq
    marker_var0 = 0.5 * var / denom
    return dict(vare0=vare0, scale_R=vare0 * (df - 2.0) / df, df_R=df,
                marker_var0=marker_var0,
                marker_scale0=marker_var0 * (df - 2.0) / df, df_marker=df,
                pi0=pi0)


def full_width_problem(dev, n=50_000, p=2_097_152):
    """The main paths' problem: a device-generated store of n x p, its Gram
    tiles at b = gb = 128, 0.1% QTL and h2 = 0.5. Returns gm, the centred
    phenotype and true breeding values on the host, sum 2pq, and the
    set-up seconds of the store and of the Grams."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.ops.grouped import grouped_matvec

    t0 = time.perf_counter()
    packed, freqs = device_store(n, p, 1, dev)
    torch.cuda.synchronize(dev)
    t_store = time.perf_counter() - t0
    b, gb = jt.pick_stable_blocks(n, 128, p)     # fast_blocks=128, as bench.py
    t0 = time.perf_counter()
    gm = jt.build_grouped_markers(packed, 2.0 * freqs, n, b, gb, dev,
                                  has_missing=False)
    torch.cuda.synchronize()
    t_gram = time.perf_counter() - t0

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    qtl = torch.rand(p, generator=g, device=dev) < 0.001
    beta_true = torch.randn(p, generator=g, device=dev) * qtl
    tbv = grouped_matvec(gm, beta_true)
    y = tbv + torch.randn(n, generator=g, device=dev) * tbv.std()
    y = (y - y.mean()).cpu().numpy()
    sum2pq = float(torch.sum(2.0 * freqs * (1.0 - freqs)))
    return gm, y, tbv.cpu().numpy(), sum2pq, t_store, t_gram


def phase3(dev, n=50_000, p=2_097_152):
    import jwas_tpu_torch as jt

    say(f"== phase 3: main path at full width, N={n} x P={p}")
    torch.cuda.reset_peak_memory_stats(dev)
    gm, y, tbv, sum2pq, t_store, t_gram = full_width_problem(dev, n, p)
    nblocks, b, _ = gm.grams.shape
    say(f"store: {gm.store.numel() / 1e9:.2f} GB packed on the device in {t_store:.1f} s")
    say(f"Gram tiles (b={b}, gb={nblocks // gm.ngroups}, "
        f"{gm.ngroups} groups, exact bf16): "
        f"{t_gram:.1f} s, {gm.grams.numel() * 4 / 1e9:.2f} GB")
    paths = {"BayesC": ("abc_inner_rounds", "packed_rhs", "packed_matvec", K6),
             "BayesR": ("bayesr_inner_rounds", "packed_rhs", "packed_matvec", K6)}
    launches = {"phase 3": {}}
    for method, kernels in paths.items():
        priors = default_priors(y, sum2pq, method=method)
        jt.reset_launches()
        res = jt.run_st(gm, y, **priors, method=method, chain_length=3 * b,
                        output_samples_frequency=b, seed=3)
        counts = {k.__name__: k.launches for k in jt.KERNELS}
        report_path(method, res, counts, p, n, tbv, dev)
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"phase 3 {method}: kernels never launched: {missing}")
        for k in kernels:
            launches["phase 3"][k] = launches["phase 3"].get(k, 0) + counts[k]
    # phase 5 keeps the store (used in place: no padding at b = gb = 128),
    # not the Gram tiles
    kept = dict(packed=gm.store, freqs=gm.means[:p].double().cpu().numpy() / 2.0,
                tbv=tbv, y=y)
    return launches, kept


def report_path(method, res, launches, p, n, tbv, dev):
    """Print one full-width run's times, rates, memory, launches and
    samples; raise on non-finite samples or EBVs."""
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    secs = res["window_seconds"]
    rates = [p * res["nreps"] / s for s in secs]
    say(f"run_st {method}: nreps={res['nreps']}, seconds per outer iteration "
        f"{', '.join(f'{s:.3f}' for s in secs)}; effective marker updates/s "
        f"{', '.join(f'{r:.4g}' for r in rates)}")
    say(f"peak device memory {peak:.2f} GB; launches {launches}")
    track = {k: res["samples"][k].tolist() for k in ("vare", "varg", "pi")}
    acc = float(np.corrcoef(res["ebv"], tbv)[0, 1])
    say(f"samples: {track}; EBV accuracy after {len(secs)} outer iterations "
        f"{acc:.4f}")
    for k, v in track.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"phase 3 {method}: non-finite {k} samples {v}")
    if res["ebv"].shape != (n,) or not np.isfinite(acc):
        raise AssertionError(f"phase 3 {method}: EBV shape {res['ebv'].shape}, "
                             f"accuracy {acc}")


# ---------------------------------------------------------------- phase 4


def stat_data(n=2_000, p=8_192, n_qtl=50, h2=0.5, seed=2024):
    """Simulated codes, phenotypes and true breeding values (numpy only, so
    the same data can be rebuilt anywhere from the seed)."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.1, 0.9, size=p)
    codes = rng.binomial(2, freqs[None, :], size=(n, p)).astype(np.uint8)
    effects = np.zeros(p)
    effects[rng.choice(p, size=n_qtl, replace=False)] = rng.normal(size=n_qtl)
    x = codes.astype(np.float64)
    bv = (x - x.mean(axis=0)) @ effects
    y = 10.0 + bv + rng.normal(0.0, np.sqrt(bv.var() * (1 - h2) / h2), size=n)
    return codes, y, bv


def stat_store(codes):
    from jwas_tpu_torch.io.packed import Packed2BitStore, pack_codes

    n, p = codes.shape
    means = codes.mean(axis=0)
    return Packed2BitStore(
        obs_ids=[f"ind{i + 1}" for i in range(n)],
        marker_ids=[f"m{j + 1}" for j in range(p)], packed=pack_codes(codes),
        means=means, allele_freq=means / 2.0, n_obs=n, n_markers=p,
        has_missing=False,
    )


def phase4_chain(where, threads=None):
    """Phase 4's BayesC chain through run_st on where (the plain versions on
    the CPU). Returns the EBVs, the posterior means of vare, varg and pi
    and the seconds."""
    import jwas_tpu_torch as jt

    if threads:
        torch.set_num_threads(threads)
    codes, y, bv = stat_data()
    store = stat_store(codes)
    t0 = time.perf_counter()
    gm = jt.setup_markers(store, store.obs_ids, torch.device(where))
    res = jt.run_st(gm, y, **default_priors(y, store.sum2pq), chain_length=PHASE4_SWEEPS,
                    burnin=PHASE4_SWEEPS // 4, seed=5)
    return dict(ebv=res["ebv"], vare=res["vare"], varg=res["varg"], pi=res["pi"],
                seconds=time.perf_counter() - t0)


def phase4(dev, cpu_chain):
    """Phase 4; see the module's docstring. cpu_chain: the CPU chain's
    result from phase4_chain("cpu") run in a worker process (an
    AsyncResult)."""
    import jwas_tpu_torch as jt

    say("== phase 4: statistical check, kernel path vs plain path")
    jt.reset_launches()
    codes, y, bv = stat_data()
    store = stat_store(codes)
    acc, ebv = {}, {}
    chains = {"cuda": phase4_chain(dev), "cpu": cpu_chain.get()}
    for where, res in chains.items():
        ebv[where] = res["ebv"]
        acc[where] = float(np.corrcoef(res["ebv"], bv)[0, 1])
        aside = ", in a worker process" if where == "cpu" else ""
        say(f"{where}: EBV accuracy {acc[where]:.4f}, vare "
            f"{res['vare']:.4g}, varg {res['varg']:.4g}, pi {res['pi']:.4f} "
            f"({res['seconds']:.1f} s{aside})")
    if acc["cuda"] < acc["cpu"] - ACC_MARGIN or acc["cuda"] < ACC_FLOOR:
        raise AssertionError(
            f"phase 4: kernel-path accuracy {acc['cuda']:.4f} vs plain "
            f"{acc['cpu']:.4f} (margin {ACC_MARGIN}, floor {ACC_FLOOR})")

    # the same chain through the model layer: a Table, build_model, runMCMC
    t0 = time.perf_counter()
    model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
        store, method="BayesC", storage="2bit"))
    out = jt.runMCMC(model, jt.Table({"ID": store.obs_ids, "y": y}),
                     chain_length=PHASE4_SWEEPS, burnin=PHASE4_SWEEPS // 4, seed=5,
                     output_folder="",
                     printout_model_info=False)
    got = np.asarray(out["EBV_y"].EBV)
    rel = float(np.abs(got - ebv["cuda"]).max() / np.abs(ebv["cuda"]).max())
    say(f"cuda runMCMC (Table, y = intercept + geno): EBVs against run_st's "
        f"max relative error {rel:.3g}, bit for bit {np.array_equal(got, ebv['cuda'])} "
        f"({time.perf_counter() - t0:.1f} s)")
    if list(out["EBV_y"].ID) != store.obs_ids or not rel <= RTOL_RUNMCMC:
        raise AssertionError(f"phase 4: runMCMC's EBVs differ from run_st's "
                             f"(relative {rel:.3g} > {RTOL_RUNMCMC})")

    t0 = time.perf_counter()
    gm = jt.setup_markers(store, store.obs_ids, dev)
    res = jt.run_st(gm, y, **default_priors(y, store.sum2pq, method="BayesR"),
                    method="BayesR", chain_length=1024, burnin=256, seed=5)
    acc_r = float(np.corrcoef(res["ebv"], bv)[0, 1])
    say(f"cuda BayesR: EBV accuracy {acc_r:.4f}, vare {res['vare']:.4g}, "
        f"sigma^2 {res['varg']:.4g}, pi {', '.join(f'{x:.4f}' for x in res['pi'])} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not acc_r >= ACC_FLOOR_BAYESR:
        raise AssertionError(f"phase 4: BayesR kernel-path accuracy {acc_r:.4f} "
                             f"< floor {ACC_FLOOR_BAYESR}")
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    if counts[K6] == 0:
        raise AssertionError(f"phase 4: the card's chains never launched K6: {counts}")
    return {K6: counts[K6]}


# ---------------------------------------------------------------- phase 5


def phase5_problem(packed, freqs, tbv, seed=5, n_train=45_000, n_herds=100):
    """Phase 3's store as a Packed2BitStore (IDs ind1.., markers m1..,
    means 2f, no missing codes) and a phenotype Table of n_train of its
    individuals in shuffled order: y = TBV + herd effect + 0.5 age + noise
    of the TBV's variance. Returns (store, table, true herd effects,
    training IDs, candidate IDs)."""
    from jwas_tpu_torch.io.packed import Packed2BitStore
    from jwas_tpu_torch.io.table import Table

    p, n = packed.shape[0], tbv.shape[0]
    ids = np.array([f"ind{i + 1}" for i in range(n)], dtype=object)
    store = Packed2BitStore(
        obs_ids=list(ids), marker_ids=[f"m{j + 1}" for j in range(p)],
        packed=packed, means=2.0 * freqs, allele_freq=freqs, n_obs=n,
        n_markers=p, has_missing=False)
    rng = np.random.default_rng(seed)
    sd = float(np.std(tbv))
    herd_effect = rng.normal(0.0, sd, n_herds)
    herd = rng.integers(1, n_herds + 1, n)
    age = np.round(rng.uniform(1.0, 5.0, n), 2)
    y = tbv + herd_effect[herd - 1] + 0.5 * age + rng.normal(0.0, sd, n)
    order = rng.permutation(n)
    train, cand = order[:n_train], order[n_train:]
    table = Table({"ID": ids[train], "y": y[train], "herd": herd[train],
                   "age": age[train]})
    return store, table, herd_effect, list(ids[train]), list(ids[cand])


def run_phase5(store, table, method="BayesC", eq="y = intercept + herd + age + geno",
               on_markers=None, around_chain=None, on_model=None, model_kw=None, **kw):
    """runMCMC at full width on phase5_problem's data (or another table and
    equation; store a Packed2BitStore, the Genotypes of a dense store or
    None, no genotypes), with the set-up (workspace; Grams on the
    row-permuted float32 path) and the chain timed inside it. on_model(model)
    is called on the built model (set_random), on_markers(gm)
    on the grouped store before the chain runs, which runs inside the
    context manager around_chain when one is given. Returns (results, seconds
    by part, what the timed parts returned: "store and Grams" the grouped
    store, "chain" run_chain's tuple (state, accum, samples, burn-in
    seconds, window seconds) of chain 0 of run_chains). model_kw: build_model's keywords
    (categorical_trait, censored_trait)."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.mcmc as em

    seconds, built = {}, {}

    def timed(name, fn):
        def call(*a, **k):
            ctx = around_chain if name == "chain" and around_chain else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            built[name] = out
            if name == "store and Grams" and on_markers is not None:
                on_markers(out)
            return out
        return call

    saved = (em.prepare_workspace, em.setup_markers, em.setup_dense_markers,
             em.run_chains)
    em.prepare_workspace = timed("workspace", em.prepare_workspace)
    em.setup_markers = timed("store and Grams", em.setup_markers)
    em.setup_dense_markers = timed("store and Grams", em.setup_dense_markers)
    em.run_chains = timed("chain", em.run_chains)
    try:
        genotypes = (store if store is None or hasattr(store, "dense") else
                     jt.get_genotypes(store, method=method, storage="2bit"))
        model = jt.build_model(eq, genotypes=genotypes, **(model_kw or {}))
        if "age" in table.columns:
            jt.set_covariate(model, "age")
        if on_model is not None:
            on_model(model)
        t0 = time.perf_counter()
        kw = dict(dict(fast_blocks=128, chain_length=384,
                       output_samples_frequency=128, seed=3,
                       printout_model_info=False), **kw)
        out = jt.runMCMC(model, table, **kw)
        seconds["runMCMC"] = time.perf_counter() - t0
    finally:
        (em.prepare_workspace, em.setup_markers, em.setup_dense_markers,
         em.run_chains) = saved
    if "chain" in built:
        states, accums, samples, _, t_burnin, windows = built["chain"]
        built["chain"] = (states[0], accums[0], samples, t_burnin, windows)
    return out, seconds, built


def direct_ebv(packed, means, alpha, cols):
    """X alpha in float64 for a few store columns of a store without missing
    codes, decoded on the device: X_ij = code - mean_j."""
    dev = packed.device
    cols = torch.as_tensor(cols, device=dev)
    shift = (2 * (cols % 4)).to(torch.uint8)
    codes = (packed[:, cols // 4] >> shift) & 3                 # (p, k)
    x = codes.to(torch.float64) - torch.as_tensor(means, device=dev)[:, None]
    a = torch.as_tensor(np.asarray(alpha, dtype=np.float64), device=dev)
    return (x * a[:, None]).sum(dim=0).cpu().numpy()


def phase5(dev, kept, n_train=45_000):
    import tempfile

    import jwas_tpu_torch as jt

    say("== phase 5: runMCMC at full width")
    tbv = kept["tbv"]
    store, table, herd_effect, train, cand = phase5_problem(
        kept["packed"], kept["freqs"], tbv, n_train=n_train)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    jt.reset_launches()
    with tempfile.TemporaryDirectory() as folder:
        out, seconds, built = run_phase5(store, table, output_folder=folder,
                                         device=dev)
        gm = built.pop("store and Grams")
        in_place = gm.store.data_ptr() == kept["packed"].data_ptr()
        b, gb = gm.grams.shape[1], gm.grams.shape[0] // gm.ngroups
        del gm, built["workspace"]
        windows = built.pop("chain")[-1]
        counts = {k.__name__: k.launches for k in jt.KERNELS}
        samples = {}
        for name in ("residual_variance", "marker_effects_variances_geno", "pi_geno"):
            with open(f"{folder}/MCMC_samples_{name}.txt") as f:
                rows = [line.strip() for line in f if line.strip()]
            samples[name] = [float(r.split(",")[0]) for r in rows
                             if not r[0].isalpha()]
        files = sorted(os.listdir(folder))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    say(f"store {store.n_obs} x {store.n_markers} used in place: {in_place}; "
        f"b={b}, gb={gb}; "
        f"{len(table)} phenotyped in shuffled order, "
        f"{store.n_obs - len(table)} candidates")
    say("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + "; the chain's windows (an outer iteration and a saved sample each) "
        + ", ".join(f"{t:.3f}" for t in windows))
    say(f"peak device memory {peak:.2f} GB; launches {counts}; files {files}")
    say(f"samples: {samples}")
    missing = [k for k in PHASE5_KEYS if k not in out]
    if missing:
        raise AssertionError(f"phase 5: result keys missing: {missing}")
    ebv_t = out["EBV_y"]
    if len(ebv_t) != store.n_obs or list(ebv_t.ID) != store.obs_ids:
        raise AssertionError(f"phase 5: EBV_y has {len(ebv_t)} rows, not {store.n_obs}")
    ebv = dict(zip(ebv_t.ID, ebv_t.EBV))
    truth = dict(zip(store.obs_ids, tbv))
    acc = {who: float(np.corrcoef([ebv[s] for s in ids], [truth[s] for s in ids])[0, 1])
           for who, ids in (("candidates", cand), ("training", train))}
    # the route of the output IDs' EBVs: K5's pass over every store column,
    # here against a direct decode of a few candidates' columns on the card
    check = [store.obs_ids.index(s) for s in cand[:64]]
    direct = direct_ebv(kept["packed"], store.means, out["marker effects geno"].Estimate,
                        check)
    got = np.array([ebv[store.obs_ids[c]] for c in check])
    err = float(np.abs(got - direct).max() / np.abs(direct).max())
    say(f"EBVs of 64 candidates against X alpha decoded directly: max relative "
        f"error {err:.3g} (tolerance {RTOL_DIRECT_EBV})")
    if not err <= RTOL_DIRECT_EBV:
        raise AssertionError(f"phase 5: candidates' EBVs off by {err:.3g}")
    loc = out["location parameters"]
    herd = [(int(float(lv)), est) for eff, lv, est in
            zip(loc.Effect, loc.Level, loc.Estimate) if eff == "herd"]
    r_herd = float(np.corrcoef([herd_effect[h - 1] for h, _ in herd],
                               [e for _, e in herd])[0, 1])
    say(f"EBV accuracy after 3 outer iterations: candidates {acc['candidates']:.4f}, "
        f"training {acc['training']:.4f}; herd estimates against the true herd "
        f"effects r = {r_herd:.4f} ({len(herd)} levels)")
    values = [np.asarray(t[c], dtype=np.float64) for k in PHASE5_KEYS
              for t in (out[k],) for c in t.columns if t[c].dtype.kind == "f"]
    values += [np.asarray(v) for v in samples.values()]
    if not all(np.isfinite(v).all() for v in values) or not np.isfinite(list(acc.values())).all():
        raise AssertionError("phase 5: non-finite results")
    path = ("abc_inner_rounds", "packed_rhs", "packed_matvec", K6)
    if any(counts[k] == 0 for k in path):
        raise AssertionError(f"phase 5: kernels never launched: {counts}")
    if not in_place:
        raise AssertionError("phase 5: runMCMC copied the device store")
    return {k: counts[k] for k in path}


# ---------------------------------------------------------------- phase 6

PATH_ABC = ("abc_inner_rounds", "packed_rhs", "packed_matvec", K6)
# device memory beyond the store and the Gram tiles that phase 6(a) may use
PHASE6_MARGIN_BYTES = 4e9


def phase6a(dev, kept, n_train=45_000):
    """BayesB through runMCMC at its default block size on phase 5's data:
    b = 136, gb = 128 at 45,000 phenotyped, so the last group is short and
    is served as G rows from a zero-padded copy of its rows; the store is
    used in place and peak memory stays within store + Grams +
    PHASE6_MARGIN_BYTES."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.ops.grouped import resolve_blocks
    from jwas_tpu_torch.ops.inner_rounds import gram_resident

    p = kept["packed"].shape[0]
    b, gb = resolve_blocks(n_train, False, p, warn=False)
    say(f"== phase 6a: runMCMC BayesB at the default block size (b={b}, gb={gb})")
    store, table, _, _, _ = phase5_problem(kept["packed"], kept["freqs"], kept["tbv"],
                                           n_train=n_train)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    jt.reset_launches()
    out, seconds, built = run_phase5(store, table, method="BayesB", device=dev,
                                     fast_blocks=False, chain_length=3 * b,
                                     output_samples_frequency=b, output_folder="")
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    gm = built.pop("store and Grams")
    in_place = gm.store.data_ptr() == kept["packed"].data_ptr()
    tail = gm.fetch.tail
    padded_tail = (tail is not None and tail.shape[0] == gm.fetch.G
                   and not bool(tail[p - (gm.ngroups - 1) * gm.fetch.G:].any()))
    shape = (gm.grams.shape[1], gm.grams.shape[0] // gm.ngroups, gm.ngroups,
             gm.valid.shape[0] - p)
    grams_bytes = gm.grams.numel() * 4
    resident = gram_resident(b, b)
    state, _, samples, _, windows = built.pop("chain")
    varg_real = state.varg[:p]
    finite = bool(torch.isfinite(varg_real).all()) and bool(torch.isfinite(state.alpha).all())
    del gm, state, built, tail
    peak = torch.cuda.max_memory_allocated(dev)
    limit = kept["packed"].numel() + grams_bytes + PHASE6_MARGIN_BYTES
    say(f"b={shape[0]}, gb={shape[1]}, {shape[2]} groups, {shape[3]} padding markers "
        f"(the last group short, served from a zero-padded copy of G rows: "
        f"{padded_tail}); store used in place: {in_place}; K1 Gram tile "
        f"{'resident (K2)' if resident else 'global (K1)'}")
    say("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + "; the chain's windows " + ", ".join(f"{t:.3f}" for t in windows))
    say(f"peak device memory {peak / 1e9:.2f} GB (store {kept['packed'].numel() / 1e9:.2f}"
        f" + Grams {grams_bytes / 1e9:.2f} + {PHASE6_MARGIN_BYTES / 1e9:.0f} GB = "
        f"{limit / 1e9:.2f} GB allowed); launches {counts}")
    say(f"samples: vare {samples['vare']}, varg (mean over markers) {samples['varg']}, "
        f"pi {samples['pi']}; results: marker effects variances "
        f"{out['marker effects variances geno'].Estimate[0]:.6g}")
    values = [np.asarray(out[k].Estimate, dtype=np.float64) for k in
              ("residual variance", "marker effects variances geno", "pi_geno",
               "marker effects geno")]
    values.append(np.asarray(out["EBV_y"].EBV, dtype=np.float64))
    if not finite or not all(np.isfinite(v).all() for v in values):
        raise AssertionError("phase 6a: non-finite results")
    if shape[:2] != (b, gb) or shape[3] <= 0:
        raise AssertionError(f"phase 6a: blocks {shape}, expected b={b}, gb={gb}, padding")
    if not in_place:
        raise AssertionError("phase 6a: runMCMC copied the device store")
    if not padded_tail:
        raise AssertionError("phase 6a: the short last group is not served as G rows")
    if not resident:
        raise AssertionError(f"phase 6a: b={b} does not take K1's resident branch (K2)")
    if peak > limit:
        raise AssertionError(f"phase 6a: peak {peak / 1e9:.2f} GB > {limit / 1e9:.2f} GB")
    if any(counts[k] == 0 for k in PATH_ABC):
        raise AssertionError(f"phase 6a: kernels never launched: {counts}")
    return {k: counts[k] for k in PATH_ABC}


def host_ram_available() -> int:
    """MemAvailable of /proc/meminfo, bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def copy_overlap(prof):
    """From a torch.profiler trace of a streamed store: the host-to-device
    copies' device seconds, the share of them during which a kernel ran (1:
    every copy hidden behind kernels, 0: copies in series with them; None
    without copies), and how many of the copies had a kernel running for at
    least half of their time, out of how many."""
    kern, copies = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        iv = (e.time_range.start, e.time_range.end)
        if "memcpy htod" in name:
            copies.append(iv)
        elif "memcpy" not in name and "memset" not in name:
            kern.append(iv)
    if not copies:
        return 0.0, None, 0, 0
    merged = []
    for t0, t1 in sorted(kern):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    starts = [m[0] for m in merged]
    total = hidden = 0.0
    mostly = 0
    for c0, c1 in copies:
        h = 0.0
        i = max(0, bisect.bisect_right(starts, c0) - 1)
        while i < len(merged) and merged[i][0] < c1:
            h += max(0.0, min(c1, merged[i][1]) - max(c0, merged[i][0]))
            i += 1
        total += c1 - c0
        hidden += h
        mostly += 2 * h >= c1 - c0
    return total / 1e6, (hidden / total if total else None), mostly, len(copies)


@contextlib.contextmanager
def busy_shares(out):
    """Profile the block with torch.profiler; then out holds the self
    device time of its kernels and of its memory copies over its wall time
    ("kernels", "copies"), each kernel's device seconds by name
    ("by_kernel"), each copy's and memset's ("by_copy"), the wall
    seconds ("wall") and the share of the
    host-to-device copies' device time during which a kernel ran
    ("overlap") and how many copies were at least half hidden, of how
    many ("mostly_hidden"; see copy_overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = copy = 0.0
    by_kernel, by_copy = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if "memcpy" in e.key.lower() or "memset" in e.key.lower():
            copy += us
            by_copy[e.key] = by_copy.get(e.key, 0.0) + us / 1e6
        else:
            kern += us
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e6
    _, overlap, mostly, ncopies = copy_overlap(prof)
    out.update(kernels=kern / 1e6 / wall, copies=copy / 1e6 / wall, wall=wall,
               overlap=overlap, mostly_hidden=(mostly, ncopies), by_kernel=by_kernel,
               by_copy=by_copy)


def phase6b(dev, kept, fast_blocks=128):
    """BayesC pi0 = 0 through runMCMC on phase 3's problem (every
    individual phenotyped, in store order) at fast_blocks = 128: the store
    resident on the card, then streamed from a pinned host copy with no
    group resident and with half of them resident (the split set through
    JWAS_HBM_BYTES), each twice, in the order streamed, hybrid, hybrid,
    streamed. Alpha, the EBVs and the vare / varg / pi tracks must equal the
    resident run's bit for bit. The first streamed and the first hybrid run
    are then profiled for one outer iteration: busy shares and the copies'
    overlap with kernels (their repeats are not: the script's time)."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.io.packed import Packed2BitStore
    from jwas_tpu_torch.io.table import Table
    from jwas_tpu_torch.ops import grouped as gr

    say("== phase 6b: the store streamed from pinned host memory")
    packed = kept["packed"]
    p, bpm = packed.shape
    n = kept["tbv"].shape[0]
    b, gb = gr.resolve_blocks(n, fast_blocks, p, warn=False)
    G = b * gb
    avail = host_ram_available()
    p_b = p
    if avail < 1.25 * p * bpm + 8e9:             # pinned copy, headroom
        p_b = max(G, int((avail - 8e9) / 1.25 / bpm) // G * G)
        say(f"host RAM available {avail / 1e9:.1f} GB cannot pin the "
            f"{p * bpm / 1e9:.1f} GB store: P cut to {p_b} for phase 6b")
    t0 = time.perf_counter()
    host = gr.pinned_copy(packed[:p_b])
    t_pin = time.perf_counter() - t0
    freqs = kept["freqs"][:p_b]
    ids = [f"ind{i + 1}" for i in range(n)]
    table = Table({"ID": np.array(ids, dtype=object), "y": kept["y"]})

    def store_of(x):
        return Packed2BitStore(obs_ids=ids, marker_ids=[f"m{j + 1}" for j in range(p_b)],
                               packed=x, means=2.0 * freqs, allele_freq=freqs,
                               n_obs=n, n_markers=p_b, has_missing=False)

    ngroups = -(-p_b // G)
    split = {"streamed": 0, "hybrid": ngroups // 2}
    runs = [("resident", store_of(packed[:p_b]), False, None)]
    for i, name in enumerate(("streamed", "hybrid", "hybrid", "streamed")):
        runs.append((name if i < 2 else f"{name} again", store_of(host), True,
                     gr.hybrid_budget(split[name], ngroups, G, b, bpm)))
    say(f"host copy: {host.numel() / 1e9:.2f} GB pinned in {t_pin:.1f} s; P = {p_b}, "
        f"b={b}, gb={gb}, {ngroups} groups of {G * bpm / 1e6:.1f} MB")
    results, launches = {}, {}
    for name, store, offload, budget in runs:
        fetch = {}

        def on_markers(gm):
            fetch["f"] = gm.fetch
            gm.fetch.record = True

        saved = os.environ.get("JWAS_HBM_BYTES")
        if budget is not None:
            os.environ["JWAS_HBM_BYTES"] = str(budget)
        try:
            torch.cuda.empty_cache()
            jt.reset_launches()
            kw = dict(method="BayesC", eq="y = intercept + geno", device=dev,
                      fast_blocks=fast_blocks, chain_length=2 * b,
                      output_samples_frequency=b, output_folder="",
                      host_offload_genotypes=offload)
            out, seconds, built = run_phase5(store, table, on_markers=on_markers, **kw)
            counts = {k.__name__: k.launches for k in jt.KERNELS}
            f = fetch["f"]
            copy_s, copy_b = f.copy_seconds()
            state, _, samples, _, windows = built["chain"]
            results[name] = dict(alpha=state.alpha.cpu().numpy(),
                                 ebv=np.asarray(out["EBV_y"].EBV),
                                 **{k: np.asarray(samples[k]) for k in ("vare", "varg", "pi")})
            del built, state, out
            busy = {}
            if offload and not name.endswith("again"):   # the repeats are not profiled
                _, _, prof_built = run_phase5(store, table, around_chain=busy_shares(busy),
                                              **dict(kw, chain_length=b))
                busy["windows"] = prof_built["chain"][-1]
                del prof_built
        finally:
            if saved is None:
                os.environ.pop("JWAS_HBM_BYTES", None)
            else:
                os.environ["JWAS_HBM_BYTES"] = saved
        launches[name] = {k: counts[k] for k in PATH_ABC}
        line = (f"{name}: {f.resident} of {f.ngroups} groups on the card; seconds: "
                + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
                + "; s / outer iteration " + ", ".join(f"{t:.4f}" for t in windows))
        if copy_b:
            line += (f"; host-to-device copies during the chain: {copy_b / 1e9:.1f} GB in "
                     f"{copy_s:.3f} s of copy-stream time, {copy_b / copy_s / 1e9:.1f} GB/s")
        if busy:
            overlap = ("none" if busy["overlap"] is None
                       else f"{busy['overlap']:.4f}")
            line += (f"; profiled chain of 1 outer iteration ({busy['wall']:.2f} s, "
                     f"windows {', '.join(f'{t:.4f}' for t in busy['windows'])}): "
                     f"kernels busy {busy['kernels']:.4f}, copies {busy['copies']:.4f} "
                     f"of the wall time; share of the copies' device time with a "
                     f"kernel running {overlap}, copies at least half hidden "
                     f"{busy['mostly_hidden'][0]} of {busy['mostly_hidden'][1]}")
        say(line)
        say(f"  launches {counts}")
    ref = results["resident"]
    for name in results:
        if name == "resident":
            continue
        same = {k: bool(np.array_equal(results[name][k], ref[k])) for k in ref}
        say(f"{name} vs resident, bit for bit: {same}")
        if not all(same.values()):
            raise AssertionError(f"phase 6b: the {name} chain differs from the resident "
                                 f"one in {[k for k, v in same.items() if not v]}")
    for name, c in launches.items():
        if any(c[k] == 0 for k in PATH_ABC):
            raise AssertionError(f"phase 6b {name}: kernels never launched: {c}")
    if not all(np.isfinite(ref[k]).all() for k in ref):
        raise AssertionError("phase 6b: non-finite results")
    del host
    return launches["streamed"]


# ---------------------------------------------------------------- phase 7

# device memory beyond the store and the Gram tiles that phase 7 may use
PHASE7_MARGIN_BYTES = 4e9


def dense_codes(n, p, seed, dev):
    """Binomial(2, f) scores, f ~ U(0.1, 0.9), int8, generated on the
    device marker-major; returned as the (n, p) view get_genotypes reads."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    freqs = 0.1 + 0.8 * torch.rand(p, generator=g, device=dev)
    q0 = (1.0 - freqs) ** 2
    q01 = q0 + 2.0 * freqs * (1.0 - freqs)
    codes = torch.empty((p, n), dtype=torch.int8, device=dev)
    for c0 in range(0, p, 2048):
        c1 = min(p, c0 + 2048)
        u = torch.rand((c1 - c0, n), generator=g, device=dev)
        codes[c0:c1] = ((u > q0[c0:c1, None]).to(torch.int8)
                        + (u > q01[c0:c1, None]).to(torch.int8))
    return codes.T


def phase7_problem(geno, seed=5, n_train=45_000, n_herds=100):
    """Phase 5's design on a dense store's individuals: TBV = X beta with
    0.1% QTL (torch seed 2, on the device), then design_table. Returns
    (table, tbv, training IDs, candidate IDs)."""
    X = geno.dense
    p, n = X.shape
    g = torch.Generator(device=X.device)
    g.manual_seed(2)
    qtl = torch.rand(p, generator=g, device=X.device) < 0.001
    beta = (torch.randn(p, generator=g, device=X.device) * qtl).to(X.dtype)
    tbv = torch.mv(X.T, beta).double().cpu().numpy()
    return design_table(geno.obs_ids, tbv, seed, n_train, n_herds)


def design_table(obs_ids, tbv, seed, n_train, n_herds=100):
    """Phase 5's design on individuals obs_ids with true breeding values
    tbv: a herd factor, an age covariate, noise of the TBV's variance over
    the weight, and a 'weights' column ~ U(0.5, 2), for n_train
    individuals in shuffled order. Returns (table, tbv, training IDs,
    candidate IDs)."""
    from jwas_tpu_torch.io.table import Table

    n = len(obs_ids)
    ids = np.array(obs_ids, dtype=object)
    rng = np.random.default_rng(seed)
    sd = float(np.std(tbv))
    herd_effect = rng.normal(0.0, sd, n_herds)
    herd = rng.integers(1, n_herds + 1, n)
    age = np.round(rng.uniform(1.0, 5.0, n), 2)
    weights = rng.uniform(0.5, 2.0, n)
    y = (tbv + herd_effect[herd - 1] + 0.5 * age
         + rng.normal(0.0, sd, n) / np.sqrt(weights))
    order = rng.permutation(n)
    train, cand = order[:n_train], order[n_train:]
    table = Table({"ID": ids[train], "y": y[train], "herd": herd[train],
                   "age": age[train], "weights": weights[train]})
    return table, tbv, list(ids[train]), list(ids[cand])


def fresh(geno, method):
    """The Genotypes of the same dense store for another method, with
    priors of their own (runMCMC fills them in on the object it gets)."""
    import dataclasses

    from jwas_tpu_torch.io.genotypes import VarianceSpec, bayesr_pi
    return dataclasses.replace(
        geno, method=method, pi=bayesr_pi(0.0) if method == "BayesR" else 0.0,
        G=VarianceSpec(val=None), genetic_variance=VarianceSpec(val=None))


def dense_gemv_line(X, G, dev):
    """The dense GEMVs of a round over one group's slab (G rows of the
    store): X_g' w and X_g v by torch.mv, each against its byte bound."""
    rows = X[:G]
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    w = torch.randn(rows.shape[1], generator=g, device=dev, dtype=X.dtype)
    v = torch.randn(G, generator=g, device=dev, dtype=X.dtype)
    nbytes = rows.numel() * rows.element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms_rhs = cuda_ms(lambda: torch.mv(rows, w), 20)
    ms_mv = cuda_ms(lambda: torch.mv(rows.T, v), 20)
    say(f"dense GEMVs of a round, {str(X.dtype).replace('torch.', '')} slab of "
        f"{G} x {rows.shape[1]} ({nbytes / 1e9:.3f} GB): X_g'w {ms_rhs:.4f} ms, "
        f"X_g v {ms_mv:.4f} ms, bound {bound:.4f} ms each (bytes; "
        f"{bound / ms_rhs:.1%} and {bound / ms_mv:.1%} of it reached)")


def run_dense(label, dev, geno, table, tbv, train, cand, kernels, keep=None, **kw):
    """runMCMC on a dense store at full width (run_phase5's timing):
    prints seconds, windows, peak memory against store + Grams +
    PHASE7_MARGIN_BYTES, launches, EBV accuracy and the output IDs' EBVs
    against X alpha computed directly; raises where a check fails.
    Returns (the store's shape and schedule, the launches of kernels
    (names, or name_f64 for the float64 builds' counts)). keep: a dict that
    receives the results ("out") and the windows' seconds ("windows")."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.ops.inner_rounds import gram_resident

    X = geno.dense
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    jt.reset_launches()
    kw = dict(dict(method=geno.method, device=dev, output_folder="",
                   heterogeneous_residuals=True), **kw)
    out, seconds, built = run_phase5(geno, table, **kw)
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    counts.update({k.__name__ + "_f64": k.launches_f64 for k in jt.KERNELS
                   if hasattr(k, "launches_f64")})
    gm = built.pop("store and Grams")
    in_place = gm.X.data_ptr() == X.data_ptr()
    nblocks, b, _ = gm.grams.shape
    shape = dict(b=b, gb=gm.G // b, groups=gm.ngroups, exact=gm.exact,
                 dtype=str(gm.X.dtype).replace("torch.", ""),
                 gram="resident" if gram_resident(
                     b, b, "BayesR" if geno.method == "BayesR" else "BayesC",
                     gm.X.dtype) else "global")
    grams_bytes = gm.grams.numel() * gm.grams.element_size()
    windows = built.pop("chain")[-1]
    if keep is not None:
        keep.update(out=out, windows=windows)
    del gm, built
    peak = torch.cuda.max_memory_allocated(dev)
    store_bytes = X.numel() * X.element_size()
    limit = store_bytes + grams_bytes + PHASE7_MARGIN_BYTES
    say(f"{label}: {shape}; store used in place: {in_place}")
    say("  seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + "; results " + f"{seconds['runMCMC'] - sum(v for k, v in seconds.items() if k != 'runMCMC'):.3f}"
        + "; windows " + ", ".join(f"{t:.4f}" for t in windows))
    say(f"  peak device memory {peak / 1e9:.2f} GB (store {store_bytes / 1e9:.2f} + Grams "
        f"{grams_bytes / 1e9:.3f} + {PHASE7_MARGIN_BYTES / 1e9:.0f} GB = "
        f"{limit / 1e9:.2f} GB allowed); launches {counts}")
    ebv = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    truth = dict(zip(geno.obs_ids, tbv))
    acc = {who: float(np.corrcoef([ebv[s] for s in ids], [truth[s] for s in ids])[0, 1])
           for who, ids in (("candidates", cand), ("training", train))}
    col = {s: i for i, s in enumerate(geno.obs_ids)}
    check = torch.as_tensor([col[s] for s in cand[:64]], device=dev)
    alpha = torch.as_tensor(np.asarray(out["marker effects geno"].Estimate,
                                       dtype=np.float64), device=dev)
    direct = (X[:, check].double() * alpha[:, None]).sum(dim=0).cpu().numpy()
    got = np.array([ebv[s] for s in cand[:64]])
    err = float(np.abs(got - direct).max() / np.abs(direct).max())
    pi = (f", pi {list(np.round(np.atleast_1d(out['pi_geno'].Estimate), 6))}"
          if "pi_geno" in out else "")
    say(f"  EBV accuracy: candidates {acc['candidates']:.4f}, training "
        f"{acc['training']:.4f}; 64 candidates' EBVs against X alpha computed "
        f"directly: max relative error {err:.3g} (tolerance {RTOL_DIRECT_EBV}); "
        f"vare {out['residual variance'].Estimate[0]:.6g}, var_g "
        f"{out['marker effects variances geno'].Estimate[0]:.6g}{pi}")
    values = [np.asarray(out[k].Estimate, dtype=np.float64) for k in
              ("residual variance", "marker effects variances geno", "pi_geno",
               "marker effects geno", "location parameters") if k in out]
    values.append(np.asarray(out["EBV_y"].EBV, dtype=np.float64))
    if not all(np.isfinite(v).all() for v in values) or not np.isfinite(list(acc.values())).all():
        raise AssertionError(f"{label}: non-finite results")
    if not err <= RTOL_DIRECT_EBV:
        raise AssertionError(f"{label}: candidates' EBVs off X alpha by {err:.3g}")
    if not in_place:
        raise AssertionError(f"{label}: runMCMC copied the dense store")
    if peak > limit:
        raise AssertionError(f"{label}: peak {peak / 1e9:.2f} GB > {limit / 1e9:.2f} GB")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    return shape, {k: counts[k] for k in kernels}


def phase7(dev, n=50_000, p=100_000, n_train=45_000):
    """Dense genotypes at full width; see the module's docstring."""
    import jwas_tpu_torch as jt

    say(f"== phase 7: dense genotypes at full width, N={n} x P={p}")
    launches = {}
    t0 = time.perf_counter()
    codes = dense_codes(n, p, 7, dev)
    torch.cuda.synchronize()
    t_codes = time.perf_counter() - t0
    t0 = time.perf_counter()
    geno = jt.get_genotypes(codes, method="BayesC", storage="f32", device=dev)
    torch.cuda.synchronize()
    t_geno = time.perf_counter() - t0
    del codes
    if geno.n_markers != p:
        raise AssertionError(f"phase 7: QC kept {geno.n_markers} of {p} markers")
    table, tbv, train, cand = phase7_problem(geno, n_train=n_train)
    say(f"int8 scores generated in {t_codes:.2f} s; get_genotypes(storage='f32') "
        f"wrote the {tuple(geno.dense.shape)} store ({geno.dense.numel() * 4 / 1e9:.2f} "
        f"GB) in {t_geno:.2f} s; {len(train)} phenotyped with weights, "
        f"{len(cand)} candidates")
    abc, br = ("abc_inner_rounds", K6), ("bayesr_inner_rounds", K6)
    shape, launches["phase 7a"] = run_dense(
        "7a BayesC, fast_blocks=True, weighted", dev, geno, table, tbv, train, cand,
        abc, fast_blocks=True, chain_length=768, output_samples_frequency=256)
    from jwas_tpu_torch.ops.markers import dense_blocks
    b, gb, _ = dense_blocks(n_train, True, p)      # b = 256, gb = 23 at full width
    if (shape["b"], shape["gb"]) != (b, gb) or (b > 240 and shape["gram"] != "global"):
        raise AssertionError(f"phase 7a: blocks {shape}, expected b={b}, gb={gb} "
                             f"(K1's global-memory Gram branch above b = 240)")
    dense_gemv_line(geno.dense, shape["b"] * shape["gb"], dev)
    _, launches["phase 7b"] = run_dense(
        "7b BayesR, fast_blocks=True, weighted", dev, fresh(geno, "BayesR"), table,
        tbv, train, cand, br, fast_blocks=True, chain_length=768,
        output_samples_frequency=256)
    shape, launches["phase 7c"] = run_dense(
        "7c BayesC, the exact sweep (fast_blocks=False), weighted", dev,
        fresh(geno, "BayesC"), table, tbv, train, cand, abc, fast_blocks=False,
        chain_length=20, output_samples_frequency=10)
    if not shape["exact"]:
        raise AssertionError("phase 7c: not the exact sweep")
    del geno
    torch.cuda.empty_cache()
    codes = dense_codes(n, p, 7, dev)
    t0 = time.perf_counter()
    geno = jt.get_genotypes(codes, method="BayesC", storage="f64", device=dev)
    torch.cuda.synchronize()
    say(f"float32 store freed; get_genotypes(storage='f64') wrote the "
        f"{geno.dense.numel() * 8 / 1e9:.2f} GB store in {time.perf_counter() - t0:.2f} s")
    del codes
    shape, launches["phase 7d"] = run_dense(
        "7d BayesC, double_precision, fast_blocks=True, weighted", dev, geno, table,
        tbv, train, cand, ("abc_inner_rounds_f64", K6 + "_f64"), fast_blocks=True,
        double_precision=True, chain_length=512, output_samples_frequency=256)
    if shape["dtype"] != "float64":
        raise AssertionError(f"phase 7d: the chain ran in {shape['dtype']}")
    dense_gemv_line(geno.dense, shape["b"] * shape["gb"], dev)
    _, launches["phase 7d BayesR"] = run_dense(
        "7d BayesR, double_precision, fast_blocks=True, weighted", dev,
        fresh(geno, "BayesR"), table, tbv, train, cand,
        ("bayesr_inner_rounds_f64", K6 + "_f64"),
        fast_blocks=True, double_precision=True, chain_length=256,
        output_samples_frequency=256)
    del geno
    torch.cuda.empty_cache()
    return launches


PHASE8_METHODS = ("RR-BLUP", "BayesL", "BayesA")


@contextlib.contextmanager
def timed_calls(seconds, name, owner, attr):
    """owner.attr timed into seconds[name] (the device synchronised on both
    sides) while the context is open."""
    fn = getattr(owner, attr)

    def call(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    setattr(owner, attr, call)
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def phase8(dev, n=50_000, p=100_000, n_train=45_000, n_gblup=20_000,
           n_train_gblup=18_000):
    """RR-BLUP, BayesL, BayesA and GBLUP at full width; see the module's
    docstring."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.setup as es
    from jwas_tpu_torch.ops.markers import dense_blocks

    say(f"== phase 8: RR-BLUP, BayesL and BayesA at N={n} x P={p}; GBLUP at "
        f"N={n_gblup} x P={p}")
    launches = {}
    codes = dense_codes(n, p, 7, dev)
    t0 = time.perf_counter()
    geno = jt.get_genotypes(codes, method="RR-BLUP", storage="f32", device=dev)
    torch.cuda.synchronize()
    del codes
    say(f"get_genotypes(method='RR-BLUP', storage='f32') wrote the "
        f"{tuple(geno.dense.shape)} store ({geno.dense.numel() * 4 / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    table, tbv, train, cand = phase7_problem(geno, n_train=n_train)
    table = type(table)({c: table[c] for c in table.columns if c != "weights"})
    b, gb, _ = dense_blocks(n_train, True, p)      # b = 256, gb = 23 at full width
    abc = ("abc_inner_rounds", K6)
    for method in PHASE8_METHODS:
        shape, launches[f"phase 8a {method}"] = run_dense(
            f"8a {method}, fast_blocks=True", dev, fresh(geno, method), table, tbv,
            train, cand, abc, fast_blocks=True, chain_length=768,
            output_samples_frequency=256, heterogeneous_residuals=False)
        if (shape["b"], shape["gb"], shape["gram"]) != (b, gb, "global"):
            raise AssertionError(f"phase 8a {method}: blocks {shape}, expected b={b}, "
                                 f"gb={gb} on K1's global-memory Gram branch")
    shape, launches["phase 8a RR-BLUP exact"] = run_dense(
        "8a RR-BLUP, the exact sweep (fast_blocks=False)", dev, fresh(geno, "RR-BLUP"),
        table, tbv, train, cand, abc, fast_blocks=False, chain_length=10,
        output_samples_frequency=5, heterogeneous_residuals=False)
    if not shape["exact"]:
        raise AssertionError("phase 8a: not the exact sweep")
    del geno
    torch.cuda.empty_cache()

    # (b) GBLUP on the first n_gblup individuals (the same scores, made
    # again): the relationship matrix on the card, then runMCMC (the
    # eigenbasis in its workspace)
    codes = dense_codes(n, p, 7, dev)[:n_gblup]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = jt.get_genotypes(codes, method="GBLUP", storage="f32", device=dev)
    torch.cuda.synchronize()
    t_grm, peak_grm = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev)
    del codes
    torch.cuda.empty_cache()
    say(f"8b GBLUP: get_genotypes(method='GBLUP') built the {tuple(g.grm.shape)} "
        f"relationship matrix from {g.n_markers} markers in {t_grm:.2f} s (peak "
        f"{peak_grm / 1e9:.2f} GB); the store freed: {g.dense is None}")
    table_g, tbv_g, train_g, cand_g = design_table(g.obs_ids, tbv[:n_gblup], 6,
                                                   n_train_gblup)
    table_g = type(table_g)({c: table_g[c] for c in table_g.columns if c != "weights"})
    torch.cuda.reset_peak_memory_stats(dev)
    jt.reset_launches()
    parts = {}
    with timed_calls(parts, "eigh", torch.linalg, "eigh"), \
            timed_calls(parts, "eigenbasis", es, "gblup_eigen"):
        out, seconds, built = run_phase5(g, table_g, device=dev, chain_length=200,
                                         output_samples_frequency=50, output_folder="")
    peak = torch.cuda.max_memory_allocated(dev)
    ws, windows = built["workspace"], built["chain"][-1]
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    say(f"  seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; of the workspace: eigh {parts['eigh']:.3f}, L and the output map "
        f"{parts['eigenbasis'] - parts['eigh']:.3f}; windows of 50 iterations "
        + ", ".join(f"{t:.4f}" for t in windows)
        + f" ({np.mean(windows[1:]) / 50 * 1e3:.3f} ms an iteration after the first)")
    say(f"  L {tuple(ws.gblup_L.shape)}, output map {tuple(ws.gblup_out.shape)}; "
        f"peak device memory {peak / 1e9:.2f} GB; launches {counts}")
    ebv = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    truth = dict(zip(g.obs_ids, tbv_g))
    acc = {who: float(np.corrcoef([ebv[s] for s in ids], [truth[s] for s in ids])[0, 1])
           for who, ids in (("candidates", cand_g), ("training", train_g))}
    alpha = torch.as_tensor(np.asarray(out["marker effects geno"].Estimate,
                                       dtype=np.float64), device=dev)
    direct = (ws.gblup_out.double() @ alpha).cpu().numpy()
    got = np.array([ebv[s] for s in ws.output_ids])
    err = float(np.abs(got - direct).max() / np.abs(direct).max())
    say(f"  EBV accuracy: candidates {acc['candidates']:.4f}, training "
        f"{acc['training']:.4f}; the {len(got)} output IDs' EBVs against the output "
        f"map times alpha: max relative error {err:.3g} (tolerance {RTOL_DIRECT_EBV}); "
        f"vare {out['residual variance'].Estimate[0]:.6g}, var_g "
        f"{out['marker effects variances geno'].Estimate[0]:.6g}")
    values = [np.asarray(out[k].Estimate, dtype=np.float64) for k in
              ("residual variance", "marker effects variances geno",
               "marker effects geno", "location parameters")] + [got]
    if not all(np.isfinite(v).all() for v in values) or not np.isfinite(list(acc.values())).all():
        raise AssertionError("phase 8b: non-finite results")
    if not err <= RTOL_DIRECT_EBV:
        raise AssertionError(f"phase 8b: EBVs off the output map times alpha by {err:.3g}")
    if ws.gblup_L.shape != (n_train_gblup, n_train_gblup) or len(got) != n_gblup:
        raise AssertionError(f"phase 8b: L {tuple(ws.gblup_L.shape)}, {len(got)} EBVs")
    if counts[K6] == 0:
        raise AssertionError(f"phase 8b: the location pass never launched K6: {counts}")
    launches["phase 8b GBLUP"] = counts
    del g, ws, built, out
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 9

# phase 9a's model: G of the ID and dam terms (per level; the truth's
# polygenic share is carried by the markers, the dam's by its maternal
# effect of variance 0.1) and of the herd; the genomic values are scaled to
# variance 1 and the residual has variance 1
PHASE9A_G = [[0.5, 0.0], [0.0, 0.1]]
PHASE9A_EQ = "y = intercept + age + herd + ID + dam + geno"
# phase 9c: the card's EBV accuracy within this of the CPU chain's
ACC_MARGIN_9C = 0.05


def phase9_pedigree(n_founders, gen_sizes, seed):
    """A random multi-generation pedigree drawn as jwas_tpu/io/datasets.py::
    _drop_pedigree draws it (the males the first half of the previous
    generation, the females the second, each parent drawn uniformly among
    them), numpy only. Returns (ids "a1".., sire and dam indices, -1 for
    a founder's, the first row of each generation and the end)."""
    rng = np.random.default_rng(seed)
    n = n_founders + sum(gen_sizes)
    sire = np.full(n, -1, dtype=np.int64)
    dam = np.full(n, -1, dtype=np.int64)
    starts, prev, row = [0, n_founders], np.arange(n_founders), n_founders
    for size in gen_sizes:
        half = len(prev) // 2
        sire[row:row + size] = prev[:half][rng.integers(0, half, size)]
        dam[row:row + size] = prev[half:][rng.integers(0, len(prev) - half, size)]
        prev, row = np.arange(row, row + size), row + size
        starts.append(row)
    ids = np.array([f"a{i + 1}" for i in range(n)], dtype=object)
    return ids, sire, dam, starts


def pedigree_table(ids, sire, dam):
    """The pedigree as get_pedigree reads it: ID, Sire, Dam, "0" unknown."""
    from jwas_tpu_torch.io.table import Table

    def parent(idx):
        return np.array([ids[i] if i >= 0 else "0" for i in idx], dtype=object)

    return Table({"ID": ids, "Sire": parent(sire), "Dam": parent(dam)})


def phase9a_design(seed=90, n_founders=900, gen_size=1_500, n_cand=1_000):
    """Phase 9a's pedigree (900 founders and 6 generations of 1,500) and
    records: the last five generations (7,500) genotyped, 1,000 of the
    last generation candidates, the other 6,500 phenotyped, each with a
    herd of 100, an age and its dam. Returns (the pedigree Table, a dict
    with the records' Table (no y yet), the pedigree's indices, the first
    genotyped row, the phenotyped and candidate rows, herds and ages)."""
    from jwas_tpu_torch.io.table import Table

    ids, sire, dam, starts = phase9_pedigree(n_founders, (gen_size,) * 6, seed)
    rng = np.random.default_rng(seed + 1)
    n, keep_from = len(ids), starts[2]
    cand = np.sort(rng.choice(np.arange(starts[-2], n), n_cand, replace=False))
    pheno = rng.permutation(np.setdiff1d(np.arange(keep_from, n), cand))
    herd = rng.integers(1, 101, n)
    age = np.round(rng.uniform(1.0, 5.0, n), 2)
    table = Table({"ID": ids[pheno],
                   "herd": np.array([f"h{h}" for h in herd[pheno]], dtype=object),
                   "age": age[pheno], "dam": ids[dam[pheno]]})
    return pedigree_table(ids, sire, dam), dict(
        table=table, ids=ids, sire=sire, dam=dam, starts=starts,
        keep_from=keep_from, pheno=pheno, cand=cand, herd=herd, age=age)


def gene_drop_store(sire, dam, starts, keep_from, p, dev, seed, chunk=65_536,
                    qtl_share=0.001):
    """Genotypes gene-dropped through a pedigree on the card, a chunk of
    markers at a time: founders Binomial(2, f), f ~ U(0.1, 0.9), every
    offspring one allele of each parent (Bernoulli(code / 2), unlinked
    loci). The animals from keep_from on are packed 2 bits a code,
    marker-major (a Packed2BitStore's bytes). Returns (packed, their
    marker means (float64, host), their genomic values (X - means) beta
    over qtl_share of the markers, beta ~ N(0, 1), host float64)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_all, n = len(sire), len(sire) - keep_from
    bpm = (n + 3) // 4
    s_t = torch.as_tensor(sire, device=dev)
    d_t = torch.as_tensor(dam, device=dev)
    packed = torch.empty((p, bpm), dtype=torch.uint8, device=dev)
    means = torch.empty(p, dtype=torch.float64, device=dev)
    tbv = torch.zeros(n, dtype=torch.float64, device=dev)
    for c0 in range(0, p, chunk):
        c = min(chunk, p - c0)
        f = 0.1 + 0.8 * torch.rand(c, generator=g, device=dev)
        X = torch.empty((n_all, c), dtype=torch.int8, device=dev)
        nf = starts[1]
        X[:nf] = ((torch.rand((nf, c), generator=g, device=dev) < f).to(torch.int8)
                  + (torch.rand((nf, c), generator=g, device=dev) < f).to(torch.int8))
        for r0, r1 in zip(starts[1:-1], starts[2:]):
            a_s, a_d = ((2.0 * torch.rand((r1 - r0, c), generator=g, device=dev)
                         < X[parent[r0:r1]]).to(torch.int8) for parent in (s_t, d_t))
            X[r0:r1] = a_s + a_d
        kept = X[keep_from:]
        m = kept.double().mean(dim=0)
        means[c0:c0 + c] = m
        beta = (torch.randn(c, generator=g, device=dev, dtype=torch.float64)
                * (torch.rand(c, generator=g, device=dev) < qtl_share))
        tbv += (kept.double() - m) @ beta
        codes = torch.zeros((c, 4 * bpm), dtype=torch.uint8, device=dev)
        codes[:, :n] = kept.T.to(torch.uint8)
        q = codes.view(c, bpm, 4)
        packed[c0:c0 + c] = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)
        del X, kept, codes, q
    return packed, means.cpu().numpy(), tbv.cpu().numpy()


def vc_sample_rows(folder, var):
    """The rows of a covariance sample file (header skipped) as arrays."""
    with open(os.path.join(folder, f"MCMC_samples_{var.replace(':', '.')}.txt")) as f:
        rows = [line.strip() for line in f if line.strip()]
    return [np.array([float(x) for x in r.split(",")]) for r in rows[1:]]


def phase9a(dev, p=2_097_152, **design):
    """Phase 9a; see the module's docstring. design: phase9a_design's
    sizes (a rehearsal's)."""
    import tempfile

    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine import mcmc as em
    from jwas_tpu_torch.io.packed import Packed2BitStore
    from jwas_tpu_torch.ops.grouped import resolve_blocks

    say(f"== phase 9a: the animal model beside the markers, P={p}")
    ped_cols, rec = phase9a_design(**design)
    t0 = time.perf_counter()
    ped = jt.get_pedigree(ped_cols)
    t_ped = time.perf_counter() - t0
    t0 = time.perf_counter()
    ped.a_inverse()
    t_ainv = time.perf_counter() - t0
    ids, keep_from, pheno, cand = rec["ids"], rec["keep_from"], rec["pheno"], rec["cand"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    packed, means, gv = gene_drop_store(rec["sire"], rec["dam"], rec["starts"],
                                        keep_from, p, dev, seed=92)
    torch.cuda.synchronize()
    t_drop = time.perf_counter() - t0
    n = len(ids) - keep_from
    store = Packed2BitStore(
        obs_ids=list(ids[keep_from:]), marker_ids=[f"m{j + 1}" for j in range(p)],
        packed=packed, means=means, allele_freq=means / 2.0, n_obs=n, n_markers=p,
        has_missing=False)
    say(f"pedigree of {len(ids)} ({ped.n} coded, max F {ped.inbreeding.max():.4f}): "
        f"get_pedigree {t_ped:.2f} s (inbreeding included), A^-1 {t_ainv:.2f} s; "
        f"{n} x {p} genotypes gene-dropped and packed on the card in {t_drop:.1f} s "
        f"({packed.numel() / 1e9:.2f} GB)")
    # the truth: genomic values of variance 1, a maternal effect of the dam
    # and a herd effect of variance 0.1 each, age, a residual of variance 1
    rng = np.random.default_rng(93)
    tbv = np.zeros(len(ids))
    tbv[keep_from:] = (gv - gv.mean()) / gv.std()
    maternal = rng.normal(0.0, 0.1 ** 0.5, len(ids))
    herd_eff = rng.normal(0.0, 0.1 ** 0.5, 101)
    y = (tbv + maternal[np.maximum(rec["dam"], 0)] + herd_eff[rec["herd"]]
         + 0.5 * rec["age"] + rng.normal(0.0, 1.0, len(ids)))
    table = rec["table"]
    table["y"] = y[pheno]
    b, _ = resolve_blocks(len(pheno), False, p, warn=False)
    seconds_model = {}

    def on_model(model):
        t0 = time.perf_counter()
        jt.set_random(model, "herd", 0.1)
        jt.set_random(model, "ID dam", ped, PHASE9A_G)
        seconds_model["set_random"] = time.perf_counter() - t0

    k6 = {}
    jt.reset_launches()
    with tempfile.TemporaryDirectory() as folder:
        with timed_calls(k6, "K6", em, "gibbs_pass_lambda"):
            out, seconds, built = run_phase5(
                store, table, eq=PHASE9A_EQ, on_model=on_model, device=dev,
                fast_blocks=False, chain_length=3 * b, output_samples_frequency=b,
                output_folder=folder)
        counts = {k.__name__: k.launches for k in jt.KERNELS}
        vc_id = vc_sample_rows(folder, "y:ID_y:dam_variances")
        vc_herd = vc_sample_rows(folder, "y:herd_variances")
        files = sorted(os.listdir(folder))
    peak = torch.cuda.max_memory_allocated(dev)
    ws, windows = built["workspace"], built["chain"][-1]
    gm = built["store and Grams"]
    K = ws.W.shape[1]
    say(f"K = {K} location levels; b={gm.grams.shape[1]}, "
        f"gb={gm.grams.shape[0] // gm.ngroups}, {gm.ngroups} groups; "
        f"{len(pheno)} phenotyped, {len(cand)} candidates")
    say("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                {**seconds_model, **seconds}.items())
        + "; windows (an outer iteration of " + str(b) + " sweeps each) "
        + ", ".join(f"{t:.3f}" for t in windows))
    say(f"K6: {counts[K6]} passes, {k6['K6'] / counts[K6] * 1e3:.2f} ms a pass, "
        f"{k6['K6'] / sum(windows):.2%} of the windows; peak device memory "
        f"{peak / 1e9:.2f} GB; launches {counts}; files {files}")
    del gm, built
    # the output IDs' EBVs: the pedigree terms' out_W sol plus X alpha
    sol = np.asarray(out["location parameters"].Estimate, dtype=np.float64)
    out_sol = np.zeros(len(ws.output_ids))
    for name in ws.prediction_terms:
        term = ws.model.term_dict[name]
        out_sol += ws.output_X[name] @ sol[term.start_pos:term.start_pos + term.n_levels]
    row = {s: i for i, s in enumerate(ws.output_ids)}
    ebv = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    check = [ids[i] for i in cand[:64]]
    direct = direct_ebv(packed, means, out["marker effects geno"].Estimate,
                        [row[s] for s in check]) + out_sol[[row[s] for s in check]]
    got = np.array([ebv[s] for s in check])
    err = float(np.abs(got - direct).max() / np.abs(direct).max())
    acc = float(np.corrcoef([ebv[ids[i]] for i in cand], tbv[cand])[0, 1])
    G = out["polygenic effects covariance matrix"].Estimate
    say(f"EBVs of 64 candidates against out_W sol + X alpha: max relative error "
        f"{err:.3g} (tolerance {RTOL_DIRECT_EBV}); EBV accuracy of the "
        f"candidates after 3 outer iterations {acc:.4f}; prediction terms "
        f"{ws.prediction_terms}; G(ID, dam) {np.round(G, 4).tolist()}, herd "
        f"{out['random effect variances y:herd'].Estimate[0]:.4g}, vare "
        f"{out['residual variance'].Estimate[0]:.4g}")
    pd_ok = all(np.isfinite(v).all() and np.linalg.eigvalsh(v.reshape(2, 2)).min() > 0
                for v in vc_id) and all(np.isfinite(v).all() and v[0] > 0 for v in vc_herd)
    if not (pd_ok and len(vc_id) == 3 and len(vc_herd) == 3):
        raise AssertionError(f"phase 9a: covariance samples {vc_id}, {vc_herd}")
    if not err <= RTOL_DIRECT_EBV or not np.isfinite(acc):
        raise AssertionError(f"phase 9a: EBVs off out_W sol + X alpha by {err:.3g}")
    K_want = 2 + len(set(table["herd"].tolist())) + 2 * len(ids)
    if K != K_want:
        raise AssertionError(f"phase 9a: K = {K}, not {K_want}")
    path = ("abc_inner_rounds", "packed_rhs", "packed_matvec", K6)
    if any(counts[k] == 0 for k in path):
        raise AssertionError(f"phase 9a: kernels never launched: {counts}")
    del packed, store, ws
    torch.cuda.empty_cache()
    return {k: counts[k] for k in path}


def phase9b(dev, n_iter=100, n_founders=1_800, gen_size=3_000, n_pheno=16_000):
    """Phase 9b; see the module's docstring."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.io.table import Table

    ids, sire, dam, starts = phase9_pedigree(n_founders, (gen_size,) * 6, seed=95)
    say(f"== phase 9b: pedigree BLUP without genotypes at K = {len(ids) + 102}")
    t0 = time.perf_counter()
    ped = jt.get_pedigree(pedigree_table(ids, sire, dam))
    t_ped = time.perf_counter() - t0
    # u ~ N(0, A) by the recursion: founders N(0, 1), then the parents'
    # mean plus Mendelian sampling of variance 1/2 - (F_s + F_d) / 4
    F = ped.inbreeding[[ped.id_index[s] for s in ids]]
    rng = np.random.default_rng(96)
    u = rng.normal(0.0, 1.0, len(ids))
    for r0, r1 in zip(starts[1:-1], starts[2:]):
        s, d = sire[r0:r1], dam[r0:r1]
        u[r0:r1] = (0.5 * (u[s] + u[d])
                    + np.sqrt(0.5 - 0.25 * (F[s] + F[d])) * u[r0:r1])
    pheno = rng.choice(np.arange(starts[1], len(ids)), n_pheno, replace=False)
    herd = rng.integers(1, 101, len(ids))
    age = np.round(rng.uniform(1.0, 5.0, len(ids)), 2)
    y = u + rng.normal(0.0, 1.0, 101)[herd] + 0.5 * age + rng.normal(0.0, 1.0, len(ids))
    table = Table({"ID": ids[pheno], "y": y[pheno], "herd": herd[pheno],
                   "age": age[pheno]})

    def on_model(model):
        jt.set_random(model, "ID", ped, 1.0)

    busy = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    jt.reset_launches()
    out, seconds, built = run_phase5(
        None, table, eq="y = intercept + age + herd + ID", on_model=on_model,
        around_chain=busy_shares(busy), device=dev, chain_length=n_iter,
        output_samples_frequency=10, output_folder="")
    peak = torch.cuda.max_memory_allocated(dev)
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    ws, windows = built["workspace"], built["chain"][-1]
    K = ws.W.shape[1]
    k6_s = sum(v for k, v in busy["by_kernel"].items() if "gibbs" in k)
    ms_iter = float(np.mean(windows[1:])) / 10 * 1e3
    ebv = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    unphen = np.setdiff1d(np.arange(len(ids)), pheno)
    acc = {who: float(np.corrcoef([ebv[ids[i]] for i in rows], u[rows])[0, 1])
           for who, rows in (("all", np.arange(len(ids))), ("unphenotyped", unphen))}
    say(f"K = {K}; {len(pheno)} phenotyped of {len(ids)}; get_pedigree {t_ped:.2f} s; "
        "seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + "; windows of 10 iterations " + ", ".join(f"{t:.4f}" for t in windows))
    say(f"{ms_iter:.2f} ms an iteration after the first window (profiled); busy "
        f"{busy['kernels']:.2%} of the chain's {busy['wall']:.2f} s, K6 "
        f"{k6_s / busy['wall']:.2%} ({k6_s / max(counts[K6], 1) * 1e3:.2f} ms a pass); "
        f"peak device memory {peak / 1e9:.2f} GB; launches {counts}")
    say("device ms an iteration by part: " + ", ".join(
        f"{k} {v:.3f}" for k, v in iteration_parts(busy, n_iter).items()))
    top = sorted(busy["by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    say("largest kernels, ms an iteration: " + "; ".join(
        f"{kernel_label(k)} {v / n_iter * 1e3:.3f}" for k, v in top))
    say(f"EBV accuracy against u: all {acc['all']:.4f}, unphenotyped "
        f"{acc['unphenotyped']:.4f}; sigma^2_u "
        f"{out['polygenic effects covariance matrix'].Estimate[0]:.4g}, vare "
        f"{out['residual variance'].Estimate[0]:.4g} (truth 1, 1)")
    values = [np.asarray(out[k].Estimate, dtype=np.float64) for k in
              ("residual variance", "polygenic effects covariance matrix",
               "location parameters")] + [np.asarray(out["EBV_y"].EBV, dtype=np.float64),
                                          np.array(list(acc.values()))]
    if not all(np.isfinite(v).all() for v in values):
        raise AssertionError("phase 9b: non-finite results")
    if K != len(ids) + 102 or counts[K6] != n_iter or len(ebv) != len(ids):
        raise AssertionError(f"phase 9b: K = {K}, {counts[K6]} K6 launches, "
                             f"{len(ebv)} EBVs")
    del built, ws
    torch.cuda.empty_cache()
    return {K6: counts[K6]}


def kernel_label(name):
    """A profiler kernel name cut to its function and, for PyTorch's
    elementwise and reduction kernels, the functors that say what they
    compute."""
    import re

    head = re.sub(r"^(void |std::enable_if<.*?>::type )", "",
                  name.replace("(anonymous namespace)::", "")).split("(")[0].split("<")[0]
    functors = sorted(set(re.findall(r"(\w+Functor\w*|\w+_kernel_cuda\w*)", name)))
    return head + (f" [{', '.join(functors)}]" if functors else "")


def iteration_parts(busy, n_iter):
    """A profiled chain's device milliseconds an iteration by part, from
    busy_shares' kernel and copy names: K6; the LHS assembly's copy of W'W
    (device-to-device copies) and other copies and memsets; matrix-vector
    and matrix products (cuBLAS gemv / gemm, the products with W);
    elementwise and reduction kernels (the Vinv adds among them); the
    rest."""
    parts = dict.fromkeys(("K6", "copies DtoD", "other copies", "gemv/gemm",
                           "elementwise", "reductions", "other kernels"), 0.0)
    for k, sec in busy["by_kernel"].items():
        name = k.lower()
        part = ("K6" if "gibbs" in name else
                "gemv/gemm" if "gemv" in name or "gemm" in name or "xmma" in name else
                "elementwise" if "elementwise" in name else
                "reductions" if "reduce" in name else "other kernels")
        parts[part] += sec
    for k, sec in busy["by_copy"].items():
        parts["copies DtoD" if "dtod" in k.lower() else "other copies"] += sec
    return {k: v / n_iter * 1e3 for k, v in parts.items()}


def phase9c(dev, p=2_000, n_iter=250):
    """Phase 9c; see the module's docstring."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.io.table import Table

    say("== phase 9c: statistical check of a pedigree-plus-genotype model")
    ids, sire, dam, starts = phase9_pedigree(100, (150,) * 6, seed=97)
    rng = np.random.default_rng(98)
    freqs = rng.uniform(0.1, 0.9, p)
    X = np.zeros((len(ids), p), dtype=np.int64)
    X[:starts[1]] = rng.binomial(2, freqs, (starts[1], p))
    for r0, r1 in zip(starts[1:-1], starts[2:]):
        X[r0:r1] = (rng.binomial(1, X[sire[r0:r1]] / 2.0)
                    + rng.binomial(1, X[dam[r0:r1]] / 2.0))
    keep_from = starts[3]                       # the last four generations: 600
    beta = np.zeros(p)
    qtl = rng.choice(p, 20, replace=False)
    beta[qtl] = rng.normal(size=20)
    Xk = X[keep_from:].astype(np.float64)
    gv = (Xk - Xk.mean(axis=0)) @ beta
    tbv = (gv - gv.mean()) / gv.std()
    cand = np.sort(rng.choice(np.arange(starts[-2], len(ids)), 100, replace=False))
    pheno = rng.permutation(np.setdiff1d(np.arange(keep_from, len(ids)), cand))
    herd = rng.integers(1, 21, len(ids))
    maternal = rng.normal(0.0, 0.1 ** 0.5, len(ids))
    y = np.zeros(len(ids))
    y[keep_from:] = tbv
    y += (maternal[np.maximum(dam, 0)] + rng.normal(0.0, 0.1 ** 0.5, 21)[herd]
          + rng.normal(0.0, 1.0, len(ids)))
    geno = Table({"ID": ids[keep_from:], **{f"m{j + 1}": X[keep_from:, j] for j in range(p)}})
    table = Table({"ID": ids[pheno], "y": y[pheno], "herd": herd[pheno],
                   "dam": ids[dam[pheno]]})
    ped = jt.get_pedigree(pedigree_table(ids, sire, dam))
    res = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        jt.reset_launches()
        # pi starts at 0.99: from 0 (every marker in) the blocked chain
        # at p = 2,000 over 500 records diverges after some hundred sweeps
        # on this data, with or without the random effects (the CPU's plain
        # versions as well)
        model = jt.build_model("y = intercept + herd + ID + dam + geno",
                               genotypes=jt.get_genotypes(geno, method="BayesC",
                                                          Pi=0.99, storage="2bit"))
        jt.set_random(model, "herd", 0.1)
        jt.set_random(model, "ID dam", ped, PHASE9A_G)
        t0 = time.perf_counter()
        out = jt.runMCMC(model, table, device=where, chain_length=n_iter,
                         burnin=n_iter // 5,
                         fast_blocks=8, seed=5, output_folder="",
                         printout_model_info=False)
        ebv = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
        res[label] = dict(
            seconds=time.perf_counter() - t0,
            acc=float(np.corrcoef([ebv[s] for s in ids[keep_from:]], tbv)[0, 1]),
            acc_cand=float(np.corrcoef([ebv[ids[i]] for i in cand],
                                       tbv[cand - keep_from])[0, 1]),
            G=np.round(out["polygenic effects covariance matrix"].Estimate, 4).tolist(),
            herd=float(out["random effect variances y:herd"].Estimate[0]),
            vare=float(out["residual variance"].Estimate[0]),
            launches={k.__name__: k.launches for k in jt.KERNELS})
    for where, r in res.items():
        say(f"{where}: EBV accuracy of the {len(ids) - keep_from} genotyped "
            f"{r['acc']:.4f} (candidates {r['acc_cand']:.4f}); posterior means "
            f"G(ID, dam) {r['G']}, herd {r['herd']:.4g}, vare {r['vare']:.4g} "
            f"({r['seconds']:.1f} s); launches {r['launches']}")
    card, cpu = res["card"], res["cpu"]
    if not (np.isfinite([card["acc"], cpu["acc"]]).all()
            and card["acc"] >= cpu["acc"] - ACC_MARGIN_9C):
        raise AssertionError(f"phase 9c: card accuracy {card['acc']:.4f} vs CPU "
                             f"{cpu['acc']:.4f} (margin {ACC_MARGIN_9C})")
    path = ("abc_inner_rounds", "packed_rhs", "packed_matvec", K6)
    if any(card["launches"][k] == 0 for k in path):
        raise AssertionError(f"phase 9c: kernels never launched: {card['launches']}")
    return {k: card["launches"][k] for k in path}


# ---------------------------------------------------------------- phase 10

MT_H2 = (0.5, 0.4, 0.3)       # phase 10's traits: heritabilities,
MT_RG, MT_RE = 0.5, 0.2       # genetic and residual correlations,
MT_MISSING = 0.1              # share of each trait's records missing
ACC_MARGIN_10E = 0.05         # card accuracy may trail the CPU's by this


def mt_truth(X, seed, t=3, qtl_share=0.001):
    """(n, t) true breeding values X' B of a dense store X (p, n): QTL on
    qtl_share of the markers with effects of correlation MT_RG (torch, on
    the store's device)."""
    p = X.shape[0]
    g = torch.Generator(device=X.device)
    g.manual_seed(seed)
    qtl = torch.rand(p, generator=g, device=X.device) < qtl_share
    C = torch.full((t, t), MT_RG, dtype=torch.float64) + (1 - MT_RG) * torch.eye(t, dtype=torch.float64)
    eff = torch.randn((p, t), generator=g, device=X.device, dtype=torch.float64)
    eff = (eff @ torch.linalg.cholesky(C).to(X.device).T) * qtl[:, None]
    return (X.T @ eff.to(X.dtype)).double().cpu().numpy()


def mt_table(obs_ids, tbv, seed, n_train, n_herds=100, missing=MT_MISSING,
             covariate=True, re=MT_RE):
    """Phenotypes of t traits on individuals obs_ids with true breeding
    values tbv (n, t): heritabilities MT_H2, residual correlation re, a
    herd factor and an age covariate (covariate), each trait's records
    missing with probability `missing` independently (a row keeps at least
    one), n_train individuals in shuffled order. Returns (table, training
    IDs, candidate IDs)."""
    from jwas_tpu_torch.io.table import Table

    n, t = tbv.shape
    rng = np.random.default_rng(seed)
    var_g = tbv.var(axis=0)
    h2 = np.resize(np.asarray(MT_H2), t)
    sd_e = np.sqrt(var_g * (1 - h2) / h2)
    Re = re * np.outer(sd_e, sd_e)
    np.fill_diagonal(Re, sd_e ** 2)
    herd = rng.integers(1, n_herds + 1, n)
    herd_effect = rng.normal(0.0, 1.0, (n_herds, t)) * np.sqrt(var_g)
    age = np.round(rng.uniform(1.0, 5.0, n), 2)
    y = tbv + herd_effect[herd - 1] + rng.multivariate_normal(np.zeros(t), Re, n)
    if covariate:
        y += 0.5 * age[:, None]
    miss = rng.uniform(size=(n, t)) < missing
    miss[miss.all(axis=1), 0] = False
    y[miss] = np.nan
    ids = np.array(obs_ids, dtype=object)
    order = rng.permutation(n)
    train, cand = order[:n_train], order[n_train:]
    cols = {"ID": ids[train], **{f"y{k + 1}": y[train, k] for k in range(t)},
            "herd": herd[train]}
    if covariate:
        cols["age"] = age[train]
    return Table(cols), list(ids[train]), list(ids[cand])


def run_mt(label, dev, geno, table, eq, kernels, on_model=None, lhs_times=False,
           model_kw=None, **kw):
    """runMCMC's multi-trait branch on phase 10's data, its set-up and chain
    timed inside it (the workspace, the store's blocks and Grams, the chain
    data, the chain; the results the rest). Prints seconds by part and a
    window, peak memory against store + Grams + PHASE7_MARGIN_BYTES (with a
    store), launches and, with lhs_times, the LHS assembly's device ms both
    ways. Raises where a check fails. Returns (results, launches of
    kernels (name, name_f64 for the float64 builds', name_pm for K7 / K8
    with a per-marker prior), the chain's cfg and data, windows). model_kw:
    build_model's keywords (categorical_trait, censored_trait)."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.mcmc_mt as em

    seconds, built = {}, {}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            built[name] = out
            return out
        return call

    names = ("prepare_workspace", "setup_dense_markers", "build_mt_data_and_states",
             "run_mt_chains")
    saved = {k: getattr(em, k) for k in names}
    for k, part in zip(names, ("workspace", "store and Grams",
                               "chain data (store and Grams included)", "chain")):
        setattr(em, k, timed(part, saved[k]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    jt.reset_launches()
    try:
        model = jt.build_model(eq, genotypes=geno, **(model_kw or {}))
        if "age" in table.columns:
            jt.set_covariate(model, "age")
        if on_model is not None:
            on_model(model)
        t0 = time.perf_counter()
        out = jt.runMCMC(model, table, device=dev, printout_model_info=False,
                         **dict(dict(seed=3), **kw))
        seconds["runMCMC"] = time.perf_counter() - t0
    finally:
        for k, fn in saved.items():
            setattr(em, k, fn)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    counts.update({k.__name__ + "_f64": k.launches_f64 for k in jt.KERNELS
                   if hasattr(k, "launches_f64")})
    counts.update({k.__name__ + "_pm": k.launches_pm for k in jt.KERNELS
                   if hasattr(k, "launches_pm")})
    cfg, data, _ = built["chain data (store and Grams included)"]
    windows = built["chain"][-1]
    # the chain data's set-up holds the store's blocks and Grams
    rest = seconds["runMCMC"] - sum(v for k, v in seconds.items()
                                    if k not in ("runMCMC", "store and Grams"))
    say(f"{label}: K = {data.W.shape[1]}, {cfg.n_obs} records, "
        f"{len(cfg.pattern_masks)} missing patterns, nreps {cfg.nreps}, sampler "
        f"{cfg.mt_sampler}{', mega-trait' if cfg.constraint else ''}")
    say("  seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; results {rest:.3f}; windows " + ", ".join(f"{t:.4f}" for t in windows))
    line = f"  peak device memory {peak / 1e9:.2f} GB"
    if geno is not None and geno.dense is not None:
        gm = data.gm
        store = gm.X.numel() * gm.X.element_size()
        grams = gm.grams.numel() * gm.grams.element_size()
        limit = store + grams + PHASE7_MARGIN_BYTES
        line += (f" (store {store / 1e9:.2f} + Grams {grams / 1e9:.3f} + "
                 f"{PHASE7_MARGIN_BYTES / 1e9:.0f} GB = {limit / 1e9:.2f} GB allowed)")
        if peak > limit:
            raise AssertionError(f"{label}: peak {peak / 1e9:.2f} GB > {limit / 1e9:.2f} GB")
        if gm.X.data_ptr() != geno.dense.data_ptr():
            raise AssertionError(f"{label}: runMCMC copied the dense store")
    say(line + f"; launches {counts}")
    if lhs_times:
        Ri = em.pattern_Ri(data.patterns, out_R(out, cfg.n_traits, dev, data.W.dtype))
        vc = tuple(torch.eye(len(g.starts), device=dev, dtype=data.W.dtype)
                   for g in cfg.re_groups)
        ms = {route: cuda_ms(lambda: (data.lhs.assemble if route == "pieces" else
                                      data.lhs.assemble_from_W)(Ri, cfg.re_groups,
                                                                data.Vinv, vc), 5)
              for route in (("pieces", "from W") if data.lhs.use_pieces else ("from W",))}
        say(f"  LHS assembly, device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
            + f" (pieces {data.lhs.piece_bytes / 1e9:.3f} GB"
            + f"{'' if data.lhs.use_pieces else ', over the budget: not kept'})")
    values = [np.asarray(v.Estimate, dtype=np.float64) for k, v in out.items()
              if not k.startswith("_") and "Estimate" in v.columns]
    if not all(np.isfinite(v).all() for v in values):
        raise AssertionError(f"{label}: non-finite results")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    return out, {k: counts[k] for k in kernels}, cfg, data, windows


def out_R(out, t, dev, dtype):
    """The posterior mean residual covariance of a result dict, (t, t)."""
    return torch.as_tensor(np.asarray(out["residual variance"].Estimate,
                                      dtype=np.float64).reshape(t, t),
                           dtype=dtype, device=dev)


def mt_accuracy(out, truth, ids, t=3):
    """EBV accuracy a trait of the individuals ids, truth {ID: (t,)}."""
    acc = []
    for k in range(t):
        ebv = dict(zip(out[f"EBV_y{k + 1}"].ID, out[f"EBV_y{k + 1}"].EBV))
        acc.append(float(np.corrcoef([ebv[s] for s in ids],
                                     [truth[s][k] for s in ids])[0, 1]))
    return acc


def phase10(dev, n=50_000, p=100_000, n_train=45_000, chain_length=512, every=256):
    """Multi-trait: (a) BayesC sampler I, (b) sampler II, (c) BayesB and the
    mega-trait BayesC on phase 7's store with 3 traits; see the module's
    docstring."""
    import tempfile

    import jwas_tpu_torch as jt

    say(f"== phase 10: multi-trait, 3 traits at N={n} x P={p}")
    launches = {}
    codes = dense_codes(n, p, 7, dev)
    t0 = time.perf_counter()
    geno = jt.get_genotypes(codes, method="BayesC", storage="f32", device=dev)
    torch.cuda.synchronize()
    del codes
    tbv = mt_truth(geno.dense, seed=10)
    table, train, cand = mt_table(geno.obs_ids, tbv, 10, n_train)
    truth = dict(zip(geno.obs_ids, tbv))
    say(f"phase 7's store again ({geno.dense.numel() * 4 / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s; {len(train)} phenotyped, "
        f"{len(cand)} candidates, {MT_MISSING:.0%} of each trait missing")
    eq = "\n".join(f"y{k} = intercept + herd + age + geno" for k in (1, 2, 3))
    runs = (("10a BayesC, sampler I", "BayesC", "I", False,
             ("mt_abc_inner_rounds_I", K6)),
            ("10b BayesC, sampler II", "BayesC", "II", False,
             ("mt_abc_inner_rounds_II", K6)),
            ("10c BayesB, sampler I", "BayesB", "I", False,
             ("mt_abc_inner_rounds_I", K6)),
            ("10c BayesC, mega-trait", "BayesC", "I", True, ("abc_inner_rounds", K6)))
    for label, method, sampler, constraint, kernels in runs:
        g = fresh(geno, method)
        g.multi_trait_sampler = sampler
        g.G.constraint = g.genetic_variance.constraint = constraint
        key = f"phase {label.split(' ')[0]}{' ' + method if label.startswith('10c') else ''}"
        key += " mega-trait" if constraint else ""
        with tempfile.TemporaryDirectory() as folder:
            out, launches[key], _, data, _ = run_mt(
                label, dev, g, table, eq, kernels, lhs_times=label.startswith("10a"),
                fast_blocks=True, chain_length=chain_length, output_samples_frequency=every,
                output_folder=folder if label.startswith("10a") else "")
            files = len(os.listdir(folder))
        acc = mt_accuracy(out, truth, cand)
        say(f"  candidates' EBV accuracy a trait {np.round(acc, 4).tolist()}; "
            f"R {np.round(np.asarray(out['residual variance'].Estimate), 4).tolist()}"
            + (f"; {files} result and sample files" if label.startswith("10a") else ""))
        if not np.isfinite(acc).all():
            raise AssertionError(f"{label}: non-finite accuracy")
        del data, g
    launches.update(phase11(dev, geno, truth, launches["phase 10a"][
        "mt_abc_inner_rounds_I"], n_train, chain_length, every))
    launches.update(phase12(dev, geno, tbv, n_train, chain_length, every))
    del geno
    torch.cuda.empty_cache()
    launches.update(phase12f(dev))
    launches["phase 10d"] = phase10d(dev)
    launches["phase 10e"] = phase10e(dev)
    launches["phase 11d"] = phase11d(dev, n, p)
    launches["phase 11e"] = phase11e(dev)
    return launches


def phase10d(dev, n_iter=20, n_founders=1_000, gen_size=1_000, n_gen=5, n_herds=100):
    """A 3-trait animal model yt = intercept + herd + ID with a pedigree and
    a 3 x 3 G at K = 3 (1 + herds + animals) ~ 18,300 (reduced in depth
    only: the pedigree's size, to K6's limit): n_iter iterations; ms an
    iteration by part (LHS assembly, K6, the rest), the LHS assembly both
    ways."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.mcmc_mt as em
    from jwas_tpu_torch.ops.location import MTLocationPieces

    ids, sire, dam, starts = phase9_pedigree(n_founders, (gen_size,) * n_gen, seed=100)
    ped = jt.get_pedigree(pedigree_table(ids, sire, dam))
    rng = np.random.default_rng(101)
    t = 3
    G = np.array([[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]])
    L = np.linalg.cholesky(G)
    u = rng.normal(size=(len(ids), t)) @ L.T
    for r0, r1 in zip(starts[1:-1], starts[2:]):
        u[r0:r1] = (0.5 * (u[sire[r0:r1]] + u[dam[r0:r1]])
                    + np.sqrt(0.5) * (rng.normal(size=(r1 - r0, t)) @ L.T))
    table, _, _ = mt_table(ids[n_founders:], u[n_founders:], 102, len(ids) - n_founders,
                           n_herds=n_herds, covariate=False)
    K = t * (1 + n_herds + len(ids))
    say(f"== phase 10d: 3-trait animal model, K = {K} ({len(ids)} animals, "
        f"{len(ids) - n_founders} phenotyped)")
    parts = {}
    with timed_calls(parts, "LHS assembly", MTLocationPieces, "assemble"), \
            timed_calls(parts, "K6", em, "gibbs_pass_general"):
        out, counts, cfg, data, windows = run_mt(
            "10d pedigree", dev, None, table,
            "\n".join(f"y{k} = intercept + herd + ID" for k in (1, 2, 3)), (K6,),
            on_model=lambda m: jt.set_random(m, "ID", ped, G),
            chain_length=n_iter, output_samples_frequency=n_iter // 2, output_folder="")
    if data.W.shape[1] != K or counts[K6] != n_iter:
        raise AssertionError(f"phase 10d: K = {data.W.shape[1]}, {counts[K6]} passes")
    total = sum(windows) / n_iter * 1e3
    per = {k: v / n_iter * 1e3 for k, v in parts.items()}
    per["rest"] = total - sum(per.values())
    say("  ms an iteration by part (host clock, synchronised): " + ", ".join(
        f"{k} {v:.3f}" for k, v in per.items()) + f"; total {total:.3f}")
    Ri = em.pattern_Ri(data.patterns, out_R(out, t, dev, data.W.dtype))
    vc = (torch.as_tensor(G, dtype=data.W.dtype, device=dev),)
    ms = {route: cuda_ms(lambda: (data.lhs.assemble if route == "pieces" else
                                  data.lhs.assemble_from_W)(Ri, cfg.re_groups, data.Vinv,
                                                            vc), 3)
          for route in (("pieces", "from W") if data.lhs.use_pieces else ("from W",))}
    say("  LHS assembly, device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" (pieces {data.lhs.piece_bytes / 1e9:.3f} GB)")
    truth = dict(zip(ids, u))
    acc = mt_accuracy(out, truth, list(ids))
    say(f"  EBV accuracy against u a trait {np.round(acc, 4).tolist()}; G "
        f"{np.round(np.asarray(out['polygenic effects covariance matrix'].Estimate), 3).tolist()}")
    del data
    torch.cuda.empty_cache()
    return counts


def phase10e(dev, n=2_000, p=2_000, n_iter=150):
    """A statistical check: 3 traits at n x p, n_iter sweeps at fast_blocks
    = 8 on the card and on the CPU (plain versions), the card's EBV
    accuracy within ACC_MARGIN_10E of the CPU's on each trait; then the
    float64 builds of K7 and K8 (double_precision), 64 sweeps each."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.io.table import Table

    say(f"== phase 10e: statistical check, 3 traits at n={n} x p={p}")
    rng = np.random.default_rng(103)
    X = rng.binomial(2, rng.uniform(0.1, 0.9, p), (n, p)).astype(np.float32)
    tbv = mt_truth(torch.as_tensor(X.T - X.mean(axis=0)[:, None]), seed=104, qtl_share=0.02)
    ids = np.array([f"i{k}" for k in range(n)], dtype=object)
    table, train, cand = mt_table(ids, tbv, 105, int(0.9 * n), n_herds=10)
    truth = dict(zip(ids, tbv))
    genotypes = Table({"ID": ids, **{f"m{j}": X[:, j] for j in range(p)}})
    eq = "\n".join(f"y{k} = intercept + herd + age + geno" for k in (1, 2, 3))
    res, launches = {}, {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        geno = jt.get_genotypes(genotypes, method="BayesC", storage="f32", device=d)
        t0 = time.perf_counter()
        jt.reset_launches()
        model = jt.build_model(eq, genotypes=geno)
        jt.set_covariate(model, "age")
        out = jt.runMCMC(model, table, device=d, chain_length=n_iter, burnin=n_iter // 5,
                         output_samples_frequency=8, fast_blocks=8, seed=5,
                         output_folder="", printout_model_info=False)
        launches[where] = {k.__name__: k.launches for k in jt.KERNELS}
        res[where] = (mt_accuracy(out, truth, list(ids)), time.perf_counter() - t0,
                      np.round(np.asarray(out["residual variance"].Estimate), 3).tolist())
    for where, (acc, sec, R) in res.items():
        say(f"{where}: EBV accuracy a trait {np.round(acc, 4).tolist()} ({sec:.1f} s); "
            f"R {R}")
    card, cpu = np.array(res["card"][0]), np.array(res["cpu"][0])
    if not (np.isfinite(card).all() and np.isfinite(cpu).all()
            and (card >= cpu - ACC_MARGIN_10E).all()):
        raise AssertionError(f"phase 10e: card accuracy {card} vs CPU {cpu} "
                             f"(margin {ACC_MARGIN_10E})")
    counts = {k: launches["card"][k] for k in ("mt_abc_inner_rounds_I", K6)}
    for sampler in ("I", "II"):
        geno = jt.get_genotypes(genotypes, method="BayesC", storage="f64", device=dev,
                                multi_trait_sampler=sampler)
        name = f"mt_abc_inner_rounds_{sampler}_f64"
        out, c, _, _, _ = run_mt(f"10e float64, sampler {sampler}", dev, geno, table, eq,
                              (name, K6 + "_f64"), chain_length=64,
                              output_samples_frequency=8, fast_blocks=8,
                              double_precision=True, output_folder="")
        counts.update(c)
    if any(v == 0 for v in counts.values()):
        raise AssertionError(f"phase 10e: kernels never launched: {counts}")
    return counts


# ---------------------------------------------------------------- phase 11

SEM_LAMBDA = (0.5, 0.3, -0.2)   # phase 11c's y1 -> y2, y1 -> y3, y2 -> y3
SEM_CAUSAL = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
ACC_MARGIN_11E = 0.05           # card accuracy may trail the CPU's by this
C0L = "mt_c0l_inner_rounds"     # K9


def sem_table(table):
    """Phase 11c's phenotypes: a table of 3 traits without missing records,
    u1..u3 (genetic, herd, age and residual), made recursive with the known
    SEM_LAMBDA: y1 = u1, y2 = l21 y1 + u2, y3 = l31 y1 + l32 y2 + u3."""
    from jwas_tpu_torch.io.table import Table

    l21, l31, l32 = SEM_LAMBDA
    y1 = np.asarray(table["y1"], dtype=np.float64)
    y2 = l21 * y1 + np.asarray(table["y2"], dtype=np.float64)
    y3 = l31 * y1 + l32 * y2 + np.asarray(table["y3"], dtype=np.float64)
    return Table({**{c: table[c] for c in table.columns}, "y1": y1, "y2": y2, "y3": y3})


def phase11(dev, geno, truth, k7_launches, n_train, chain_length, every):
    """Multi-trait RR-BLUP and BayesL (K9) and SEM on phase 10's store and
    design: (a) RR-BLUP with the prior update every 256 iterations, (b)
    BayesL, (c) SEM: BayesC sampler I (K7) with y1 -> y2, y1 -> y3,
    y2 -> y3 on phenotypes made recursive with SEM_LAMBDA and no missing
    record; see the module's docstring."""
    import tempfile

    import jwas_tpu_torch.engine.output_mt as om

    say(f"== phase 11: multi-trait RR-BLUP, BayesL (K9) and SEM at N={len(truth)} x "
        f"P={geno.n_markers}")
    launches = {}
    tbv = np.array([truth[s] for s in geno.obs_ids])
    table, _, cand = mt_table(geno.obs_ids, tbv, 10, n_train)
    eq = "\n".join(f"y{k} = intercept + herd + age + geno" for k in (1, 2, 3))
    for label, method in (("11a RR-BLUP, prior update every 256", "RR-BLUP"),
                          ("11b BayesL", "BayesL")):
        kw = dict(update_priors_frequency=256) if method == "RR-BLUP" else {}
        with tempfile.TemporaryDirectory() as folder:
            out, counts, _, data, _ = run_mt(
                label, dev, fresh(geno, method), table, eq, (C0L, K6), fast_blocks=True,
                chain_length=chain_length, output_samples_frequency=every,
                output_folder=folder if method == "RR-BLUP" else "", **kw)
        acc = mt_accuracy(out, truth, cand)
        say(f"  candidates' EBV accuracy a trait {np.round(acc, 4).tolist()}; K9 launches "
            f"{counts[C0L]} (K7 in 10a {k7_launches}); G "
            f"{np.round(np.asarray(out['marker effects variances geno'].Estimate), 6).tolist()}")
        if not np.isfinite(acc).all() or counts[C0L] != k7_launches:
            raise AssertionError(f"{label}: accuracy {acc}, {counts[C0L]} launches of K9")
        launches[f"phase 11{label[2]}"] = counts
        del data, out

    # (c) SEM: BayesC sampler I on the recursive phenotypes (SEM's lambda
    # is identified with independent residuals: the draw reads R's diagonal)
    table_s, _, cand_s = mt_table(geno.obs_ids, tbv, 11, n_train, missing=0.0, re=0.0)
    table_s = sem_table(table_s)
    g = fresh(geno, "BayesC")
    g.multi_trait_sampler = "I"
    parts = {}
    with timed_calls(parts, "SEM tables", om, "sem_tables"):
        out, counts, cfg, data, _ = run_mt(
            "11c SEM, BayesC sampler I", dev, g, table_s, eq,
            ("mt_abc_inner_rounds_I", K6), fast_blocks=True, chain_length=chain_length,
            output_samples_frequency=every, output_folder="", causal_structure=SEM_CAUSAL)
    sc = out["structural coefficients"]
    lam = np.asarray(sc.Estimate, dtype=np.float64)
    direct, indirect, overall = (np.asarray(out[k].Estimate, dtype=np.float64) for k in (
        "marker effects geno", "indirect marker effects geno", "overall marker effects geno"))
    err = float(np.abs(overall - (direct + indirect)).max() / np.abs(overall).max())
    acc = mt_accuracy(out, truth, cand_s)
    say(f"  lambda {dict(zip(sc.Edge, np.round(lam, 4).tolist()))} against the truth "
        f"{list(SEM_LAMBDA)}; overall = direct + indirect to {err:.3g} of the largest; "
        f"SEM tables {parts['SEM tables']:.3f} s at P = {cfg.n_markers}; candidates' EBV "
        f"accuracy a trait {np.round(acc, 4).tolist()}")
    if (cfg.sem_edges != ((1, 0), (2, 0), (2, 1)) or not np.isfinite(lam).all()
            or not err <= 1e-5 or not np.isfinite(acc).all()):
        raise AssertionError(f"phase 11c: edges {cfg.sem_edges}, lambda {lam}, {err}")
    launches["phase 11c"] = counts
    del data, out, g
    torch.cuda.empty_cache()
    return launches


def phase11d(dev, n, p, n_gblup=20_000, n_train=18_000, n_iter=200):
    """Multi-trait GBLUP on the first n_gblup individuals of phase 10's
    scores (their relationship matrix built on the card; reduced from N as
    phase 8b is: the float64 eigh), n_train phenotyped on 3 traits (10%
    of each missing), n_iter iterations: seconds of the matrix, the eigh and
    an iteration, accuracy."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.setup as es

    say(f"== phase 11d: multi-trait GBLUP, 3 traits at N={n_gblup} x P={p}")
    codes = dense_codes(n, p, 7, dev)[:n_gblup]
    t0 = time.perf_counter()
    g = jt.get_genotypes(codes, method="GBLUP", storage="f32", device=dev)
    torch.cuda.synchronize()
    t_grm = time.perf_counter() - t0
    X = codes.T.float()
    del codes
    tbv = mt_truth(X - X.mean(dim=1, keepdim=True), seed=10)
    del X
    torch.cuda.empty_cache()
    table, _, cand = mt_table(g.obs_ids, tbv, 12, n_train)
    truth = dict(zip(g.obs_ids, tbv))
    parts = {}
    with timed_calls(parts, "eigh", torch.linalg, "eigh"), \
            timed_calls(parts, "eigenbasis", es, "gblup_eigen"):
        out, counts, cfg, data, windows = run_mt(
            "11d GBLUP", dev, g, table,
            "\n".join(f"y{k} = intercept + herd + age + geno" for k in (1, 2, 3)), (K6,),
            chain_length=n_iter, output_samples_frequency=n_iter // 4, output_folder="")
    acc = mt_accuracy(out, truth, cand)
    say(f"  relationship matrix {t_grm:.3f} s, eigh {parts['eigh']:.3f} s, L and the "
        f"output map {parts['eigenbasis'] - parts['eigh']:.3f} s; "
        f"{np.mean(windows[1:]) / (n_iter // 4) * 1e3:.3f} ms an iteration after the "
        f"first window; L {tuple(data.gm.L.shape)}; candidates' EBV accuracy a trait "
        f"{np.round(acc, 4).tolist()}")
    if data.gm.L.shape != (n_train, n_train) or not np.isfinite(acc).all():
        raise AssertionError(f"phase 11d: L {tuple(data.gm.L.shape)}, accuracy {acc}")
    del g, data, out
    torch.cuda.empty_cache()
    return counts


def phase11e(dev, n=2_000, p=2_000, n_iter=150, n_f64=64):
    """A statistical check: 3 traits at n x p, multi-trait BayesL for
    n_iter sweeps at fast_blocks = 8 on the card (K9) and on the CPU (its
    plain version), the card's EBV accuracy within ACC_MARGIN_11E of the
    CPU's on each trait; then n_f64 sweeps of K9's float64 build
    (double_precision)."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.io.table import Table

    say(f"== phase 11e: statistical check, multi-trait BayesL at n={n} x p={p}")
    rng = np.random.default_rng(113)
    X = rng.binomial(2, rng.uniform(0.1, 0.9, p), (n, p)).astype(np.float32)
    tbv = mt_truth(torch.as_tensor(X.T - X.mean(axis=0)[:, None]), seed=114, qtl_share=0.02)
    ids = np.array([f"i{k}" for k in range(n)], dtype=object)
    table, train, cand = mt_table(ids, tbv, 115, int(0.9 * n), n_herds=10)
    truth = dict(zip(ids, tbv))
    genotypes = Table({"ID": ids, **{f"m{j}": X[:, j] for j in range(p)}})
    eq = "\n".join(f"y{k} = intercept + herd + age + geno" for k in (1, 2, 3))
    res, launches = {}, {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        geno = jt.get_genotypes(genotypes, method="BayesL", storage="f32", device=d)
        t0 = time.perf_counter()
        jt.reset_launches()
        model = jt.build_model(eq, genotypes=geno)
        jt.set_covariate(model, "age")
        out = jt.runMCMC(model, table, device=d, chain_length=n_iter, burnin=n_iter // 5,
                         output_samples_frequency=8, fast_blocks=8, seed=5,
                         output_folder="", printout_model_info=False)
        launches[where] = {k.__name__: k.launches for k in jt.KERNELS}
        res[where] = (mt_accuracy(out, truth, list(ids)), time.perf_counter() - t0,
                      np.round(np.asarray(out["residual variance"].Estimate), 3).tolist())
    for where, (acc, sec, R) in res.items():
        say(f"{where}: EBV accuracy a trait {np.round(acc, 4).tolist()} ({sec:.1f} s); "
            f"R {R}")
    card, cpu = np.array(res["card"][0]), np.array(res["cpu"][0])
    if not (np.isfinite(card).all() and np.isfinite(cpu).all()
            and (card >= cpu - ACC_MARGIN_11E).all()):
        raise AssertionError(f"phase 11e: card accuracy {card} vs CPU {cpu} "
                             f"(margin {ACC_MARGIN_11E})")
    counts = {k: launches["card"][k] for k in (C0L, K6)}
    geno = jt.get_genotypes(genotypes, method="BayesL", storage="f64", device=dev)
    _, c, _, _, _ = run_mt("11e float64, BayesL", dev, geno, table, eq, (C0L + "_f64",),
                           chain_length=n_f64, output_samples_frequency=8, fast_blocks=8,
                           double_precision=True, output_folder="")
    counts.update(c)
    if any(v == 0 for v in counts.values()):
        raise AssertionError(f"phase 11e: kernels never launched: {counts}")
    return counts


# ---------------------------------------------------------------- phase 12

PREVALENCE_12A = 0.2              # 12a's binary trait: the top 20% affected
CAT_QUANTILES = (0.3, 0.6, 0.85)  # 12b's 4 categories (tests/test_threshold_traits.py)
CENSORED_SHARE = 0.4              # 12b's censored trait: the top 40% right-censored
ANNO_SHARE = 0.2                  # 12c's first annotation marks 20% of the markers
PI_MT_ANNO = {(0.0, 0.0): 0.9, (1.0, 0.0): 0.03, (0.0, 1.0): 0.03, (1.0, 1.0): 0.04}
ACC_MARGIN_12F = 0.05             # card accuracy may trail the CPU's by this


def qtl_mask(p, seed, dev, share=0.001):
    """mt_truth's QTL (its generator's first draw): a (p,) bool numpy mask."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.rand(p, generator=g, device=dev) < share).cpu().numpy()


def anno_columns(qtl, seed, k=4, share=ANNO_SHARE):
    """(p, k) annotations: column 1 marks a random `share` of the markers
    that holds every QTL (tests/test_annotations.py:18-36), the others are
    random normals."""
    rng = np.random.default_rng(seed)
    p = len(qtl)
    first = qtl.astype(np.float64)
    extra = max(int(share * p) - int(qtl.sum()), 0)
    first[rng.choice(np.flatnonzero(~qtl), extra, replace=False)] = 1.0
    return np.column_stack([first, rng.normal(size=(p, k - 1))])


def latent_table(obs_ids, tbv, seed, n_train, kind, n_herds=100, h2=0.5):
    """A single trait's records on individuals obs_ids: the liability tbv +
    herd + 0.5 age + noise at heritability h2 (against the noise), then
    kind "binary" (the top PREVALENCE_12A coded 2, the rest 1),
    "categorical" (1..4 cut at the CAT_QUANTILES of the liability),
    "censored" (the top CENSORED_SHARE right-censored at its lower bound:
    columns y_l and y_u) or "continuous"; n_train individuals in shuffled
    order. Returns (table, training IDs, candidate IDs)."""
    from jwas_tpu_torch.io.table import Table

    n = len(obs_ids)
    ids = np.array(obs_ids, dtype=object)
    rng = np.random.default_rng(seed)
    sd = float(np.std(tbv))
    herd = rng.integers(1, n_herds + 1, n)
    age = np.round(rng.uniform(1.0, 5.0, n), 2)
    liab = (tbv + rng.normal(0.0, 0.3 * sd, n_herds)[herd - 1] + 0.1 * sd * age
            + rng.normal(0.0, sd * np.sqrt((1 - h2) / h2), n))
    cols = {}
    if kind == "binary":
        cols["y"] = 1 + (liab > np.quantile(liab, 1 - PREVALENCE_12A)).astype(np.int64)
    elif kind == "categorical":
        cols["y"] = 1 + np.searchsorted(np.quantile(liab, CAT_QUANTILES), liab)
    elif kind == "censored":
        cut = np.quantile(liab, 1 - CENSORED_SHARE)
        cols["y_l"] = np.where(liab > cut, cut, liab)
        cols["y_u"] = np.where(liab > cut, np.inf, liab)
    else:
        cols["y"] = liab
    order = rng.permutation(n)
    train, cand = order[:n_train], order[n_train:]
    table = Table({"ID": ids[train], **{k: v[train] for k, v in cols.items()},
                   "herd": herd[train], "age": age[train]})
    return table, list(ids[train]), list(ids[cand])


def latent_mt_table(table):
    """mt_table's 3 traits with y2 made binary (above its median) and y3
    ordered categorical (cut at the CAT_QUANTILES), missing records kept."""
    for name, cuts in (("y2", (0.5,)), ("y3", CAT_QUANTILES)):
        y = np.asarray(table[name], dtype=np.float64)
        seen = np.isfinite(y)
        table[name] = np.where(seen, 1 + np.searchsorted(np.quantile(y[seen], cuts), y),
                               np.nan)
    return table


class CallTimer:
    """For the duration of a with-block, owner.attr timed at each call:
    CUDA events around it on the current stream (device ms, including any
    gap in which the device waits for the host's launches), the host's
    seconds to issue it, and, of its second call, the device operations
    and the host's largest costs (torch.profiler); the times leave out the
    first two calls."""

    def __init__(self, owner, attr):
        self.owner, self.attr = owner, attr
        self.events, self.host, self.launches, self.calls = [], [], 0, 0
        self.top = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.fn = fn = getattr(self.owner, self.attr)

        def call(*a, **k):
            self.calls += 1
            if self.calls == 1:
                return fn(*a, **k)
            if self.calls == 2:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out = fn(*a, **k)
                    torch.cuda.synchronize()
                self.launches = sum(1 for e in prof.events()
                                    if e.device_type == torch.autograd.DeviceType.CUDA)
                host = [e for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CPU]
                self.top = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in
                            sorted(host, key=lambda e: e.self_cpu_time_total)[-4:][::-1]]
                return out
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            out = fn(*a, **k)
            e.record()
            self.host.append(time.perf_counter() - t0)
            self.events.append((s, e))
            return out

        setattr(self.owner, self.attr, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)

    def line(self, what):
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in self.events]
        if not ms:
            return f"{what}: not called"
        return (f"{what}: device {np.mean(ms):.4f} ms an iteration (events, {len(ms)} "
                f"iterations), host {np.mean(self.host) * 1e3:.4f} ms to issue, "
                f"{self.launches} device operations an iteration; host's largest "
                f"(profiled call, self ms, calls): "
                + ", ".join(f"{k} {v:.3f} x{c}" for k, v, c in self.top))


@contextlib.contextmanager
def latent_timers(mt=False, anno=None, korsgaard=False):
    """CallTimers of the latent step (engine/mcmc.py::latent_step or
    engine/mcmc_mt.py::mt_latent_step), the annotation update anno (a
    function name of ops/annotations.py) and Korsgaard's draw."""
    import jwas_tpu_torch.engine.mcmc as em
    import jwas_tpu_torch.engine.mcmc_mt as emt
    from jwas_tpu_torch.ops import annotations as an
    from jwas_tpu_torch.ops import variance as tv

    timers = {}
    with contextlib.ExitStack() as stack:
        timers["latent step"] = stack.enter_context(
            CallTimer(emt, "mt_latent_step") if mt else CallTimer(em, "latent_step"))
        if anno:
            timers["annotation update"] = stack.enter_context(CallTimer(an, anno))
        if korsgaard:
            timers["Korsgaard's R"] = stack.enter_context(
                CallTimer(tv, "sample_conditional_inv_wishart_korsgaard"))
        yield timers


def say_timers(timers, latent=True):
    for what, tm in timers.items():
        if what != "latent step" or latent:
            say("  " + tm.line(what))


def slope_line(out, label, steps=False):
    """The first annotation's posterior slope (step 1's with steps), which
    must be above 0: that column marks the markers holding every QTL."""
    c = out["annotation coefficients geno"]
    rows = np.asarray(c.Annotation) == "Annotation_1"
    if steps:
        rows &= np.asarray(c.Step) == 1
    slope = float(np.asarray(c.Estimate, dtype=np.float64)[rows][0])
    say(f"  {label}: the first annotation's slope {slope:.4f}; pi "
        f"{np.round(np.atleast_1d(np.asarray(out['pi_geno'].Estimate, dtype=np.float64)), 5).tolist()}")
    if not slope > 0:
        raise AssertionError(f"{label}: the first annotation's slope {slope} is not above 0")
    return slope


def phase12(dev, geno, tbv, n_train, chain_length, every):
    """Latent traits and annotations on phase 10's store and truth; see the
    module's docstring."""
    import dataclasses

    say(f"== phase 12: latent traits and annotations at N={geno.dense.shape[1]} x "
        f"P={geno.dense.shape[0]}")
    launches = {}
    tbv1 = tbv[:, 0]
    abc, br = ("abc_inner_rounds", K6), ("bayesr_inner_rounds", K6)
    kw = dict(fast_blocks=True, chain_length=chain_length, output_samples_frequency=every,
              heterogeneous_residuals=False)
    st = (("12a binary BayesC", "binary"), ("12b 4-category BayesC", "categorical"),
          ("12b censored BayesC", "censored"))
    for label, kind in st:
        table, train, cand = latent_table(geno.obs_ids, tbv1, 120, n_train, kind)
        keep = {}
        model_kw = (dict(censored_trait=["y"]) if kind == "censored"
                    else dict(categorical_trait=["y"]))
        with latent_timers() as timers:
            _, launches[f"phase {label.split()[0]} {kind}"] = run_dense(
                label, dev, fresh(geno, "BayesC"), table, tbv1, train, cand, abc,
                keep=keep, model_kw=model_kw, **kw)
        say_timers(timers)
        vare = float(np.asarray(keep["out"]["residual variance"].Estimate)[0])
        say(f"  posterior mean of vare {vare!r}")
        if kind != "censored" and vare != 1.0:
            raise AssertionError(f"{label}: a categorical trait's vare {vare} is not 1")
    # 12c: annotations on the markers, the first marking 20% holding every QTL
    A = anno_columns(qtl_mask(geno.dense.shape[0], 10, dev), 121)
    table, train, cand = latent_table(geno.obs_ids, tbv1, 122, n_train, "continuous")
    for label, method, anno in (("12c annotated BayesC", "BayesC", "anno_bayesc_update"),
                                ("12c annotated BayesR", "BayesR", "anno_bayesr_update")):
        g = dataclasses.replace(fresh(geno, method), annotations=A, estimate_pi=True)
        if method == "BayesC":
            g.pi = 0.9
        keep = {}
        with latent_timers(anno=anno) as timers:
            _, launches[f"phase {label}"] = run_dense(
                label, dev, g, table, tbv1, train, cand,
                abc if method == "BayesC" else br, keep=keep, **kw)
        say_timers(timers, latent=False)
        slope_line(keep["out"], label, steps=method == "BayesR")
    # 12d: 2-trait annotated BayesC, samplers I and II with a per-marker prior
    table2, _, cand2 = mt_table(geno.obs_ids, tbv[:, :2], 123, n_train)
    truth2 = dict(zip(geno.obs_ids, tbv[:, :2]))
    eq2 = "\n".join(f"y{k} = intercept + herd + age + geno" for k in (1, 2))
    for sampler in ("I", "II"):
        name = f"mt_abc_inner_rounds_{sampler}"
        g = dataclasses.replace(fresh(geno, "BayesC"), annotations=A, estimate_pi=True,
                                pi=dict(PI_MT_ANNO), multi_trait_sampler=sampler)
        label = f"12d 2-trait annotated BayesC, sampler {sampler}"
        with latent_timers(anno="anno_bayesc_mt_update") as timers:
            out, launches[f"phase 12d {sampler}"], _, _, _ = run_mt(
                label, dev, g, table2, eq2, (name, name + "_pm", K6), output_folder="",
                **{k: v for k, v in kw.items() if k != "heterogeneous_residuals"})
        say_timers(timers, latent=False)
        say(f"  candidates' EBV accuracy a trait "
            f"{np.round(mt_accuracy(out, truth2, cand2, t=2), 4).tolist()}")
        slope_line(out, label, steps=True)
    # 12e: 3 traits, one continuous, one binary, one 4-category
    table3, _, cand3 = mt_table(geno.obs_ids, tbv, 124, n_train)
    table3 = latent_mt_table(table3)
    truth3 = dict(zip(geno.obs_ids, tbv))
    eq3 = "\n".join(f"y{k} = intercept + herd + age + geno" for k in (1, 2, 3))
    with latent_timers(mt=True, korsgaard=True) as timers:
        out, launches["phase 12e"], _, _, _ = run_mt(
            "12e 3-trait BayesC, continuous + binary + 4-category, sampler I", dev,
            fresh(geno, "BayesC"), table3, eq3, ("mt_abc_inner_rounds_I", K6),
            model_kw=dict(categorical_trait=["y2", "y3"]), output_folder="",
            **{k: v for k, v in kw.items() if k != "heterogeneous_residuals"})
    say_timers(timers)
    R = np.asarray(out["residual variance"].Estimate, dtype=np.float64).reshape(3, 3)
    say(f"  candidates' EBV accuracy a trait "
        f"{np.round(mt_accuracy(out, truth3, cand3), 4).tolist()}; R "
        f"{np.round(R, 4).tolist()}; R_bb {R[1, 1]!r}")
    if abs(R[1, 1] - 1.0) > 1e-5:
        raise AssertionError(f"12e: the binary trait's R_bb {R[1, 1]} is not 1")
    return launches


def phase12f(dev, n=2_000, p=2_000, n_iter=150, n_f64=64):
    """A statistical check of phase 12's models at n x p: 12a's binary
    BayesC, 12c's annotated BayesC, 12d's 2-trait annotated BayesC
    (sampler I) and 12e's 3-trait model, n_iter sweeps at fast_blocks = 8
    on the card and on the CPU (plain versions), the card's EBV accuracy
    within ACC_MARGIN_12F of the CPU's on each trait; then n_f64 sweeps of
    12d's model with double_precision, samplers I and II (the float64
    builds of K7 and K8 with a per-marker prior)."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.io.table import Table

    say(f"== phase 12f: statistical check of phase 12's models at n={n} x p={p}")
    rng = np.random.default_rng(125)
    X = rng.binomial(2, rng.uniform(0.1, 0.9, p), (n, p)).astype(np.float32)
    Xc = torch.as_tensor(X.T - X.mean(axis=0)[:, None])
    tbv = mt_truth(Xc, seed=126, qtl_share=0.02)
    A = anno_columns(qtl_mask(p, 126, torch.device("cpu"), 0.02), 127)
    ids = np.array([f"i{k}" for k in range(n)], dtype=object)
    genotypes = Table({"ID": ids, **{f"m{j}": X[:, j] for j in range(p)}})
    binary, _, _ = latent_table(ids, tbv[:, 0], 128, int(0.9 * n), "binary", n_herds=10)
    cont, _, _ = latent_table(ids, tbv[:, 0], 129, int(0.9 * n), "continuous", n_herds=10)
    two, _, _ = mt_table(ids, tbv[:, :2], 130, int(0.9 * n), n_herds=10)
    three = latent_mt_table(mt_table(ids, tbv, 131, int(0.9 * n), n_herds=10)[0])
    eq = lambda t: "\n".join(f"y{k} = intercept + herd + age + geno"  # noqa: E731
                             for k in range(1, t + 1)) if t > 1 else \
        "y = intercept + herd + age + geno"
    # each model's card run must launch its marker kernel: K1, K7 with a
    # per-marker prior, K7 with the global one
    models = (("12a binary BayesC", binary, 1, {}, dict(categorical_trait=["y"]),
               "abc_inner_rounds"),
              ("12c annotated BayesC", cont, 1, dict(annotations=A, Pi=0.9), {},
               "abc_inner_rounds"),
              ("12d annotated 2-trait BayesC, sampler I", two, 2,
               dict(annotations=A, Pi=dict(PI_MT_ANNO)), {}, "mt_abc_inner_rounds_I_pm"),
              ("12e 3 traits, binary and 4-category", three, 3, {},
               dict(categorical_trait=["y2", "y3"]), "mt_abc_inner_rounds_I"))
    counts = {}
    for label, table, t, gkw, mkw, kernel in models:
        res = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            geno = jt.get_genotypes(genotypes, method="BayesC", storage="f32", device=d,
                                    **gkw)
            t0 = time.perf_counter()
            jt.reset_launches()
            model = jt.build_model(eq(t), genotypes=geno, **mkw)
            jt.set_covariate(model, "age")
            out = jt.runMCMC(model, table, device=d, chain_length=n_iter,
                             burnin=n_iter // 5, output_samples_frequency=8, fast_blocks=8,
                             seed=5, output_folder="", printout_model_info=False)
            if where == "card":
                run = {k.__name__: k.launches for k in jt.KERNELS}
                run.update({k.__name__ + "_pm": k.launches_pm for k in jt.KERNELS
                            if hasattr(k, "launches_pm")})
                if not run.get(kernel) or not run.get(K6):
                    raise AssertionError(f"phase 12f {label}: the card run launched "
                                         f"{kernel} {run.get(kernel)} and {K6} "
                                         f"{run.get(K6)} times")
                for k, v in run.items():
                    counts[k] = counts.get(k, 0) + v
            truth = dict(zip(ids, tbv[:, :t]))
            acc = ([float(np.corrcoef(np.asarray(out["EBV_y"].EBV, dtype=np.float64),
                                      [truth[s][0] for s in out["EBV_y"].ID])[0, 1])]
                   if t == 1 else mt_accuracy(out, truth, list(ids), t=t))
            res[where] = (np.array(acc), time.perf_counter() - t0)
        say(f"{label}: " + "; ".join(f"{w} EBV accuracy a trait "
                                     f"{np.round(a, 4).tolist()} ({sec:.1f} s)"
                                     for w, (a, sec) in res.items()))
        card, cpu = res["card"][0], res["cpu"][0]
        if not (np.isfinite(card).all() and np.isfinite(cpu).all()
                and (card >= cpu - ACC_MARGIN_12F).all()):
            raise AssertionError(f"phase 12f {label}: card accuracy {card} vs CPU {cpu} "
                                 f"(margin {ACC_MARGIN_12F})")
    for sampler in ("I", "II"):
        name = f"mt_abc_inner_rounds_{sampler}_f64"
        geno = jt.get_genotypes(genotypes, method="BayesC", storage="f64", device=dev,
                                annotations=A, Pi=dict(PI_MT_ANNO),
                                multi_trait_sampler=sampler)
        _, c, _, _, _ = run_mt(f"12f float64, annotated 2-trait BayesC, sampler {sampler}",
                               dev, geno, two, eq(2),
                               (name, f"mt_abc_inner_rounds_{sampler}_pm", K6 + "_f64"),
                               chain_length=n_f64, output_samples_frequency=8,
                               fast_blocks=8, double_precision=True, output_folder="")
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return {"phase 12f": counts}


# ---------------------------------------------------------------- phase 13

ACC_FLOOR_13A = 0.55      # tests/test_sparse_mme.py::test_solve_sparse_100k_levels
AGREE_13A = 0.999         # its bound on CG's BLUPs against Jacobi's
ACC_FLOOR_13B = 0.3       # tests/integration/test_ssbr_scale.py's bound
IMPUTE_RESIDUAL_13B = 1e-6
ACC_MARGIN_13C = 0.05     # card accuracy may trail the CPU's by this


def ssbr_pedigree(n, gen, seed):
    """tests/integration/test_ssbr_scale.py:41-52's generational pedigree:
    the first gen animals founders, animal k's parents drawn uniformly from
    k - 2 gen .. k - 2 (the two generations before). Returns (ids, sire,
    dam), -1 for an unknown parent."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    lo, hi = np.maximum(k - 2 * gen, 0), np.maximum(k - 1, 1)
    anc = np.stack([rng.integers(lo, hi), rng.integers(lo, hi)])
    founder = k < gen
    ids = np.array([f"a{i}" for i in range(n)], dtype=object)
    return ids, np.where(founder, -1, anc[0]), np.where(founder, -1, anc[1])


def polygenic_values(ped, ids, seed):
    """u ~ N(0, A) through the exact factor, u = hAi^-1 z (hAi lower
    triangular in the pedigree's order), scaled to sd 1; in ids' order."""
    from scipy.sparse.linalg import spsolve_triangular

    z = np.random.default_rng(seed).normal(size=len(ids))
    u = spsolve_triangular(ped.a_inverse_factor().tocsr(), z, lower=True)
    u = u / u.std()
    return u[[ped.id_index[s] for s in ids]]


def ssbr_problem(dev, ped, ids, u, n_geno, p, n_pheno_geno, n_pheno_nongeno,
                 n_qtl=50, n_herds=100, seed=133, two_traits=False):
    """13b's data on a pedigree (ids in order, u its polygenic values):
    the youngest n_geno animals genotyped, Binomial(2, f) at p markers on
    the device, n_qtl QTL with N(0, 1) effects; breeding values 0.6 u plus
    the genotyped animals' marker value (sd 1), as the gated test makes
    them; n_pheno_geno genotyped (the older ones) and the last
    n_pheno_nongeno non-genotyped phenotyped, y = herd + bv + noise of bv's
    variance (h2 0.5), 100 herds; the other genotyped animals are the
    candidates. two_traits: y2 = 0.8 bv + noise of 0.9 bv's sd. Returns a
    dict: the Genotypes' codes (n_geno, p) int8, the genotyped IDs, the
    Table, truth (ID -> bv), the candidates, the non-genotyped phenotyped
    IDs and the phenotypes' variance."""
    from jwas_tpu_torch.io.table import Table

    n = len(ids)
    codes = dense_codes(n_geno, p, seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    qtl = torch.randperm(p, generator=g, device=dev)[:n_qtl]
    beta = torch.zeros(p, device=dev)
    beta[qtl] = torch.randn(n_qtl, generator=g, device=dev)
    Xq = codes[:, qtl].to(torch.float64)
    gv = ((Xq - Xq.mean(0)) @ beta[qtl].double()).cpu().numpy()
    gv = (gv - gv.mean()) / gv.std()
    bv = 0.6 * u
    bv[n - n_geno:] += gv
    rng = np.random.default_rng(seed + 2)
    geno_rows = np.arange(n - n_geno, n)
    pheno = np.concatenate([np.arange(n - n_geno - n_pheno_nongeno, n - n_geno),
                            geno_rows[:n_pheno_geno]])
    cand = geno_rows[n_pheno_geno:]
    sd = float(np.std(bv[pheno]))
    herd = rng.integers(1, n_herds + 1, n)
    y = rng.normal(0.0, 0.5 * sd, n_herds + 1)[herd] + bv + rng.normal(0.0, sd, n)
    cols = {"ID": ids[pheno], "y1" if two_traits else "y": y[pheno],
            "herd": np.array([f"h{h}" for h in herd[pheno]], dtype=object)}
    if two_traits:
        cols["y2"] = 0.8 * bv[pheno] + rng.normal(0.0, 0.9 * sd, len(pheno))
    return dict(codes=codes, geno_ids=list(ids[geno_rows]), table=Table(cols),
                truth=dict(zip(ids, bv)), cand=list(ids[cand]),
                nongeno_pheno=list(ids[pheno[:n_pheno_nongeno]]),
                var_y=float(np.var(y[pheno], ddof=1)))


def ssbr_genotypes(prob, dev, two_traits=False, fixed_pi=False):
    """get_genotypes on the problem's codes, written to dev, named by the
    genotyped animals' IDs; the genetic variance 0.3 var(y) as the gated
    test gives it (two traits: runMCMC's default). pi starts at 0.99 (the
    2-trait pattern prior: 0.99 on none), as phase 9c's does: most
    phenotyped rows are imputed conditional means of the genotyped ones,
    so the store holds far fewer independent rows than records, while the
    blocked schedule's stale set is capped by the records (0.4 n); at
    13b's shape the blocked chain diverged from pi = 0 and from 0.99 on
    the card, so 13b runs the exact sweep, as the gated test does. fixed_pi: pi held at 0.98 (the pattern prior 0.97 on none, 0.02
    on both), estimatePi off, for 13c's blocked chains: with pi estimated
    they diverged on the CPU as well once pi fell below ~0.92 (p = 2,000
    over 700 genotyped records)."""
    import jwas_tpu_torch as jt

    codes = prob["codes"] if dev.type == "cuda" else prob["codes"].cpu()
    if two_traits:
        pi = ({(0.0, 0.0): 0.97, (1.0, 0.0): 0.005, (0.0, 1.0): 0.005, (1.0, 1.0): 0.02}
              if fixed_pi else
              {(0.0, 0.0): 0.99, (1.0, 0.0): 0.0025, (0.0, 1.0): 0.0025, (1.0, 1.0): 0.005})
    else:
        pi = 0.98 if fixed_pi else 0.99
    geno = jt.get_genotypes(codes, None if two_traits else prob["var_y"] * 0.3,
                            method="BayesC", Pi=pi, estimatePi=not fixed_pi, device=dev,
                            G_is_marker_variance=False)
    geno.obs_ids = list(prob["geno_ids"])
    return geno


def accuracy(ebv_table, truth, ids, col="EBV"):
    ebv = dict(zip(ebv_table.ID, np.asarray(getattr(ebv_table, col), dtype=np.float64)))
    return float(np.corrcoef([ebv[s] for s in ids], [truth[s] for s in ids])[0, 1])


def po_cg_bound_ms(sl):
    """The byte bound of one PO-CG iteration on the sparse path: the CSR
    arrays of W, W' and each group's Vinv read once, and 8 vectors of K
    (x, r, p, the preconditioner and the free mask read; x, r, p written)
    and 2 of n."""
    from jwas_tpu_torch.ops.sparse_mme import csr_bytes

    item = sl.free.element_size()
    nbytes = (csr_bytes(sl.W) + csr_bytes(sl.Wt) + sum(csr_bytes(g.V) for g in sl.groups)
              + 8 * sl.n_loc * item + 2 * sl.n_obs * item)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


@contextlib.contextmanager
def capture_chain_data(store):
    """engine.mcmc._build_st_data_and_states wrapped so that store["ws"] and
    store["data"] hold the chain's workspace and STData."""
    import jwas_tpu_torch.engine.mcmc as em

    fn = em._build_st_data_and_states

    def call(*a, **k):
        store["ws"] = a[0]
        out = fn(*a, **k)
        store["data"] = out[1]
        return out

    em._build_st_data_and_states = call
    try:
        yield
    finally:
        em._build_st_data_and_states = fn


def phase13a(dev, ped, ids, u, n_pheno=30_000, chain_length=96, every=32):
    """Phase 13a; see the module's docstring."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.mcmc as em
    from jwas_tpu_torch.engine.solve import solve
    from jwas_tpu_torch.io.table import Table

    say(f"== phase 13a: the sparse location path at {len(ids) + 1} levels")
    rng = np.random.default_rng(134)
    obs = rng.choice(len(ids), n_pheno, replace=False)
    table = Table({"ID": ids[obs], "y": 5.0 + u[obs] + rng.normal(size=n_pheno)})

    def fresh():
        m = jt.build_model("y = intercept + ID")
        jt.set_random(m, "ID", ped, 1.0)
        return m

    est = {}
    for solver, kw in (("CG", dict(maxiter=500, tolerance=1e-10)),
                       ("Jacobi", dict(maxiter=2000, tolerance=1e-12))):
        t0 = time.perf_counter()
        out = solve(fresh(), table, solver=solver, device=dev, **kw)
        sec = time.perf_counter() - t0
        info = solve.last
        est[solver] = np.asarray(out.Estimate, dtype=np.float64)[1:]
        say(f"solve {solver}: {sec:.2f} s, {info['iterations']} iterations, relative "
            f"residual {info['relative_residual']:.3g} (K = {info['K']}, LHS "
            f"{info['lhs_nnz']} nonzeros); BLUP accuracy "
            f"{np.corrcoef(est[solver], u)[0, 1]:.4f}")
    acc = float(np.corrcoef(est["CG"], u)[0, 1])
    agree = float(np.corrcoef(est["CG"], est["Jacobi"])[0, 1])
    keep = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with CallTimer(em, "sparse_location_step") as timer, capture_chain_data(keep):
        out, seconds, built = run_phase5(None, table, eq="y = intercept + ID",
                                     on_model=lambda m: jt.set_random(m, "ID", ped, 1.0),
                                     device=dev, chain_length=chain_length,
                                     output_samples_frequency=every, output_folder="")
    peak = torch.cuda.max_memory_allocated(dev)
    cg = out["_location_cg"]
    sl = keep["data"].sl
    bound, nbytes = po_cg_bound_ms(sl)
    ms = [s.elapsed_time(e) for s, e in timer.events]
    it_per = cg["iterations"] / cg["solves"]
    chain_acc = accuracy(out["EBV_y"], dict(zip(ids, u)), list(ids))
    say("runMCMC seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + f"; windows of {every} sweeps " + ", ".join(f"{t:.4f}" for t in built["chain"][-1])
        + f"; peak device memory {peak / 1e9:.2f} GB")
    say(f"a sweep: {np.mean(ms):.3f} ms of device time for the location draw (events, "
        f"{len(ms)} sweeps), host {np.mean(timer.host) * 1e3:.3f} ms, "
        f"{timer.launches} device operations (profiled sweep); PO-CG "
        f"{it_per:.1f} iterations a draw, {np.mean(ms) / it_per:.4f} ms and "
        f"{timer.launches / it_per:.1f} operations an iteration against a byte bound of "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB); {cg['host_reads']} host reads of the "
        f"stopping test in {cg['solves']:.0f} draws")
    say(f"R3 counters: {cg['not_converged']:.0f} of {cg['solves']:.0f} draws unconverged, "
        f"worst relative residual {cg['worst_residual']:.3g}; EBV accuracy of the chain "
        f"{chain_acc:.4f}; CG against Jacobi r = {agree:.6f}; vare "
        f"{out['residual variance'].Estimate[0]:.4g}, sigma^2_u "
        f"{out['polygenic effects covariance matrix'].Estimate[0]:.4g} (truth 1, 1)")
    reps = [jt.runMCMC(fresh(), table, device=dev, chain_length=8, seed=7, output_folder="",
                       printout_model_info=False)["location parameters"] for _ in range(2)]
    same = bool(np.array_equal(np.asarray(reps[0].Estimate), np.asarray(reps[1].Estimate)))
    say(f"two 8-sweep chains of one seed: location parameters bit for bit {same}")
    # the floor holds the BLUPs (the reference test's); the chain's EBVs are
    # the mean of its 3 saved samples, reported
    if not (agree >= AGREE_13A and acc >= ACC_FLOOR_13A and np.isfinite(chain_acc)):
        raise AssertionError(f"phase 13a: CG vs Jacobi {agree:.6f}, accuracy {acc:.4f}, "
                             f"chain {chain_acc:.4f}")
    if not (cg["not_converged"] == 0 and np.isfinite(cg["worst_residual"]) and same
            and np.isfinite(np.asarray(out["EBV_y"].EBV, dtype=np.float64)).all()):
        raise AssertionError(f"phase 13a: CG counters {cg}, repeat bit for bit {same}")
    return {}


def phase13b(dev, ped, ids, u, ped_seconds=0.0, p=50_000, n_geno=20_000,
             n_pheno_geno=10_000, n_pheno_nongeno=40_000, chain_length=24, every=8):
    """Phase 13b; see the module's docstring."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.mcmc as em
    from jwas_tpu_torch.ops import grouped

    say(f"== phase 13b: single-step BayesC, {len(ids)}-animal pedigree, {n_geno} "
        f"genotyped at P={p}")
    t0 = time.perf_counter()
    prob = ssbr_problem(dev, ped, ids, u, n_geno, p, n_pheno_geno=n_pheno_geno,
                        n_pheno_nongeno=n_pheno_nongeno)
    geno = ssbr_genotypes(prob, dev)
    del prob["codes"]
    torch.cuda.empty_cache()
    say(f"data and get_genotypes: {time.perf_counter() - t0:.2f} s (store "
        f"{tuple(geno.dense.shape)}); {len(prob['table'])} phenotyped")
    chain_peak = {}

    @contextlib.contextmanager
    def around_chain():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
        yield
        torch.cuda.synchronize()
        chain_peak.update(peak=torch.cuda.max_memory_allocated(dev), start=start)

    keep = {}
    jt.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with CallTimer(em, "sparse_location_step") as t_loc, \
                CallTimer(grouped, "abc_inner_rounds") as t_k1, capture_chain_data(keep):
            out, seconds, built = run_phase5(
                geno, prob["table"], eq="y = intercept + herd + geno",
                around_chain=around_chain(),
                on_model=lambda m: jt.outputEBV(m, prob["cand"] + prob["nongeno_pheno"]),
                device=dev, chain_length=chain_length, output_samples_frequency=every,
                fast_blocks=False, single_step_analysis=True, pedigree=ped, output_folder="")
    except Exception:
        if "data" in keep:           # what the set-up made, for the diagnosis
            d = keep["data"]
            say(f"phase 13b failed: single-step set-up {keep['ws'].ssbr}; the store "
                f"finite: {bool(torch.isfinite(d.gm.X).all())}; the CG's counters "
                f"{d.sl.stats.read()}")
        raise
    peak_all = torch.cuda.max_memory_allocated(dev)
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    ssbr = out["_single_step"]
    cg = out["_location_cg"]
    gm = built.pop("store and Grams")
    windows = built.pop("chain")[-1]
    X = gm.X
    store_bytes = X.numel() * X.element_size()
    K = keep["data"].sl.n_loc
    bound, nbytes = po_cg_bound_ms(keep["data"].sl)
    say(f"K = {K} ({ssbr['nongenotyped']} epsilon levels, sparse path); store "
        f"{tuple(X.shape)} ({store_bytes / 1e9:.2f} GB), b = {gm.grams.shape[1]}, "
        f"{gm.ngroups} groups")
    results = seconds["runMCMC"] - sum(v for k, v in seconds.items() if k != "runMCMC")
    say(f"seconds: pedigree (13a's get_pedigree) {ped_seconds:.2f}, A^-1 partition "
        f"{ssbr['partition_s']:.2f}, imputation {ssbr['imputation_s']:.2f} ({ssbr['solver']}, "
        f"chunks of {ssbr['chunk']} markers, {ssbr['cg_iterations']} CG iterations over the "
        f"chunks, worst relative residual {ssbr['cg_worst_residual']:.3g}), J "
        f"{ssbr['J_s']:.2f}, workspace in all {seconds['workspace']:.2f}, store and Grams "
        f"{seconds['store and Grams']:.2f}, chain {seconds['chain']:.2f}, results "
        f"{results:.2f}; windows " + ", ".join(f"{t:.4f}" for t in windows))
    nn = ssbr["nongenotyped"]
    if ssbr["cg_iterations"]:
        imp_bytes = 6 * nn * ssbr["chunk"] * 8
        say(f"imputation CG: {ssbr['imputation_s'] / ssbr['cg_iterations'] * 1e3:.2f} ms an "
            f"iteration of a {ssbr['chunk']}-column chunk (wall, set-up included) against a "
            f"byte bound of {imp_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms (X, R, P read and "
            f"written in float64, {imp_bytes / 1e9:.2f} GB, A_nn's CSR aside)")
    lms = [s.elapsed_time(e) for s, e in t_loc.events]
    k1 = [s.elapsed_time(e) for s, e in t_k1.events]
    rounds = counts["abc_inner_rounds"] / max(len(windows), 1)
    it_per = cg["iterations"] / max(cg["solves"], 1)
    say(f"an outer iteration: the PO-CG draw {np.mean(lms) if lms else float('nan'):.3f} ms "
        f"({it_per:.1f} iterations, {t_loc.launches} device operations, byte bound of an "
        f"iteration {bound:.4f} ms), K1 {np.mean(k1):.4f} ms a call x {rounds:.0f} calls = "
        f"{np.mean(k1) * rounds:.1f} ms; R3: {cg['not_converged']:.0f} unconverged, worst "
        f"{cg['worst_residual']:.3g}")
    dense_gemv_line(X, gm.G, dev)
    limit = store_bytes + PHASE7_MARGIN_BYTES
    acc_c = accuracy(out["EBV_y"], prob["truth"], prob["cand"])
    acc_n = accuracy(out["EBV_y"], prob["truth"], prob["nongeno_pheno"])
    say(f"peak device memory {peak_all / 1e9:.2f} GB (set-up included); the chain's "
        f"{chain_peak['peak'] / 1e9:.2f} GB (store {store_bytes / 1e9:.2f} + "
        f"{PHASE7_MARGIN_BYTES / 1e9:.0f} GB = {limit / 1e9:.2f} GB allowed); launches {counts}")
    say(f"EBV accuracy: genotyped candidates {acc_c:.4f}, non-genotyped phenotyped "
        f"{acc_n:.4f}; vare {out['residual variance'].Estimate[0]:.4g}, epsilon's variance "
        f"{out['random effect variances y:ϵ'].Estimate[0]:.4g}")
    values = [np.asarray(out[k].Estimate, dtype=np.float64) for k in
              ("residual variance", "marker effects geno", "location parameters")]
    values.append(np.asarray(out["EBV_y"].EBV, dtype=np.float64))
    if counts["abc_inner_rounds"] == 0:
        raise AssertionError("phase 13b: K1 never launched")
    if not ssbr["cg_worst_residual"] <= IMPUTE_RESIDUAL_13B:
        raise AssertionError(f"phase 13b: imputation residual {ssbr['cg_worst_residual']}")
    if not (all(np.isfinite(v).all() for v in values) and np.isfinite(cg["worst_residual"])):
        raise AssertionError("phase 13b: non-finite results or PO-CG draws")
    if chain_peak["peak"] > limit:
        raise AssertionError(f"phase 13b: the chain's peak {chain_peak['peak'] / 1e9:.2f} GB "
                             f"> {limit / 1e9:.2f} GB")
    if not (acc_c >= ACC_FLOOR_13B and acc_n >= ACC_FLOOR_13B):
        raise AssertionError(f"phase 13b: accuracy {acc_c:.4f} / {acc_n:.4f} < {ACC_FLOOR_13B}")
    del gm, built, geno, X, keep
    torch.cuda.empty_cache()
    return {"abc_inner_rounds": counts["abc_inner_rounds"]}


def phase13c(dev, n_ped=5_000, gen=100, n_geno=1_000, p=2_000, n_iter=300,
             n_pheno_geno=700, n_pheno_nongeno=1_300, n_ped_mt=2_000, n_pheno_nongeno_mt=800):
    """Phase 13c; see the module's docstring."""
    import jwas_tpu_torch as jt

    say(f"== phase 13c: single-step card against CPU, {n_ped} animals ({n_ped_mt} for 2 "
        f"traits), {n_geno} genotyped at p={p}")

    def pedigree(n):
        ids, sire, dam = ssbr_pedigree(n, gen, 135)
        ped = jt.get_pedigree(pedigree_table(ids, sire, dam))
        return ped, ids, polygenic_values(ped, ids, 136)

    runs = (("single-trait SSBR, sparse path", False, dict(sparse_location=True),
             ("abc_inner_rounds",), pedigree(n_ped), n_pheno_nongeno),
            ("2-trait SSBR, dense path", True, {},
             ("mt_abc_inner_rounds_I", K6), pedigree(n_ped_mt), n_pheno_nongeno_mt))
    counts = {}
    for label, two, kw, kernels, (ped, ids, u), nongeno in runs:
        prob = ssbr_problem(dev, ped, ids, u, n_geno, p, n_pheno_geno=n_pheno_geno,
                            n_pheno_nongeno=nongeno, n_herds=20, seed=137,
                            two_traits=two)
        eq = ("y1 = intercept + herd + geno\ny2 = intercept + herd + geno" if two
              else "y = intercept + herd + geno")
        res = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            jt.reset_launches()
            model = jt.build_model(eq, genotypes=ssbr_genotypes(prob, d, two, fixed_pi=True))
            jt.outputEBV(model, prob["cand"] + prob["nongeno_pheno"])
            t0 = time.perf_counter()
            out = jt.runMCMC(model, prob["table"], device=d, chain_length=n_iter,
                             burnin=n_iter // 5, fast_blocks=8, seed=5, output_folder="",
                             single_step_analysis=True, pedigree=ped,
                             printout_model_info=False, **kw)
            traits = ("y1", "y2") if two else ("y",)
            acc = [accuracy(out[f"EBV_{t}"], prob["truth"], who) for t in traits
                   for who in (prob["cand"], prob["nongeno_pheno"])]
            res[where] = dict(acc=np.array(acc), seconds=time.perf_counter() - t0,
                              launches={k.__name__: k.launches for k in jt.KERNELS},
                              cg=out.get("_location_cg"))
        say(f"{label}: " + "; ".join(
            f"{w} EBV accuracy (candidates, non-genotyped) a trait "
            f"{np.round(r['acc'], 4).tolist()} ({r['seconds']:.1f} s)" for w, r in res.items())
            + (f"; card PO-CG {res['card']['cg']}" if res["card"]["cg"] else ""))
        card, cpu = res["card"]["acc"], res["cpu"]["acc"]
        if not (np.isfinite(card).all() and np.isfinite(cpu).all()
                and (card >= cpu - ACC_MARGIN_13C).all()):
            raise AssertionError(f"phase 13c {label}: card {card} vs CPU {cpu}")
        missing = [k for k in kernels if res["card"]["launches"][k] == 0]
        if missing:
            raise AssertionError(f"phase 13c {label}: kernels never launched: {missing}")
        for k in kernels:
            counts[k] = counts.get(k, 0) + res["card"]["launches"][k]
        del prob
        torch.cuda.empty_cache()
    return counts


def phase13(dev):
    """Phase 13: the sparse location path, solve and single-step."""
    import jwas_tpu_torch as jt

    ids, sire, dam = ssbr_pedigree(100_000, 2_000, 131)
    t0 = time.perf_counter()
    ped = jt.get_pedigree(pedigree_table(ids, sire, dam))
    ped_seconds = time.perf_counter() - t0
    u = polygenic_values(ped, ids, 132)
    say(f"phase 13: get_pedigree of {len(ids)} animals in {ped_seconds:.2f} s")
    launches = {"phase 13a": phase13a(dev, ped, ids, u),
                "phase 13b": phase13b(dev, ped, ids, u, ped_seconds)}
    launches["phase 13c"] = phase13c(dev)
    return launches


# ---------------------------------------------------------------- phase 14


class EventTimer:
    """For the duration of a with-block, owner.attr timed at each call after
    the first by CUDA events on the current stream (device ms, including
    any gap in which the device waits for the host), read at the end."""

    def __init__(self, owner, attr):
        self.owner, self.attr, self.events, self.calls = owner, attr, [], 0

    def __enter__(self):
        self.fn = fn = getattr(self.owner, self.attr)

        def call(*a, **k):
            self.calls += 1
            if self.calls == 1:
                return fn(*a, **k)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.events.append((s, e))
            return out

        setattr(self.owner, self.attr, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return float(np.mean([s.elapsed_time(e) for s, e in self.events])) if self.events \
            else float("nan")


RRM_ACC_FLOOR = 0.55       # tests/test_rrm.py:84's floor of the trajectory accuracy


def rrm_table(ids, ind, t_idx, times, y):
    """The long data as runMCMC(RRM=Phi) reads it: ID first, time, y."""
    import jwas_tpu_torch as jt
    return jt.Table({"ID": np.asarray(ids, dtype=object)[ind], "time": times[t_idx], "y": y})


def rrm_problem(dev, n, p, ntimes, c, seed, n_qtl=50, miss=0.15, pe_share=0.8):
    """A test-day design, tests/test_rrm.py's _rrm_sim scaled up: Binomial(2,
    f) genotypes made on the device (dense_codes) and written to the
    float32 store, n_qtl QTL with c-vector N(0, 1) effects on the Legendre
    basis over days 1..ntimes, U = Phi (effects X') the true trajectories,
    miss of the cells unrecorded, y = 1 + 0.3 t + U + pe + e with a
    permanent-environment effect pe ~ N(0, (pe_share sd U)^2) an animal
    (test_rrm_with_iid_random_effect's) and e ~ N(0, sd(U)^2); records
    ordered by animal in the store's order (so the store is used in place)."""
    import jwas_tpu_torch as jt

    t0 = time.perf_counter()
    geno = jt.get_genotypes(dense_codes(n, p, seed, dev), method="BayesC", storage="f32",
                            device=dev)
    rng = np.random.default_rng(seed)
    times = np.arange(1.0, ntimes + 1)
    phi = jt.generate_full_phi(times, c)
    qtl = rng.choice(geno.n_markers, n_qtl, replace=False)
    eff = torch.as_tensor(rng.normal(size=(c, n_qtl)), dtype=torch.float32, device=dev)
    U = (torch.as_tensor(phi, dtype=torch.float32, device=dev)
         @ (eff @ geno.dense[torch.as_tensor(qtl, device=dev)])).double().cpu().numpy()
    sig = U.std()
    pe = rng.normal(0.0, pe_share * sig, n)
    keep = rng.uniform(size=(n, ntimes)) >= miss
    ind, t_idx = np.nonzero(keep)
    y = (1.0 + 0.3 * times[t_idx] + U[t_idx, ind] + pe[ind]
         + rng.normal(0.0, sig, len(ind)))
    table = rrm_table(geno.obs_ids, ind, t_idx, times, y)
    torch.cuda.synchronize()
    return dict(geno=geno, phi=phi, U=U, times=times, table=table, pe_var=float(np.var(pe)),
                sig=sig, seconds=time.perf_counter() - t0, n_records=len(y))


def trajectory_accuracy(out, U, ids, times):
    """The EBV trajectories' correlation with the true ones over every
    (animal, day) cell, recorded or not (tests/test_rrm.py:73-84)."""
    traj = out["EBV_trajectory"]
    row = {(s, float(t)): k for k, (s, t) in enumerate(zip(traj.ID, traj.time))}
    ebv = np.asarray(traj.EBV, dtype=np.float64)
    got = np.array([[ebv[row[(s, float(t))]] for s in ids] for t in times])
    return float(np.corrcoef(got.reshape(-1), U.reshape(-1))[0, 1])


def phase14a(dev, n=10_000, ntimes=10, p=50_000, c=3, chain_length=384, every=128):
    """Phase 14a: RRM at full width; see the module's docstring."""
    import tempfile

    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine import mcmc_rrm
    from jwas_tpu_torch.ops.sparse_mme import csr_bytes

    say(f"== phase 14: random regression (RRM), {n} animals x {ntimes} test days, P = {p}, "
        f"c = {c}")
    prob = rrm_problem(dev, n, p, ntimes, c, seed=141)
    geno = prob["geno"]
    say(f"data (codes on the card, get_genotypes' float32 store of "
        f"{geno.dense.numel() * 4 / 1e9:.2f} GB, {prob['n_records']} records of "
        f"{n * ntimes} cells): {prob['seconds']:.2f} s")
    model = jt.build_model("y = intercept + time + ID + geno", genotypes=geno)
    jt.set_covariate(model, "time")
    jt.set_random(model, "ID", 0.64 * prob["sig"] ** 2)
    jt.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    keep = {}
    build = mcmc_rrm.run_window

    def run_window(cfg, state, data, *a, **k):       # the chain's data, for its sizes
        keep.setdefault("data", data)
        return build(cfg, state, data, *a, **k)

    mcmc_rrm.run_window = run_window
    try:
        with tempfile.TemporaryDirectory() as folder, \
                EventTimer(mcmc_rrm, "rrm_step") as t_step, \
                EventTimer(mcmc_rrm, "sweep_rrm_abc") as t_k10, \
                EventTimer(mcmc_rrm, "gibbs_pass_lambda") as t_k6, \
                EventTimer(mcmc_rrm, "assemble_lhs_lambda") as t_lhs:
            t0 = time.perf_counter()
            out = jt.runMCMC(model, prob["table"], device=dev, chain_length=chain_length,
                             output_samples_frequency=every, seed=142, RRM=prob["phi"],
                             output_folder=folder, printout_model_info=False)
            seconds = time.perf_counter() - t0
            files = len(os.listdir(folder))
    finally:
        mcmc_rrm.run_window = build
    peak = torch.cuda.max_memory_allocated(dev)
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    counts["sweep_rrm_abc_f64"] = jt.sweep_rrm_abc.launches_f64
    data = keep["data"]
    K = data.WtW.shape[0]
    x_bytes = data.X.numel() * data.X.element_size()
    w_bytes = csr_bytes(data.W) + csr_bytes(data.Wt)
    wtw_bytes = data.WtW.numel() * data.WtW.element_size()
    rrm = out["_rrm"]
    s = rrm["seconds"]
    cg = data.cross_grams
    if cg is not None:
        from jwas_tpu_torch.ops.rrm import _chunk_of
        say(f"K10's cross-Grams: chunk b = {_chunk_of(cg)}, "
            f"{cg.numel() * cg.element_size() / 1e6:.1f} MB (built in set-up, within Phi and "
            f"mPhiPhi's seconds)")
    say(f"K = {K}; runMCMC {seconds:.2f} s: design {s['design']:.2f}, Phi and mPhiPhi "
        f"{s['phi_mphiphi']:.2f}, workspace {s['workspace']:.2f}, chain {s['chain']:.2f}, "
        f"results {s['results']:.2f} s ({files} files); windows of {every} sweeps "
        + ", ".join(f"{w:.2f}" for w in rrm["windows"]) + " s")
    k10, k6, lhs, step = t_k10.ms(), t_k6.ms(), t_lhs.ms(), t_step.ms()
    bound = k10_bounds(dict(X=data.X, mphiphi=data.mphiphi, Wgrid=data.obs_mask,
                            obs_mask=data.obs_mask, phi=data.phi))["bound_ms"]
    say(f"an outer iteration on the device: {step:.3f} ms = K10's call (its draws included) "
        f"{k10:.3f} ms ({k10 * 1e6 / p:.1f} ns a marker step; bound {bound:.4f} ms) + K6 "
        f"{k6:.3f} ms a pass + the LHS {lhs:.3f} ms + the rest {step - k10 - k6 - lhs:.3f} ms")
    budget = x_bytes + w_bytes + wtw_bytes + 4e9
    say(f"peak device memory {peak / 1e9:.2f} GB (X {x_bytes / 1e9:.2f} + W and W' "
        f"{w_bytes / 1e9:.3f} + W'W {wtw_bytes / 1e9:.2f} + 4 GB = {budget / 1e9:.2f} allowed)")
    acc = trajectory_accuracy(out, prob["U"], geno.obs_ids, prob["times"])
    pe = float(out["random effect variances y:ID"].Estimate[0])
    vare = float(out["residual variance"].Estimate[0])
    say(f"trajectory EBV accuracy {acc:.4f} (floor {RRM_ACC_FLOOR}); pe variance {pe:.4f} "
        f"(truth {prob['pe_var']:.4f}); residual variance {vare:.4f} (truth "
        f"{prob['sig'] ** 2:.4f}); pi {np.round(np.asarray(out['pi_geno'].Estimate), 4).tolist()}"
        f"; launches {{K10: {counts['sweep_rrm_abc']}, K6: {counts[K6]}}}")
    finite = all(np.isfinite(np.asarray(t[col], dtype=np.float64)).all()
                 for key, t in out.items() if not key.startswith("_")
                 for col in ("Estimate", "EBV") if col in t.columns)
    if counts["sweep_rrm_abc"] == 0 or counts[K6] == 0:
        raise AssertionError(f"phase 14: a kernel never launched: {counts}")
    if not finite:
        raise AssertionError("phase 14: a posterior mean is not finite")
    if peak > budget:
        raise AssertionError(f"phase 14: peak {peak / 1e9:.2f} GB above {budget / 1e9:.2f}")
    if not acc >= RRM_ACC_FLOOR:
        raise AssertionError(f"phase 14: trajectory accuracy {acc:.4f} < {RRM_ACC_FLOOR}")
    del out, prob, geno, model, data, keep
    torch.cuda.empty_cache()
    return counts


def rrm_sim(seed=3, nind=250, p=100, ntimes=5, c=2, miss=0.15):
    """tests/test_rrm.py's _rrm_sim in numpy: (table, X (nind, p), U,
    ids, times, Phi)."""
    import jwas_tpu_torch as jt

    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.1, 0.9, p)
    X = rng.binomial(2, freqs[None, :], size=(nind, p)).astype(float)
    times = np.arange(1.0, ntimes + 1)
    phi = jt.generate_full_phi(times, ncoeff=c)
    effects = np.zeros((c, p))
    qtl = rng.choice(p, 10, replace=False)
    effects[:, qtl] = rng.normal(0, 1.0, (c, 10))
    U = phi @ (effects @ (X - X.mean(axis=0)).T)
    sig = U.std()
    ids = [f"i{k}" for k in range(nind)]
    rows = [(ik, ti, 1.0 + 0.3 * tval + U[ti, ik] + rng.normal(0, sig))
            for ti, tval in enumerate(times) for ik in range(nind) if rng.uniform() >= miss]
    ind = np.array([r[0] for r in rows])
    t_idx = np.array([r[1] for r in rows])
    y = np.array([r[2] for r in rows])
    return rrm_table(ids, ind, t_idx, times, y), X, U, ids, times, phi


def rrm_pedigree_sim(seed=4, n_founders=30, gen_size=60, n_gen=2, p=60, n_qtl=8,
                     ntimes=4):
    """test_rrm_with_pedigree_polygenic_effect's design: a pedigree
    (phase9_pedigree), genotypes gene-dropped from Binomial(2, f) founders,
    TBV from n_qtl QTL at h2 0.5, each animal recorded on ntimes days, y =
    1 + TBV + N(0, 1). Returns (table, X, TBV, Pedigree, ids, times, Phi)."""
    import jwas_tpu_torch as jt

    rng = np.random.default_rng(seed)
    ids, sire, dam, _ = phase9_pedigree(n_founders, [gen_size] * n_gen, seed)
    n = len(ids)
    f = rng.uniform(0.1, 0.9, p)
    hap = np.zeros((n, 2, p), dtype=np.int64)
    hap[:n_founders] = rng.uniform(size=(n_founders, 2, p)) < f
    for i in range(n_founders, n):
        for k, par in enumerate((sire[i], dam[i])):
            hap[i, k] = hap[par, rng.integers(0, 2, p), np.arange(p)]
    X = hap.sum(1).astype(float)
    beta = np.zeros(p)
    beta[rng.choice(p, n_qtl, replace=False)] = rng.normal(size=n_qtl)
    tbv = (X - X.mean(0)) @ beta
    tbv *= 1.0 / tbv.std()
    times = np.arange(1.0, ntimes + 1)
    ind = np.repeat(np.arange(n), ntimes)
    t_idx = np.tile(np.arange(ntimes), n)
    y = 1.0 + tbv[ind] + rng.normal(0.0, 1.0, len(ind))
    ped = jt.get_pedigree(pedigree_table(ids, sire, dam))
    return (rrm_table(list(ids), ind, t_idx, times, y), X, tbv, ped, list(ids), times,
            jt.generate_full_phi(times, ncoeff=2))


def phase14b(dev, n_iter=600, n_iter_ped=200, n_f64=100):
    """Phase 14b: the card against the CPU; see the module's docstring."""
    import jwas_tpu_torch as jt

    say(f"== phase 14b: RRM card against CPU at tests/test_rrm.py's shapes, {n_iter} sweeps")
    table, X, U, ids, times, phi = rrm_sim()
    ptable, pX, tbv, ped, pids, ptimes, pphi = rrm_pedigree_sim()
    counts = {}

    def bayesc(d, **kw):
        g = jt.get_genotypes(X, method="BayesC", device=d,
                             double_precision=kw.get("double_precision", False))
        g.obs_ids = list(ids)
        m = jt.build_model("y = intercept + time + geno", genotypes=g)
        return m, table, phi, U

    def pedigree(d, **kw):
        g = jt.get_genotypes(pX, method="RR-BLUP", device=d)
        g.obs_ids = list(pids)
        m = jt.build_model("y = intercept + ID + geno", genotypes=g)
        jt.set_random(m, "ID", ped)
        U_ped = np.broadcast_to(tbv, (len(ptimes), len(pids)))
        return m, ptable, pphi, U_ped

    for label, make, idset, tset, sweeps in (
            ("BayesC, y = intercept + time + geno", bayesc, ids, times, n_iter),
            (f"RR-BLUP, y = intercept + ID + geno, ID on the pedigree, {n_iter_ped} sweeps",
             pedigree, pids, ptimes, n_iter_ped)):
        res = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            jt.reset_launches()
            model, tab, ph, truth = make(d)
            t0 = time.perf_counter()
            # the CPU's plain sweep is a loop of small operations: one
            # thread runs it ~5x faster than the host's cores together
            threads = torch.get_num_threads()
            torch.set_num_threads(1 if where == "cpu" else threads)
            try:
                out = jt.runMCMC(model, tab, device=d, chain_length=sweeps,
                                 burnin=sweeps // 4, seed=9, RRM=ph, output_folder="",
                                 printout_model_info=False)
            finally:
                torch.set_num_threads(threads)
            res[where] = dict(acc=trajectory_accuracy(out, truth, idset, tset),
                              seconds=time.perf_counter() - t0,
                              launches={k.__name__: k.launches for k in jt.KERNELS})
        say(f"{label}: " + "; ".join(f"{w} trajectory accuracy {r['acc']:.4f} "
                                     f"({r['seconds']:.1f} s)" for w, r in res.items()))
        if not (np.isfinite(res["card"]["acc"])
                and res["card"]["acc"] >= res["cpu"]["acc"] - ACC_MARGIN):
            raise AssertionError(f"phase 14b {label}: card {res['card']['acc']} vs CPU "
                                 f"{res['cpu']['acc']}")
        for k in ("sweep_rrm_abc", K6):
            if res["card"]["launches"][k] == 0:
                raise AssertionError(f"phase 14b {label}: {k} never launched")
            counts[k] = counts.get(k, 0) + res["card"]["launches"][k]
    # the float64 builds of K10 and K6 on the BayesC chain
    jt.reset_launches()
    model, tab, ph, truth = bayesc(dev, double_precision=True)
    out = jt.runMCMC(model, tab, device=dev, chain_length=n_f64, burnin=n_f64 // 4, seed=9,
                     RRM=ph, double_precision=True, output_folder="", printout_model_info=False)
    acc = trajectory_accuracy(out, truth, ids, times)
    n64 = jt.sweep_rrm_abc.launches_f64
    say(f"float64 BayesC, {n_f64} sweeps: trajectory accuracy {acc:.4f}, K10's float64 "
        f"build {n64} launches, K6's {jt.gibbs_pass_lambda.launches_f64}")
    if n64 == 0 or not np.isfinite(acc):
        raise AssertionError(f"phase 14b float64: launches {n64}, accuracy {acc}")
    counts["sweep_rrm_abc_f64"] = n64
    counts[K6 + "_f64"] = jt.gibbs_pass_lambda.launches_f64
    return counts


def phase14(dev):
    """Phase 14: random regression at full width, then card against CPU."""
    return {"phase 14a": phase14a(dev), "phase 14b": phase14b(dev)}


# ---------------------------------------------------------------- phase 15

# device memory GWAS may use beyond the store: its decode budget
# (ops/grouped.py::_DECODE_BYTES, 1 GB of float32 columns) and a margin
PHASE15_DECODE_BYTES = 1 << 30
PHASE15_MARGIN_BYTES = 4e9
PHASE15_THRESHOLD = 0.001      # GWAS's default WPPA threshold
PHASE15_NEAR = 1e-5            # a proportion this close (relative) to it may flip
PATH_ABC_15 = ("abc_inner_rounds", "packed_rhs", "packed_matvec", K6)
PATH_DENSE_15 = ("abc_inner_rounds", K6)    # BayesC on a dense store


def gwas_map(p, n_chr, span=100_000_000, ids=None):
    """A map of p markers (ids, default m1..) over n_chr chromosomes of
    span bp, each chromosome's markers consecutive and evenly spaced.
    Returns the Table and each marker's fixed 1 Mb window (1-based,
    numbered over the chromosomes in turn: every window holds markers)."""
    import jwas_tpu_torch as jt

    per = -(-p // n_chr)
    spacing = span // per
    j = np.arange(p)
    chrom, pos = j // per + 1, (j % per) * spacing + 1
    nwin = np.array([int(pos[chrom == c].max() // 1_000_000) + 1
                     for c in range(1, n_chr + 1)])
    first = np.concatenate([[0], np.cumsum(nwin)[:-1]])
    window = first[chrom - 1] + pos // 1_000_000 + 1
    ids = np.array([f"m{i + 1}" for i in j] if ids is None else ids, dtype=object)
    return jt.Table({"markerID": ids, "chromosome": chrom, "position": pos}), window


def gwas_parts(seconds, fn):
    """fn() (a GWAS call) with the seconds of its sample-file reads and of
    its X A products (BV) split out of its wall time and added to
    seconds["read"] and seconds["BV"]. Returns fn()'s value, the wall time
    minus both, and the parts (with "samples": the last file's samples)."""
    from jwas_tpu_torch.analysis import gwas

    local = {}
    read = gwas.read_marker_samples

    def reading(path):
        t0 = time.perf_counter()
        out = read(path)
        local["read"] = local.get("read", 0.0) + time.perf_counter() - t0
        local["samples"] = out[1]
        return out

    gwas.read_marker_samples = reading
    try:
        with timed_calls(local, "BV", gwas.Columns, "matmul"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        gwas.read_marker_samples = read
    for k in ("read", "BV"):
        seconds[k] = seconds.get(k, 0.0) + local.get(k, 0.0)
    return out, wall - local.get("read", 0.0) - local.get("BV", 0.0), local


def check_gwas(label, res, p, S, props, lebv=None, direct=None, cols=None):
    """The checks every full-width GWAS passes: numSNP sums to p, prGenVar
    and WPPA finite, WPPA in [0, 1], the variance proportions finite, and
    the local EBVs summed over the windows equal X mean(alpha) (direct, for
    the store columns cols) within 1e-4 relative."""
    n_snp = int(np.sum(res["numSNP"]))
    wppa, pr = np.asarray(res["WPPA"]), np.asarray(res["prGenVar"])
    if n_snp != p:
        raise AssertionError(f"{label}: numSNP sums to {n_snp}, not {p}")
    if not (np.isfinite(pr).all() and np.isfinite(wppa).all() and np.isfinite(props).all()):
        raise AssertionError(f"{label}: non-finite prGenVar, WPPA or proportions")
    if not ((wppa >= 0) & (wppa <= 1)).all():
        raise AssertionError(f"{label}: WPPA outside [0, 1]")
    if props.shape[1] != S:
        raise AssertionError(f"{label}: {props.shape[1]} samples, not {S}")
    if lebv is None:
        return None
    total = np.zeros(len(lebv[lebv.columns[0]]), dtype=np.float64)
    for c in lebv.columns:
        total += np.asarray(lebv[c], dtype=np.float64)
    err = float(np.abs(total[cols] - direct).max() / np.abs(direct).max())
    if not err <= 1e-4:
        raise AssertionError(f"{label}: local EBVs sum to X alpha within {err:.3g}, not 1e-4")
    return err


def phase15a(dev, n=50_000, p=100_000, n_train=45_000, n_outer=45, n_burn=5):
    """Phase 15a; see the module's docstring."""
    import tempfile

    import jwas_tpu_torch as jt
    from jwas_tpu_torch.analysis import diagnostics, gwas
    from jwas_tpu_torch.engine.samples_io import STSampleStream
    from jwas_tpu_torch.ops.grouped import resolve_blocks

    b, gb = resolve_blocks(n_train, False, p, warn=False)
    say(f"== phase 15a: two chains, GWAS and the diagnostics at N={n} x P={p} "
        f"(b={b}, gb={gb}, {n_outer} outer iterations, {n_burn} burnt in)")
    torch.cuda.empty_cache()
    packed, freqs = device_store(n, p, 15, dev)
    freqs = freqs.double().cpu().numpy()
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    qtl = torch.rand(p, generator=g, device=dev) < 0.001
    beta = torch.randn(p, generator=g, device=dev) * qtl
    truth_store = jt.Packed2BitStore(
        obs_ids=[f"ind{i + 1}" for i in range(n)], marker_ids=[f"m{j + 1}" for j in range(p)],
        packed=packed, means=2.0 * freqs, allele_freq=freqs, n_obs=n, n_markers=p,
        has_missing=False)
    tbv = gwas.genotype_columns(truth_store, None, dev).matmul(
        beta[:, None].float())[:, 0].double().cpu().numpy()
    qtl = torch.nonzero(qtl).flatten().cpu().numpy()
    store, table, _, _, cand = phase5_problem(packed, freqs, tbv, n_train=n_train)
    map_t, window_of = gwas_map(p, 10, ids=store.marker_ids)
    S = (n_outer - n_burn)
    seconds = {}
    jt.reset_launches()
    with tempfile.TemporaryDirectory() as folder:
        with timed_calls(seconds, "writing the files", STSampleStream, "write_sample"):
            t0 = time.perf_counter()
            model = jt.build_model("y = intercept + herd + age + geno",
                                   genotypes=jt.get_genotypes(store, method="BayesC",
                                                              storage="2bit"))
            jt.set_covariate(model, "age")
            out = jt.runMCMC(model, table, device=dev, chain_length=n_outer * b,
                             burnin=n_burn * b, output_samples_frequency=b, seed=15,
                             n_chains=2, output_chain_samples=True,
                             output_marker_samples=True, output_folder=folder,
                             printout_model_info=False)
            torch.cuda.synchronize()
            seconds["the chains (runMCMC, set-up included)"] = (
                time.perf_counter() - t0 - seconds["writing the files"])
        counts = {k.__name__: k.launches for k in jt.KERNELS}
        f0 = out["_marker_sample_file"]
        chain_files = [os.path.join(c, os.path.basename(f0))
                       for c in out["_chain_sample_folders"]]
        vare_files = [os.path.join(c, "MCMC_samples_residual_variance.txt")
                      for c in out["_chain_sample_folders"]]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mf, t_mf, _ = gwas_parts(seconds, lambda: jt.GWAS(f0))
        (res, props, lebv), t_win, parts = gwas_parts(seconds, lambda: jt.GWAS(
            model, map_t, f0, local_EBV=True, output_winVarProps=True, device=dev))
        t_bv = parts["BV"]
        corr, t_cor, _ = gwas_parts(seconds, lambda: jt.GWAS(
            model, map_t, chain_files, genetic_correlation=True, device=dev))
        seconds["the windows"] = t_win + t_mf
        seconds["the correlation"] = t_cor
        peak = torch.cuda.max_memory_allocated(dev)
        read_psrf = {}
        with timed_calls(read_psrf, "read", diagnostics, "read_sample_file"):
            t0 = time.perf_counter()
            psrf_v = jt.PSRF_per_parameter(*vare_files)
            psrf_m = jt.PSRF_per_parameter(*chain_files, max_params=1000)
            seconds["PSRF"] = time.perf_counter() - t0 - read_psrf["read"]
        seconds["reading the files"] = seconds.pop("read") + read_psrf["read"]
        col_of = {s: i for i, s in enumerate(store.obs_ids)}
        check_cols = [col_of[s] for s in cand[:64]]
        direct = direct_ebv(packed, store.means, parts["samples"].mean(axis=0), check_cols)
    flops = 2.0 * n * p * S
    say("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()
                                if k != "BV") + f", BV {seconds['BV']:.3f}")
    say(f"BV = X A over the 2-bit store: {2 * n * p * S / 1e12:.3f} TFLOP in {t_bv:.3f} s "
        f"({flops / t_bv / 1e12:.2f} TFLOP/s, decoded chunks of "
        f"{PHASE15_DECODE_BYTES // (4 * n)} markers and torch.mm); {len(res)} windows, "
        f"{len(corr)} correlation windows")
    store_bytes = packed.numel()
    limit = store_bytes + PHASE15_DECODE_BYTES + PHASE15_MARGIN_BYTES
    say(f"GWAS peak device memory {peak / 1e9:.3f} GB (allocated before it "
        f"{base / 1e9:.3f} GB; store {store_bytes / 1e9:.3f} + 1.07 decode + 4 GB = "
        f"{limit / 1e9:.3f} GB allowed); launches {counts}")
    psrf = dict(zip(out["PSRF"]["parameter"], out["PSRF"]["PSRF"]))
    say("PSRF table: " + ", ".join(f"{k} {v:.4f}" for k, v in psrf.items()))
    ebv = dict(zip(out["EBV_y"]["ID"], np.asarray(out["EBV_y"]["EBV"], dtype=np.float64)))
    truth = dict(zip(store.obs_ids, tbv))
    acc = float(np.corrcoef([ebv[s] for s in cand], [truth[s] for s in cand])[0, 1])
    wppa = dict(zip(np.asarray(res["window"]), np.asarray(res["WPPA"])))
    qtl_w = set(window_of[qtl].tolist())
    w_q = float(np.mean([wppa[w] for w in qtl_w]))
    w_o = float(np.mean([v for w, v in wppa.items() if w not in qtl_w]))
    order = np.argsort(-np.asarray(corr["estimate_cov"]), kind="stable")[:3]
    top_cor = np.asarray(corr["estimate_cor"])[order]
    say(f"pooled EBV accuracy of the {len(cand)} candidates {acc:.4f}; WPPA: the "
        f"{len(qtl_w)} QTL windows' mean {w_q:.4f}, the other {len(wppa) - len(qtl_w)} "
        f"{w_o:.4f}; the top WPPA windows {np.asarray(res['window'])[:5].tolist()}; "
        f"estimate_cor of the 3 largest estimate_cov {np.round(top_cor, 4).tolist()}; "
        f"model frequency mean {float(np.mean(mf['modelfrequency'])):.4f}")
    say(f"PSRF_per_parameter: vare {np.round(np.asarray(psrf_v['PSRF']), 4).tolist()}, "
        f"{len(psrf_m)} of the first 1,000 marker effects moving, median "
        f"{float(np.median(psrf_m['PSRF'])):.4f}, max {float(np.max(psrf_m['PSRF'])):.4f}")
    err = check_gwas("phase 15a", res, p, S, props, lebv, direct, check_cols)
    say(f"local EBVs summed over the windows against X mean(alpha) decoded directly "
        f"(64 candidates): max relative error {err:.3g}")
    # LOOCV's eBV branch on 2,000 candidates x 2,000 markers, float64 on the card
    rng = np.random.default_rng(15)
    cj = np.sort(rng.choice(p, 2_000, replace=False))
    ci = np.asarray([col_of[s] for s in cand[:2_000]])
    cols = gwas.genotype_columns(store, None, dev)
    X = cols.rows(torch.as_tensor(cj, device=dev))[:, torch.as_tensor(ci, device=dev)].T
    y_c = tbv[ci] + rng.normal(0.0, float(np.std(tbv)), len(ci))
    vara = float(out["marker effects variances geno"]["Estimate"][0])
    vare = float(out["residual variance"]["Estimate"][0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = jt.LOOCV(X.double(), y_c, vara, vare, verbose=False, device=dev)
    t_loocv = time.perf_counter() - t0
    say(f"LOOCV (eBV branch, {len(ci)} candidates x {len(cj)} markers, float64 on the "
        f"card) {t_loocv:.3f} s: mean square {float(e @ e / len(e)):.4g}, accuracy "
        f"{float(np.corrcoef(y_c, y_c + e)[0, 1]):.4f}")
    values = [np.asarray(out[k]["Estimate"], dtype=np.float64) for k in
              ("residual variance", "marker effects variances geno", "pi_geno",
               "marker effects geno", "location parameters")]
    values += [np.asarray(out["EBV_y"]["EBV"], dtype=np.float64), np.asarray(list(psrf.values())),
               np.asarray(corr["estimate_cov"]), np.asarray(corr["estimate_cor"]),
               np.asarray(psrf_v["PSRF"]), np.asarray(psrf_m["PSRF"]), e, np.asarray([acc])]
    if not all(np.isfinite(v).all() for v in values):
        raise AssertionError("phase 15a: non-finite results")
    if any(counts[k] == 0 for k in PATH_ABC_15):
        raise AssertionError(f"phase 15a: kernels never launched: {counts}")
    if not w_q > w_o:
        raise AssertionError(f"phase 15a: QTL windows' WPPA {w_q:.4f} <= others' {w_o:.4f}")
    if not (top_cor > 0.5).all():
        raise AssertionError(f"phase 15a: estimate_cor {top_cor} of the top covariances")
    if peak > limit:
        raise AssertionError(f"phase 15a: GWAS peak {peak / 1e9:.3f} GB > {limit / 1e9:.3f}")
    if set(psrf) != {"vare", "h2", "genvar", "varg", "pi[0]"}:
        raise AssertionError(f"phase 15a: PSRF table {psrf}")
    del packed, store, model, cols, X
    torch.cuda.empty_cache()
    return {k: counts[k] for k in PATH_ABC_15}


def phase15b(dev, kept, n_outer=13, n_burn=5, n_chr=20):
    """Phase 15b (on phase 3's store, before it is freed); see the module's
    docstring."""
    import tempfile

    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine.samples_io import STSampleStream

    p, n = kept["packed"].shape[0], kept["tbv"].shape[0]
    say(f"== phase 15b: GWAS over the north-star store, N={n} x P={p}, "
        f"{n_outer} outer iterations ({n_burn} burnt in), 1 Mb windows on {n_chr} "
        "chromosomes")
    store, table, _, _, cand = phase5_problem(kept["packed"], kept["freqs"], kept["tbv"])
    map_t, _ = gwas_map(p, n_chr, ids=store.marker_ids)
    S = n_outer - n_burn
    b = 128
    torch.cuda.empty_cache()
    jt.reset_launches()
    with tempfile.TemporaryDirectory() as folder:
        seconds = {}
        geno = jt.get_genotypes(store, method="BayesC", storage="2bit", Pi=0.999)
        with timed_calls(seconds, "writing the files", STSampleStream, "write_sample"):
            out, parts, built = run_phase5(geno, table, device=dev, fast_blocks=b,
                                           chain_length=n_outer * b, burnin=n_burn * b,
                                           output_samples_frequency=b,
                                           output_marker_samples=True, output_folder=folder)
        counts = {k.__name__: k.launches for k in jt.KERNELS}
        model_geno = built.pop("store and Grams")
        del built, model_geno
        seconds.update({k: v for k, v in parts.items() if k != "runMCMC"})
        seconds["chain"] -= seconds["writing the files"]
        f0 = out["_marker_sample_file"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        (res, props, lebv), t_win, gparts = gwas_parts(seconds, lambda: jt.GWAS(
            None, map_t, f0, genotypes=store, local_EBV=True, output_winVarProps=True,
            device=dev))
        seconds["the windows"] = t_win
        seconds["reading the files"] = seconds.pop("read")
        peak = torch.cuda.max_memory_allocated(dev)
        col_of = {s: i for i, s in enumerate(store.obs_ids)}
        check_cols = [col_of[s] for s in cand[:64]]
        direct = direct_ebv(kept["packed"], store.means, gparts["samples"].mean(axis=0),
                            check_cols)
        size = os.path.getsize(f0)
    t_bv = gparts["BV"]
    say("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    say(f"marker-effect sample file {size / 1e6:.1f} MB ({S} samples x {p} markers); "
        f"BV = X A {2 * n * p * S / 1e12:.3f} TFLOP in {t_bv:.3f} s "
        f"({2 * n * p * S / t_bv / 1e12:.2f} TFLOP/s); {len(res)} windows")
    store_bytes = kept["packed"].numel()
    limit = store_bytes + PHASE15_DECODE_BYTES + PHASE15_MARGIN_BYTES
    say(f"GWAS peak device memory {peak / 1e9:.3f} GB (allocated before it "
        f"{base / 1e9:.3f} GB; store {store_bytes / 1e9:.3f} + 1.07 + 4 GB = "
        f"{limit / 1e9:.3f} GB allowed); launches {counts}")
    err = check_gwas("phase 15b", res, p, S, props, lebv, direct, check_cols)
    ebv = dict(zip(out["EBV_y"]["ID"], np.asarray(out["EBV_y"]["EBV"], dtype=np.float64)))
    truth = dict(zip(store.obs_ids, kept["tbv"]))
    acc = float(np.corrcoef([ebv[s] for s in cand], [truth[s] for s in cand])[0, 1])
    say(f"local EBVs against X mean(alpha): max relative error {err:.3g}; WPPA mean "
        f"{float(np.mean(res['WPPA'])):.4f}, top windows "
        f"{np.asarray(res['window'])[:5].tolist()}; candidates' EBV accuracy {acc:.4f}; "
        f"vare {float(out['residual variance']['Estimate'][0]):.4g}, pi "
        f"{float(out['pi_geno']['Estimate'][0]):.6f}")
    if peak > limit:
        raise AssertionError(f"phase 15b: GWAS peak {peak / 1e9:.3f} GB > {limit / 1e9:.3f}")
    if any(counts[k] == 0 for k in PATH_ABC_15):
        raise AssertionError(f"phase 15b: kernels never launched: {counts}")
    if not np.isfinite(acc):
        raise AssertionError("phase 15b: non-finite EBVs")
    del res, props, lebv, store, geno
    torch.cuda.empty_cache()
    return {k: counts[k] for k in PATH_ABC_15}


def near_threshold_ok(props_ref, wppa_ref, wppa, windows):
    """WPPA equal but where a sample's proportion lies within PHASE15_NEAR
    (relative) of the threshold: there by at most 1/S a such sample."""
    S = props_ref.shape[1]
    near = (np.abs(props_ref - PHASE15_THRESHOLD) <= PHASE15_NEAR * PHASE15_THRESHOLD).sum(1)
    return bool((np.abs(wppa - wppa_ref) <= near[windows - 1] / S + 1e-12).all())


def gwas_card_vs_cpu(dev, model, map_file, map_one, f, f2, store):
    """GWAS on the card and on the CPU: fixed windows over map_file and
    sliding ones over map_one (a chromosome), with the variance proportions
    and local EBVs, and the correlation of two files. Returns the largest
    differences; raises where they exceed 15c's tolerances."""
    import jwas_tpu_torch as jt

    worst = {}
    for sliding in (False, True):
        runs = [jt.GWAS(model, map_one if sliding else map_file, f, genotypes=store,
                        sliding_window=sliding, output_winVarProps=True, local_EBV=True,
                        device=d)
                for d in (dev, torch.device("cpu"))]
        (res, props, lebv), (res_c, props_c, lebv_c) = runs
        o, oc = np.argsort(res["window"]), np.argsort(res_c["window"])
        w = np.asarray(res["window"])[o]
        if not np.array_equal(w, np.asarray(res_c["window"])[oc]):
            raise AssertionError("phase 15c: the card's windows differ from the CPU's")
        pr, pr_c = np.asarray(res["prGenVar"])[o], np.asarray(res_c["prGenVar"])[oc]
        if not (np.allclose(pr, pr_c, rtol=1e-4, atol=1e-6)
                and np.allclose(props, props_c, rtol=1e-4, atol=1e-6)):
            raise AssertionError(f"phase 15c: prGenVar differs (sliding {sliding})")
        if not near_threshold_ok(props_c, np.asarray(res_c["WPPA"])[oc],
                                 np.asarray(res["WPPA"])[o], w):
            raise AssertionError(f"phase 15c: WPPA differs (sliding {sliding})")
        d_ebv = max(float(np.abs(np.asarray(lebv[c]) - np.asarray(lebv_c[c])).max())
                    for c in lebv.columns)
        if not d_ebv <= 1e-4:
            raise AssertionError(f"phase 15c: local EBVs differ by {d_ebv:.3g}")
        key = "sliding" if sliding else "fixed"
        worst[key] = dict(windows=len(w), prGenVar=float(np.abs(pr - pr_c).max()),
                          local_EBV=d_ebv,
                          WPPA=float(np.abs(np.asarray(res["WPPA"])[o]
                                            - np.asarray(res_c["WPPA"])[oc]).max()))
    cor = [jt.GWAS(model, map_file, [f, f2], genotypes=store, genetic_correlation=True,
                   device=d) for d in (dev, torch.device("cpu"))]
    for c in ("estimate_cov", "std_cov", "estimate_cor", "std_cor"):
        a, b = np.asarray(cor[0][c]), np.asarray(cor[1][c])
        if not np.allclose(a, b, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"phase 15c: correlation column {c} differs")
        worst[c] = float(np.abs(a - b).max())
    return worst


def phase15c(dev):
    """Phase 15c; see the module's docstring."""
    import tempfile

    import jwas_tpu_torch as jt
    from jwas_tpu_torch.io.datasets import simulate_genomic_data

    say("== phase 15c: GWAS, LOOCV and three chains, the card against the CPU")
    t_data = time.perf_counter()
    codes, y, bv = stat_data()
    store = stat_store(codes)
    n, p = codes.shape
    t_data = time.perf_counter() - t_data
    jt.reset_launches()
    with tempfile.TemporaryDirectory() as folder:
        t_chain = time.perf_counter()
        model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
            store, method="BayesC", storage="2bit"))
        out = jt.runMCMC(model, jt.Table({"ID": store.obs_ids, "y": y}), device=dev,
                         fast_blocks=8, chain_length=8 * 30, burnin=8 * 10,
                         output_samples_frequency=8, seed=5, output_marker_samples=True,
                         output_folder=os.path.join(folder, "res"),
                         printout_model_info=False)
        t_chain = time.perf_counter() - t_chain
        gwas_counts = {k.__name__: k.launches for k in jt.KERNELS}
        if any(gwas_counts[k] == 0 for k in PATH_ABC_15):
            raise AssertionError(f"phase 15c: kernels never launched: {gwas_counts}")
        f = out["_marker_sample_file"]
        with open(f) as fh:
            lines = fh.read().splitlines()
        f2 = os.path.join(folder, "MCMC_samples_marker_effects_geno_y2.txt")
        with open(f2, "w") as fh:           # the same samples, rolled by one row
            fh.write("\n".join([lines[0]] + lines[2:] + lines[1:2]) + "\n")
        map_t, _ = gwas_map(p, 4, span=20_000_000)
        map_file = os.path.join(folder, "map.csv")
        map_t.to_csv(map_file)
        t0 = time.perf_counter()
        worst = gwas_card_vs_cpu(dev, model, map_file, map_t.take(np.arange(p // 8)),
                                 f, f2, store)
        t_gwas = time.perf_counter() - t0
    say(f"data {t_data:.1f} s, the card's chain and its files {t_chain:.1f} s; GWAS card "
        f"against CPU ({len(lines) - 1} samples; {t_gwas:.1f} s): "
        + "; ".join(f"{k} {v}" for k, v in worst.items()))
    vara = float(out["marker effects variances geno"]["Estimate"][0])
    vare = float(out["residual variance"]["Estimate"][0])
    loocv = {}
    t_loocv = time.perf_counter()
    for branch, (rows, cols) in (("eMEM", (500, 50)), ("eBV", (300, 600))):
        X = codes[:rows, :cols].astype(np.float64)
        got = jt.LOOCV(X, y[:rows], vara, vare, verbose=False, device=dev)
        ref = jt.LOOCV(X, y[:rows], vara, vare, verbose=False, device="cpu")
        loocv[branch] = float(np.abs(got - ref).max() / np.abs(ref).max())
        if not loocv[branch] <= 1e-8:
            raise AssertionError(f"phase 15c: LOOCV {branch} differs by {loocv[branch]:.3g}")
    say(f"LOOCV card against CPU ({time.perf_counter() - t_loocv:.1f} s), max relative "
        f"difference: {loocv}")
    # tests/test_multichain.py:10-22's model, three chains on the card
    sim = simulate_genomic_data(n=300, p=120, n_qtl=12, h2=0.5, seed=61)
    geno = jt.get_genotypes(sim["genotypes"], method="BayesC", name="geno", device=dev)
    jt.reset_launches()
    t0 = time.perf_counter()
    mc = jt.runMCMC(jt.build_model("y = intercept + geno", genotypes=geno),
                    sim["phenotypes"], chain_length=600, burnin=120, seed=3, n_chains=3,
                    output_samples_frequency=5, output_folder="", device=dev,
                    printout_model_info=False)
    t_mc = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    acc = float(np.corrcoef(np.asarray(mc["EBV_y"]["EBV"], float), sim["true_bv"])[0, 1])
    psrf = dict(zip(mc["PSRF"]["parameter"], mc["PSRF"]["PSRF"]))
    say(f"3 chains of 600 sweeps on the card in {t_mc:.1f} s: EBV accuracy {acc:.4f} "
        f"(> 0.85), PSRF {({k: round(v, 4) for k, v in psrf.items()})} (vare in 0.8..1.3); "
        f"launches {counts}")
    if not acc > 0.85 or not 0.8 < psrf["vare"] < 1.3:
        raise AssertionError(f"phase 15c: three chains' accuracy {acc:.4f}, PSRF {psrf}")
    if any(counts[k] == 0 for k in PATH_DENSE_15):
        raise AssertionError(f"phase 15c: the three chains never launched: {counts}")
    return ({k: gwas_counts[k] for k in PATH_ABC_15},
            {k: counts[k] for k in PATH_DENSE_15})


def phase15(dev):
    """Phase 15a and 15c (15b runs on phase 3's store); 15c's launches of
    its GWAS chain and of its three chains apart."""
    launches = {"phase 15a": phase15a(dev)}
    launches["phase 15c gwas"], launches["phase 15c chains"] = phase15c(dev)
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    import multiprocessing

    import jwas_tpu_torch  # noqa: F401  (the port must import before a worker starts)

    dev = torch.device("cuda", 0)
    # phase 4's CPU chain (plain versions) runs in a worker process while
    # nvcc builds the kernels; the worker is stopped on every way out

    workers = multiprocessing.get_context("spawn").Pool(1)
    try:
        cpu_chain = workers.apply_async(phase4_chain, ("cpu", 2))
        return run_phases(dev, cpu_chain)
    finally:
        workers.terminate()
        workers.join()


def run_phases(dev, cpu_chain):
    from jwas_tpu_torch import _build
    from jwas_tpu_torch.io.pedigree import _inbreeding_meuwissen_luo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say("== phase 1: device and build")
    say(f"card: {card}")
    say(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    _build.library()
    say(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    t0 = time.perf_counter()
    _build.host_library()
    F = _inbreeding_meuwissen_luo(np.array([-1, -1, 0, 0, 2]), np.array([-1, -1, 1, 1, 3]))
    if not np.allclose(F, [0.0, 0.0, 0.0, 0.0, 0.25]):
        raise AssertionError(f"csrc/pedigree.cpp: inbreeding {F}")
    say(f"csrc/pedigree.cpp built with g++ and checked in {time.perf_counter() - t0:.1f} s")
    say("\n".join(line for line in _build.build_log.splitlines()
                  if "registers" in line or "spill" in line
                  or line.endswith(" s")))      # seconds a source
    for kernel, dtype, t, rows, regs, stores, loads in mt_registers(_build.build_log):
        say(f"{kernel} {dtype} t={t} " + (f"R={rows}" if rows else "constants") +
            f": {regs} registers, {stores} / {loads} bytes spill stores / loads")

    recs = phase2(dev)
    launches, kept = phase3(dev)
    launches["phase 4"] = phase4(dev, cpu_chain)
    launches["phase 5"] = phase5(dev, kept)
    launches["phase 6a"] = phase6a(dev, kept)
    launches["phase 6b"] = phase6b(dev, kept)
    launches["phase 15b"] = phase15b(dev, kept)
    del kept
    torch.cuda.empty_cache()
    launches.update(phase7(dev))
    launches.update(phase8(dev))
    launches["phase 9a"] = phase9a(dev)
    launches["phase 9b"] = phase9b(dev)
    launches["phase 9c"] = phase9c(dev)
    launches.update(phase10(dev))
    launches.update(phase13(dev))
    launches.update(phase14(dev))
    launches.update(phase15(dev))

    # launches: phase 3's (run_st, both methods), phase 4's (K6 of the
    # card's chains), phase 5's (runMCMC), phase 6's (runMCMC BayesB;
    # BayesC streamed with no group resident), phase 7's (runMCMC on dense
    # stores; the float64 builds' in 7d), phase 8's (runMCMC RR-BLUP,
    # BayesL, BayesA through K1; GBLUP K6 only), phase 9's (the animal
    # model beside the markers, pedigree BLUP, the card's chain of 9c),
    # phase 10's (K7 in 10a and 10c, K8 in 10b, K1 in the mega-trait run,
    # the float64 builds of K7 and K8 in 10e), phase 12's (K1, K3, K7 and
    # K8, the latter two with a per-marker prior in 12d and 12f); K6 in
    # every one
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name],
                    launches=sum(c.get(name, 0) for c in launches.values()),
                    launches_by_phase={ph: c.get(name, 0) for ph, c in launches.items()},
                    **recs[name]) for name in REPLACES]
    for k in kernels:                 # K7 / K8's per-marker prior's launches
        if "per_marker" in k:
            k["per_marker"]["launches"] = sum(c.get(k["name"] + "_pm", 0)
                                              for c in launches.values())
            k["per_marker"]["source"] = "jwas_tpu_torch/csrc/mt_inner_rounds_pm.cu"
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
