#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (vgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):

1. card identity: name and power limit, TF32 off, build the CUDA kernels
   (one ``nvcc`` per source, started together);
2. every kernel against its plain PyTorch version on the card, twice for
   identical bits: K1 at the fits' Grams and at ragged shapes in both of its
   modes (a: the epilogue in registers; b: d split over the card), K4 on
   the square panel, a rectangular panel at a nonzero row offset (its
   diagonal block exactly symmetric) and without an offset; then the
   kernel autograd Function against the dense torch MMD in all three
   backward regimes (stash, flash, panel, and the panel regime over four
   panels); the GoF
   kernel (K5) against its float64 plain version at the GoF path's own
   shape (17000 pooled rows, d=10240, 1002 indicator rows) and a ragged one
   in its full-Gram regime, and in its panel regime (forced by lowering
   ``GRAM_BUFFER_BYTES``) at a ragged shape with ten alphas (the stress
   width's recommended one, 1.1e9, among them) and at the
   stress width; the KNN-score kernels (K6 resident, K7 streaming) against
   their plain version at both ensembles' shapes and the RNA-Seq
   deployment's (801 x 20,531), both modes, with
   ``exclude_self`` at the ``predict`` batches, at ragged shapes and on
   tie-heavy integer rows (equal to the bit for 'kth'), each with an
   all-zero, a one-column and an all-column mask; the fused whole-fit kernel (K8) against its
   plain version with injected noise at the notebook shape, the gate's
   widest corner and two ragged shapes (each state leaf's change over the
   fit held, at a learning rate that moves it), its Philox noise's distribution,
   and its rng-mode fit against the fit fed that noise, to the bit; and the
   bf16-operand variants of K1-K4 (``gram_matmul_dtype='bfloat16'``, the
   tensor cores: TMA-fed ``wgmma`` in thread-block clusters) against their
   plain versions on the same bf16-rounded operands, each timed beside its
   f32 kernel with its bound and each pass's device time: K1 at the kl and
   flash fits' Grams, a ragged m past one wave of tile pairs and the panel
   fit's forward, K2 at the stress Gram, K3 at the kl Gram, at m=8192 and at
   a ragged m with d past 16 chunks, K4 on the square panel (with a ragged
   offset panel and an ordered one, d split in clusters), past half a wave
   (one CTA a tile) on a ragged d with an offset panel whose columns lie on
   both sides of its block and an ordered one with ragged rows, and on one
   real panel (m=45056, R=1472); and the multi-tensor Adadelta update
   against its plain path, to the bit, over the stress fits' generator and
   detector tensors (f32 and bf16 state, the encoder's device flag false and
   true, a misaligned and a ragged leaf beside them), timed beside its byte
   bound;
3. the no-kl main path at full width: ``VGAN_no_kl`` fit at the stress
   configuration (n=2000, d=10240, batch 500, 2 epochs), then
   generate_subspaces, approx_subspace_dist and check_if_myopic; every fit
   of phases 3-4 takes no plain-path Adadelta call, and those of phases 3,
   3b and 3h launch the Adadelta kernel once an update;
3b. the kl main path at full width: ``VGAN`` fit at the kl stress
   configuration (the same shape, 2 epochs: one detector and one generator
   epoch), the same fit on the dense torch path and with the reference
   quirks off, the detector's MMD and its gradient on the fitted model's
   own encodings through the kernels against the dense torch MMD,
   generate_subspaces and approx_subspace_dist, then
   check_if_myopic past the dense caps (count 8500 in float64, 5000 in
   float32, from 10000 rows) through K5, the float64 route held to a
   blockwise float64 oracle on the card and the float32 route to it; then
   the fit continued to its next detector epoch, whose frozen encoder (its
   flag false on the card) stays as it was;
3c. the subspace ensemble at full width, ``knn`` and ``knn_mean``:
   ``SubspaceEnsemble.from_model`` on the phase-3 stress model (500 sampled
   masks, 2000 x 10240 train rows, 500 test rows with 25 planted outliers),
   which runs K7 only, and the JAX package's bench ensemble (1024 masks,
   1000 x 500 rows, d=100, 25 planted outliers), which runs K6 only:
   decision_function, predict, decision_scores_ and labels_ through the
   public API, held to the same ensemble on the generic torch path, with the
   outliers' ROC AUC (asserted on the bench ensemble);
3d. the fused whole-fit path: ``VGAN_no_kl(fit_impl='fused')`` at the
   notebook configuration (d=10, n=2000, lr 0.001, 15 epochs) in one K8
   launch, in the loss and mask bands, then ``continue_fit`` on the scan
   path and a checkpoint restored into a fresh estimator on the card;
3e. the other native bases (lof, abod, cof, iforest, mahalanobis, copod,
   hbos, ecod), which launch no kernel: on the bench ensemble's data and
   masks (iforest at bench.py's 256 masks, 100 trees, chunk 32),
   decision_function, predict, decision_scores_ and labels_ on the card with
   the KNN counts at zero, the ROC AUC of the planted outliers held, the
   first 16 masks' raw scores held to each scorer function on the CPU and
   their ensemble to the same ensemble with device='cpu' (a disagreement of
   lof, abod or cof must be a near-tie of float64 distances), each base's
   decision_function time; then lof, iforest and copod on the stress
   ensemble (500 masks, 2000 x 10240 train rows);
3f. the heterogeneous ensemble with ``vgan_tpu``'s default members (knn,
   lof, ecod): ``HeterogeneousEnsemble.from_model`` on the phase-3 stress
   model (500 masks, 2000 x 10240 train rows), whose knn member runs K7
   only: decision_function under 'average', 'select' and 'vote', predict,
   predict_proba, decision_scores_ and labels_, each with its KNN launches
   counted (one a call; labels_ none) and timed, held to a float64 numpy
   recombination of the members' own outputs; then the knn member
   distilled (one float64 eigh of 10752 x 10752) and scored with no KNN
   launch. On the bench data (1024 masks, K6 only): all six combinations,
   held the same way, ROC AUC asserted, predict, a JL member placed first,
   every member distilled and each distiller held to a float64 host run;
   every ensemble on the first 16 masks against the same ensemble with
   device='cpu' (labels equal except on rows whose host score sits within
   the allowed move of its threshold);
3g. serving and the CLI at full width: ``vgan_tpu_torch.cli.main`` in
   this process on the stress rows, ``fit --epochs 2`` (8 K2 launches,
   ``.pt`` files), ``sample``, ``check-myopic``, ``score --base knn`` (one K7
   launch, held to the API's decision_function) and ``export``, and one
   ``python3 -m vgan_tpu_torch sample`` subprocess; the stress sampler's
   ``torch.export`` program (masks equal to generate_subspaces to the bit)
   and the stress knn ensemble's (the generic path, held to the live K7 call
   within phase 3c's limit), each with its export seconds, artifact size
   and call time; on the bench data the per-subspace knn program (against
   K6 within phase 2's bound), the heterogeneous programs (knn, lof, ecod:
   'average', 'select', knn distilled) within phase 3f's row limits, and
   the iforest, loda and ocsvm programs on 16 masks within phase 3e's. Each
   loaded program is called twice for the same bits and launches no kernel;
3h. the multi-device paths in a world of one: an NCCL group of one rank
   over loopback and a ``make_mesh(data=1, model=1)`` mesh; the
   data-parallel no-kl and kl stress fits with ``shard_features`` (K2 8
   launches; K1 and K3), their loss histories held to phases 3 and 3b; the
   dp no-kl fit again with the three bf16 options (K2 bf16 8 launches),
   held in phase 3i to the single-device fit with them, to the bit;
   ``check_if_myopic`` on the kl mesh model at phase 3b's counts (K5 on the
   sharded permutation rows), its p-values equal to phase 3b's; the stress
   (K7) and bench (K6) knn ensembles with ``mesh=`` under 'average' and
   'max', and split into four mask shards and into three (which pads the
   pool with zero-weight masks) run in turn, held to the unsharded calls
   within phase 3c's limit; the CLI's
   ``fit --mesh data=1 --shard-features`` (K2) and ``score --mesh data=1
   --base knn`` (K7); ``python3 -m vgan_tpu_torch._dryrun 4``;
3i. the bf16 options, all three together, at the stress width: the no-kl
   stress fit (K2's bf16 variant, 8 launches, no f32 one), one kl cycle (K1's
   and K3's) and a one-epoch panel fit (K1's and K4's), each held to the
   same fit on the dense torch path with the same options, the first two
   also to phases 3 and 3b within vgan_tpu's own rtol 0.08 of the f32 fit;
4. the other regimes through ``fit`` (d=1024 flash; d=10240 with the K'
   stash off, panel), and the d=10 notebook configuration of both
   estimators, which runs no kernel. Every kernel fit's losses are held
   against the same fit on the dense torch path;
5. CUDA-event times of each kernel and its plain version, bounds (K1 and
   K3 also at m=40960 in the flash regime, each with its peak memory beside
   z's bytes and held to its plain version evaluated in row blocks; K1 also
   at the panel fit's forward; K4 also on one real panel, m=45056, R=1472;
   K8: a
   2000-epoch fused fit at the notebook shape, its plain version over the
   first 20 epochs, the scan path's steps/s there, and the corner's time
   per step), the
   stress fits' steps/s, both ensembles' API-level subspace-scorings/s, and
   a profiler breakdown of one no-kl stress epoch and of one kl detector and
   one kl generator epoch by device kernel, with the device's busy share;
   the stress fits' steps/s with the bf16 options beside them, for
   information.
   K8's phase timer gives each phase's microseconds a step at both fused
   shapes. Phase 3e's times are repeated there.

Prints a JSON line of the kernels, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
CUDA device. Imports nothing of JAX or ``vgan_tpu``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): non-tensor float32 rate and
# HBM3 bandwidth, the denominators of the bounds below.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Operations per Gram pair beside the distance product (d2 assembly, one
# exp, the integer-power ladder and its sums), counted into the bounds.
OPS_PER_ENTRY = 20

STRESS = dict(n=2000, d=10240, batch=500)  # bench.py's "no-kl stress" and "kl stress" shape
# the stress fits' Adadelta (the no-kl estimator's lr; torch's rho and eps)
ADADELTA = dict(rho=0.9, eps=1e-6, lr=0.007, wd=0.04)
# check_if_myopic on the kl path: counts past both dense caps (pooled rows
# 17000 > 16384 on the float64 route, 10000 > 8192 on the float32 route),
# sampled from this many rows of the stress width
GOF_ROWS, GOF_COUNT_F64, GOF_COUNT_F32 = 10000, 8500, 5000
GOF_PERMUTATIONS = 1000  # check_if_myopic's default
GOF_ALPHAS = (0.01, 1.0)
# the alpha check_if_myopic adds at the stress width: the frozen training
# bandwidth passed as an alpha (the reference quirk), 1.101283e+09 in phase
# 3b's runs on the H100; phase 2 holds K5's panel regime at it too
GOF_RECOMMENDED_ALPHA = 1.1e9
ORACLE_PERMUTATIONS = 64

# phase 3h: the ensembles' mask axis split into these many shards, whose
# per-rank bodies run in turn on the one card; 4 divides the stress and
# bench pools, 3 leaves zero-weight padding masks in the last shard
MESH_SHARDS = (4, 3)

# Tolerances, each with its reason:
# quadrant sums: same f32 inputs, sums of m^2 positive terms; the kernel and
# the plain version differ only in summation order (d-chunk FMA order and
# the reduction tree), a few ulp of the terms each, far below 1e-5.
RTOL_SUMS = 1e-5
# K' entries: ulp-level differences of exp and of the d2 dot product;
# atol covers entries near 0 (K' ~ 1/bw ~ 1e-4 at the stress shape).
RTOL_KP, ATOL_KP = 1e-5, 1e-7
# gradients and S @ z: signed sums over m terms that partly cancel, so the
# error is held against the largest entry, not entrywise.
GRAD_FRAC = 1e-4
# K3 at m=40960 (both halves drawn from one distribution) against its plain
# version's f32 S summed in float64: rowsum(S) and S @ z cancel there, so an
# error held to the largest entry measures the cancellation, not the kernel
# (on an H100 the kernel, the earlier 64 x 64 design and a TF32 control all
# read 4e-4 to 5e-4 of the largest entry). Each entry is held instead to this
# fraction of the sum of its terms' magnitudes: there the two f32 kernels
# read 3.8e-7 and 5.2e-7 and the TF32 control 1.2e-5, which the check must
# refuse.
TERM_FRAC = 2e-6
# phase 3h's fits in a world of one against phases 3 and 3b: every
# collective is over one rank and the step's arithmetic is the
# single-device step's, so the histories are expected equal to the bit; a
# sum ordered otherwise may move them by a few ulp, far below this.
RTOL_MESH_FIT = 1e-5
# the fit's per-epoch losses on the kernel path vs the dense torch path:
# eight Adadelta steps compound f32 rounding differences of ~1e-6.
RTOL_FIT_LOSS = 1e-3
# K5's C planes against the plain version in float64 on the same f32
# values: the kernel's Kahan-compensated f32 accumulation keeps about one
# ulp of |C|, far below this fraction of max|C| per alpha.
C_FRAC = 1e-5
# the float64 GoF route against a blockwise float64 oracle on the same
# permutations: the statistic is a difference of Gram means of order one,
# and the route's per-entry f32 kernel values move it by far less than
# this; the p-value may move by the ties this shift can flip, at most two
# permutations' worth.
ORACLE_STAT_ATOL = 1e-6
ORACLE_P_ATOL = 2.0 / ORACLE_PERMUTATIONS
# the float32 route's statistic against the float64 route's: its final sums
# of O(m^2) entries are f32, and the statistic is their near-cancellation.
F32_STAT_RTOL = 5e-2
# K6 / K7 squared 'kth' scores against the plain version, as a fraction of
# max(an + bn), the scale at which the expansion (an + bn) - 2 cross
# cancels: the two sum the masked norms and the cross product in other
# orders, a few ulp of that scale at d <= 3000. At d = 10240 the sums have
# ten times the terms (typical rounding sqrt(d) 2^-24, about 6e-6 of the
# scale), so the bound there is ten times wider. A 'mean' score averages the
# sqrt of the k smallest d2, each within the same eps (order statistics move
# no more than their inputs), and |sqrt(a) - sqrt(b)| <= min(sqrt(eps),
# eps / sqrt(b)), with b at least the nearest neighbour's d2 b1: so 'mean' is
# held to min(sqrt(eps), eps / sqrt(b1)) per score, b1 from the plain version
# at k = 1 (a duplicated row has b1 = 0). On small-integer rows every d2 is exact:
# 'kth' must be equal to the bit, 'mean' (k square roots summed in another
# order) within KNN_MEAN_RTOL_EXACT.
KNN_D2_FRAC, KNN_D2_FRAC_WIDE, KNN_WIDE_D = 1e-5, 1e-4, 4096
KNN_MEAN_RTOL_EXACT = 1e-6
# the ensembles' decision_function on the kernel path against the generic
# torch path: per-subspace scores agree to the bounds above, and the
# z-score divides each subspace's error by that subspace's spread over the
# test rows; held to this fraction of the largest aggregated score.
ENSEMBLE_FRAC = 1e-4
# the bench ensemble's 25 planted outliers (rows scaled by 3 at d=100, masks
# of about 30 features) are far from the Gaussian rows in every subspace
BENCH_AUC_MIN = 0.95
# K8 against its plain version: the same f32 steps with other summation
# orders (block partials, FMA contraction); a dozen Adadelta steps compound
# them, so each state leaf's change over the fit is held to a fraction of
# its largest change. At this learning rate a step moves a parameter by up
# to about lr * 3e-3, so a dozen steps move each params leaf by about 4e-3,
# and the limit, a thousandth of that, stays about 60x the f32 spacing of a
# leaf near 0.5. (At the fit's lr 0.001 the whole change would be smaller
# than such a limit on the values themselves.)
FUSED_LOSS_RTOL, FUSED_BW_RTOL, FUSED_LEAF_FRAC = 1e-4, 1e-5, 1e-3
FUSED_CHECK_LR = 0.1
# the fused fit at the notebook configuration (the verify skill's bands)
NOTEBOOK_FIT = dict(epochs=15, lr=0.001)
FUSED_TIMED_EPOCHS = 2000  # the reference's default epochs
FUSED_PLAIN_EPOCHS = 20  # the plain version's eager steps, timed over the fit's first epochs
SCAN_TIMED_EPOCHS = 50
FUSED_CORNER = dict(n=8192, d=128, bs=1000, epochs=20)  # K8's time per step at the gate's corner
# The bf16-operand variants of K1-K4 (phase 2) are held to their plain
# versions on the same bf16-rounded operands with the f32 kernels' limits:
# the products of bf16 values are exact in f32, and the variants add each
# mma's 16-term sum into IEEE f32 accumulators, so only the order of the
# sums differs (quadrant sums RTOL_SUMS, K' RTOL_KP and ATOL_KP, S @ z and
# rowsum(S) GRAD_FRAC of their largest entry).
# the tensor cores' dense bf16 rate (NVIDIA data sheet, H100 SXM): the
# bf16 variants' distance products are bound by it, the rest by the f32 rate
PEAK_BF16_FLOPS = 989e12
BF16_OPTIONS = dict(gram_matmul_dtype="bfloat16", model_matmul_dtype="bfloat16",
                    opt_state_dtype="bfloat16")
# phase 3i: a bf16-option fit on the kernels is held to the same fit on the
# dense torch path with the same options at RTOL_FIT_LOSS, as the f32 fits
# are: the two MMDs differ at the f32 level only, and the bf16 layers and
# state see the same values on both paths (9.3e-7 apart on an H100 in this
# phase's first run). Against the f32 fit, vgan_tpu's own limit for the
# options (test_bf16_model_and_opt_state_fit_close_to_f32).
RTOL_BF16_VS_F32 = 0.08
N_OUTLIERS = 25
# phase 5's large Gram shapes: K1 in the flash regime at m=40960 (mode (a)),
# and K4 on one real panel of the panel regime (m=45056: (M, M) K' no longer
# fits the 7 GiB stash; R = _panel_rows(m) = 1472)
K1_LARGE = (20480, 20480, 1024)
# the flash fit's timed epochs (4 steps each) in flash_fit_rates: the fit is
# host-bound, and over 4 epochs its steps/s spread almost 2x within each side
FLASH_FIT_EPOCHS = 64
K4_REAL_PANEL = dict(n1=22528, n2=22528, d=10240, offset=0)
# a plain version is timed only where its whole-Gram temporaries, about
# this many (m, m) f32 arrays at its peak, fit in PLAIN_MAX_BYTES
PLAIN_GRAM_ARRAYS, PLAIN_MAX_BYTES = 10, 24 << 30
BENCH_ENSEMBLE = dict(n_train=1000, n_test=500, d=100, n_masks=1024, k=10)  # bench.py:414-419
STRESS_ENSEMBLE = dict(subspace_count=500, n_test=500, k=10)
# the RNA-Seq deployment's score cell (benchmarks/configs/
# vgan_no_kl.rnaseq.d20531.json, traffic score.b500): K7 at d = 20,531
RNASEQ_ENSEMBLE = dict(n_train=801, n_test=500, d=20531, n_masks=500, k=10)
# phase 3f: the heterogeneous ensemble with the JAX package's default members
# (knn, lof, ecod) at the stress width and on the bench data; the bench
# ensemble's every combination ('weighted' with HETERO_WEIGHTS), one with a
# JL member placed first, and distillers of DISTILL_FEATURES random features
HETERO_MEMBERS = ({"base": "knn"}, {"base": "lof"}, {"base": "ecod"})
HETERO_COMBINATIONS = ("average", "max", "median", "select", "weighted", "vote")
HETERO_WEIGHTS = (3.0, 1.0, 1.0)
HETERO_JL = {"base": "knn", "jl_dim": 20}
DISTILL_FEATURES = 512
# The combination on the card against a float64 numpy recombination of the
# same members' outputs: both standardize the same f32 scores in float64 and
# round them to f32, where the reduction orders can differ by one ulp (6e-8
# of a standardized score of at most a few units), then combine in float64
# and round once more; held to this fraction of the largest combined score.
# 'vote' sums 0/1 labels: equal. 'select''s weights: within HETERO_W_ATOL.
HETERO_FRAC, HETERO_W_ATOL = 1e-6, 1e-6
# A distiller on the card (float32 features, float64 solve) against a float64
# host run on the same draws and train scores: the features' f32 rounding
# reaches the predictions through a ridge-regularized solve, 3.1e-7 of the
# largest prediction at most on the bench data on the CPU (nine fits of the
# three members); held to 30 times that. The GCV pick must be the float64
# run's unless its two smallest values lie within GCV_MARGIN_MIN (relative),
# a hundred times what that rounding moves them.
DISTILL_FRAC, GCV_MARGIN_MIN = 1e-5, 1e-4
# phase 3e: the other native bases on the bench ensemble's data and masks,
# at their default knobs; iforest at bench.py's own configuration
# (bench.py:472-493); kpca (the full kernel, pyod's default: one (1000, 1000)
# eigh a mask), ocsvm (300 FISTA steps of 60 bisection steps, a few hundred
# launches a step), ae and dsvdd (50 Adam epochs) on the first
# FEW_MASKS masks; lof, iforest, copod and the matmul-shaped kde, cblof,
# gmm, loda, inne, sampling, lmdd and sod once more on the stress ensemble
# (mcd, pca and kpca would factor a (10240, 10240) matrix a mask; ocsvm and
# sos are 300 x 60 and 64 launch-bound steps over (2000, 2000) kernels a
# mask; ae and dsvdd would train 50 epochs of a (2000, 10240) autoencoder a
# mask)
OTHER_BASES = ("lof", "abod", "cof", "iforest", "mahalanobis", "copod", "hbos", "ecod",
               "mcd", "pca", "kpca", "cblof", "gmm", "kde", "loda", "inne", "sampling", "sod",
               "lmdd", "ocsvm", "sos", "ae", "dsvdd")
NEIGHBOR_BASES = ("lof", "abod", "cof")
IFOREST_BENCH = dict(n_masks=256, n_trees=100, chunk=32)
FEW_MASKS, FEW_MASK_BASES = 128, ("kpca", "ocsvm", "ae", "dsvdd")
# phase 3g: the bench data's per-subspace and heterogeneous programs
SERVING_MASKS = 32
STRESS_BASES = ("lof", "iforest", "copod", "kde", "cblof", "gmm", "loda", "inne", "sampling",
                "lmdd", "sod")
# The card against the host: the pool's first CHECK_MASKS masks (the whole
# pool of the index-reading bases takes minutes on the host's CPU).
CHECK_MASKS = 16
# Each base's raw scores on the card against its scorer function on the CPU,
# in float64 where the score is a continuous function of the distances:
# lof, abod and mahalanobis carry the f32 rounding of d2 (within
# KNN_D2_FRAC of max(an + bn)) through a few divisions, far below 1e-4; cof
# forms its pair distances by the identity |a_i - a_j|^2 = sq_i + sq_j -
# 2 dots, which cancels in f32 to about sqrt(2^-24) of the root distance, and
# its ratio of two chaining sums doubles that (the JAX package's own tests
# absorb it at 1e-3); copod and ecod sum f32 logarithms of exact count
# fractions over the selected dimensions. iforest and hbos make discrete
# decisions on f32 arithmetic (a split threshold, a bin number) as the JAX
# package does in the input's f32: their reference is the CPU in float32,
# where every decision is the same, and only the logarithms and the mean over
# trees round differently.
# The parametric bases, each against float64: kde's log-kernel terms carry
# the f32 distances' error (the neighbour bases' bound), small beside its
# scores of about 50;
# cblof's distances to centroids that are means of the same assigned rows,
# and mcd's Cholesky of a well-conditioned (d, d) covariance, round as one
# f32 product does; gmm carries 30 EM iterations of f32 responsibilities
# (1.6e-5 measured on an H100); pca divides each component
# distance by its explained-variance ratio, from an f32 eigh (Jacobi on the
# card), and kpca each squared projection by its (1000, 1000) kernel
# eigenvalue (both measured under 1e-5). cblof's assignments, mcd's
# h-subsets and reweighting, and pca's component signs are discrete
# decisions on f32 arithmetic: a mask where the float64 run takes one of
# them within DECISION_REL of flipping (the scorers' ``margins``) is
# "decision-exposed"; every other mask takes the host's decisions, so
# float64 holds there. cblof's margin is relative to |x|^2 + max |c|^2, and
# an f32 distance over s <= 100 active columns is within s 2^-24 of that
# (3e-6 covers s = 50; the bench masks select about 30); mcd's distances
# and pca's coefficients sat within 1e-6 and 1e-5 of float64 on an H100,
# ten times which are their limits.
# The bases of PR 11. loda decides its bins on f32 projections, as hbos does
# on f32 values: its reference is the CPU in float32, whose densities and
# logarithms round differently, and whose projections round otherwise: a
# train projection that changes bins moves one count by 1, and a query in
# that bin by |log(1 + 1/c)| / P, under the limit for c >= 20 of the P = 100
# directions (a query's own bin is a decision, below). sampling is the
# square root of one f32 distance (within s 2^-24 of |x|^2 + |y|^2
# relative). sod's reference
# means and variances are short sums of exact row values, and its score
# the root of a sum of squared deviations, which loses relative precision
# only where a query sits near its reference mean (the absolute floor
# covers that); lmdd's closed forms sum squared deviations from a mean of
# 1000 rows. inne's ratios 1 - r2' / r2 carry two f32 distances' error. ocsvm
# solves a QP by 300 f32 FISTA steps whose kernel carries the distances'
# error, and its offset averages f(x) over the margin support vectors, a set
# that can change by a vector near its tolerance (f there equals the offset
# to the solver's precision). sos finds each row's beta by 64 f32 bisection
# steps on an entropy that carries the distances' error, then multiplies
# 1000 binding complements. ae and dsvdd train 50 f32 Adam epochs, whose
# normalized step moves a weight of near-zero gradient by +-lr on the sign
# of its rounding (up to sqrt(50) lr = 7e-3 of drift; 1e-3 relative seen on
# an H100). The first chip run of these limits saw at most, of the largest
# score: sampling 1.6e-7, inne 1.3e-7, sod 8.0e-8, lmdd 9.0e-8, loda
# 1.8e-7, ocsvm 4.8e-7, sos 8.2e-6.
# Decisions (the margins of each float64 host run, relative as each scorer
# says; DECISION_REL): a query's loda bin, its projection against the bin
# edges, each within s 2^-24 of sum_j |x_j w_j| (s <= 80 active columns, the
# edges' own error twice that: 2e-5); inne's coverage tests and
# covering-ball choice, and sod's neighbour places and variance test, on
# distances within 2 (s + 2) 2^-24
# of the rows' squared norms on either side of the gap; dsvdd's centre snap
# (|c| against 0.1 and its sign) on mean embeddings of two f32 layers.
RAW_RTOL = dict(lof=1e-4, abod=1e-4, cof=1e-3, mahalanobis=1e-4, copod=1e-5, ecod=1e-5,
                iforest=1e-5, hbos=1e-5, kde=1e-5, cblof=1e-5, mcd=1e-5, gmm=1e-4, pca=1e-4,
                kpca=1e-4, loda=1e-4, inne=1e-5, sampling=1e-5, sod=1e-5, lmdd=1e-5,
                ocsvm=1e-4, sos=1e-4, ae=1e-2, dsvdd=1e-2)
RAW_ATOL_FRAC = 1e-5
RAW_F32_BASES = ("iforest", "hbos", "loda")
DECISION_REL = dict(cblof=3e-6, mcd=1e-5, pca=1e-4, loda=2e-5, inne=5e-5, sod=3e-5,
                    dsvdd=3e-4)
# pca's batched eigh launches about 186 kernels a mask (190,000 a call at
# 1024 masks), which take the profiler some 35 s to gather: its device
# share is read from a call over its first PROFILE_MASKS masks (one chunk).
# ocsvm launches about 150,000 kernels a chunk whatever its size (300 FISTA
# steps of 60 bisection steps): one chunk of 25 masks; sos about 900 a
# chunk of 12: 128 masks.
PROFILE_MASKS = dict(pca=128, ocsvm=25, sos=128)
# ROC AUC of the planted outliers that the JAX package (vgan_tpu) gives on
# the CPU on the same data, masks and configuration
# (examples/jax_base_auc.py): 1.0 for every base, so each is held to
# BENCH_AUC_MIN
JAX_BENCH_AUC = dict(lof=1.0, abod=1.0, cof=1.0, iforest=1.0, mahalanobis=1.0, copod=1.0,
                     hbos=1.0, ecod=1.0, mcd=1.0, pca=1.0, kpca=1.0, cblof=1.0, gmm=1.0,
                     kde=1.0, loda=1.0, inne=1.0, sampling=1.0, sod=1.0, lmdd=1.0, ocsvm=1.0,
                     sos=1.0, ae=1.0, dsvdd=1.0)
# lof, abod and cof read neighbour sets (cof also their order). The card and
# the CPU form d2 = an + bn - 2 cross in f32, in other summation orders: each
# within (s + 2) 2^-24 2 (an + bn) of the exact value, s the mask's selected
# columns (the sums' forward error bound), so two neighbours whose float64 d2
# lie within twice the sum of their bounds can change places between them:
# such a (mask, row) is "tie-exposed". A raw
# score beyond the tolerance above must be tie-exposed: for lof, a gap at the
# k-th place of the row's own list or of one of its neighbours' (their lrd
# reads their sets); for abod, of the row's own; for cof, a gap anywhere in
# the first k + 1 places of the row's list or of a neighbour's (the chain
# reads the order). Aggregated, a row is held to ENSEMBLE_FRAC of the largest
# score plus, for each mask where it is tie-exposed, that mask's weight times
# its z-score range (how far one changed neighbour set can move the row's
# z-score).


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed no card")
    return out[0].strip()


def make_pair(n1: int, n2: int, d: int, seed: int, device):
    """x ~ N(0, 1); y = a masked copy of other rows, as the no-kl loss
    compares a batch with its projection."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n1, d), dtype=np.float32)
    keep = (rng.random(d) < 0.5).astype(np.float32)
    y = rng.standard_normal((n2, d), dtype=np.float32) * keep
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def gram_inputs(n1, n2, d, seed, device):
    from vgan_tpu_torch.ops import mmd as M

    x, y = make_pair(n1, n2, d, seed, device)
    z = torch.cat([x, y]).contiguous()
    norms = torch.sum(z * z, dim=1)
    bw = M.candidate_bandwidth(z).to(torch.float32)
    return x, y, z, norms, bw


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def assert_close(name, got, want, rtol, atol=0.0) -> float:
    err = max_abs(got, want)
    ok = bool(torch.all(torch.abs(got - want) <= atol + rtol * torch.abs(want)))
    check(ok, f"{name}: kernel disagrees with the plain version (max abs err {err:.3e})")
    return err


def assert_frac(name, got, want, frac) -> float:
    err = max_abs(got, want)
    lim = frac * float(torch.max(torch.abs(want)))
    check(err <= lim, f"{name}: max abs err {err:.3e} > {lim:.3e}")
    return err


def repeat_identical(name, fn) -> None:
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    sync()
    for u, v in zip(a, b):
        check(torch.equal(u, v), f"{name}: two runs gave different bits")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_panel(name, z, norms, bw, mults, r0, r1, offset, cols_t) -> float:
    """K4 on rows r0:r1 of z against all of z, with ``offset`` (then r0 ==
    offset, and the diagonal block must come out exactly symmetric) or
    without (ordered tiles), held to the plain version; twice for
    identical bits. Returns the max abs error."""
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    zr, nr = z[r0:r1], norms[r0:r1]

    def run():
        return G.kprime_panel(zr, z, nr, norms, bw, mults, offset=offset, cols_t=cols_t)

    p_k = run()
    p_p = G.kprime_panel_reference(zr, z, nr, norms, bw, mults)
    err = assert_close(name, p_k, p_p, RTOL_KP, ATOL_KP)
    if offset is not None:
        block = p_k[:, offset:offset + (r1 - r0)]
        check(torch.equal(block, block.T), f"{name}: K' of the diagonal block is not symmetric")
    repeat_identical(name, run)
    return err


def phase_kernels(device, gram_shapes, flash_shapes, log):
    """Each kernel against its plain version; returns the max abs error of
    each kernel at each shape, keyed ``(name, (n1, n2, d))``. ``gram_shapes``:
    (n1, n2, d, K1's expected mode or None)."""
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    mults = M.bandwidth_multipliers()
    sms = G._sms(device)
    errs = {}
    for n1, n2, d, want_mode in gram_shapes:
        shape = (n1, n2, d)
        m = n1 + n2
        _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=11, device=device)
        tag = f"({n1}+{n2}, d={d})"

        mode = G.tile_schedule(G.tile_pairs(m), d, sms)[0]
        check(want_mode in (None, mode), f"K1 {tag} takes mode ({mode}), expected ({want_mode})")
        s_k = G.gram_quadrant_sums(z, norms, bw, n1, mults)
        s_p = G.gram_quadrant_sums_reference(z, norms, bw, n1, mults)
        errs["gram_quadrant_sums", shape] = assert_close(
            f"gram_quadrant_sums {tag} mode ({mode})", s_k, s_p, RTOL_SUMS)
        repeat_identical("gram_quadrant_sums", lambda: G.gram_quadrant_sums(z, norms, bw, n1, mults))

        (s_k, kp_k) = G.gram_quadrant_sums_stash(z, norms, bw, n1, mults)
        (s_p, kp_p) = G.gram_quadrant_sums_stash_reference(z, norms, bw, n1, mults)
        e1 = assert_close(f"gram_quadrant_sums_stash sums {tag}", s_k, s_p, RTOL_SUMS)
        e2 = assert_close(f"gram_quadrant_sums_stash kp {tag}", kp_k, kp_p, RTOL_KP, ATOL_KP)
        errs["gram_quadrant_sums_stash", shape] = max(e1, e2)
        repeat_identical("gram_quadrant_sums_stash",
                         lambda: G.gram_quadrant_sums_stash(z, norms, bw, n1, mults))

        # K4: the square panel as the panel backward calls it at m <= R
        # (offset 0), a rectangular panel at a nonzero offset (C = m ragged,
        # columns on both sides of its diagonal block), both on one
        # column-major copy of z; then as a plain call, without an offset or
        # a copy (ordered tiles): the full square and a ragged row panel
        cols_t = G.panel_operand(z)
        modes = []
        errs["kprime_panel", shape] = 0.0
        for r0, r1, offset in ((0, m, 0), (256, 576, 256), (0, m, None), (37, min(m, 337), None)):
            blocks = G.panel_blocks(r1 - r0, m, offset)
            modes.append(G.tile_schedule(blocks, d, sms)[0])
            e = check_panel(f"kprime_panel rows {r0}:{r1} offset {offset} {tag} mode ({modes[-1]})",
                            z, norms, bw, mults, r0, r1, offset,
                            cols_t if offset is not None else None)
            errs["kprime_panel", shape] = max(errs["kprime_panel", shape], e)
        log(f"  K1 (mode {mode}) K2 K4 (modes {', '.join(modes)}) {tag}: ok")

    for n1, n2, d in flash_shapes:
        _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=12, device=device)
        tag = f"({n1}+{n2}, d={d})"
        sz_k, rs_k = G.gram_backward_flash(z, norms, bw, n1, n2, mults)
        sz_p, rs_p = G.gram_backward_flash_reference(z, norms, bw, n1, n2, mults)
        e1 = assert_frac(f"gram_backward_flash sz {tag}", sz_k, sz_p, GRAD_FRAC)
        e2 = assert_frac(f"gram_backward_flash rs {tag}", rs_k, rs_p, GRAD_FRAC)
        errs["gram_backward_flash", (n1, n2, d)] = max(e1, e2)
        repeat_identical("gram_backward_flash",
                         lambda: G.gram_backward_flash(z, norms, bw, n1, n2, mults))
        mode, _, nsplit = G.flash_schedule(n1 + n2, d, sms)
        log(f"  K3 {tag} mode ({mode}), {nsplit} splits: ok")
    return errs


def bf16_bound(mma_ops: float, f32_ops: float, nbytes: float):
    """A bf16 variant's bound: its products on the tensor cores at the bf16
    rate (the distance product; K3 bf16's S @ z too, which it runs there
    through the exact three-term split of S) plus its other operations at
    the f32 rate, or its bytes at the HBM rate, whichever is larger, in ms.
    K1, K2 and K3 bf16 read the f32 z (4 bytes a value: they round it on the
    card); K4 bf16 reads its prepared bf16 operands (2 bytes)."""
    t_ops = (mma_ops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_bf16_kernels(device, shapes, log) -> dict:
    """Each bf16-operand variant (K1-K4) against its plain version on the
    same bf16-rounded operands and the f32 rows' norms, twice for identical
    bits, timed (CUDA events) beside its f32 kernel and its plain version on
    the same inputs in this call, with its bound. ``shapes``: name -> the
    (n1, n2, d) it is held at, the main path's first. Returns each variant's
    row of the kernels line, less its launches."""
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    mults = M.bandwidth_multipliers()
    sms = G._sms(device)
    rows = {}

    def record(name, label, fn, f32, plain, err, tol, mma_ops, f32_ops, nbytes, iters=20,
               old_count=None):
        warmup = 1 if iters < 20 else 3
        t = {"shape": label, "ms": cuda_ms(fn, iters, warmup), "f32_ms": cuda_ms(f32, iters, warmup),
             "plain_ms": cuda_ms(plain, iters, warmup), "max_abs_err": err, "tol": tol}
        t["bound_ms"], t["bound_by"] = bf16_bound(mma_ops, f32_ops, nbytes)
        old = ""
        if old_count:  # the bound as counted before (K3 bf16: S @ z at the f32 rate)
            t["bound_ms_old_count"] = bf16_bound(*old_count)[0]
            old = f"; {t['bound_ms_old_count']:.4f} ms with S @ z at the f32 rate"
        t["device_us"] = device_split(fn, calls=10)  # each pass's device time
        passes = "; device us a call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(t["device_us"].items(), key=lambda kv: -kv[1]))
        log(f"  {name} {label}: {t['ms']:.4f} ms (f32 kernel {t['f32_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']}{old})"
            f"{passes}; max abs err {err:.3e} ({tol})")
        if name in rows:
            rows[name]["at_other_shapes"].append(t)
        else:
            rows[name] = dict(t, at_other_shapes=[])

    sums_tol, kp_tol = f"rtol {RTOL_SUMS}", f"rtol {RTOL_KP} atol {ATOL_KP}"
    for n1, n2, d in shapes["gram_quadrant_sums_bf16"]:
        _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=41, device=device)
        m, zr = n1 + n2, G.rounded(z)
        slices = G.cluster_schedule(G.tile_pairs(m), d, sms)[0]
        err = assert_close(f"gram_quadrant_sums_bf16 m={m} d={d}",
                           G.gram_quadrant_sums_bf16(z, norms, bw, n1, mults),
                           G.gram_quadrant_sums_reference(zr, norms, bw, n1, mults), RTOL_SUMS)
        repeat_identical("gram_quadrant_sums_bf16",
                         lambda: G.gram_quadrant_sums_bf16(z, norms, bw, n1, mults))
        pairs = sym_pairs(m)
        record("gram_quadrant_sums_bf16", f"m={m} d={d}, {slices} CTAs a cluster",
               lambda: G.gram_quadrant_sums_bf16(z, norms, bw, n1, mults),
               lambda: G.gram_quadrant_sums(z, norms, bw, n1, mults),
               lambda: G.gram_quadrant_sums_reference(zr, norms, bw, n1, mults), err, sums_tol,
               2 * pairs * d, OPS_PER_ENTRY * pairs, 4 * m * d + 4 * (m + 1 + 4))
    for n1, n2, d in shapes["gram_quadrant_sums_stash_bf16"]:
        _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=42, device=device)
        m, zr = n1 + n2, G.rounded(z)
        s_k, kp_k = G.gram_quadrant_sums_stash_bf16(z, norms, bw, n1, mults)
        s_p, kp_p = G.gram_quadrant_sums_stash_reference(zr, norms, bw, n1, mults)
        e_sums = assert_close(f"gram_quadrant_sums_stash_bf16 sums m={m} d={d}", s_k, s_p, RTOL_SUMS)
        e_kp = assert_close(f"gram_quadrant_sums_stash_bf16 kp m={m} d={d}", kp_k, kp_p, RTOL_KP,
                            ATOL_KP)
        err = max(e_sums, e_kp)
        check(torch.equal(kp_k, kp_k.T), f"gram_quadrant_sums_stash_bf16 m={m}: K' is not symmetric")
        rel = float(torch.max(torch.abs(s_k - s_p)[0, :3] / torch.abs(s_p)[0, :3]))
        log(f"  gram_quadrant_sums_stash_bf16 m={m} d={d} (the tensor cores sum 64 products "
            f"before each f32 fold): K' max abs err {e_kp:.3e} (max|K'| "
            f"{float(torch.max(torch.abs(kp_p))):.3e}), sums max rel err {rel:.3e}; K' symmetric "
            f"to the bit")
        repeat_identical("gram_quadrant_sums_stash_bf16",
                         lambda: G.gram_quadrant_sums_stash_bf16(z, norms, bw, n1, mults))
        pairs = sym_pairs(m)
        slices = G.cluster_schedule(G.tile_pairs(m), d, sms)[0]
        record("gram_quadrant_sums_stash_bf16", f"m={m} d={d}, {slices} CTAs a cluster",
               lambda: G.gram_quadrant_sums_stash_bf16(z, norms, bw, n1, mults),
               lambda: G.gram_quadrant_sums_stash(z, norms, bw, n1, mults),
               lambda: G.gram_quadrant_sums_stash_reference(zr, norms, bw, n1, mults),
               err, f"sums {sums_tol}; kp {kp_tol}", 2 * pairs * d, OPS_PER_ENTRY * pairs,
               4 * m * d + 4 * (m + 1 + 4 + m * m))
    for n1, n2, d in shapes["gram_backward_flash_bf16"]:
        z, norms, bw = large_gram_inputs(n1 + n2, d, 43, device)
        m, zr = n1 + n2, G.rounded(z)
        cluster, groups, nsplit = G.flash_cluster_schedule(m, d, sms)
        sz_k, rs_k = G.gram_backward_flash_bf16(z, norms, bw, n1, n2, mults)
        sz_p, rs_p = G.gram_backward_flash_reference(zr, norms, bw, n1, n2, mults)
        err = max(assert_frac(f"gram_backward_flash_bf16 sz m={m} d={d}", sz_k, sz_p, GRAD_FRAC),
                  assert_frac(f"gram_backward_flash_bf16 rs m={m} d={d}", rs_k, rs_p, GRAD_FRAC))
        del sz_k, rs_k, sz_p, rs_p
        repeat_identical("gram_backward_flash_bf16",
                         lambda: G.gram_backward_flash_bf16(z, norms, bw, n1, n2, mults))
        pairs = sym_pairs(m)
        iters = 20 if m <= 4096 else 3
        nbytes = 4 * m * d + 4 * (m * d + 2 * m + 1)
        record("gram_backward_flash_bf16",
               f"m={m} d={d}, {cluster} CTAs a cluster, {groups} output groups, {nsplit} splits",
               lambda: G.gram_backward_flash_bf16(z, norms, bw, n1, n2, mults),
               lambda: G.gram_backward_flash(z, norms, bw, n1, n2, mults),
               lambda: G.gram_backward_flash_reference(zr, norms, bw, n1, n2, mults), err,
               f"{GRAD_FRAC} of max|ref|", 2 * pairs * d + 2 * m * m * d, OPS_PER_ENTRY * pairs,
               nbytes, iters,
               old_count=(2 * pairs * d, OPS_PER_ENTRY * pairs + 2 * m * m * d, nbytes))
        torch.cuda.empty_cache()
    for n1, n2, d, R, checks in shapes["kprime_panel_bf16"]:
        z, norms, bw = large_gram_inputs(n1 + n2, d, 44, device)
        m, zr = n1 + n2, G.rounded(z)
        cols_t = G.panel_operand(z, bf16=True)
        err = 0.0
        for r0, r1, offset in checks:  # the panel timed first, then ragged and ordered ones
            tag = f"kprime_panel_bf16 rows {r0}:{r1} offset {offset} m={m} d={d}"
            ct = cols_t if offset is not None else None
            p_k = G.kprime_panel_bf16(z[r0:r1], z, norms[r0:r1], norms, bw, mults, offset=offset,
                                      cols_t=ct)
            e = assert_close(tag, p_k, G.kprime_panel_reference(zr[r0:r1], zr, norms[r0:r1], norms,
                                                                bw, mults), RTOL_KP, ATOL_KP)
            if offset is not None:
                block = p_k[:, offset:offset + (r1 - r0)]
                check(torch.equal(block, block.T), f"{tag}: K' of the diagonal block is not symmetric")
            del p_k
            repeat_identical(tag, lambda: G.kprime_panel_bf16(z[r0:r1], z, norms[r0:r1], norms, bw,
                                                              mults, offset=offset, cols_t=ct))
            err = max(err, e)
        zr_rows, n_rows = z[:R], norms[:R]
        cols_f32 = G.panel_operand(z)
        ctas = G.panel_bf16_schedule(G.panel_blocks(R, m, 0), d, sms)
        formed = R * m - R * (R - 1) // 2
        record("kprime_panel_bf16", f"R={R} C={m} d={d} offset 0, {ctas} CTAs a cluster",
               lambda: G.kprime_panel_bf16(zr_rows, z, n_rows, norms, bw, mults, offset=0,
                                           cols_t=cols_t),
               lambda: G.kprime_panel(zr_rows, z, n_rows, norms, bw, mults, offset=0,
                                      cols_t=cols_f32),
               lambda: G.kprime_panel_reference(zr[:R], zr, n_rows, norms, bw, mults), err, kp_tol,
               formed * 2 * d, formed * OPS_PER_ENTRY, 2 * m * d + 4 * (R + m + 1 + R * m),
               20 if m <= 4096 else 3)
        del z, zr, cols_t, cols_f32
        torch.cuda.empty_cache()
    return rows


def core_against_dense(x, y, bw, want: str, label: str, log):
    """The autograd Function (``mmd2_cuda_core``) against the dense torch
    MMD on the same inputs and bandwidth: the value within ``RTOL_SUMS`` of
    the quadrant means' scale, the gradients within ``GRAD_FRAC`` of their
    largest entry, and only the kernels of regime ``want`` launched."""
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    mults = M.bandwidth_multipliers()
    n1, n2, d = x.shape[0], y.shape[0], x.shape[1]
    check(G.regime(n1 + n2, d) == want, f"{label}: ({n1}+{n2}, d={d}) is not in the {want} regime")
    G.reset_launch_counts()
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    v_k = G.mmd2_cuda_core(xk, yk, bw, mults)
    gx_k, gy_k = torch.autograd.grad(v_k, (xk, yk))
    counts = G.launch_counts()
    xp, yp = x.clone().requires_grad_(), y.clone().requires_grad_()
    v_p, _ = M.mmd2_biased(xp, yp, bandwidth=bw, mults=mults)
    gx_p, gy_p = torch.autograd.grad(v_p, (xp, yp))
    # MMD^2 is a difference of the quadrant means: hold the value to their
    # scale, not to the (possibly cancelling) difference
    z = torch.cat([x, y])
    s = G.gram_quadrant_sums_reference(z, torch.sum(z * z, 1), bw, n1, mults)
    scale = float(s[0, 0] / n1**2 + 2 * s[0, 1] / (n1 * n2) + s[0, 2] / n2**2)
    v_k, v_p = float(v_k.detach()), float(v_p.detach())
    check(abs(v_k - v_p) <= RTOL_SUMS * scale, f"{label} value: {v_k} vs {v_p} (scale {scale})")
    ex = assert_frac(f"{label} grad x", gx_k, gx_p, GRAD_FRAC) / float(torch.max(torch.abs(gx_p)))
    ey = assert_frac(f"{label} grad y", gy_k, gy_p, GRAD_FRAC) / float(torch.max(torch.abs(gy_p)))
    expected = {"stash": {"gram_quadrant_sums_stash"},
                "flash": {"gram_quadrant_sums", "gram_backward_flash"},
                "panel": {"gram_quadrant_sums", "kprime_panel"}}[want]
    check({k for k, v in counts.items() if v} == expected,
          f"{label} launched {counts}, expected {sorted(expected)}")
    log(f"  {label} ({n1}+{n2}, d={d}): value {v_k:.9e} vs dense {v_p:.9e} "
        f"(|d| {abs(v_k - v_p) / scale:.2e} of the scale {scale:.4e}); largest grad error "
        f"{max(ex, ey):.2e} of max|grad|")


def phase_core(device, stash_shape, flash_shape, log):
    """The autograd Function against the dense torch MMD, three regimes; the
    panel regime also with its panel budget lowered to 320 rows, so that
    the backward streams four panels (offsets 0, 320, 640, 960)."""
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    saved = G._KP_STASH_BYTES, G.PANEL_BYTES
    m = stash_shape[0] + stash_shape[1]
    try:
        for want, shape, panel_rows in (("stash", stash_shape, 0), ("flash", flash_shape, 0),
                                        ("panel", stash_shape, 0), ("panel", stash_shape, 320)):
            if want == "panel":
                G._KP_STASH_BYTES = 0
            if panel_rows:
                G.PANEL_BYTES = panel_rows * m * 4
                check(G._panel_rows(m) == panel_rows, f"panel rows {G._panel_rows(m)}")
            x, y, _, _, bw = gram_inputs(*shape, seed=13, device=device)
            label = f"core {want}" + (f", {panel_rows}-row panels" if panel_rows else "")
            core_against_dense(x, y, bw, want, label, log)
    finally:
        G._KP_STASH_BYTES, G.PANEL_BYTES = saved


def kl_encodings_against_dense(model, X, batch: int, device, log):
    """One detector step's MMD on the kl model's own encodings,
    ``enc(x)`` and ``enc(U x)`` of a batch, at the frozen training bandwidth,
    through the kernels and the dense torch MMD. The fit's detector loss
    cannot show this: at d=10240 its reconstruction terms (about 1.8e10)
    swamp the MMD term in f32."""
    rng = np.random.default_rng(8)
    xb = torch.from_numpy(X[rng.choice(len(X), size=batch, replace=False)]).to(device)
    noise = torch.from_numpy(rng.standard_normal((batch, model.generator.latent_size),
                                                 dtype=np.float32)).to(device)
    with torch.no_grad():
        u = model.generator(noise)
        enc_x, enc_ux = model.detector.encoder(xb), model.detector.encoder(u * xb)
    bw = torch.tensor(model.bandwidth, dtype=torch.float32, device=device)
    core_against_dense(enc_x, enc_ux, bw, "flash", "kl detector MMD on the model's encodings", log)


def gof_samples(X, count: int, seed: int):
    """Two samples as check_if_myopic builds them: ``count`` rows of the
    column-L2-normalized data and their masked copies with the dropped
    features mean-imputed (the masks drawn at random here)."""
    rng = np.random.default_rng(seed)
    xn = X / np.linalg.norm(X.astype(np.float64), axis=0)
    x = xn[rng.choice(len(X), size=count, replace=False)].astype(np.float32)
    keep = rng.random(x.shape) < 0.5
    return x, (keep * x + x.mean(axis=0) * ~keep).astype(np.float32)


def indicator_rows(n1: int, n2: int, n_perms: int, seed: int, ones_row: bool = True):
    """(1 + n_perms [+ 1], n1 + n2) float32: the observed split, random
    permutations of it, and the all-ones row of the pooled total."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([np.ones(n1), np.zeros(n2)])
    rows = [base] + [rng.permutation(base) for _ in range(n_perms)]
    if ones_row:
        rows.append(np.ones(n1 + n2))
    return np.stack(rows).astype(np.float32)


def gof_kernel_inputs(x, y, n_perms, seed, device):
    z = torch.from_numpy(np.concatenate([x, y])).to(device).contiguous()
    a = torch.from_numpy(indicator_rows(len(x), len(y), n_perms, seed)).to(device)
    return z, torch.sum(z * z, dim=1), a


def phase_gof_kernel(device, shapes, log):
    """K5 against its plain version run in float64 on the same f32 values,
    per alpha within ``C_FRAC`` of max|C|, then a re-run for identical bits.
    ``shapes``: (rows of the data, n1, n2, d, permutations, alphas, panel
    rows): with panel rows set, ``GRAM_BUFFER_BYTES`` is lowered so that
    pass 1 forms d2 in panels of that many rows, else the full Gram must
    fit. Returns the max abs error at each (n1, n2, d) of the full-Gram
    regime."""
    from vgan_tpu_torch.ops.cuda import gof_gram as GG

    errs = {}
    saved = GG.GRAM_BUFFER_BYTES
    for n_rows, n1, n2, d, n_perms, alphas, panel_rows in shapes:
        X = np.random.default_rng(31).standard_normal((n_rows, d), dtype=np.float32)
        x, _ = gof_samples(X, n1, seed=32)
        _, y = gof_samples(X, n2, seed=33)
        z, norms, a = gof_kernel_inputs(x, y, n_perms, 34, device)
        alphas = [float(np.float32(al)) for al in alphas]
        m = n1 + n2
        try:
            if panel_rows:
                GG.GRAM_BUFFER_BYTES = 4 * panel_rows * -(-m // GG.KERNEL_TILE) * GG.KERNEL_TILE
            plan = GG.panels(m)
            want = "panels" if panel_rows else "full"
            check(GG.regime(m) == want, f"K5 at m={m}: regime {GG.regime(m)}, expected {want}")
            tag = (f"({n1}+{n2}, d={d}, P={a.shape[0]}, {len(alphas)} alphas {alphas}; {want}: "
                   f"{len(plan)} panel{'s' if len(plan) > 1 else ''} of d2)")
            c = GG.a_times_k(z, norms, a, alphas)
            ref = GG.a_times_k_reference(z.double(), norms.double(), a.double(), alphas)
            err = 0.0
            for q, al in enumerate(alphas):
                err = max(err, assert_frac(f"a_times_k alpha={al} {tag}", c[q].double(), ref[q],
                                           C_FRAC))
            del c, ref
            repeat_identical("a_times_k", lambda: GG.a_times_k(z, norms, a, alphas))
        finally:
            GG.GRAM_BUFFER_BYTES = saved
        if not panel_rows:
            errs[n1, n2, d] = err
        log(f"  K5 {tag}: max abs err {err:.3e}, identical bits on a re-run: ok")
    return errs


def knn_inputs(nt, ntr, d, nm, seed, device, integer=False, exclude_self=False):
    """Test rows, train rows and 0/1 masks (about 30% of the features; mask
    1 all-zero, mask 2 one column, mask 3 every column). With
    ``exclude_self`` and nt > ntr the test rows start with the train rows,
    as ``predict``'s combined batch does."""
    rng = np.random.default_rng(seed)

    def rows(n):
        if integer:  # small integers: exact distances, heavy ties
            return rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        return rng.standard_normal((n, d), dtype=np.float32)

    xtr = rows(ntr)
    xte = np.concatenate([xtr, rows(nt - ntr)]) if exclude_self and nt > ntr else rows(nt)
    masks = rng.random((nm, d)) < 0.3
    masks[~masks.any(axis=1), 0] = True
    masks[1] = False
    masks[2] = np.arange(d) == d // 2
    masks[3] = True
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float32)
    return as_dev(xte), as_dev(xtr), as_dev(masks)


def notebook_data(n: int = 2000):
    """The reference notebook's data: d=10 with a (non-PSD) covariance of 500
    between features 0, 8 and 9."""
    rng = np.random.default_rng(0)
    cov = np.eye(10)
    for i, j in [(0, 8), (0, 9), (8, 9)]:
        cov[i, j] = cov[j, i] = 500
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rng.multivariate_normal([0] * 10, cov, n)


def fused_inputs(X, bs: int, epochs: int, seed: int, device, lr: float = 0.001):
    """K8's packed inputs for a fit of ``X`` from a seeded initial generator:
    the host schedule from seeded numpy draws, the packed state, and the
    keyword arguments shared by the kernel and its plain version."""
    from vgan_tpu_torch.ops.cuda import fused_no_kl as FN
    from vgan_tpu_torch.train.steps import TrainConfig, init_no_kl_state

    n, d = X.shape
    config = TrainConfig(ndims=d, batch_size=bs, lr_g=lr)
    state = init_no_kl_state(config, seed, device)
    rng = np.random.default_rng(seed)
    x3, starts, _, _ = FN.schedule(torch.from_numpy(np.asarray(X, np.float32)).to(device), bs,
                                   epochs, rng.permutation(n), rng.integers(0, n, size=epochs),
                                   None, None)
    latent = config.latent_size
    packed = [t.contiguous() for t in (
        *FN.pack_params(dict(state.generator.state_dict()), latent, d, device),
        *FN.pack_params(state.opt_state.square_avg, latent, d, device),
        *FN.pack_params(state.opt_state.acc_delta, latent, d, device))]
    kw = dict(d=d, bs=bs, latent=latent, lr=config.lr_g, weight_decay=config.weight_decay,
              penalty_weight=config.penalty_weight)
    return x3, torch.from_numpy(starts.astype(np.int32)).to(device), packed, kw


def phase_fused_kernel(device, shapes, log):
    """K8 against its plain version with injected noise, offsets and
    permutation (``FUSED_*`` tolerances), twice for identical bits; the
    Philox fill's distribution; the rng-mode fit against the fit fed that
    fill, to the bit. ``shapes``: (label, n, d, bs, epochs). Returns the
    largest error (losses, bandwidth and every state leaf, absolute) per
    (n, d, bs)."""
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import fused_no_kl as FN

    errs = {}
    for label, n, d, bs, epochs in shapes:
        X = notebook_data(n) if d == 10 else np.random.default_rng(n + d).standard_normal(
            (n, d), dtype=np.float32)
        x3, starts, packed, kw = fused_inputs(X, bs, epochs, seed=7, device=device,
                                              lr=FUSED_CHECK_LR)
        bsp = _build.round_up(bs, 64)
        T = int(starts.shape[0])
        noise = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (T, bsp, FN.LP), dtype=np.float32)).to(device)
        run = lambda: FN.fused_no_kl_fit_cuda(x3, starts, *packed, noise, 0, n=n, **kw)
        got = run()
        want = FN.fused_no_kl_fit_reference(x3, starts.cpu().numpy(), *packed, noise, **kw)
        sync()
        tag = f"{label} (n={n}, d={d}, bs={bs}, {epochs} epochs, {T} steps)"
        err = assert_close(f"K8 losses {tag}", got[7], want[7], FUSED_LOSS_RTOL)
        err = max(err, assert_close(f"K8 bandwidth {tag}", got[6], want[6], FUSED_BW_RTOL))
        # each leaf's change from its initial value (the Adadelta state starts at 0)
        worst = 0.0
        for i, pair in enumerate(("params", "square_avg", "acc_delta")):
            leaves_0, leaves_k, leaves_p = (FN.unpack_params(*s[2 * i:2 * i + 2], kw["latent"], d)
                                            for s in (packed, got, want))
            for name in leaves_p:
                change = leaves_p[name] - leaves_0[name]
                e = assert_frac(f"K8 {pair} {name} change {tag}", leaves_k[name] - leaves_0[name],
                                change, FUSED_LEAF_FRAC)
                err = max(err, e)
                worst = max(worst, e / max(float(torch.max(torch.abs(change))), 1e-30))
        repeat_identical(f"K8 {tag}", run)
        errs[n, d, bs] = err
        log(f"  K8 {tag}: losses {got[7][:2].tolist()}... vs plain {want[7][:2].tolist()}..., "
            f"bw {float(got[6][0]):.6e}; largest abs err {err:.3e}; largest leaf-change error "
            f"{worst:.3e} of that leaf's largest change (limit {FUSED_LEAF_FRAC}); identical bits "
            f"on a re-run: ok")

    # the Philox fill: distribution, distinct steps, and the rng-mode fit fed it
    steps, rows, lanes = 8, 1024, 128
    z = FN.philox_normal(12345, steps, rows, lanes, device).reshape(-1).double()
    mean, var = float(z.mean()), float(z.var())
    zs, _ = torch.sort(z)
    cdf = torch.special.ndtr(zs)
    i = torch.arange(1, zs.numel() + 1, device=zs.device, dtype=torch.float64) / zs.numel()
    ks = float(torch.max(torch.maximum(i - cdf, cdf - (i - 1.0 / zs.numel()))))
    check(abs(mean) < 5e-3 and abs(var - 1.0) < 1e-2 and ks < 5e-3,
          f"Philox normals: mean {mean}, var {var}, KS {ks}")
    fill = FN.philox_normal(12345, 2, 64, 128, device)
    check(not torch.equal(fill[0], fill[1]), "Philox: two steps gave the same draws")
    log(f"  Philox fill, {z.numel()} normals: mean {mean:.3e}, var {var:.6f}, KS distance to "
        f"N(0, 1) {ks:.3e}; distinct steps differ: ok")
    label, n, d, bs, epochs = shapes[0]
    X = notebook_data(n)
    x3, starts, packed, kw = fused_inputs(X, bs, epochs, seed=9, device=device)
    T = int(starts.shape[0])
    rng_mode = FN.fused_no_kl_fit_cuda(x3, starts, *packed, None, 4242, n=n, **kw)
    fed = FN.fused_no_kl_fit_cuda(x3, starts, *packed,
                                  FN.philox_normal(4242, T, _build.round_up(bs, 64), FN.LP, device),
                                  4242, n=n, **kw)
    sync()
    for a, b in zip(rng_mode, fed):
        check(torch.equal(a, b), "K8 in rng mode differs from K8 fed the Philox fill")
    log(f"  K8 rng mode equals K8 fed the Philox fill to the bit ({label}, {T} steps): ok")
    return errs


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float32 or 16-bit tensor (-0.0 apart from +0.0)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def adadelta_leaves(device, shapes, flags, state_dtype, seed: int):
    """(p, g, sq, acc, flag) for each shape: p ~ N(0, 1), g ~ N(0, 1e-4),
    the averages positive, as a few steps leave them; then a misaligned leaf
    of 3 chunks and 5 values (the scalar path over several blocks) and an
    aligned one of 1001 values (a ragged tail past the 16-byte path)."""
    from vgan_tpu_torch.ops.cuda import adadelta as A

    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape, flag, offset in [(s, f, 0) for s, f in zip(shapes, flags)] + [
            ((3 * A.CHUNK + 5,), True, 1), ((1001,), True, 0)]:
        def draw(scale, low=None):
            if low is None:
                t = torch.randn(shape, generator=gen, device=device) * scale
            else:
                t = (torch.rand(shape, generator=gen, device=device) * scale + low).to(state_dtype)
            return placed(t, offset)

        out.append((draw(1.0), draw(1e-2), draw(1e-4, 1e-6), draw(1e-5, 1e-7), flag))
    return out


def placed(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of t that starts ``offset`` values into a fresh buffer."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def adadelta_copies(leaves):
    """Copies of p and the averages at the same offsets from 16 bytes."""
    def copy(t):
        return placed(t, t.data_ptr() % 16 // t.element_size())

    return [(copy(p), g, copy(sq), copy(acc), f) for p, g, sq, acc, f in leaves]


def adadelta_models(d: int, device) -> dict:
    """The stress fits' parameter shapes and step flags: the generator's 8
    tensors, the detector's 16 with the encoder's device flag false (the kl
    fit's window) and true."""
    lat = d // 16

    def stack(widths):
        return [s for a, b in zip(widths[:-1], widths[1:]) for s in ((b, a), (b,))]

    gen, enc = stack([lat, 2 * lat, 4 * lat, 8 * lat, d]), stack([d, 8 * lat, 4 * lat, 2 * lat, lat])
    out = {"generator": (gen, [True] * 8)}
    for label, on in (("detector, encoder frozen", False), ("detector, encoder active", True)):
        out[label] = (enc + gen, [torch.tensor(on, device=device)] * 8 + [True] * 8)
    return out


def adadelta_bytes(leaves) -> int:
    """Bytes one update must move: p, g and both averages read, p and both
    averages written, once each, for every leaf that steps."""
    total = 0
    for p, g, sq, acc, flag in leaves:
        if isinstance(flag, torch.Tensor) and not bool(flag):
            continue
        total += p.numel() * (3 * p.element_size() + 4 * sq.element_size())
    return total


def phase_adadelta_kernel(device, d: int, log) -> dict:
    """The multi-tensor Adadelta kernel against its plain path at the stress
    fits' tensor lists (f32 and bf16 state, the encoder's flag false and
    true, a misaligned and a ragged leaf beside them): one launch, p and both
    averages equal to the plain path's, a frozen leaf's bits unchanged, the
    same bits twice. Returns the kernel table's row: CUDA-event ms (wrapper
    included) and profiler device us of one update at each list, beside the
    plain path's ms and the byte bound (phases 3, 3b and 3h add the fits'
    launches: one an update, no plain-path call)."""
    from vgan_tpu_torch.ops.cuda import adadelta as A

    hp = (ADADELTA["rho"], ADADELTA["eps"], ADADELTA["lr"], ADADELTA["wd"])
    times = []
    for state in (torch.float32, torch.bfloat16):
        for label, (shapes, flags) in adadelta_models(d, device).items():
            start = adadelta_leaves(device, shapes, flags, state, seed=len(times))
            kernel, plain = adadelta_copies(start), adadelta_copies(start)
            A.reset_launch_counts()
            A.update(kernel, *hp)
            sync()
            check(A.launch_counts() == {"adadelta_multi": 1, "plain_update": 0},
                  f"adadelta {label}: launches {A.launch_counts()}")
            check(not A.vector_aligned(kernel[-2]) and A.vector_aligned(kernel[0]),
                  "adadelta: the misaligned leaf is not misaligned")
            for leaf in plain:
                A.plain_update(*leaf, *hp)
            sync()
            for i, (mine, theirs, first) in enumerate(zip(kernel, plain, start)):
                frozen = isinstance(first[4], torch.Tensor) and not bool(first[4])
                for j in (0, 2, 3):
                    check(torch.equal(mine[j], theirs[j]),
                          f"adadelta {label} {state}: leaf {i} part {j} differs from the plain path")
                    if frozen:
                        check(torch.equal(bits(mine[j]), bits(first[j])),
                              f"adadelta {label} {state}: frozen leaf {i} changed")

            def run():
                leaves = adadelta_copies(start)
                A.update(leaves, *hp)
                return tuple(t for p, _, sq, acc, _ in leaves for t in (p, sq, acc))

            repeat_identical(f"adadelta {label} {state}", run)
            models = start[:len(shapes)]  # the model's own leaves, timed
            A.reset_launch_counts()
            ms = cuda_ms(lambda: A.update(models, *hp))
            launches = A.launch_counts()["adadelta_multi"]
            check(launches == 23, f"adadelta {label}: {launches} launches in 23 calls")
            us = device_split(lambda: A.update(models, *hp), host_ops=False)
            plain_ms = cuda_ms(lambda: [A.plain_update(*leaf, *hp) for leaf in models],
                               iters=5, warmup=1)
            nbytes = adadelta_bytes(models)
            bound_ms, by = bound(0.0, nbytes)
            row = {"shape": f"{label}, {sum(p.numel() for p, *_ in models)} values, "
                            f"{str(state).split('.')[-1]} state",
                   "ms": ms, "device_us": {k: v for k, v in us.items() if "adadelta" in k},
                   "plain_ms": plain_ms, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": by}
            times.append(row)
            log(f"  adadelta_multi {row['shape']}: equal to the plain path to the bit, twice; "
                f"{ms:.4f} ms (device us {row['device_us']}), plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({nbytes} bytes)")

    first = times[0]
    return {"name": "adadelta_multi", "route": "cuda",
            "source": "vgan_tpu_torch/ops/cuda/csrc/adadelta.cu",
            "replaces": "none (vgan_tpu/train/adadelta.py is plain jnp)",
            **{k: first[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "at_other_shapes": times[1:]}


def phase_knn_kernels(device, shapes, log):
    """K6 / K7 against their plain version (``KNN_*`` tolerances), their
    operands' launch against its plain version (equal), the regime's kernel
    launched, the all-zero mask scored 0, and a re-run for
    identical bits. ``shapes``: (label, nt, ntr, d, n_masks, k,
    exclude_self, integer). Returns the largest |score error| per
    (kernel, (nt, ntr, d))."""
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import knn_score as KS

    errs = {}
    for label, nt, ntr, d, nm, k, excl, integer in shapes:
        xte, xtr, masks = knn_inputs(nt, ntr, d, nm, 41, device, integer, excl)
        name = "knn_scores_resident" if KS._resident_supported(ntr, d) else "knn_scores_stream"
        # the operands' launch against its plain version: the copies equal,
        # each mask's selected columns (the first count entries) equal
        got = KS.kernel_operands(xte, xtr, masks)
        want = (_build.column_major(xte, KS.KERNEL_TILE), _build.column_major(xtr, KS.KERNEL_TILE),
                *KS.selected_columns(masks))
        sync()
        counts = want[3].tolist()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and torch.equal(got[3], want[3])
              and all(torch.equal(got[2][i, :n], want[2][i, :n]) for i, n in enumerate(counts)),
              f"{label}: the KNN kernels' operands differ from their plain version")
        del got, want
        # each mask's own max(an + bn), (nm, 1)
        scale = (torch.amax((xte * xte) @ masks.T, dim=0)
                 + torch.amax((xtr * xtr) @ masks.T, dim=0))[:, None]
        frac = KNN_D2_FRAC_WIDE if d > KNN_WIDE_D else KNN_D2_FRAC
        tag = f"{label} ({nt} x {ntr}, d={d}, {nm} masks, k={k}, exclude_self={excl})"
        for mode in ("kth", "mean"):
            KS.reset_launch_counts()
            got = KS.knn_scores_all_masks(xte, xtr, masks, k, mode, excl)
            sync()
            check(KS.launch_counts()[name] == 1, f"{tag}: launched {KS.launch_counts()}, not {name}")
            ref = KS.knn_scores_all_masks_reference(xte, xtr, masks, k, mode, excl)
            err = max_abs(got, ref)
            if integer and mode == "kth":
                check(torch.equal(got, ref), f"{tag} kth: not equal to the plain version "
                                             f"on exact distances (max abs err {err:.3e})")
                what = "equal to the bit"
            elif integer:
                assert_close(f"{tag} mean", got, ref, KNN_MEAN_RTOL_EXACT)
                what = f"rtol {KNN_MEAN_RTOL_EXACT}"
            elif mode == "kth":
                e2 = torch.abs(got.double() ** 2 - ref.double() ** 2)
                check(bool(torch.all(e2 <= frac * scale)),
                      f"{tag} kth: |d s^2| above {frac} x its mask's max(an + bn)")
                worst = float(torch.max(e2 / torch.clamp_min(scale, 1e-30)))
                what = f"|d s^2| at most {worst:.2e} of its mask's max(an + bn) (limit {frac})"
            else:
                eps = frac * scale
                s1 = KS.knn_scores_all_masks_reference(xte, xtr, masks, 1, "kth", excl)
                lim = torch.where(s1 > 0, torch.minimum(eps.sqrt(), eps / s1), eps.sqrt())
                d_s = torch.abs(got - ref)
                check(bool(torch.all(d_s <= lim)),
                      f"{tag} mean: |d s| above min(sqrt(eps), eps / s1)")
                worst = float(torch.max(torch.where(lim > 0, d_s / lim, d_s)))
                what = (f"within min(sqrt(eps), eps / s1) per score, eps = {frac} x its mask's "
                        f"max(an + bn) (largest |d s| / limit {worst:.2e})")
            check(bool(torch.all(got[1] == 0.0)), f"{tag} {mode}: the all-zero mask scored nonzero")
            check(bool(torch.all(torch.isfinite(got))), f"{tag} {mode}: non-finite scores")
            repeat_identical(f"{tag} {mode}",
                             lambda: KS.knn_scores_all_masks(xte, xtr, masks, k, mode, excl))
            key = (name, (nt, ntr, d))
            errs[key] = max(errs.get(key, 0.0), err)
            log(f"  {'K6' if name == 'knn_scores_resident' else 'K7'} {tag} {mode}: "
                f"max abs err {err:.3e}, {what}; identical bits on a re-run: ok")
        del xte, xtr, masks
    return errs


# ---------------------------------------------------------------------------
# phases 3-4: fits through the public estimator
# ---------------------------------------------------------------------------


def fit_counts(X, device, cls=None, **kw):
    """A fit with the kernel counts set to 0 just before it and read just
    after; the losses are the generator history, preceded by the detector
    history for the kl estimator (NaN before the first epoch of a kind).
    Returns ``(model, counts, losses, seconds, updates)``: ``counts`` the
    MMD kernels' launches, ``updates`` the Adadelta kernel's (every update
    of a fit on the card goes to it: no plain-path call)."""
    from vgan_tpu_torch import VGAN_no_kl
    from vgan_tpu_torch.ops.cuda import adadelta as A
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    model = (cls or VGAN_no_kl)(verbose=False, device=device, **kw)
    sync()
    G.reset_launch_counts()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(X)
    sync()
    seconds = time.perf_counter() - t0
    counts = G.launch_counts()
    updates = A.launch_counts()
    check(updates["plain_update"] == 0, f"a fit on the card took the plain Adadelta path: {updates}")
    kinds = [k for k in ("detector_loss", "generator_loss") if k in model.train_history]
    for kind in kinds:
        h = np.asarray(model.train_history[kind])
        # a kl history is NaN before the first epoch of its kind, and only there
        lead = int(np.argmax(~np.isnan(h))) if len(kinds) == 2 else 0
        check(np.all(np.isnan(h[:lead])) and np.all(np.isfinite(h[lead:])),
              f"{kind} history {h.tolist()} is not finite from its first epoch on")
    losses = np.concatenate([np.asarray(model.train_history[k]) for k in kinds])
    return model, counts, losses, seconds, updates["adadelta_multi"]


def fit_against_dense(X, device, label, log, **kw):
    """A fit on the default (kernel) path, then the same fit (same seed and
    streams) on the dense torch path; their loss histories must agree, and
    both update through the Adadelta kernel as often. Returns the first
    fit's model, MMD launches, losses and Adadelta launches."""
    model, counts, losses, seconds, updates = fit_counts(X, device, **kw)
    log(f"  {label}: losses {losses.tolist()} in {seconds:.3f} s, launches {counts}, "
        f"Adadelta launches {updates}")
    _, plain_counts, plain_losses, _, plain_updates = fit_counts(X, device, mmd_impl="torch", **kw)
    check(sum(plain_counts.values()) == 0, f"mmd_impl='torch' launched {plain_counts}")
    check(plain_updates == updates,
          f"{label}: {plain_updates} Adadelta launches on the dense path, {updates} on the kernel's")
    check(np.allclose(losses, plain_losses, rtol=RTOL_FIT_LOSS, atol=0.0, equal_nan=True),
          f"{label}: kernel-path losses {losses} vs dense-path {plain_losses}")
    seen = np.isfinite(plain_losses)
    gap = float(np.max(np.abs(losses[seen] - plain_losses[seen]) / np.abs(plain_losses[seen])))
    log(f"  {label}: dense torch path losses {plain_losses.tolist()} agree within "
        f"{RTOL_FIT_LOSS} (largest relative gap {gap:.3e})")
    return model, counts, losses, updates


def phase_main_path(device, n, d, batch, log):
    """The stress fit -> sample -> GoF workflow; returns the K2 launches,
    the fitted model, its training rows and the fit's Adadelta launches
    (one an update: ``steps``)."""
    X = np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)
    steps = 2 * (n // batch)
    model, counts, _, updates = fit_against_dense(X, device, "stress fit", log,
                                              epochs=2, batch_size=batch)
    check(counts["gram_quadrant_sums_stash"] == steps,
          f"stress fit launched the stash kernel {counts['gram_quadrant_sums_stash']} times, "
          f"expected {steps}")
    check(sum(counts.values()) == steps, f"stress fit launched other kernels: {counts}")
    check(updates == steps, f"stress fit launched the Adadelta kernel {updates} times, "
                            f"expected {steps}")

    sample_workflow(model, batch, d, log)
    p = model.check_if_myopic(X, count=batch, rng=np.random.default_rng(3)).to_numpy().ravel()
    check(np.all((p >= 0.0) & (p <= 1.0)), f"p-values out of [0, 1]: {p}")
    log(f"  GoF p-values {p.tolist()}")
    return counts["gram_quadrant_sums_stash"], model, X, updates


def sample_workflow(model, nsubs, d, log):
    masks = model.generate_subspaces(nsubs)
    check(masks.shape == (nsubs, d) and masks.dtype == np.bool_, f"masks {masks.shape} {masks.dtype}")
    check(np.array_equal(masks, model.generate_subspaces(nsubs)), "generate_subspaces not deterministic")
    model.approx_subspace_dist()
    check(abs(float(np.sum(model.proba)) - 1.0) < 1e-9, "subspace probabilities do not sum to 1")
    log(f"  {len(model.subspaces)} unique masks, top probability {float(np.max(model.proba)):.4f}")


def gof_oracle(x, y, alpha: float, a_rows, device, block: int = 2048):
    """Blockwise float64 statistics of the indicator rows on the card (the
    method of examples/gof_precise_check.py): C = A @ K in row blocks of K,
    the diagonal zeroed, never m^2 resident. ``(observed, p_value)``."""
    n1, n2 = len(x), len(y)
    z = torch.from_numpy(np.concatenate([x, y]).astype(np.float64)).to(device)
    zn = torch.sum(z * z, dim=1)
    A = torch.from_numpy(a_rows).to(device, torch.float64)
    B = 1.0 - A
    s_xx = torch.zeros(A.shape[0], dtype=torch.float64, device=device)
    s_xy = torch.zeros_like(s_xx)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for r0 in range(0, n1 + n2, block):
        r1 = min(r0 + block, n1 + n2)
        d2 = torch.clamp_min(zn[r0:r1, None] + zn[None, :] - 2.0 * (z[r0:r1] @ z.T), 0.0)
        k = torch.exp(-alpha * d2)
        k[torch.arange(r1 - r0), torch.arange(r0, r1)] = 0.0
        ck = A[:, r0:r1] @ k
        s_xx += torch.sum(ck * A, dim=1)
        s_xy += torch.sum(ck * B, dim=1)
        total += torch.sum(k)
    s_yy = total - s_xx - 2.0 * s_xy
    stats = s_xx / (n1 * (n1 - 1)) + s_yy / (n2 * (n2 - 1)) - 2.0 * s_xy / (n1 * n2)
    stats = stats.cpu().numpy()
    return float(stats[0]), float(np.mean(stats[1:] >= stats[0]))


def phase_kl_main_path(device, n, d, batch, log):
    """The kl stress fit -> sample -> GoF workflow, then the fit continued
    into its next detector epoch, the encoder frozen. Returns the launches
    of K1 and K3 in the kl fit and of K5 in check_if_myopic, and the fit's
    loss history, the GoF p-values (phase 3h holds its mesh runs to them)
    and the Adadelta kernel's launches in each fit (one an update)."""
    from vgan_tpu_torch import VGAN
    from vgan_tpu_torch.ops.cuda import adadelta as A
    from vgan_tpu_torch.ops.cuda import gof_gram as GG
    from vgan_tpu_torch.ops.cuda import mmd_gram as G
    from vgan_tpu_torch.ops.mmd_test import (
        mmd_permutation_test_sweep,
        mmd_permutation_test_sweep_precise,
    )

    X = np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)
    steps = n // batch  # per epoch: phases [detector, generator]
    model, counts, kl_losses, updates = fit_against_dense(X, device, "kl stress fit", log, cls=VGAN,
                                                 epochs=2, batch_size=batch)
    want = dict(dict.fromkeys(G.launch_counts(), 0), gram_quadrant_sums=2 * steps,
                gram_backward_flash=steps)
    check(counts == want, f"kl stress fit launches {counts}, expected {want}")
    # the generator detached: updates in the detector epoch only
    check(updates == steps, f"kl stress fit: {updates} Adadelta launches, expected {steps}")
    launches = {k: counts[k] for k in ("gram_quadrant_sums", "gram_backward_flash")}
    kl_encodings_against_dense(model, X, batch, device, log)
    _, counts_q, losses_q, _, updates_q = fit_counts(X, device, cls=VGAN, epochs=2,
                                                     batch_size=batch,
                                                     replicate_reference_quirks=False)
    want_q = dict(want, gram_backward_flash=2 * steps)
    check(counts_q == want_q, f"kl fit with the quirks off launched {counts_q}, expected {want_q}")
    check(updates_q == 2 * steps,
          f"kl fit with the quirks off: {updates_q} Adadelta launches, expected {2 * steps}")
    log(f"  kl fit, quirks off (the generator trains): losses {losses_q.tolist()}, launches {counts_q}")
    sample_workflow(model, batch, d, log)

    Xg = np.random.default_rng(5).standard_normal((GOF_ROWS, d), dtype=np.float32)
    pvals, k5 = {}, 0
    for count, precision in ((GOF_COUNT_F64, "float64"), (GOF_COUNT_F32, "float32")):
        sync()
        GG.reset_launch_counts()
        t0 = time.perf_counter()
        gof = model.check_if_myopic(Xg, count=count, precision=precision,
                                    rng=np.random.default_rng(6))
        sync()
        seconds = time.perf_counter() - t0
        n_k5 = GG.launch_counts()["a_times_k"]
        check(n_k5 > 0, f"check_if_myopic(count={count}, {precision}) did not launch K5")
        k5 += n_k5
        p = gof.to_numpy().ravel()
        check(np.all((p >= 0.0) & (p <= 1.0)), f"p-values out of [0, 1]: {p}")
        pvals[precision] = p.tolist()
        log(f"  check_if_myopic count={count} {precision} ({2 * count} pooled rows): "
            f"p-values {p.tolist()} (columns {list(gof.columns)}; recommended alpha = the "
            f"frozen training bandwidth {model.bandwidth:.6e}) in {seconds:.2f} s, K5 launches {n_k5}")

    # alpha=0.01 on the float64 route's own samples and 64 shared permutations
    x, y = model._gof_samples(Xg, GOF_COUNT_F64, np.random.default_rng(6))
    perms = indicator_rows(len(x), len(y), ORACLE_PERMUTATIONS, seed=9, ones_row=False)
    s64, p64 = mmd_permutation_test_sweep_precise(x, y, [0.01], permutations=perms[1:],
                                                  device=device)
    s_or, p_or = gof_oracle(x, y, 0.01, perms, device)
    check(abs(float(s64[0]) - s_or) < ORACLE_STAT_ATOL and abs(float(p64[0]) - p_or) <= ORACLE_P_ATOL,
          f"float64 route stat {float(s64[0])!r} p {float(p64[0])} vs oracle {s_or!r} p {p_or}")
    s32, _ = mmd_permutation_test_sweep(torch.from_numpy(x), torch.from_numpy(y), [0.01],
                                        permutations=torch.from_numpy(perms[1:]), device=device)
    s32 = float(s32[0])
    check(abs(s32 - float(s64[0])) <= F32_STAT_RTOL * abs(float(s64[0])),
          f"float32 route stat {s32!r} vs float64 route {float(s64[0])!r}")
    log(f"  alpha=0.01, {len(x)}+{len(y)} rows, {ORACLE_PERMUTATIONS} permutations: float64 route "
        f"stat {float(s64[0]):.9e} p {float(p64[0]):.4f}; oracle stat {s_or:.9e} p {p_or:.4f} "
        f"(|d stat| {abs(float(s64[0]) - s_or):.2e}); float32 route stat {s32:.9e} "
        f"(rel {abs(s32 - float(s64[0])) / abs(float(s64[0])):.2e})")
    launches["a_times_k"] = k5

    # the schedule's 4 other generator epochs (detached), then a detector
    # epoch with the encoder frozen: its flag false on the card
    before = {k: v.clone() for k, v in model.detector.named_parameters()}
    sync()
    A.reset_launch_counts()
    model.continue_fit(X, model.iternum_g)
    sync()
    frozen = A.launch_counts()
    check(frozen == {"adadelta_multi": steps, "plain_update": 0},
          f"kl stress fit continued to a detector epoch: Adadelta {frozen}, expected {steps}")
    for name, p in model.detector.named_parameters():
        check(torch.equal(p, before[name]) == name.startswith("encoder."),
              f"kl detector epoch, encoder frozen: {name} "
              f"{'changed' if name.startswith('encoder.') else 'stayed'}")
    updates = {"kl stress fit": updates, "kl fit, quirks off": updates_q,
               "kl detector epoch, encoder frozen": frozen["adadelta_multi"]}
    log(f"  Adadelta kernel launches {updates}, no plain-path call; the frozen encoder unchanged")
    return launches, {"losses": kl_losses, "pvals": pvals, "updates": updates}


def phase_fused_main_path(device, log):
    """``VGAN_no_kl(fit_impl='fused')`` at the notebook configuration with
    the K8 count set to 0 just before the fit and read just after: one
    launch, the loss and mask bands; then ``continue_fit`` on the scan path
    and a checkpoint restored into a fresh estimator on the card. Returns
    the K8 launches of the fit."""
    from vgan_tpu_torch import VGAN_no_kl
    from vgan_tpu_torch.ops.cuda import fused_no_kl as FN

    X = notebook_data()
    model = VGAN_no_kl(verbose=False, device=device, fit_impl="fused", **NOTEBOOK_FIT)
    sync()
    FN.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(X)
    sync()
    seconds = time.perf_counter() - t0
    launches = FN.launch_counts()["fused_no_kl_fit_cuda"]
    check(launches == 1, f"the fused fit launched K8 {launches} times, expected 1")
    h = np.asarray(model.train_history["generator_loss"])
    check(len(h) == NOTEBOOK_FIT["epochs"] and np.all(np.isfinite(h)), f"fused history {h}")
    check(2.5 <= h[-1] <= 5.0, f"fused fit final loss {h[-1]} outside the 2.5-5 band")
    model.approx_subspace_dist()
    check(len(model.subspaces) < 20, f"fused fit gave {len(model.subspaces)} unique masks")
    log(f"  fused fit d=10, {NOTEBOOK_FIT['epochs']} epochs: final loss {h[-1]:.6f} (band "
        f"2.5-5), {len(model.subspaces)} unique masks (band < 20), top probability "
        f"{float(np.max(model.proba)):.4f}, bandwidth {model.bandwidth:.6e}, {launches} K8 "
        f"launch in {seconds:.3f} s (first call: includes the schedule and packing)")
    bw = model.bandwidth
    model.continue_fit(X, 2)
    h = model.train_history["generator_loss"]
    check(len(h) == NOTEBOOK_FIT["epochs"] + 2 and np.isfinite(h[-1]) and model.bandwidth == bw,
          f"continue_fit after the fused fit: history {h[-3:]}, bandwidth {model.bandwidth}")
    check(FN.launch_counts()["fused_no_kl_fit_cuda"] == 1, "continue_fit launched K8")
    with tempfile.TemporaryDirectory() as ckpt:
        model.save_checkpoint(ckpt)
        restored = VGAN_no_kl(verbose=False, device=device, **NOTEBOOK_FIT).restore_checkpoint(ckpt)
    check(restored.train_state.bw_value.device == model.train_state.bw_value.device,
          "the restored state is not on the estimator's device")
    check(np.array_equal(restored.generate_subspaces(500), model.generate_subspaces(500)),
          "restored checkpoint samples other masks")
    log(f"  continue_fit 2 epochs on the scan path: losses {h[-2:]}, bandwidth kept; "
        f"save_checkpoint -> restore_checkpoint on the card: equal generate_subspaces(500)")
    return launches


def roc_auc(scores, is_outlier) -> float:
    """Mann-Whitney ROC AUC of the outliers against the rest (ties half)."""
    pos, neg = scores[is_outlier][:, None], scores[~is_outlier][None, :]
    return float(np.mean((pos > neg) + 0.5 * (pos == neg)))


def outlier_rows(rng, n: int, d: int):
    """``n`` Gaussian rows, the first ``N_OUTLIERS`` scaled by 3."""
    x = rng.standard_normal((n, d), dtype=np.float32)
    x[:N_OUTLIERS] *= 3.0
    is_outlier = np.zeros(n, bool)
    is_outlier[:N_OUTLIERS] = True
    return x, is_outlier


def drive_ensemble(ens, Xt, is_outlier, kernel: str, label: str, log) -> float:
    """decision_function, predict, decision_scores_ and labels_ through the
    public API, with the KNN kernel counts set to 0 just before and read just
    after: ``kernel`` once per call, the other never. Then the same
    decision_function on the generic torch path (no kernel). Returns the
    outliers' ROC AUC."""
    from vgan_tpu_torch.ops.cuda import knn_score as KS

    sync()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    scores = ens.decision_function(Xt)
    t_dec = time.perf_counter() - t0
    labels = ens.predict(Xt)
    train_scores = ens.decision_scores_
    train_labels = ens.labels_
    sync()
    counts = KS.launch_counts()
    want = dict(dict.fromkeys(counts, 0), **{kernel: 3})
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    n_tr = ens._x_train.shape[0]
    check(scores.shape == (len(Xt),) and np.all(np.isfinite(scores)), f"{label}: scores not finite")
    check(train_scores.shape == (n_tr,) and np.all(np.isfinite(train_scores)),
          f"{label}: decision_scores_ not finite")
    check(set(np.unique(labels)) <= {0, 1}, f"{label}: predict labels {np.unique(labels)}")
    check(np.array_equal(train_labels, (train_scores > ens.threshold_).astype(np.int64))
          and ens.threshold_ == float(np.quantile(train_scores, 1.0 - ens.contamination)),
          f"{label}: labels_ != decision_scores_ > threshold_ at the (1 - contamination) quantile")
    generic = ens._native_scores(ens._as_device(Xt), False, reduce=True).cpu().numpy()
    check(sum(KS.launch_counts().values()) == 3, f"{label}: the generic path launched a kernel")
    err = float(np.max(np.abs(scores - generic)))
    lim = ENSEMBLE_FRAC * float(np.max(np.abs(generic)))
    check(err <= lim, f"{label}: kernel path vs generic torch path max abs err {err:.3e} > {lim:.3e}")
    auc = roc_auc(scores, is_outlier)
    log(f"  {label}: {len(ens.subspaces)} masks, launches {counts}; decision_function "
        f"{t_dec:.3f} s (first call), vs the generic torch path max abs err {err:.3e} "
        f"(limit {lim:.3e}); {int(labels.sum())} of {len(Xt)} test rows and "
        f"{int(train_labels.sum())} of {n_tr} train rows labelled outliers, threshold_ "
        f"{ens.threshold_:.6f}; ROC AUC of the {N_OUTLIERS} planted outliers {auc:.4f}")
    return auc


def phase_ensembles(device, model, X, log):
    """The subspace ensemble through the public API: from the phase-3 stress
    model (K7) and at the bench configuration (K6), both bases. Returns the
    launches of each kernel and the ensembles with their test rows, for
    phase 5."""
    from vgan_tpu_torch import SubspaceEnsemble

    launches = {"knn_scores_resident": 0, "knn_scores_stream": 0}
    runs = {}
    k = STRESS_ENSEMBLE["k"]
    Xt, is_out = outlier_rows(np.random.default_rng(21), STRESS_ENSEMBLE["n_test"], X.shape[1])
    for base in ("knn", "knn_mean"):
        ens = SubspaceEnsemble.from_model(model, STRESS_ENSEMBLE["subspace_count"], base=base,
                                          k=k).fit(X)
        check(ens.device.type == "cuda", f"the ensemble runs on {ens.device}")
        auc = drive_ensemble(ens, Xt, is_out, "knn_scores_stream",
                             f"stress ensemble {base} ({len(X)} x {X.shape[1]} train, "
                             f"{len(Xt)} test, k={k})", log)
        log("    (AUC not asserted: the masks come from a 2-epoch fit)")
        launches["knn_scores_stream"] += 3
        runs["stress", base] = (ens, Xt)

    cfg = BENCH_ENSEMBLE
    xtr, xte, is_out, subs = bench_data()
    for base in ("knn", "knn_mean"):
        ens = SubspaceEnsemble(subs, np.full(cfg["n_masks"], 1.0 / cfg["n_masks"]), base=base,
                               k=cfg["k"]).fit(xtr)
        auc = drive_ensemble(ens, xte, is_out, "knn_scores_resident",
                             f"bench ensemble {base} ({cfg['n_train']} x {cfg['d']} train, "
                             f"{cfg['n_test']} test, k={cfg['k']})", log)
        check(auc >= BENCH_AUC_MIN, f"bench ensemble {base}: ROC AUC {auc:.4f} < {BENCH_AUC_MIN}")
        launches["knn_scores_resident"] += 3
        runs["bench", base] = (ens, xte)
    return launches, runs


def bench_data():
    """The bench ensemble's rows and masks (bench.py:414-419): 1000 x 100
    Gaussian train rows, 500 test rows with N_OUTLIERS planted, 1024 masks
    of about 30 features."""
    cfg = BENCH_ENSEMBLE
    rng = np.random.default_rng(22)
    xtr = rng.standard_normal((cfg["n_train"], cfg["d"]), dtype=np.float32)
    xte, is_out = outlier_rows(rng, cfg["n_test"], cfg["d"])
    subs = rng.uniform(size=(cfg["n_masks"], cfg["d"])) < 0.3
    subs[~subs.any(axis=1), 0] = True
    return xtr, xte, is_out, subs


def base_config(base: str, subs):
    """(masks, constructor keywords) of a base on the bench data: iforest
    at bench.py's configuration, FEW_MASK_BASES on the first FEW_MASKS
    masks, the others on every mask; all at the bench ensemble's k (read by
    the neighbour bases only) and every other knob at its default."""
    if base == "iforest":
        cfg = IFOREST_BENCH
        return subs[:cfg["n_masks"]], dict(n_trees=cfg["n_trees"], chunk=cfg["chunk"])
    if base in FEW_MASK_BASES:
        return subs[:FEW_MASKS], dict(k=BENCH_ENSEMBLE["k"])
    return subs, dict(k=BENCH_ENSEMBLE["k"])


def host_reference(base: str, ens, xte, xtr, masks, margins=None):
    """Raw (masks, nt) scores of ``base`` from its scorer function on the
    CPU with the knobs of the ensemble ``ens``, in float64 (float32 for the
    bases whose decisions are defined in f32); ``margins`` (a list) receives
    the decision margins of the bases in DECISION_REL."""
    from vgan_tpu_torch.ensemble import od

    dtype = torch.float32 if base in RAW_F32_BASES else torch.float64
    te, tr = torch.from_numpy(xte).to(dtype), torch.from_numpy(xtr).to(dtype)
    m = torch.from_numpy(masks).to(dtype)
    if base in od._DIM_BASES:
        return od._dim_subspace_raw(od._dim_scores_impl(te, tr, base=base, n_bins=10), m)
    scorer, kk = od._scorer_and_k(base, **od._scorer_params(ens))
    if base in DECISION_REL:
        scorer = functools.partial(scorer, margins=margins)
    return scorer(te, tr, m, kk)


def tie_exposure(base: str, xte, xtr, masks, k: int) -> torch.Tensor:
    """(masks, nt) bool: the (mask, test row) pairs whose score can change
    with a near-tie lost between the card's and the host's d2 (see
    NEIGHBOR_BASES' tolerance note), from float64 d2 on the CPU."""
    te, tr = torch.from_numpy(xte).double(), torch.from_numpy(xtr).double()
    m = torch.from_numpy(masks).double()
    an, bn = ((te * te) @ m.T).T, ((tr * tr) @ m.T).T
    gamma = (m.sum(dim=1) + 2.0) * 2.0**-24 * 2.0  # per mask: the f32 bound's factor

    def ties(q, qn, exclude_self):
        d2 = qn[:, :, None] + bn[:, None, :] - 2.0 * (q[None] * m[:, None, :]) @ tr.T
        bound = gamma[:, None, None] * (qn[:, :, None] + bn[:, None, :])
        if exclude_self:
            i = torch.arange(len(tr))
            d2[:, i, i] = torch.inf
        vals, idx = torch.sort(d2, dim=-1, stable=True)
        err = torch.gather(bound, 2, idx[..., :k + 1])
        gap = (vals[..., 1:k + 1] - vals[..., :k]) <= 2.0 * (err[..., 1:] + err[..., :-1])
        return gap[..., k - 1], gap.any(dim=-1), idx[..., :k]

    edge_te, any_te, nbr_te = ties(te, an, False)
    if base == "abod":
        return edge_te
    edge_tr, any_tr, _ = ties(tr, bn, True)
    c, nt, _ = nbr_te.shape
    own, theirs = (edge_te, edge_tr) if base == "lof" else (any_te, any_tr)
    via_nbr = torch.gather(theirs, 1, nbr_te.reshape(c, -1)).reshape(c, nt, k).any(dim=-1)
    return own | via_nbr


def hold_against_host(base: str, ens_kw: dict, xte, xtr, masks, log) -> None:
    """The first CHECK_MASKS masks: raw scores on the card against the
    scorer function on the CPU, and the card's ensemble against the same
    ensemble with device='cpu'."""
    from vgan_tpu_torch import SubspaceEnsemble

    masks = masks[:CHECK_MASKS]
    proba = np.full(len(masks), 1.0 / len(masks))
    card = SubspaceEnsemble(masks, proba, base=base, **ens_kw).fit(xtr)
    host = SubspaceEnsemble(masks, proba, base=base, device="cpu", **ens_kw).fit(xtr)
    raw = torch.from_numpy(card._raw_per_subspace(xte)).double()
    margins = []
    ref = host_reference(base, host, xte, xtr, masks, margins).double()
    err = torch.abs(raw - ref)
    lim = RAW_RTOL[base] * torch.abs(ref) + RAW_ATOL_FRAC * float(torch.max(torch.abs(ref)))
    beyond = err > lim
    if base in NEIGHBOR_BASES:
        exposed = tie_exposure(base, xte, xtr, masks, ens_kw["k"])
    elif margins:
        # a (masks,) margin exposes a mask, a (masks, nt) one a (mask, row) entry
        least = functools.reduce(torch.minimum, (m if m.ndim == 2 else m[:, None]
                                                 for m in margins)).double()
        exposed = (least <= DECISION_REL[base]).expand_as(beyond)
        log(f"    {int(exposed.any(dim=1).sum())} of {len(masks)} masks and "
            f"{int(exposed.sum())} entries decision-exposed (least margin "
            f"{float(least.min()):.3e}, limit {DECISION_REL[base]})")
    else:
        exposed = torch.zeros_like(beyond)
    unexplained = beyond & ~exposed
    check(not bool(unexplained.any()),
          f"{base}: {int(unexplained.sum())} raw scores beyond rtol {RAW_RTOL[base]} that no "
          f"near-tie explains (max abs err {float(err[unexplained].max()):.3e})"
          if bool(unexplained.any()) else "")
    raw_err = float(err[~exposed].max()) if bool((~exposed).any()) else 0.0
    agg = card.decision_function(xte)
    agg_host = host.decision_function(xte)
    d_agg = np.abs(agg - agg_host)
    base_lim = ENSEMBLE_FRAC * float(np.max(np.abs(agg_host)))
    ref_z = (ref - ref.mean(dim=1, keepdim=True)) / (ref.std(dim=1, keepdim=True, correction=0)
                                                     + 1e-12)
    z_range = (ref_z.amax(dim=1) - ref_z.amin(dim=1)).numpy()
    row_lim = base_lim + (exposed.numpy() * (proba * z_range)[:, None]).sum(axis=0)
    check(bool(np.all(d_agg <= row_lim)),
          f"{base}: card vs CPU ensemble: a row's error passes its limit by "
          f"{float(np.max(d_agg - row_lim)):.3e}")
    tight = ~exposed.numpy().any(axis=0)
    log(f"    vs the host ({len(masks)} masks): raw max abs err {raw_err:.3e} on "
        f"{int((~exposed).sum())} unexposed entries (limit rtol {RAW_RTOL[base]} + "
        f"{RAW_ATOL_FRAC} x max |ref| {float(torch.max(torch.abs(ref))):.4g}; reference "
        f"{'float32' if base in RAW_F32_BASES else 'float64'}), {int(beyond.sum())} beyond it, "
        f"all among {int(exposed.sum())} exposed of {exposed.numel()}; ensemble max abs err "
        f"{float(d_agg[tight].max()) if tight.any() else 0.0:.3e} on {int(tight.sum())} "
        f"unexposed rows (limit {base_lim:.3e}), {float(d_agg.max()):.3e} over all rows "
        f"(row limits up to {float(row_lim.max()):.3e})")


def phase_other_bases(device, model, X, log) -> dict:
    """The other native bases through the public API (no KNN kernel): on
    the bench ensemble's data and masks (iforest at bench.py's
    configuration, FEW_MASK_BASES on FEW_MASKS masks), decision_function,
    predict, decision_scores_ and labels_ on the card, the K6 / K7 counts at
    zero, the card held to the host, the planted outliers' ROC AUC held, and
    each base's decision_function time; then STRESS_BASES on the stress
    ensemble. Returns each base's times."""
    from vgan_tpu_torch import SubspaceEnsemble
    from vgan_tpu_torch.ops.cuda import knn_score as KS

    t_phase = time.perf_counter()
    xtr, xte, is_out, subs = bench_data()
    rates = {}
    for base in OTHER_BASES:
        t_base = time.perf_counter()
        masks, kw = base_config(base, subs)
        ens = SubspaceEnsemble(masks, np.full(len(masks), 1.0 / len(masks)), base=base,
                               **kw).fit(xtr)
        check(ens.device.type == "cuda", f"the ensemble runs on {ens.device}")
        label = (f"{base} ({len(masks)} masks, {len(xtr)} x {xtr.shape[1]} train, "
                 f"{len(xte)} test, " + ", ".join(f"{k}={v}" for k, v in kw.items()) + ")")
        sync()
        KS.reset_launch_counts()
        scores = ens.decision_function(xte)
        labels = ens.predict(xte)
        train_scores = ens.decision_scores_
        train_labels = ens.labels_
        sync()
        counts = KS.launch_counts()
        check(sum(counts.values()) == 0, f"{label}: KNN kernel launches {counts}")
        check(scores.shape == (len(xte),) and np.all(np.isfinite(scores)),
              f"{label}: scores not finite")
        check(train_scores.shape == (len(xtr),) and np.all(np.isfinite(train_scores)),
              f"{label}: decision_scores_ not finite")
        check(set(np.unique(labels)) <= {0, 1}, f"{label}: predict labels {np.unique(labels)}")
        check(np.array_equal(train_labels, (train_scores > ens.threshold_).astype(np.int64)),
              f"{label}: labels_ != decision_scores_ > threshold_")
        auc = roc_auc(scores, is_out)
        jax_auc = JAX_BENCH_AUC[base]
        auc_min = BENCH_AUC_MIN if jax_auc >= BENCH_AUC_MIN else jax_auc - 0.02
        check(auc >= auc_min, f"{label}: ROC AUC {auc:.4f} < {auc_min:.4f}")
        log(f"  {label}: launches {counts}; {int(labels.sum())} of {len(xte)} test and "
            f"{int(train_labels.sum())} of {len(xtr)} train rows labelled outliers; ROC AUC of "
            f"the {N_OUTLIERS} planted outliers {auc:.4f} (limit {auc_min:.4f}; the JAX package "
            f"on the CPU: {jax_auc:.4f}"
            + ("" if jax_auc >= BENCH_AUC_MIN else ", below BENCH_AUC_MIN: held to it less 0.02")
            + ")")
        hold_against_host(base, kw, xte, xtr, masks, log)
        times = []
        for _ in range(4):  # a warm-up, then the median of 3
            sync()
            t0 = time.perf_counter()
            ens.decision_function(xte)
            times.append(time.perf_counter() - t0)
        sec = statistics.median(times[1:])
        t_prof = time.perf_counter()
        prof_ens, prof_ms = ens, sec * 1e3
        if base in PROFILE_MASKS:
            pm = masks[:PROFILE_MASKS[base]]
            prof_ens = SubspaceEnsemble(pm, np.full(len(pm), 1.0 / len(pm)), base=base,
                                        **kw).fit(xtr)
            prof_ens.decision_function(xte)
            sync()
            t0 = time.perf_counter()
            prof_ens.decision_function(xte)
            prof_ms = (time.perf_counter() - t0) * 1e3
        split = device_split(lambda: prof_ens.decision_function(xte), calls=1, host_ops=False,
                             warmup=False)
        t_prof = time.perf_counter() - t_prof
        busy_ms = sum(split.values()) / 1e3
        top = sorted(split.items(), key=lambda kv: -kv[1])[:4]
        rates[base] = {"ms": sec * 1e3, "subspace_scorings_per_s": len(masks) / sec,
                       "n_masks": len(masks)}
        log(f"    decision_function {sec * 1e3:.3f} ms (median of 3 after a warm-up), "
            f"{len(masks) / sec:.1f} subspace-scorings/s"
            + (f" (the whole {len(subs)}-mask pool at this rate: {len(subs) / len(masks) * sec:.2f}"
               " s)" if len(masks) < len(subs) else "")
            + f"; {time.perf_counter() - t_base:.1f} s for the base in this phase")
        log(f"    on the device (profiler, one call over {len(prof_ens.subspaces)} masks, "
            f"{prof_ms:.3f} ms; {t_prof:.1f} s to profile) {busy_ms:.3f} ms, "
            f"{100.0 * busy_ms / prof_ms:.1f}% of the call: "
            + ", ".join(f"{name[:48]} {us / 1e3:.3f} ms" for name, us in top))

    k = STRESS_ENSEMBLE["k"]
    Xt, _ = outlier_rows(np.random.default_rng(21), STRESS_ENSEMBLE["n_test"], X.shape[1])
    for base in STRESS_BASES:
        ens = SubspaceEnsemble.from_model(model, STRESS_ENSEMBLE["subspace_count"], base=base,
                                          k=k).fit(X)
        sync()
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        scores = ens.decision_function(Xt)
        sec = time.perf_counter() - t0
        counts = KS.launch_counts()
        check(sum(counts.values()) == 0, f"stress {base}: KNN kernel launches {counts}")
        check(scores.shape == (len(Xt),) and np.all(np.isfinite(scores)),
              f"stress {base}: scores not finite")
        rates["stress " + base] = {"ms": sec * 1e3, "n_masks": len(ens.subspaces),
                                   "subspace_scorings_per_s": len(ens.subspaces) / sec}
        log(f"  stress ensemble {base} ({len(ens.subspaces)} masks, {len(X)} x {X.shape[1]} "
            f"train, {len(Xt)} test): decision_function {sec:.3f} s (first call), "
            f"{len(ens.subspaces) / sec:.1f} subspace-scorings/s, launches {counts}")
    log(f"  phase 3e: {time.perf_counter() - t_phase:.1f} s")
    return rates


def numpy_combine(member_scores, combination: str, weights=None):
    """The plain reference of the heterogeneous combination: each member's
    scores standardized in float64 over the batch and rounded to f32 (as
    the ensemble's member_scores), combined in float64. Returns
    (combined, weights or None)."""
    s = np.stack([np.asarray(x, np.float64) for x in member_scores])
    s = (s - s.mean(axis=1, keepdims=True)) / (s.std(axis=1, keepdims=True) + 1e-12)
    s = s.astype(np.float32).astype(np.float64)
    n = len(s)
    if combination == "max":
        return s.max(axis=0), None
    if combination == "median":
        return np.median(s, axis=0), None
    if combination == "weighted":
        w = np.asarray(weights, np.float64) / np.sum(weights)
        return w @ s, w
    if combination == "select":
        cons = s.mean(axis=0)
        cons = (cons - cons.mean()) / (cons.std() + 1e-12)
        w = np.clip((s * cons[None, :]).mean(axis=1), 0.0, None)
        w = w / w.sum() if w.sum() > 0 else np.full(n, 1.0 / n)
        return w @ s, w
    return s.mean(axis=0), None


def hold_recombination(het, got, member_outputs, label) -> str:
    """``got``, the ensemble's decision_function on the card, against the
    float64 numpy recombination of its members' own outputs on the same rows
    (``member_outputs``: their decision_function, or for 'vote' their
    predict labels); 'vote' must be equal. Returns what it found."""
    if het.combination == "vote":
        n = len(het.members)
        w = np.full(n, 1.0 / n) if het.weights is None else het.weights / het.weights.sum()
        want = (w @ np.stack(member_outputs).astype(np.float64)).astype(np.float32)
        check(np.array_equal(got, want), f"{label}: vote fractions differ from the members' labels")
        return "vs the float64 recombination of the members' own labels: equal"
    want, w = numpy_combine(member_outputs, het.combination, het.weights)
    err, top = float(np.max(np.abs(got - want))), float(np.max(np.abs(want)))
    check(err <= HETERO_FRAC * top,
          f"{label}: vs the float64 recombination max abs err {err:.3e} > {HETERO_FRAC * top:.3e}")
    if w is not None and het.combination == "select":
        w_err = float(np.max(np.abs(het.member_weights_ - w)))
        check(w_err <= HETERO_W_ATOL, f"{label}: member_weights_ {het.member_weights_} vs {w}")
    return (f"vs the float64 recombination of the members' own outputs max abs err {err:.3e} "
            f"of the largest {top:.4g} (limit {HETERO_FRAC} of it)")


def member_times(het, x) -> str:
    """Each member's own decision_function on ``x``, median of 3 (after the
    calls before it)."""
    parts = []
    for m in het.members:
        sec = median_seconds(functools.partial(m.decision_function, x))
        parts.append(f"{m.base} {sec * 1e3:.3f} ms")
    return ", ".join(parts)


def counted(label: str, fn, want: dict):
    """``fn()`` with the KNN counts set to 0 just before and read just after;
    they must equal ``want``. Returns (result, counts, seconds)."""
    from vgan_tpu_torch.ops.cuda import knn_score as KS

    sync()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync()
    sec = time.perf_counter() - t0
    counts = KS.launch_counts()
    full = dict(dict.fromkeys(counts, 0), **want)
    check(counts == full, f"{label}: launches {counts}, expected {full}")
    return out, counts, sec


def median_seconds(fn, calls: int = 3) -> float:
    """Median host-clock seconds of ``calls`` calls (after the caller's
    warm-up), each ending in its host fetch."""
    times = []
    for _ in range(calls):
        sync()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def lipschitz_limit(combination: str, d, w_card=None, w_host=None, z_host=None):
    """How far a row's combined score may move when the standardized member
    scores move by ``d`` (n_members, nt): 'average' / 'weighted' by the
    weighted mean of the moves, 'max' / 'median' by the largest, 'select'
    by its weights' mean plus what its weights' own change moves."""
    if combination == "average":
        return d.mean(axis=0)
    if combination in ("max", "median"):
        return d.max(axis=0)
    lim = w_card.astype(np.float64) @ d
    if combination == "select":
        lim = lim + np.abs(w_card.astype(np.float64) - w_host) @ np.abs(z_host)
    return lim


def hold_hetero_host(card, host, x, exclude_self: bool, label: str):
    """A non-vote ensemble on the card against the same ensemble on the
    host: each row within ENSEMBLE_FRAC of the largest score plus how far
    its members' measured moves can carry it (``lipschitz_limit``). Returns
    (card scores, host scores, row limits, member moves)."""
    got = card.decision_function(x, exclude_self=exclude_self)
    want = host.decision_function(x, exclude_self=exclude_self)
    zc = card.member_scores(x, exclude_self=exclude_self).astype(np.float64)
    zh = host.member_scores(x, exclude_self=exclude_self).astype(np.float64)
    d = np.abs(zc - zh)
    w, wh = None, None
    if card.combination == "weighted":
        w = card.weights / card.weights.sum()
    elif card.combination == "select":  # the weights of the calls above
        w, wh = card.member_weights_, host.member_weights_
    lim = ENSEMBLE_FRAC * float(np.max(np.abs(want))) + lipschitz_limit(card.combination, d, w,
                                                                         wh, zh)
    err = np.abs(got.astype(np.float64) - want)
    check(bool(np.all(err <= lim)), f"{label}: card vs host passes a row's limit by "
          f"{float(np.max(err - lim)):.3e}")
    return got, want, lim, d


def label_exposure(s_host, thr_card, thr_host, lim):
    """Rows whose host score sits within the card's allowed move (``lim``)
    plus the thresholds' own difference of the threshold."""
    return np.abs(np.asarray(s_host, np.float64) - thr_host) <= lim + abs(thr_card - thr_host)


def hold_vote_host(card, host, xtr, xte) -> int:
    """'vote' on the card against the host: equal fractions except on rows
    where some member's own predict score (train+test batch, self-pairs
    excluded) sits within its allowed move of its threshold: ENSEMBLE_FRAC
    of its largest score for knn and ecod (held here), its measured move for
    lof (whose near-ties phase 3e holds). Returns the exposed rows' count."""
    from vgan_tpu_torch.ensemble.hetero import _positional

    n_tr = len(xtr)
    both = np.concatenate([xtr, xte])
    got, want = card.decision_function(xte), host.decision_function(xte)
    exposed = np.zeros(len(xte), bool)
    for mc, mh in zip(card.members, host.members):
        sc = mc.decision_function(both, exclude_self=_positional(mc)).astype(np.float64)
        sh = mh.decision_function(both, exclude_self=_positional(mh)).astype(np.float64)
        err = np.abs(sc - sh)
        if mc.base in NEIGHBOR_BASES:
            lim = err
        else:
            lim = np.full(len(sh), ENSEMBLE_FRAC * float(np.max(np.abs(sh))))
            check(bool(np.all(err <= lim)), f"vote member {mc.base}: card vs host max abs err "
                                            f"{float(err.max()):.3e} > {float(lim[0]):.3e}")
        q = 1.0 - mc.contamination
        exposed |= label_exposure(sh[n_tr:], np.quantile(sc[:n_tr], q),
                                  np.quantile(sh[:n_tr], q), lim[n_tr:])
    check(np.array_equal(got[~exposed], want[~exposed]),
          f"vote: card and host fractions differ on {int(np.sum(got[~exposed] != want[~exposed]))}"
          " unexposed rows")
    return int(exposed.sum())


def hold_bench_host(make, masks, xtr, xte, label, log) -> None:
    """Every bench ensemble of phase 3f on the pool's first CHECK_MASKS masks
    (the whole pool's lof takes minutes on the host's CPU), on the card
    against the same ensemble with device='cpu': scores (``hold_hetero_host``),
    each member's own scores (knn and ecod within ENSEMBLE_FRAC; lof's
    near-ties are held in phase 3e, and its measured moves enter the limits),
    and the label decisions, equal except on exposed rows."""
    n_tr = len(xtr)
    both = np.concatenate([xtr, xte])
    masks = masks[:CHECK_MASKS]
    for c in HETERO_COMBINATIONS:
        card, host = make(c, masks), make(c, masks, device="cpu")
        lab = f"{label} {c}, first {len(masks)} masks, card vs host"
        if c == "vote":
            n_exp = hold_vote_host(card, host, xtr, xte)
            lab_c, lab_h = card.predict(xte), host.predict(xte)
            check(np.array_equal(lab_c, (card.decision_function(xte) > 0.5).astype(np.int64)),
                  f"{lab}: predict is not the strict majority")
            log(f"  {lab}: vote fractions equal on {len(xte) - n_exp} rows, {n_exp} exposed; "
                f"predict labels differ on {int(np.sum(lab_c != lab_h))} rows")
            continue
        got, want, lim, d = hold_hetero_host(card, host, xte, False, lab)
        tight = float(np.max(np.abs(got - want)))
        log(f"  {lab}: max abs err {tight:.3e} (row limits {float(lim.min()):.3e} to "
            f"{float(lim.max()):.3e}); members' standardized moves up to "
            + ", ".join(f"{m.base} {float(x):.3e}" for m, x in zip(card.members, d.max(axis=1))))
        if c != "average":
            continue
        for mc, mh in zip(card.members, host.members):
            rc, rh = mc.decision_function(xte), mh.decision_function(xte)
            err = np.abs(rc.astype(np.float64) - rh)
            lim_m = ENSEMBLE_FRAC * float(np.max(np.abs(rh)))
            if mc.base not in NEIGHBOR_BASES:
                check(bool(np.all(err <= lim_m)), f"{lab} member {mc.base}: max abs err "
                                                  f"{float(err.max()):.3e} > {lim_m:.3e}")
            log(f"    member {mc.base}: card vs host max abs err {float(err.max()):.3e}, "
                f"{int(np.sum(err > lim_m))} rows beyond {lim_m:.3e}"
                + (" (near-ties: phase 3e)" if mc.base in NEIGHBOR_BASES else ""))
        lab_c, lab_h = card.predict(xte), host.predict(xte)
        thr_c, thr_h = card.threshold_, host.threshold_
        _, want_b, lim_b, _ = hold_hetero_host(card, host, both, True, f"{lab} predict batch")
        exposed = label_exposure(want_b[n_tr:], thr_c, thr_h, lim_b[n_tr:])
        check(np.array_equal(lab_c[~exposed], lab_h[~exposed]),
              f"{lab}: predict labels differ on unexposed rows")
        log(f"    predict: threshold_ {thr_c:.6f} (host {thr_h:.6f}), labels equal on "
            f"{int((~exposed).sum())} rows, {int(exposed.sum())} exposed, "
            f"{int(np.sum(lab_c != lab_h))} differ")


def distiller_f64(dist, x_tr, s_tr, x):
    """A float64 host run of the fitted distiller ``dist`` on its own draws
    (W, b) and transforms, fitted to the same train scores: features, solve
    and GCV in float64. Returns (predictions on ``x``, the GCV values)."""
    from vgan_tpu_torch.ensemble import distill as TD

    p = {k: v.double().cpu() if torch.is_tensor(v) else v for k, v in dist._params.items()}

    def standardized(a):
        return (torch.from_numpy(np.asarray(a, np.float64)) - p["x_mu"]) / p["x_sd"]

    y = (torch.from_numpy(np.asarray(s_tr, np.float32).astype(np.float64)) - p["y_mu"]) / p["y_sd"]
    ridges = TD._GCV_RIDGES if dist.ridge == "gcv" else (dist.ridge,)
    betas, gcvs = TD._rff_fit_gcv(standardized(x_tr), y, p["w"], p["b"],
                                  torch.tensor(ridges, dtype=torch.float64), dist.n_features)
    pick = ridges.index(dist.ridge_)  # the card's pick; the caller holds the host's to it
    pred = TD._rff_predict(standardized(x), p["w"], p["b"], betas[pick], dist.n_features)
    return (pred * p["y_sd"] + p["y_mu"]).numpy(), gcvs.numpy()


def gcv_margin(gcvs) -> float:
    """Relative gap between the two smallest GCV values (inf for one ridge)."""
    g = np.sort(np.asarray(gcvs, np.float64))
    return float((g[1] - g[0]) / g[0]) if len(g) > 1 else float("inf")


def phase_hetero(device, model, X, log) -> dict:
    """The heterogeneous ensemble (``vgan_tpu``'s default members knn, lof,
    ecod) through the public API with the KNN counts read around every call:
    at the stress width from the phase-3 model (K7: one launch a call) and on
    the bench data (K6), each call held to a float64 numpy recombination of
    its members' own outputs, the bench ensembles also to the same ensembles
    on the host (first CHECK_MASKS masks), then distilled. Returns each
    kernel's launches and the calls' times."""
    from vgan_tpu_torch import HeterogeneousEnsemble
    from vgan_tpu_torch.ensemble.distill import _GCV_RIDGES
    from vgan_tpu_torch.ensemble.hetero import _positional

    t_phase = time.perf_counter()
    K6, K7 = "knn_scores_resident", "knn_scores_stream"
    launches = {K6: 0, K7: 0}
    times = {}

    def run(label, fn, kernel, n):
        out, counts, sec = counted(label, fn, {kernel: n})
        launches[kernel] += n
        return out, counts, sec

    # the stress width: the phase-3 model's pool, 2000 x 10240 train rows
    k = STRESS_ENSEMBLE["k"]
    Xt, is_out = outlier_rows(np.random.default_rng(21), STRESS_ENSEMBLE["n_test"], X.shape[1])
    het = HeterogeneousEnsemble.from_model(model, STRESS_ENSEMBLE["subspace_count"],
                                           members=list(HETERO_MEMBERS), k=k).fit(X)
    check(het.device.type == "cuda" and all(m.device == het.device for m in het.members),
          f"the heterogeneous ensemble runs on {het.device}")
    ens = {"average": het}
    for c in ("select", "vote"):
        ens[c] = HeterogeneousEnsemble(model.subspaces, model.proba, members=list(HETERO_MEMBERS),
                                       combination=c, k=k).fit(X)
    label = (f"stress hetero ({len(model.subspaces)} masks, {len(X)} x {X.shape[1]} train, "
             f"{len(Xt)} test, k={k})")
    calls = [(f"decision_function {c}", functools.partial(ens[c].decision_function, Xt))
             for c in ("average", "select", "vote")]
    calls += [("predict", functools.partial(het.predict, Xt)),
              ("predict_proba linear", functools.partial(het.predict_proba, Xt, "linear"))]
    outs = {}
    for name, fn in calls:
        outs[name], counts, first = run(f"{label} {name}", fn, K7, 1)
        times["stress " + name] = median_seconds(fn)
        log(f"  {label} {name}: launches {counts}; {first:.3f} s first call, "
            f"{times['stress ' + name]:.3f} s (median of 3 after it)")
    train_scores, counts, _ = run(f"{label} decision_scores_", lambda: het.decision_scores_, K7, 1)
    train_labels, counts_l, _ = run(f"{label} labels_", lambda: het.labels_, K7, 0)
    log(f"  {label} decision_scores_: launches {counts}; labels_: launches {counts_l}")
    for name in ("decision_function average", "decision_function select",
                 "decision_function vote"):
        check(outs[name].shape == (len(Xt),) and np.all(np.isfinite(outs[name])),
              f"{label} {name}: scores not finite")
    check(set(np.unique(outs["predict"])) <= {0, 1}, f"{label}: predict labels")
    proba = outs["predict_proba linear"]
    check(proba.shape == (len(Xt), 2) and np.all((proba >= 0) & (proba <= 1))
          and np.allclose(proba.sum(axis=1), 1.0), f"{label}: predict_proba")
    check(train_scores.shape == (len(X),) and np.all(np.isfinite(train_scores)),
          f"{label}: decision_scores_ not finite")
    check(np.array_equal(train_labels, (train_scores > het.threshold_).astype(np.int64))
          and het.threshold_ == float(np.quantile(train_scores, 1.0 - het.contamination)),
          f"{label}: labels_ != decision_scores_ > threshold_")
    member_out = [m.decision_function(Xt) for m in het.members]
    member_labels = [m.predict(Xt) for m in ens["vote"].members]
    for c in ("average", "select", "vote"):
        found = hold_recombination(ens[c], outs[f"decision_function {c}"],
                                   member_labels if c == "vote" else member_out, f"{label} {c}")
        log(f"  {label} {c}: {found}; ROC AUC of the {N_OUTLIERS} planted outliers "
            f"{roc_auc(outs[f'decision_function {c}'], is_out):.4f}"
            + (f"; member_weights_ {ens[c].member_weights_}" if c == "select" else ""))
    log(f"  {label} members' own decision_function: {member_times(het, Xt)}")
    log(f"    (AUC not asserted: the masks come from a 2-epoch fit); "
        f"{int(outs['predict'].sum())} of {len(Xt)} test rows labelled outliers")
    _, counts, sec = run(f"{label} distill(members=[0])",
                         lambda: het.distill(members=[0], n_features=DISTILL_FEATURES), K7, 1)
    dist = het._distillers[0]
    times["stress distill"] = sec
    scores, counts_d, sec_d = run(f"{label} decision_function after distill",
                                  functools.partial(het.decision_function, Xt), K7, 0)
    check(np.all(np.isfinite(scores)), f"{label}: distilled scores not finite")
    log(f"  {label} distill(members=[0], n_features={DISTILL_FEATURES}): launches {counts}, "
        f"{sec:.3f} s (one float64 eigh of {DISTILL_FEATURES + X.shape[1]} x "
        f"{DISTILL_FEATURES + X.shape[1]}); ridge_ {dist.ridge_}, GCV margin "
        f"{gcv_margin(dist._gcvs):.3e}; then decision_function: launches {counts_d}, "
        f"{sec_d:.3f} s, ROC AUC {roc_auc(scores, is_out):.4f}")

    # the bench data: 1024 masks, d=100 (K6)
    cfg = BENCH_ENSEMBLE
    xtr, xte, is_out, subs = bench_data()
    n_tr = len(xtr)

    def make(c, masks, members=HETERO_MEMBERS, device=None):
        return HeterogeneousEnsemble(
            masks, np.full(len(masks), 1.0 / len(masks)), members=list(members), combination=c,
            weights=HETERO_WEIGHTS if c == "weighted" else None, k=cfg["k"], device=device,
        ).fit(xtr)

    label = f"bench hetero ({len(subs)} masks, {n_tr} x {cfg['d']} train, {len(xte)} test)"
    bench = {c: make(c, subs) for c in HETERO_COMBINATIONS}
    member_out = [m.decision_function(xte) for m in bench["average"].members]
    member_labels = [m.predict(xte) for m in bench["vote"].members]
    for c, e in bench.items():
        fn = functools.partial(e.decision_function, xte)
        scores, counts, _ = run(f"{label} {c}", fn, K6, 1)
        times["bench " + c] = median_seconds(fn)
        found = hold_recombination(e, scores, member_labels if c == "vote" else member_out,
                                   f"{label} {c}")
        auc = roc_auc(scores, is_out)
        check(auc >= BENCH_AUC_MIN, f"{label} {c}: ROC AUC {auc:.4f} < {BENCH_AUC_MIN}")
        log(f"  {label} {c}: launches {counts}; {times['bench ' + c] * 1e3:.3f} ms (median of 3 "
            f"after a warm-up); {found}; ROC AUC {auc:.4f}"
            + (f"; member_weights_ {e.member_weights_}" if c == "select" else ""))
    e = bench["average"]
    log(f"  {label} members' own decision_function: {member_times(e, xte)}")
    labels, counts, _ = run(f"{label} predict", functools.partial(e.predict, xte), K6, 1)
    check(set(np.unique(labels)) <= {0, 1} and labels[:N_OUTLIERS].all(),
          f"{label}: predict misses a planted outlier")
    jl = make("average", subs, (HETERO_JL, *HETERO_MEMBERS))
    s_jl, counts_jl, _ = run(f"{label} JL member first, decision_function",
                             functools.partial(jl.decision_function, xte), K6, 2)
    labels_jl, _, _ = run(f"{label} JL member first, predict", functools.partial(jl.predict, xte),
                          K6, 2)
    auc = roc_auc(s_jl, is_out)
    check(auc >= BENCH_AUC_MIN and labels_jl[:N_OUTLIERS].all(),
          f"{label} JL member first: ROC AUC {auc:.4f}")
    log(f"  {label} predict: launches {counts}; {int(labels.sum())} of {len(xte)} labelled "
        f"outliers; JL member first (jl_dim={HETERO_JL['jl_dim']}): decision_function launches "
        f"{counts_jl}, ROC AUC {auc:.4f}, predict {int(labels_jl.sum())} labelled outliers")
    _, counts, sec = run(f"{label} distill()", functools.partial(e.distill,
                                                                 n_features=DISTILL_FEATURES),
                         K6, 1)
    s_d, counts_d, _ = run(f"{label} decision_function, every member distilled",
                           functools.partial(e.decision_function, xte), K6, 0)
    log(f"  {label} distill(): launches {counts}, {sec:.3f} s; then decision_function: "
        f"launches {counts_d}, ROC AUC {roc_auc(s_d, is_out):.4f}")
    for i, m in enumerate(e.members):
        dist = e._distillers[i]
        s_tr = m.decision_function(xtr, exclude_self=_positional(m))
        want, gcvs = distiller_f64(dist, xtr, s_tr, xte)
        margin = gcv_margin(gcvs)
        host_pick = (_GCV_RIDGES[int(np.argmin(gcvs))] if dist.ridge == "gcv"
                     else dist.ridge)
        check(host_pick == dist.ridge_ or margin <= GCV_MARGIN_MIN,
              f"{label} member {i}: ridge_ {dist.ridge_} on the card, {host_pick} in float64 "
              f"with a GCV margin {margin:.3e}")
        err = float(np.max(np.abs(dist.predict(xte) - want)))
        lim = DISTILL_FRAC * float(np.max(np.abs(want)))
        check(err <= lim, f"{label} member {i}: distiller vs float64 max abs err {err:.3e} > "
                          f"{lim:.3e}")
        log(f"    distiller {i} ({m.base}): ridge_ {dist.ridge_} (float64 host run: {host_pick}, "
            f"GCV margin {margin:.3e}); predictions vs the float64 host run max abs err "
            f"{err:.3e} (limit {lim:.3e})")
    hold_bench_host(make, subs, xtr, xte, label, log)
    log(f"  phase 3f: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "times": times}


def cli(argv) -> str:
    """``vgan_tpu_torch.cli.main(argv)`` in this process; its stdout."""
    from vgan_tpu_torch import cli as C

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = C.main(argv)
    check(rc == 0, f"vgan_tpu_torch {' '.join(argv)} returned {rc}")
    return out.getvalue()


def mb(path) -> float:
    return Path(path).stat().st_size / 1e6


def generic_member_moves(het, x):
    """(live standardized member scores, the same from the generic path the
    exported program runs, their absolute difference): a knn member's live
    call rides K6 / K7 and its program the generic chunked path; the other
    members and a distilled one run the same path either way."""
    from vgan_tpu_torch.ensemble.od import _zscore

    rows = []
    for i, m in enumerate(het.members):
        if i in het._distillers:
            rows.append(het._distillers[i].predict(x))
        elif m.base in ("knn", "knn_mean"):
            xd = m._as_device(m._project(np.asarray(x)))
            rows.append(m._native_scores(xd, False, reduce=True).cpu().numpy())
        else:
            rows.append(m.decision_function(x))
    z_gen = _zscore(torch.as_tensor(np.stack(rows).astype(np.float64))).float().numpy()
    z_live = het.member_scores(x)
    return z_live.astype(np.float64), z_gen.astype(np.float64), np.abs(z_live - z_gen)


def phase_serving(device, model, X, log) -> dict:
    """Serving and the CLI at full width. The CLI in this process on the
    stress rows (``fit`` counts K2, ``score --base knn`` K7), ``python3 -m
    vgan_tpu_torch`` once, the stress sampler's and the stress knn
    ensemble's exported programs against their live calls, and on the bench
    data the per-subspace (knn) and heterogeneous exports (first
    SERVING_MASKS masks) and the iforest, loda and ocsvm ensemble exports
    (first CHECK_MASKS), each sized for the batch it serves. Each loaded program is
    called twice for the same bits and launches no kernel. Returns the CLI's
    K2 and K7 launches."""
    from vgan_tpu_torch import HeterogeneousEnsemble, SubspaceEnsemble, VGAN_no_kl
    from vgan_tpu_torch import serving as S
    from vgan_tpu_torch.ensemble.hetero import _combine
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    t_phase = time.perf_counter()
    # torch.export traces in Python: keep the cyclic collector off the
    # objects the earlier phases left (the traces took twice as long in the
    # full smoke as alone)
    gc.collect()
    gc.freeze()
    card = card_identity()
    n, d = X.shape
    k, nsubs = STRESS_ENSEMBLE["k"], STRESS_ENSEMBLE["subspace_count"]
    Xt, _ = outlier_rows(np.random.default_rng(21), STRESS_ENSEMBLE["n_test"], d)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.save(tmp / "stress.npy", X)
        np.save(tmp / "test.npy", Xt)
        # the CLI in process, the launch counts read around each call
        sync()
        G.reset_launch_counts()
        t0 = time.perf_counter()
        out = cli(["fit", "--data", str(tmp / "stress.npy"), "--epochs", "2", "--out",
                   str(tmp / "run"), "--quiet"])
        sync()
        sec = time.perf_counter() - t0
        counts = G.launch_counts()
        steps = 2 * (n // 500)
        check(counts["gram_quadrant_sums_stash"] == steps and sum(counts.values()) == steps,
              f"CLI fit launched {counts}, expected {steps} of K2 only")
        launches["gram_quadrant_sums_stash"] = steps
        gen = tmp / "run" / "models" / "generator_0.pt"
        check(gen.is_file() and out.startswith("final loss: "), f"CLI fit wrote no {gen}")
        log(f"  cli fit --epochs 2 ({n} x {d}): {sec:.2f} s, launches {counts}; "
            f"{out.strip()}")
        loaded = VGAN_no_kl(verbose=False)
        loaded.load_models(gen, ndims=d)
        check(next(loaded.generator.parameters()).device.type == "cuda",
              "the loaded generator is not on the card")
        _, counts, sec = counted("cli sample", lambda: cli([
            "sample", "--generator", str(gen), "--ndims", str(d), "--nsubs", str(nsubs),
            "--out", str(tmp / "masks.npy")]), {})
        check(np.array_equal(np.load(tmp / "masks.npy"), loaded.generate_subspaces(nsubs)),
              "CLI sample masks differ from generate_subspaces")
        log(f"  cli sample ({nsubs} masks): {sec:.2f} s, equal to generate_subspaces")
        out, _, sec = counted("cli check-myopic", lambda: cli([
            "check-myopic", "--data", str(tmp / "stress.npy"), "--generator", str(gen)]), {})
        check("p-val" in out and "recommended bandwidth" in out, f"CLI check-myopic: {out}")
        log(f"  cli check-myopic (count 500): {sec:.2f} s: {' '.join(out.split())}")
        _, counts, sec = counted("cli score", lambda: cli([
            "score", "--train", str(tmp / "stress.npy"), "--test", str(tmp / "test.npy"),
            "--generator", str(gen), "--base", "knn", "--subspaces", str(nsubs), "--k", str(k),
            "--out", str(tmp / "scores.npy")]), {"knn_scores_stream": 1})
        launches["knn_scores_stream"] = 1
        got = np.load(tmp / "scores.npy")
        want = SubspaceEnsemble.from_model(loaded, nsubs, base="knn", k=k).fit(X) \
            .decision_function(Xt)
        err, lim = float(np.max(np.abs(got - want))), ENSEMBLE_FRAC * float(np.max(np.abs(want)))
        check(err <= lim, f"CLI score vs decision_function max abs err {err:.3e} > {lim:.3e}")
        log(f"  cli score --base knn --subspaces {nsubs} --k {k}: {sec:.2f} s, launches {counts}; "
            f"vs decision_function max abs err {err:.3e} (limit {lim:.3e})")
        t0 = time.perf_counter()
        cli(["export", "--generator", str(gen), "--ndims", str(d), "--out",
             str(tmp / "cli_sampler.pt2")])
        sec = time.perf_counter() - t0
        fn = S.load_sampler(tmp / "cli_sampler.pt2")
        check(np.array_equal(S.sample_masks(fn, nsubs, loaded._latent_size, loaded.seed),
                             loaded.generate_subspaces(nsubs)), "CLI export: masks differ")
        log(f"  cli export: {sec:.2f} s, {mb(tmp / 'cli_sampler.pt2'):.1f} MB; its masks equal "
            "generate_subspaces")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "vgan_tpu_torch", "sample", "--generator",
                              str(gen), "--ndims", str(d), "--nsubs", "50", "--out",
                              str(tmp / "masks50.npy")], capture_output=True, text=True,
                             timeout=300, cwd=Path(__file__).resolve().parent)
        check(run.returncode == 0, f"python3 -m vgan_tpu_torch sample: {run.stderr[-2000:]}")
        check(np.array_equal(np.load(tmp / "masks50.npy"), loaded.generate_subspaces(50)),
              "python3 -m vgan_tpu_torch sample: masks differ")
        log(f"  python3 -m vgan_tpu_torch sample (a subprocess on the card): "
            f"{time.perf_counter() - t0:.2f} s, masks equal")

        # the stress sampler (the phase-3 model)
        t0 = time.perf_counter()
        S.export_sampler(model, tmp / "sampler.pt2")
        sec = time.perf_counter() - t0
        fn = S.load_sampler(tmp / "sampler.pt2")
        got = S.sample_masks(fn, nsubs, model._latent_size, model.seed)
        want = model.generate_subspaces(nsubs)
        differ = np.flatnonzero((got != want).any(axis=1))
        if len(differ):
            g = torch.Generator().manual_seed(int(model.seed))
            z = torch.randn((nsubs, model._latent_size), generator=g).double()
            gen64 = {name: v.double().cpu() for name, v in model.generator.state_dict().items()}
            h = z
            for i in range(4):
                h = h @ gen64[f"main.{i}.weight"].T + gen64[f"main.{i}.bias"]
            u = torch.softmax(h, dim=-1)
            margin = torch.abs(u - 1.0 / d).min(dim=-1).values / (1.0 / d)
            log(f"  sampler rows differing: {differ.tolist()}; float64 margins "
                f"{margin[differ].tolist()}")
        check(len(differ) == 0, f"the loaded sampler's masks differ on {len(differ)} rows")
        check(np.array_equal(got, S.sample_masks(fn, nsubs, model._latent_size, model.seed)),
              "the loaded sampler's second call differs")
        n_params = sum(p.numel() for p in model.generator.parameters())
        log(f"  export_sampler (stress generator, {n_params} parameters): {sec:.2f} s, "
            f"{mb(tmp / 'sampler.pt2'):.1f} MB; {nsubs} masks equal to generate_subspaces, "
            f"twice ({card})")

        # the stress knn ensemble (phase 3c's) through its program, sized
        # for the batch it serves (max_batch = 500: the chunk the live
        # generic path takes; 4096 would unroll 250 chunks of 2 masks)
        ens = SubspaceEnsemble.from_model(model, nsubs, base="knn", k=k).fit(X)
        t0 = time.perf_counter()
        S.export_ensemble_scorer(ens, tmp / "stress.pt2", max_batch=len(Xt))
        sec = time.perf_counter() - t0
        fn = S.load_ensemble_scorer(tmp / "stress.pt2")
        got, counts, first = counted("stress program", functools.partial(fn, Xt), {})
        check(np.array_equal(got, fn(Xt)), "the stress program's second call differs")
        want, _, _ = counted("stress live", functools.partial(ens.decision_function, Xt),
                             {"knn_scores_stream": 1})
        err, lim = float(np.max(np.abs(got - want))), ENSEMBLE_FRAC * float(np.max(np.abs(want)))
        check(err <= lim, f"stress program vs live K7 max abs err {err:.3e} > {lim:.3e}")
        t_prog = median_seconds(functools.partial(fn, Xt))
        t_live = median_seconds(functools.partial(ens.decision_function, Xt))
        log(f"  export_ensemble_scorer (stress knn, {len(ens.subspaces)} masks, {n} x {d} "
            f"train): {sec:.2f} s, {mb(tmp / 'stress.pt2'):.1f} MB; the program on {len(Xt)} "
            f"rows {t_prog * 1e3:.3f} ms (first call {first * 1e3:.3f} ms, no kernel launch) "
            f"against the live decision_function {t_live * 1e3:.3f} ms (K7), median of 3; "
            f"max abs err {err:.3e} (limit {lim:.3e}) ({card})")

        # the bench data: the per-subspace and heterogeneous programs on the
        # first SERVING_MASKS masks (one lof chunk for batches of 500; the
        # whole pool's lof would unroll 32 chunks into its program)
        xtr, xte, _, subs = bench_data()
        cfg, nt = BENCH_ENSEMBLE, len(xte)
        subs = subs[:SERVING_MASKS]
        raw = SubspaceEnsemble(subs, np.full(len(subs), 1.0 / len(subs)), k=cfg["k"],
                               normalize=None).fit(xtr)
        t0 = time.perf_counter()
        S.export_per_subspace_scorer(raw, tmp / "per.pt2", max_batch=nt)
        sec = time.perf_counter() - t0
        fn = S.load_ensemble_scorer(tmp / "per.pt2")
        got, _, _ = counted("per-subspace program", functools.partial(fn, xte), {})
        check(np.array_equal(got, fn(xte)), "the per-subspace program's second call differs")
        want, _, _ = counted("per-subspace live", functools.partial(raw.per_subspace_scores, xte),
                             {"knn_scores_resident": 1})
        # K6's squared scores against the generic path's: phase 2's bound,
        # KNN_D2_FRAC of max(an + bn) per mask
        m = subs.astype(np.float64)
        scale = ((xte.astype(np.float64) ** 2) @ m.T).max(axis=0) \
            + ((xtr.astype(np.float64) ** 2) @ m.T).max(axis=0)
        e2 = np.abs(got.astype(np.float64) ** 2 - want.astype(np.float64) ** 2)
        check(bool(np.all(e2 <= KNN_D2_FRAC * scale[:, None])),
              f"per-subspace program vs K6: squared scores off by up to "
              f"{float(np.max(e2 / scale[:, None])):.3e} of max(an + bn)")
        log(f"  export_per_subspace_scorer (bench knn, {len(subs)} masks, raw): {sec:.2f} s, "
            f"{mb(tmp / 'per.pt2'):.2f} MB; squared scores vs K6 within "
            f"{float(np.max(e2 / scale[:, None])):.3e} of max(an + bn) (limit {KNN_D2_FRAC})")
        for label, c, distill in (("average", "average", None), ("select", "select", None),
                                  ("knn distilled", "average", [0])):
            het = HeterogeneousEnsemble(subs, np.full(len(subs), 1.0 / len(subs)),
                                        members=list(HETERO_MEMBERS), combination=c,
                                        k=cfg["k"]).fit(xtr)
            if distill:
                het.distill(members=distill, n_features=DISTILL_FEATURES)
            t0 = time.perf_counter()
            S.export_hetero_scorer(het, tmp / "het.pt2", max_batch=nt)
            sec = time.perf_counter() - t0
            fn = S.load_ensemble_scorer(tmp / "het.pt2")
            got, _, _ = counted(f"hetero {label} program", functools.partial(fn, xte), {})
            check(np.array_equal(got, fn(xte)), f"hetero {label}: second call differs")
            want = het.decision_function(xte)
            z_live, z_gen, moves = generic_member_moves(het, xte)
            w_live = w_gen = None
            if c == "select":
                w_live = het.member_weights_
                w_gen = _combine(torch.from_numpy(z_gen), "select")[1].numpy()
            lim = ENSEMBLE_FRAC * float(np.max(np.abs(want))) + lipschitz_limit(
                c, moves, w_live, w_gen, z_gen)
            err = np.abs(got.astype(np.float64) - want)
            check(bool(np.all(err <= lim)), f"hetero {label} program vs live passes a row's "
                                            f"limit by {float(np.max(err - lim)):.3e}")
            log(f"  export_hetero_scorer (bench, knn + lof + ecod, {label}): {sec:.2f} s, "
                f"{mb(tmp / 'het.pt2'):.2f} MB; vs live max abs err {float(err.max()):.3e} "
                f"(row limits from {float(lim.min()):.3e}; the knn member's standardized "
                f"move up to {float(moves.max()):.3e})")
        # raw scores (normalize=None), so that phase 3e's per-mask limits
        # carry over: a row of the average within RAW_RTOL of the mean |raw
        # score| over the masks plus RAW_ATOL_FRAC of the largest
        proba = np.full(CHECK_MASKS, 1.0 / CHECK_MASKS)
        for base in ("iforest", "loda", "ocsvm"):
            ens = SubspaceEnsemble(subs[:CHECK_MASKS], proba, base=base, k=cfg["k"],
                                   normalize=None).fit(xtr)
            t0 = time.perf_counter()
            S.export_ensemble_scorer(ens, tmp / f"{base}.pt2", max_batch=nt)
            sec = time.perf_counter() - t0
            fn = S.load_ensemble_scorer(tmp / f"{base}.pt2")
            got, _, t_prog = counted(f"{base} program", functools.partial(fn, xte), {})
            check(np.array_equal(got, fn(xte)), f"{base} program: second call differs")
            raw_live, _, t_live = counted(f"{base} live", functools.partial(
                ens._raw_per_subspace, xte), {})
            raw_live = raw_live.astype(np.float64)
            want = proba @ raw_live  # the live decision_function, in float64
            lim = (RAW_RTOL[base] * (proba @ np.abs(raw_live))
                   + RAW_ATOL_FRAC * float(np.abs(raw_live).max()))
            err = np.abs(got.astype(np.float64) - want)
            check(bool(np.all(err <= lim)), f"{base} program vs live passes a row's limit by "
                                            f"{float(np.max(err - lim)):.3e}")
            log(f"  export_ensemble_scorer (bench {base}, {CHECK_MASKS} masks, raw): {sec:.2f} s, "
                f"{mb(tmp / f'{base}.pt2'):.2f} MB; program {t_prog * 1e3:.1f} ms, live "
                f"{t_live * 1e3:.1f} ms (first calls); max abs err {float(err.max()):.3e} (row "
                f"limits from {float(lim.min()):.3e}); two calls equal")
    gc.unfreeze()
    log(f"  phase 3g: {time.perf_counter() - t_phase:.1f} s")
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def same_history(label: str, got, want) -> str:
    """``got`` equal to ``want`` to the bit, or within RTOL_MESH_FIT."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{label}: history {got.shape} vs {want.shape}")
    if np.array_equal(got, want, equal_nan=True):
        return "equal to the bit"
    check(np.allclose(got, want, rtol=RTOL_MESH_FIT, atol=0.0, equal_nan=True),
          f"{label}: {got.tolist()} vs {want.tolist()}")
    seen = np.isfinite(want)
    gap = float(np.max(np.abs(got[seen] - want[seen]) / np.abs(want[seen])))
    return f"within {gap:.3e} relative (limit {RTOL_MESH_FIT})"


def phase_multidevice(device, n, d, batch, main_losses, kl_results, runs, log,
                      mesh_runs=None) -> dict:
    """The multi-device paths (``vgan_tpu_torch.parallel``) on the card, in
    an NCCL group of one rank over loopback (the one card of this machine):
    the data-parallel no-kl and kl stress fits with the columns sharded
    (K2; K1 and K3), held to phases 3 and 3b; the dp no-kl stress fit again
    with the three bf16 options (K2 bf16), its losses left in
    ``mesh_runs["no-kl bf16"]`` for phase 3i, which holds them to its
    single-device fit to the bit; ``check_if_myopic`` on the kl
    mesh model at phase 3b's counts (K5 on the sharded permutation rows),
    held to phase 3b's p-values; the stress (K7) and bench (K6) knn
    ensembles with ``mesh=`` under 'average' and 'max', and each split into
    MESH_SHARDS mask shards (one count padding the pool) whose per-rank
    bodies run in turn and are combined as the all-reduce does, held to
    the unsharded calls within phase 3c's limit;
    the CLI's ``fit --mesh data=1 --shard-features`` (K2) and ``score --mesh
    data=1`` (K7); ``python3 -m vgan_tpu_torch._dryrun 4`` (gloo CPU ranks).
    Every item's kernel counts are set to 0 just before it and read just
    after. Returns the phase's launches of each kernel."""
    import torch.distributed as dist

    from vgan_tpu_torch import VGAN, SubspaceEnsemble, VGAN_no_kl
    from vgan_tpu_torch.ops.cuda import gof_gram as GG
    from vgan_tpu_torch.ops.cuda import mmd_gram as G
    from vgan_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count

    torch.cuda.set_device(device.index or 0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(data=1, model=1)
        probe = torch.arange(4.0, device=device)
        dist.all_reduce(probe)
        sync()
        check(dist.get_backend() == "nccl" and mesh.device_type == "cuda"
              and probe.tolist() == [0.0, 1.0, 2.0, 3.0],
              f"NCCL world of one: backend {dist.get_backend()}, mesh on {mesh.device_type}")
        log(f"  NCCL group of one over loopback, mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names} on {mesh.device_type}, an all_reduce on the card: "
            f"{time.perf_counter() - t0:.2f} s")

        X = np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)  # phase 3's rows
        steps = 2 * (n // batch)
        zero = dict.fromkeys(G.launch_counts(), 0)
        # each dp fit right after the same fit unsharded (warm), for its time
        plain_sec = fit_counts(X, device, epochs=2, batch_size=batch)[3]
        _, counts, losses, sec, updates = fit_counts(X, device, epochs=2, batch_size=batch,
                                                     mesh=mesh, shard_features=True)
        want = dict(zero, gram_quadrant_sums_stash=steps)
        check(counts == want, f"dp no-kl stress fit launched {counts}, expected {want}")
        check(updates == steps, f"dp no-kl stress fit: {updates} Adadelta launches, not {steps}")
        add(dict(counts, adadelta_multi=updates))
        log(f"  dp no-kl stress fit (mesh data=1 model=1, shard_features): {sec:.2f} s (the "
            f"unsharded fit just before: {plain_sec:.2f} s), launches {counts}; losses "
            f"{losses.tolist()}, "
            f"{same_history('dp no-kl stress fit', losses, main_losses)} to phase 3's")

        model, counts, losses, sec, updates = fit_counts(X, device, epochs=2, batch_size=batch,
                                                         mesh=mesh, shard_features=True,
                                                         **BF16_OPTIONS)
        want = dict(zero, gram_quadrant_sums_stash_bf16=steps)
        check(counts == want, f"dp no-kl stress fit with the bf16 options launched {counts}, "
                              f"expected {want}")
        check(updates == steps, f"dp no-kl stress fit with the bf16 options: {updates} Adadelta "
                                f"launches, not {steps}")
        check(model.generator.compute_dtype == torch.bfloat16,
              "dp no-kl stress fit: the generator does not compute in bf16")
        add(dict(counts, adadelta_multi=updates))
        if mesh_runs is not None:
            mesh_runs["no-kl bf16"] = losses
        log(f"  dp no-kl stress fit with the bf16 options (mesh, shard_features): {sec:.2f} s, "
            f"launches {counts}; losses {losses.tolist()} (held to phase 3i's fit)")

        plain_sec = fit_counts(X, device, cls=VGAN, epochs=2, batch_size=batch)[3]
        kl_model, counts, losses, sec, updates = fit_counts(X, device, cls=VGAN, epochs=2,
                                                            batch_size=batch, mesh=mesh,
                                                            shard_features=True)
        want = dict(zero, gram_quadrant_sums=2 * (n // batch), gram_backward_flash=n // batch)
        check(counts == want, f"dp kl stress fit launched {counts}, expected {want}")
        check(updates == n // batch,
              f"dp kl stress fit: {updates} Adadelta launches, not {n // batch}")
        add(dict(counts, adadelta_multi=updates))
        log(f"  dp kl stress fit (mesh, shard_features): {sec:.2f} s (the unsharded fit just "
            f"before: {plain_sec:.2f} s), launches {counts}; losses {losses.tolist()}, "
            f"{same_history('dp kl stress fit', losses, kl_results['losses'])} to phase 3b's")

        Xg = np.random.default_rng(5).standard_normal((GOF_ROWS, d), dtype=np.float32)
        for count, precision in ((GOF_COUNT_F64, "float64"), (GOF_COUNT_F32, "float32")):
            sync()
            GG.reset_launch_counts()
            t0 = time.perf_counter()
            p = kl_model.check_if_myopic(Xg, count=count, precision=precision,
                                         rng=np.random.default_rng(6)).to_numpy().ravel()
            sync()
            sec = time.perf_counter() - t0
            counts = GG.launch_counts()
            check(counts == {"a_times_k": 1},
                  f"mesh check_if_myopic({precision}) launched {counts}, expected one K5")
            add(counts)
            check(p.tolist() == kl_results["pvals"][precision],
                  f"mesh check_if_myopic({precision}) p-values {p.tolist()} vs phase 3b's "
                  f"{kl_results['pvals'][precision]}")
            log(f"  check_if_myopic with the mesh, count={count} {precision} (permutation "
                f"rows sharded over 'data'): {sec:.2f} s, launches {counts}; p-values "
                f"{p.tolist()} equal to phase 3b's")

        combine = {"average": lambda parts: torch.stack(parts).sum(dim=0),
                   "max": lambda parts: torch.stack(parts).amax(dim=0)}
        padded = 0
        for kind, kernel in (("stress", "knn_scores_stream"), ("bench", "knn_scores_resident")):
            ens, Xt = runs[kind, "knn"]
            for agg in ("average", "max"):
                pool = dict(base="knn", k=ens.k, aggregation=agg)
                single = SubspaceEnsemble(ens.subspaces, ens.proba, **pool).fit(
                    ens._train_matrix())
                want = single.decision_function(Xt)
                lim = ENSEMBLE_FRAC * float(np.max(np.abs(want)))
                mesh_ens = SubspaceEnsemble(ens.subspaces, ens.proba, mesh=mesh,
                                            **pool).fit(ens._train_matrix())
                got, counts, sec = counted(f"{kind} {agg} ensemble with mesh",
                                           lambda: mesh_ens.decision_function(Xt), {kernel: 1})
                add(counts)
                err = float(np.max(np.abs(got - want)))
                check(err <= lim,
                      f"{kind} {agg} ensemble with mesh: max abs err {err:.3e} > {lim:.3e}")
                log(f"  {kind} knn ensemble ('{agg}') with mesh= ({len(ens.subspaces)} masks): "
                    f"{sec:.3f} s, launches {counts}; vs the unsharded call max abs err "
                    f"{err:.3e} (limit {lim:.3e})")
                x_dev = mesh_ens._as_device(Xt)
                for shards in MESH_SHARDS:
                    pad = (-len(ens.subspaces)) % shards
                    padded += pad
                    parts, counts, sec = counted(
                        f"{kind} {agg} ensemble in {shards} shards",
                        lambda: [mesh_ens._mask_shard(x_dev, False, s, shards)
                                 for s in range(shards)],
                        {kernel: shards})
                    add(counts)
                    got = combine[agg](parts).cpu().numpy()  # what the all-reduce does
                    err = float(np.max(np.abs(got - want)))
                    check(np.all(np.isfinite(got)) and err <= lim,
                          f"{kind} {agg} ensemble in {shards} shards ({pad} padding masks): "
                          f"max abs err {err:.3e} > {lim:.3e}")
                    log(f"  {kind} knn ensemble ('{agg}') as {shards} mask shards in turn "
                        f"(each rank's body; {pad} zero-weight padding masks): {sec:.3f} s, "
                        f"launches {counts}; their {'sum' if agg == 'average' else 'max'} vs "
                        f"the unsharded call max abs err {err:.3e} (limit {lim:.3e})")
        check(padded > 0, "no shard split of phase 3h padded its pool")

        ens, Xt = runs["stress", "knn"]
        k, nsubs = ens.k, len(ens.subspaces)
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            np.save(tmp / "stress.npy", X)
            np.save(tmp / "test.npy", Xt)
            sync()
            G.reset_launch_counts()
            t0 = time.perf_counter()
            out = cli(["fit", "--data", str(tmp / "stress.npy"), "--epochs", "2", "--batch-size",
                       str(batch), "--mesh", "data=1", "--shard-features", "--out",
                       str(tmp / "run"), "--quiet"])
            sync()
            sec = time.perf_counter() - t0
            counts = G.launch_counts()
            check(counts == dict(zero, gram_quadrant_sums_stash=steps),
                  f"cli fit --mesh launched {counts}")
            add(counts)
            gen = tmp / "run" / "models" / "generator_0.pt"
            final = float(out.split("final loss: ")[1].split()[0])
            check(gen.is_file(), f"cli fit --mesh wrote no {gen}")
            log(f"  cli fit --mesh data=1 --shard-features --epochs 2: {sec:.2f} s, launches "
                f"{counts}; final loss {final!r}, "
                f"{same_history('cli fit --mesh', [final], main_losses[-1:])} to phase 3's")
            loaded = VGAN_no_kl(verbose=False)
            loaded.load_models(gen, ndims=d)
            _, counts, sec = counted("cli score --mesh", lambda: cli([
                "score", "--train", str(tmp / "stress.npy"), "--test", str(tmp / "test.npy"),
                "--generator", str(gen), "--base", "knn", "--subspaces", str(nsubs), "--k",
                str(k), "--mesh", "data=1", "--out", str(tmp / "scores.npy")]),
                {"knn_scores_stream": 1})
            add(counts)
            got = np.load(tmp / "scores.npy")
            want = SubspaceEnsemble.from_model(loaded, nsubs, base="knn", k=k).fit(X) \
                .decision_function(Xt)
            err = float(np.max(np.abs(got - want)))
            lim = ENSEMBLE_FRAC * float(np.max(np.abs(want)))
            check(err <= lim, f"cli score --mesh vs decision_function max abs err {err:.3e}")
            log(f"  cli score --mesh data=1 --base knn: {sec:.2f} s, launches {counts}; vs the "
                f"unsharded decision_function max abs err {err:.3e} (limit {lim:.3e})")
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "vgan_tpu_torch._dryrun", "4"],
                         capture_output=True, text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent)
    ok = [line for line in run.stdout.splitlines() if "dryrun_multidevice OK" in line]
    check(run.returncode == 0 and len(ok) == 1,
          f"python3 -m vgan_tpu_torch._dryrun 4: rc {run.returncode}\n{run.stderr[-3000:]}")
    log(f"  python3 -m vgan_tpu_torch._dryrun 4 (gloo CPU ranks, no card): "
        f"{time.perf_counter() - t0:.2f} s: {ok[0]}")
    log(f"  phase 3h: {time.perf_counter() - t_phase:.1f} s; {card_identity()}; launches "
        f"{launches}")
    return launches


def phase_bf16_options(device, n, d, batch, main_losses, kl_losses, log, mesh_losses=None) -> dict:
    """The three bf16 options together through the estimators at the stress
    width (phase 3's rows): the no-kl stress fit (8 steps: K2's bf16 variant
    only), one kl cycle (a detector and a generator epoch: K1's and K3's)
    and a one-epoch panel fit (the K' stash off: K1's and K4's), each with
    the kernel counts set to 0 just before it and read just after, held to
    the same fit on the dense torch path with the same options, the first
    two also to phases 3 and 3b's f32 fits; the no-kl fit also to phase
    3h's dp fit with the options (``mesh_losses``), to the bit. Returns each
    variant's launches (K1's under the kl cycle and, apart, the panel fit)."""
    from vgan_tpu_torch import VGAN
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    t_phase = time.perf_counter()
    X = np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)
    zero = dict.fromkeys(G.launch_counts(), 0)
    steps = n // batch

    def fit(label, want, cls=None, epochs=2):
        model, counts, losses, sec, _ = fit_counts(X, device, cls, epochs=epochs, batch_size=batch,
                                                **BF16_OPTIONS)
        check(counts == dict(zero, **want), f"{label}: launched {counts}, expected {want}")
        _, plain_counts, plain, _, _ = fit_counts(X, device, cls, epochs=epochs, batch_size=batch,
                                               mmd_impl="torch", **BF16_OPTIONS)
        check(sum(plain_counts.values()) == 0, f"mmd_impl='torch' launched {plain_counts}")
        seen = np.isfinite(plain)
        gap = float(np.max(np.abs(losses[seen] - plain[seen]) / np.abs(plain[seen])))
        check(np.allclose(losses, plain, rtol=RTOL_FIT_LOSS, atol=0.0, equal_nan=True),
              f"{label}: kernel-path losses {losses} vs dense-path {plain}")
        log(f"  {label}: losses {losses.tolist()}, launches {counts}, {sec:.3f} s "
            f"({epochs * steps / sec:.2f} steps/s, the first call included); the dense torch "
            f"path with the options: losses {plain.tolist()}, largest relative gap {gap:.3e} "
            f"(limit {RTOL_FIT_LOSS})")
        state = model.train_state
        opt = state.det_opt if cls is VGAN else state.opt_state
        check(model.generator.compute_dtype == torch.bfloat16
              and all(t.dtype == torch.bfloat16 for t in opt.square_avg.values())
              and all(p.dtype == torch.float32 for p in model.generator.parameters()),
              f"{label}: the model or optimizer state is not as the options ask")
        return counts, losses

    def against_f32(label, losses, f32):
        seen = np.isfinite(f32)
        gap = float(np.max(np.abs(losses[seen] - f32[seen]) / np.abs(f32[seen])))
        check(np.allclose(losses, f32, rtol=RTOL_BF16_VS_F32, atol=0.0, equal_nan=True),
              f"{label}: bf16 losses {losses} vs the f32 fit's {f32}")
        log(f"  {label}: against the f32 fit's losses {f32.tolist()}: largest relative gap "
            f"{gap:.3e} (limit {RTOL_BF16_VS_F32}, vgan_tpu's own)")

    counts, losses = fit("no-kl stress fit, bf16 options",
                         {"gram_quadrant_sums_stash_bf16": 2 * steps})
    against_f32("no-kl stress fit, bf16 options", losses, main_losses)
    if mesh_losses is not None:
        check(np.array_equal(losses, mesh_losses),
              f"no-kl stress fit, bf16 options: {losses.tolist()} vs phase 3h's dp fit "
              f"{mesh_losses.tolist()}")
        log("  no-kl stress fit, bf16 options: equal to the bit to phase 3h's dp fit with them")
    launches = {"gram_quadrant_sums_stash_bf16": counts["gram_quadrant_sums_stash_bf16"]}
    counts, losses = fit("kl stress cycle, bf16 options",
                         {"gram_quadrant_sums_bf16": 2 * steps, "gram_backward_flash_bf16": steps},
                         cls=VGAN)
    against_f32("kl stress cycle, bf16 options", losses, kl_losses)
    launches["gram_quadrant_sums_bf16"] = counts["gram_quadrant_sums_bf16"]
    launches["gram_backward_flash_bf16"] = counts["gram_backward_flash_bf16"]
    saved = G._KP_STASH_BYTES
    G._KP_STASH_BYTES = 0
    try:
        panels = -(-batch * 2 // G._panel_rows(2 * batch))
        counts, _ = fit("panel fit, bf16 options", {"gram_quadrant_sums_bf16": steps,
                                                    "kprime_panel_bf16": steps * panels},
                        epochs=1)
    finally:
        G._KP_STASH_BYTES = saved
    launches["kprime_panel_bf16"] = counts["kprime_panel_bf16"]
    launches["gram_quadrant_sums_bf16", "panel fit"] = counts["gram_quadrant_sums_bf16"]
    log(f"  phase 3i: {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


def phase_other_regimes(device, n, d_flash, d_panel, batch, log):
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    steps = n // batch
    launches = {}
    X = np.random.default_rng(1).standard_normal((n, d_flash), dtype=np.float32)
    _, counts, _, _ = fit_against_dense(X, device, f"flash fit d={d_flash}", log,
                                     epochs=2, batch_size=batch)
    check(counts == dict(dict.fromkeys(G.launch_counts(), 0), gram_quadrant_sums=2 * steps,
                         gram_backward_flash=2 * steps),
          f"flash fit launches {counts}, expected {2 * steps} of K1 and K3")
    launches["gram_quadrant_sums", "flash fit"] = counts["gram_quadrant_sums"]
    launches["gram_backward_flash"] = counts["gram_backward_flash"]

    saved = G._KP_STASH_BYTES
    G._KP_STASH_BYTES = 0
    try:
        X = np.random.default_rng(2).standard_normal((n, d_panel), dtype=np.float32)
        _, counts, _, _ = fit_against_dense(X, device, f"panel fit d={d_panel}", log,
                                         epochs=1, batch_size=batch)
    finally:
        G._KP_STASH_BYTES = saved
    check(counts["gram_quadrant_sums"] == steps and counts["kprime_panel"] >= steps
          and counts["gram_quadrant_sums_stash"] == 0 and counts["gram_backward_flash"] == 0,
          f"panel fit launches {counts}, expected {steps} of K1 and >= {steps} of K4")
    launches["kprime_panel"] = counts["kprime_panel"]
    launches["gram_quadrant_sums", "panel fit"] = counts["gram_quadrant_sums"]

    # the reference notebook's configuration (d=10): dense torch path, no kernel
    Xn = notebook_data()
    model, counts, losses, _, _ = fit_counts(Xn, device, **NOTEBOOK_FIT)
    check(sum(counts.values()) == 0, f"the d=10 notebook fit launched kernels: {counts}")
    model.approx_subspace_dist()
    log(f"  notebook config d=10: final loss {losses[-1]:.6f} (reference band about 2.5-5), "
        f"{len(model.subspaces)} unique masks (band < 20), top probability "
        f"{float(np.max(model.proba)):.4f}")

    # the kl estimator there: its generator never trains (the reference's
    # detach), so it keeps the init's two complementary masks near 0.5 / 0.5
    from vgan_tpu_torch import VGAN

    model, counts, losses, _, _ = fit_counts(Xn, device, cls=VGAN, epochs=15)
    check(sum(counts.values()) == 0, f"the d=10 kl notebook fit launched kernels: {counts}")
    model.approx_subspace_dist()
    check(len(model.subspaces) == 2 and np.all(model.subspaces.sum(axis=0) == 1)
          and np.all(np.abs(model.proba - 0.5) < 0.1),
          f"kl notebook masks {model.subspaces.astype(int).tolist()} with probabilities "
          f"{model.proba.tolist()}, expected two complementary masks near 0.5 / 0.5")
    log(f"  kl notebook config d=10: two complementary masks {model.subspaces.astype(int).tolist()}, "
        f"probabilities {model.proba.tolist()}, final detector loss "
        f"{model.train_history['detector_loss'][-1]:.6f}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: times and bounds
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, calls: int = 10, host_ops: bool = True, warmup: bool = True) -> dict:
    """Device microseconds a call of each kernel that ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls after a warm-up (unless the
    caller has warmed ``fn`` up); without ``host_ops`` only the device
    activity is traced (fewer events to gather for a call that launches
    tens of thousands of kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    sync()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        sync()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]:
            e.self_device_time_total / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def device_busy_us(fn) -> float:
    """Device microseconds of every kernel one call of ``fn`` launches, from
    ``torch.profiler``, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def bound(ops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """The larger of the operations at the rate of the kernel's datapath
    (``peak``, op/s; every kernel of the port runs IEEE f32 on the CUDA
    cores) and the bytes at the HBM rate, in ms, and which of the two."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sym_pairs(m: int) -> int:
    """Off-diagonal entries of a symmetric m x m Gram, each counted once:
    the distances the function needs, whatever a kernel recomputes."""
    return m * (m - 1) // 2


def gram_ops(m: int, d: int, backward: bool = False) -> float:
    """The distance product and the bandwidth ladder over each unordered
    pair once, plus for K3 the product S @ z (2 m^2 d: S is symmetric, but
    a symmetric times a general matrix still takes every product)."""
    pairs = sym_pairs(m)
    return 2 * pairs * d + OPS_PER_ENTRY * pairs + (2 * m * m * d if backward else 0)


def gof_ops(m: int, d: int, P: int, n_alphas: int) -> float:
    """The distances over each unordered pair once, the A @ K products, and
    per pair and alpha the scaling, exp and mask."""
    return 2 * sym_pairs(m) * d + 2 * m * m * P * n_alphas + 4 * sym_pairs(m) * n_alphas


def panel_ops(R: int, C: int, d: int, offset) -> float:
    """K4 over an (R, C) panel: 2 d per entry and the ladder, over the R C
    entries less, with an offset, the R (R - 1) / 2 mirrored entries of its
    diagonal block (each unordered pair there is formed once)."""
    formed = R * C - (R * (R - 1) // 2 if offset is not None else 0)
    return formed * (2 * d + OPS_PER_ENTRY)


def large_gram_inputs(m: int, d: int, seed: int, device):
    """z ~ N(0, 1) drawn on the card (at these sizes a host draw and copy
    would take longer than the kernels), its norms and bandwidth."""
    from vgan_tpu_torch.ops import mmd as M

    z = torch.randn((m, d), generator=torch.Generator(device=device).manual_seed(seed),
                    device=device)
    return z, torch.sum(z * z, dim=1), M.candidate_bandwidth(z).to(torch.float32)


def blockwise_quadrant_sums(z, norms, bw, n1: int, mults, block: int = 4096):
    """K1's plain version evaluated in row blocks, each block's f32 Gram
    summed in float64: the same entries where the whole (m, m) temporaries
    would not fit."""
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    m = z.shape[0]
    sums = torch.zeros(4, dtype=torch.float64, device=z.device)
    for r0 in range(0, m, block):
        r1 = min(m, r0 + block)
        k = M.multi_rbf_gram(G._sq_dists(z[r0:r1], z, norms[r0:r1], norms), bw, mults)
        x = min(max(n1 - r0, 0), r1 - r0)  # rows of this block below n1
        sums[0] += torch.sum(k[:x, :n1], dtype=torch.float64)
        sums[1] += torch.sum(k[:x, n1:], dtype=torch.float64)
        sums[2] += torch.sum(k[x:, n1:], dtype=torch.float64)
        del k
    return sums.to(torch.float32).reshape(1, 4)


def flash_row_blocks(z, norms, bw, n1: int, n2: int, mults, block: int = 4096):
    """K3's plain S in row blocks, where the whole (m, m) S would not fit:
    yields (r0, r1, S[r0:r1]) in f32, the plain coefficients times K'(d2)."""
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    m = z.shape[0]
    cxx, cyy, cxy = G._coefficients(n1, n2)
    cols_x = torch.arange(m, device=z.device) < n1
    for r0 in range(0, m, block):
        r1 = min(m, r0 + block)
        rows_x = torch.arange(r0, r1, device=z.device)[:, None] < n1
        coeff = torch.where(rows_x & cols_x, cxx, torch.where(~rows_x & ~cols_x, cyy, cxy))
        yield r0, r1, coeff.to(z.dtype) * G._kernel_deriv(
            G._sq_dists(z[r0:r1], z, norms[r0:r1], norms), bw, mults)


def blockwise_flash(z, norms, bw, n1: int, n2: int, mults):
    """K3's plain version in row blocks: each block's f32 S multiplied and
    summed in float64, with the magnitudes of the terms, |S| @ |z| and
    rowsum(|S|). Returns (sz, rs, sz_scale, rs_scale), float64."""
    m = z.shape[0]
    z64 = z.double()
    out = [torch.empty((m, z.shape[1]), dtype=torch.float64, device=z.device),
           torch.empty((m, 1), dtype=torch.float64, device=z.device)]
    out += [torch.empty_like(o) for o in out]
    for r0, r1, s in flash_row_blocks(z, norms, bw, n1, n2, mults):
        s = s.double()
        out[0][r0:r1] = s @ z64
        out[1][r0:r1] = torch.sum(s, dim=1, keepdim=True)
        s.abs_()
        out[2][r0:r1] = s @ z64.abs()
        out[3][r0:r1] = torch.sum(s, dim=1, keepdim=True)
        del s
    return tuple(out)


def blockwise_flash_tf32(z, norms, bw, n1: int, n2: int, mults):
    """A lower-precision control for K3's check at large m: the plain
    version in row blocks with TF32 matmuls (the d2 product and S @ z) and
    f32 row sums. Returns (sz, rs), f32."""
    m = z.shape[0]
    sz = torch.empty((m, z.shape[1]), dtype=torch.float32, device=z.device)
    rs = torch.empty((m, 1), dtype=torch.float32, device=z.device)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for r0, r1, s in flash_row_blocks(z, norms, bw, n1, n2, mults):
            sz[r0:r1] = s @ z
            rs[r0:r1] = torch.sum(s, dim=1, keepdim=True)
            del s
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return sz, rs


def flash_readings(z, norms, bw, n1: int, n2: int, mults, sources: dict, log) -> dict:
    """How far each (sz, rs) of ``sources`` (name: a callable that gives
    it) lies from K3's plain version in row blocks (``blockwise_flash``):
    name: (the largest |error| over the largest |entry| of sz or rs, the
    reading phase 2 holds to GRAD_FRAC; the largest |error| over the sum of
    its terms' magnitudes, the reading held to TERM_FRAC; the largest
    |error|)."""
    want = blockwise_flash(z, norms, bw, n1, n2, mults)
    readings = {}
    for who, source in sources.items():
        grad = term = top = 0.0
        for g, w, scale in zip(source(), want[:2], want[2:]):
            e = torch.abs(g.double() - w)
            grad = max(grad, float(e.max()) / float(torch.max(torch.abs(w))))
            term = max(term, float(torch.max(e / scale.clamp_min(1e-300))))
            top = max(top, float(e.max()))
            del e
        readings[who] = (grad, term, top)
        log(f"  gram_backward_flash m={z.shape[0]} d={z.shape[1]} {who} against the plain "
            f"version in row blocks: |error| / largest |entry| {grad:.3e} (GRAD_FRAC "
            f"{GRAD_FRAC}), |error| / sum of |terms| {term:.3e} (TERM_FRAC {TERM_FRAC})")
    return readings


def phase_times(device, shapes, errs, launches, log):
    """One row per kernel at the shape its main path gives it, with the
    times at its other shapes under ``at_other_shapes``."""
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import gof_gram as GG
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    mults = M.bandwidth_multipliers()
    sms = G._sms(device)

    def timed(name, label, fn, plain, ops, nbytes, iters=20, warmup=3):
        """``plain`` None: its whole-Gram temporaries would not fit, untimed."""
        t = {"shape": label, "ms": cuda_ms(fn, iters, warmup),
             "plain_ms": cuda_ms(plain, iters, warmup) if plain else None}
        t["bound_ms"], t["bound_by"] = bound(ops, nbytes)
        if plain is None:
            t["plain_note"] = (f"not timed: its (m, m) temporaries (about {PLAIN_GRAM_ARRAYS} f32 "
                               f"arrays) exceed {PLAIN_MAX_BYTES / 2**30:.0f} GiB")
        plain_txt = f"plain {t['plain_ms']:.4f} ms" if plain else "plain not timed"
        log(f"  {name} {label}: {t['ms']:.4f} ms ({plain_txt}, "
            f"bound {t['bound_ms']:.4f} ms by {t['bound_by']})")
        return t

    def gram(name, shape, seed):
        n1, n2, d = shape
        _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=seed, device=device)
        m = n1 + n2
        label = f"m={m} d={d}"
        if name == "gram_quadrant_sums":
            t = timed(name, label, lambda: G.gram_quadrant_sums(z, norms, bw, n1, mults),
                      lambda: G.gram_quadrant_sums_reference(z, norms, bw, n1, mults),
                      gram_ops(m, d), 4 * (m * d + m + 1 + 4))
            t["mode"] = G.tile_schedule(G.tile_pairs(m), d, sms)[0]
            return t
        if name == "gram_backward_flash":
            t = timed(name, label, lambda: G.gram_backward_flash(z, norms, bw, n1, n2, mults),
                      lambda: G.gram_backward_flash_reference(z, norms, bw, n1, n2, mults),
                      gram_ops(m, d, backward=True), 4 * (2 * m * d + 2 * m + 1))
            t["mode"], _, t["nsplit"] = G.flash_schedule(m, d, sms)
            t["passes_us"] = device_split(
                lambda: G.gram_backward_flash(z, norms, bw, n1, n2, mults))
            log(f"  {name} {label} by pass (profiler, device us a call): " + ", ".join(
                f"{k} {v:.2f}" for k, v in t["passes_us"].items()))
            return t
        t = timed(name, label, lambda: G.gram_quadrant_sums_stash(z, norms, bw, n1, mults),
                  lambda: G.gram_quadrant_sums_stash_reference(z, norms, bw, n1, mults),
                  gram_ops(m, d), 4 * (m * d + m + 1 + 4 + m * m))
        t["passes_us"] = device_split(lambda: G.gram_quadrant_sums_stash(z, norms, bw, n1, mults))
        log(f"  {name} {label} by pass (profiler, device us a call): " + ", ".join(
            f"{k} {v:.2f}" for k, v in t["passes_us"].items()))
        return t

    def k1_large(shape):
        """K1 in mode (a) at large m: its peak memory beside z's bytes (it
        must hold no more than z's column-major copy, one wave of tiles and
        the partials), held to the plain version evaluated in row blocks."""
        n1, n2, d = shape
        m = n1 + n2
        z, norms, bw = large_gram_inputs(m, d, 24, device)
        mode = G.tile_schedule(G.tile_pairs(m), d, sms)[0]
        check(mode == "a", f"K1 at m={m} d={d} takes mode ({mode}), expected (a)")
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s_k = G.gram_quadrant_sums(z, norms, bw, n1, mults)
        sync()
        peak = torch.cuda.max_memory_allocated()
        limit = 4 * (d * _build.round_up(m, G.STASH_TILE) + G.STASH_BLOCKS_PER_SM * sms * G.STASH_TILE ** 2
                     + 12 * G.tile_pairs(m) + 4)
        check(peak - base <= limit, f"K1 at m={m} d={d} allocated {peak - base} bytes, more than "
                                    f"z's copy, one wave of tiles and the partials ({limit})")
        err = assert_close(f"gram_quadrant_sums m={m} d={d} mode (a)", s_k,
                           blockwise_quadrant_sums(z, norms, bw, n1, mults), RTOL_SUMS)
        repeat_identical("gram_quadrant_sums", lambda: G.gram_quadrant_sums(z, norms, bw, n1, mults))
        fits = PLAIN_GRAM_ARRAYS * 4 * m * m <= PLAIN_MAX_BYTES
        t = timed("gram_quadrant_sums", f"m={m} d={d}",
                  lambda: G.gram_quadrant_sums(z, norms, bw, n1, mults),
                  (lambda: G.gram_quadrant_sums_reference(z, norms, bw, n1, mults)) if fits else None,
                  gram_ops(m, d), 4 * (m * d + m + 1 + 4), iters=3, warmup=1)
        t.update(mode=mode, max_abs_err=err, max_memory_allocated=peak, call_bytes=peak - base,
                 z_bytes=4 * m * d, tol=f"rtol {RTOL_SUMS} (plain version in row blocks)")
        log(f"  gram_quadrant_sums m={m} d={d}: torch.cuda.max_memory_allocated {peak} bytes, "
            f"{peak - base} of them this call's (z itself {4 * m * d} bytes); sums within "
            f"{err:.3e} of the plain version in row blocks")
        return t

    def k3_large(shape):
        """K3 in mode (a) at large m: the bytes it allocates beyond its
        inputs (z's two copies, the outputs and the partials of its later
        splits, nothing of m^2), held to the plain version evaluated in row
        blocks, identical bits on a re-run."""
        n1, n2, d = shape
        m = n1 + n2
        z, norms, bw = large_gram_inputs(m, d, 24, device)
        mode, slice_, nsplit = G.flash_schedule(m, d, sms)
        check(mode == "a", f"K3 at m={m} d={d} takes mode ({mode}), expected (a)")
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sz, rs = G.gram_backward_flash(z, norms, bw, n1, n2, mults)
        sync()
        peak = torch.cuda.max_memory_allocated()
        scratch = 4 * G.flash_scratch_floats(m, d, slice_, nsplit)
        limit = scratch + 4 * (m * d + m) + 4096
        check(peak - base <= limit, f"K3 at m={m} d={d} allocated {peak - base} bytes, more than "
                                    f"its scratch and outputs ({limit})")
        sources = {"this tree": lambda: (sz, rs),
                   "TF32 control": lambda: blockwise_flash_tf32(z, norms, bw, n1, n2, mults)}
        readings = flash_readings(z, norms, bw, n1, n2, mults, sources, log)
        check(readings["this tree"][1] <= TERM_FRAC,
              f"gram_backward_flash m={m} d={d} (this tree): an entry off the plain version "
              f"in row blocks by {readings['this tree'][1]:.3e} of the sum of its terms' "
              f"magnitudes, more than {TERM_FRAC}")
        check(readings["TF32 control"][1] > TERM_FRAC,
              f"K3's check at m={m} d={d} passes the TF32 control "
              f"({readings['TF32 control'][1]:.3e} <= {TERM_FRAC})")
        err = readings["this tree"][2]
        del sz, rs
        repeat_identical("gram_backward_flash",
                         lambda: G.gram_backward_flash(z, norms, bw, n1, n2, mults))
        t = timed("gram_backward_flash", f"m={m} d={d}",
                  lambda: G.gram_backward_flash(z, norms, bw, n1, n2, mults), None,
                  gram_ops(m, d, backward=True), 4 * (2 * m * d + 2 * m + 1), iters=3, warmup=1)
        t.update(mode=mode, nsplit=nsplit, max_abs_err=err, max_memory_allocated=peak,
                 call_bytes=peak - base, scratch_bytes=scratch, z_bytes=4 * m * d,
                 tol=f"{TERM_FRAC} of each entry's sum of |terms| (plain version in row blocks, "
                     "float64 sums)",
                 readings={who: {"grad_frac": r[0], "term_frac": r[1], "max_abs_err": r[2]}
                           for who, r in readings.items()})
        log(f"  gram_backward_flash m={m} d={d}: mode ({mode}), {nsplit} splits; "
            f"torch.cuda.max_memory_allocated {peak} bytes, {peak - base} of them this call's "
            f"(z itself {4 * m * d} bytes; scratch {scratch}: z column-major, [z | 1] row-major, "
            f"{nsplit - 1} partials); within {err:.3e} of the plain version in row blocks")
        return t

    def panel(n1, n2, d, R, offset, iters, seed, large):
        """K4 on rows offset .. offset + R against all of z, as the panel
        backward calls it (its column-major copy made once, timed apart).
        ``large``: inputs drawn on the card, and held to the plain version
        here (phase 2 holds the smaller shapes)."""
        m = n1 + n2
        if large:
            z, norms, bw = large_gram_inputs(m, d, seed, device)
        else:
            _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=seed, device=device)
        cols_t = G.panel_operand(z)
        zr, nr = z[offset:offset + R], norms[offset:offset + R]
        mode = G.tile_schedule(G.panel_blocks(R, m, offset), d, sms)[0]

        def fn():
            return G.kprime_panel(zr, z, nr, norms, bw, mults, offset=offset, cols_t=cols_t)

        def plain():
            return G.kprime_panel_reference(zr, z, nr, norms, bw, mults)

        label = f"R={R} C={m} d={d} offset {offset}"
        t = timed("kprime_panel", label, fn, plain, panel_ops(R, m, d, offset),
                  4 * (m * d + R + m + 1 + R * m), iters, 1 if iters < 20 else 3)
        t["mode"] = mode
        t["operand_ms"] = cuda_ms(lambda: G.panel_operand(z), iters, 1)
        log(f"  kprime_panel {label}: mode ({mode}); the column-major copy of z (once per "
            f"backward) {t['operand_ms']:.4f} ms")
        if large:
            t["max_abs_err"] = assert_close(f"kprime_panel {label}", fn(), plain(), RTOL_KP, ATOL_KP)
            t["tol"] = f"rtol {RTOL_KP} atol {ATOL_KP}"
        return t

    def gof(shape):
        n_rows, n1, n2, d, n_perms, alphas, _ = shape
        X = np.random.default_rng(35).standard_normal((n_rows, d), dtype=np.float32)
        x, _ = gof_samples(X, n1, seed=36)
        _, y = gof_samples(X, n2, seed=37)
        z, norms, a = gof_kernel_inputs(x, y, n_perms, 38, device)
        m, P, k = n1 + n2, a.shape[0], len(alphas)
        t = timed("a_times_k", f"m={m} d={d} P={P} alphas={k}",
                  lambda: GG.a_times_k(z, norms, a, alphas),
                  lambda: GG.a_times_k_reference(z, norms, a, alphas),
                  gof_ops(m, d, P, k), 4 * (m * d + m + P * m + k + k * P * m),
                  iters=3, warmup=1)
        # pass 1 alone (the symmetric d2 of the full-Gram regime): the split
        # of the time between the distances and the A @ K pass
        check(GG.regime(m) == "full", f"K5 at m={m} is not in the full-Gram regime")
        z_t = _build.column_major(z, GG.KERNEL_TILE)
        M = z_t.shape[1]
        norms_p = torch.zeros(M, dtype=torch.float32, device=device)
        norms_p[:m] = norms
        d2 = torch.empty((M, M), dtype=torch.float32, device=device)
        t["pass1_ms"] = cuda_ms(lambda: _build.launch(
            GG._lib(), "vgan_gof_gram_d2", device, z_t.data_ptr(), norms_p.data_ptr(), M, d, 1, 0,
            M // GG.KERNEL_TILE, d2.data_ptr()), 3, 1)
        log(f"  a_times_k {t['shape']}: pass 1 (d2, each pair once) alone {t['pass1_ms']:.4f} ms, "
            f"{2 * sym_pairs(m) * d / t['pass1_ms'] / 1e9:.1f} TFLOP/s of distances")
        return t

    gram_src = "vgan_tpu_torch/ops/cuda/csrc/mmd_gram.cu"
    pallas = "vgan_tpu/ops/pallas/mmd_gram.py"
    rows = []
    # K1: the kl fit's Gram (its main path), the flash fit's, the panel
    # fit's forward (with that fit's launches) and the flash regime at large m
    k1 = {"name": "gram_quadrant_sums", "route": "cuda", "source": gram_src,
          "replaces": f"{pallas}:207 _fwd_kernel", **gram("gram_quadrant_sums", shapes["kl"], 21),
          "launches": launches["gram_quadrant_sums"],
          "max_abs_err": errs["gram_quadrant_sums", shapes["kl"]], "tol": f"rtol {RTOL_SUMS}",
          "library_ms": None, "at_other_shapes": []}
    for shape, fit in ((shapes["flash"], "flash fit"), (shapes["stress"], "panel fit")):
        t = gram("gram_quadrant_sums", shape, 22)
        t.update(launches=launches["gram_quadrant_sums", fit], launches_on=fit,
                 max_abs_err=errs["gram_quadrant_sums", shape])
        k1["at_other_shapes"].append(t)
    torch.cuda.empty_cache()
    k1["at_other_shapes"].append(k1_large(shapes["k1_large"]))
    torch.cuda.empty_cache()
    rows.append(k1)
    for name, replaces, tol in (
        ("gram_quadrant_sums_stash", f"{pallas}:269 _fwd_stash_kernel",
         f"sums rtol {RTOL_SUMS}; kp rtol {RTOL_KP} atol {ATOL_KP}"),
        ("gram_backward_flash", f"{pallas}:469 _flash_bwd_kernel", f"{GRAD_FRAC} of max|ref|"),
    ):
        main, others = {"gram_quadrant_sums_stash": (shapes["stress"], []),
                        "gram_backward_flash": (shapes["kl"], [shapes["flash"]])}[name]
        rows.append({"name": name, "route": "cuda", "source": gram_src, "replaces": replaces,
                     **gram(name, main, seed=21), "launches": launches[name],
                     "max_abs_err": errs[name, main], "tol": tol, "library_ms": None,
                     "at_other_shapes": [gram(name, o, seed=22) for o in others]})
        if name == "gram_backward_flash":
            torch.cuda.empty_cache()
            rows[-1]["at_other_shapes"].append(k3_large(shapes["k1_large"]))
            torch.cuda.empty_cache()
    # K4: the panel fit's square panel (its main path), then one real panel
    n1, n2, d = shapes["stress"]
    k4 = {"name": "kprime_panel", "route": "cuda", "source": gram_src,
          "replaces": f"{pallas}:606 _kprime_panel_kernel",
          **panel(n1, n2, d, n1 + n2, 0, 20, 21, False), "launches": launches["kprime_panel"],
          "max_abs_err": errs["kprime_panel", shapes["stress"]],
          "tol": f"rtol {RTOL_KP} atol {ATOL_KP}", "library_ms": None}
    rp = shapes["k4_real_panel"]
    k4["at_other_shapes"] = [panel(rp["n1"], rp["n2"], rp["d"], G._panel_rows(rp["n1"] + rp["n2"]),
                                   rp["offset"], 3, 25, True)]
    torch.cuda.empty_cache()
    rows.append(k4)
    main, *others = shapes["gof"]
    rows.append({
        "name": "a_times_k", "route": "cuda", "source": "vgan_tpu_torch/ops/cuda/csrc/gof_gram.cu",
        "replaces": "vgan_tpu/ops/pallas/gof_gram.py:59 _ak_kernel", **gof(main),
        "launches": launches["a_times_k"], "max_abs_err": errs["a_times_k", main[1:4]],
        "tol": f"{C_FRAC} of max|C| per alpha (float64 plain version)", "library_ms": None,
        "at_other_shapes": [gof(o) for o in others],
    })
    return rows


def knn_ops(n_selected: int, nm: int, nt: int, ntr: int) -> float:
    """Over each mask's selected columns (``n_selected`` of them in all):
    the cross products (2 per pair and column) and the masked norms of the
    test and train rows; and one compare per (mask, row, train) entry."""
    return 2 * nt * ntr * n_selected + 2 * (nt + ntr) * n_selected + nm * nt * ntr


def knn_times(runs, errs, launches, hetero_launches, log):
    """K6 and K7 at the shapes the ensembles' decision_function gives them,
    on those ensembles' own device tensors (mode 'kth'). ``launches`` are
    phase 3c's, ``hetero_launches`` phase 3f's."""
    from vgan_tpu_torch.ops.cuda import knn_score as KS

    rows = []
    for name, key, replaces, iters in (
        ("knn_scores_resident", ("bench", "knn"), "92 _knn_kernel", 20),
        ("knn_scores_stream", ("stress", "knn"), "157 _knn_stream_kernel", 3),
    ):
        ens, Xt = runs[key]
        x, xtr = ens._as_device(Xt), ens._x_train
        masks, _ = ens._device_pool()
        nm, (nt, d), ntr, k = masks.shape[0], x.shape, xtr.shape[0], ens.k
        t = {"shape": f"{nm} masks, {nt} x {ntr}, d={d}, k={k}",
             "ms": cuda_ms(lambda: KS.knn_scores_all_masks(x, xtr, masks, k), iters, 1),
             "plain_ms": cuda_ms(lambda: KS.knn_scores_all_masks_reference(x, xtr, masks, k),
                                 iters, 1)}
        n_sel = int(masks.sum())
        t["bound_ms"], t["bound_by"] = bound(knn_ops(n_sel, nm, nt, ntr),
                                             4 * (nm * d + nt * d + ntr * d + nm * nt))
        t["selected_columns"] = n_sel
        log(f"  {name} {t['shape']}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms by {t['bound_by']})")
        rows.append({
            "name": name, "route": "cuda", "source": "vgan_tpu_torch/ops/cuda/csrc/knn_score.cu",
            "replaces": f"vgan_tpu/ops/pallas/knn_score.py:{replaces}",
            **t, "launches": launches[name], "launches_hetero": hetero_launches[name],
            "max_abs_err": errs[name, (nt, ntr, d)],
            "tol": f"kth |d s^2| <= eps = {KNN_D2_FRAC} (d <= {KNN_WIDE_D}) or {KNN_D2_FRAC_WIDE} "
                   "of max(an + bn); mean |d s| <= min(sqrt(eps), eps / s1); integer rows: kth "
                   "equal",
            "library_ms": None,
        })
    return rows


def panel_fit_rates(device, log) -> float:
    """The panel fit's steps/s: the no-kl stress shape with the K' stash off
    (K1 and K4 each step), host clock over 4 epochs."""
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    n, d, batch = STRESS["n"], STRESS["d"], STRESS["batch"]
    saved = G._KP_STASH_BYTES
    try:
        G._KP_STASH_BYTES = 0
        rate = fit_steps_per_s(device, n, d, batch, epochs=4)
    finally:
        G._KP_STASH_BYTES = saved
    log(f"  panel fit (n={n}, d={d}, batch {batch}, K' stash off): {rate:.2f} steps/s")
    return rate


def flash_fit_rates(device, log) -> dict:
    """The steps/s of the two fits that run K3: the kl stress fit (one
    AlternationSchedule(1, 5) cycle: K3 on the detector's m=1000, L=640
    encodings) and the flash fit (n=2000, d=1024, batch 500,
    FLASH_FIT_EPOCHS epochs: K1 and K3 each step), host clock, after a
    warm-up of each. Then the flash fit's device time a step
    (``torch.profiler``, 4 epochs): the fit is host-bound, so K3's share of
    its steps shows there and not in its steps/s."""
    n, d, batch = STRESS["n"], STRESS["d"], STRESS["batch"]
    kl_fit_steps_per_s(device, n, d, batch)
    fit_steps_per_s(device, n, 1024, batch)
    rates = {
        "kl stress fit": kl_fit_steps_per_s(device, n, d, batch),
        "flash fit": fit_steps_per_s(device, n, 1024, batch, epochs=FLASH_FIT_EPOCHS),
        "flash fit device us/step": device_busy_us(
            lambda: fit_steps_per_s(device, n, 1024, batch, epochs=4)) / (4 * (n // batch)),
    }
    for fit, rate in rates.items():
        log(f"  {fit}: {rate:.2f}" + ("" if fit.endswith("us/step") else " steps/s"))
    return rates


def fused_ops_bytes(n: int, d: int, bs: int, latent: int, steps: int):
    """Per fit, per step over the m = 2 bs valid rows: the distances and the
    ladder over each unordered pair once (``gram_ops``), K' [q | q * zc]
    over the bs masked rows, the only ones the backward reads (2 bs m (d +
    1)), the generator's forward, dh and dW GEMMs, and about 10 operations
    per parameter for Adadelta; bytes: the dataset read once, the state
    (parameters and two Adadelta averages) read and written once, one loss
    per step."""
    widths = [latent, 2 * latent, 4 * latent, 8 * latent, d]
    macs = sum(a * b for a, b in zip(widths, widths[1:]))
    n_params = macs + sum(widths[1:])
    m = 2 * bs
    per_step = gram_ops(m, d) + 2 * bs * m * (d + 1) + 6 * bs * macs + 10 * n_params
    return steps * per_step, 4 * (n * d + 6 * n_params + steps)


def fused_phases(x3, starts, packed, kw, n: int, seed: int, label: str, log) -> dict:
    """K8's phase timer over one fit on these inputs (rng mode): each
    phase's microseconds per step (the step-0 bandwidth phase: per fit)."""
    from vgan_tpu_torch.ops.cuda import fused_no_kl as FN

    T = int(starts.shape[0])
    ns = torch.zeros(len(FN.PHASES), dtype=torch.int64, device=x3.device)
    FN.fused_no_kl_fit_cuda(x3, starts, *packed, None, seed, n=n, phase_ns=ns, **kw)
    sync()
    us = {name: v / 1e3 / (1 if name == "bandwidth" else T)
          for name, v in zip(FN.PHASES, ns.cpu().tolist())}
    log(f"  K8 phases, {label}, {T} steps: " + ", ".join(
        f"{k} {v:.3f} us{' per fit' if k == 'bandwidth' else '/step'}" for k, v in us.items())
        + f"; sum {sum(v for k, v in us.items() if k != 'bandwidth'):.3f} us/step")
    return us


def fused_times(device, errs, launches, log):
    """K8's row: a fused fit at the notebook shape over the reference's
    default 2000 epochs (one launch, in-kernel noise) against its plain
    version on the same inputs (fed the same Philox normals), the scan
    path's steps/s at that shape, and K8's time per step at the gate's
    widest corner."""
    from vgan_tpu_torch.ops.cuda import fused_no_kl as FN
    from vgan_tpu_torch.train.steps import TrainConfig, init_no_kl_state, no_kl_train_epochs

    X = notebook_data()
    n, d, bs = X.shape[0], X.shape[1], 500
    x3, starts, packed, kw = fused_inputs(X, bs, FUSED_TIMED_EPOCHS, seed=11, device=device)
    T = int(starts.shape[0])
    t = {"shape": f"n={n} d={d} bs={bs}, {FUSED_TIMED_EPOCHS} epochs = {T} steps",
         "ms": cuda_ms(lambda: FN.fused_no_kl_fit_cuda(x3, starts, *packed, None, 99, n=n, **kw),
                       iters=3, warmup=1)}
    # the plain version's eager steps over the fit's first epochs, fed the
    # kernel's own Philox normals
    Tp = FUSED_PLAIN_EPOCHS * (n // bs)
    plain_noise = FN.philox_normal(99, Tp, bs, kw["latent"], device)
    starts_host = starts[:Tp].cpu().numpy()
    t["plain_ms"] = cuda_ms(lambda: FN.fused_no_kl_fit_reference(x3, starts_host, *packed,
                                                                 plain_noise, **kw),
                            iters=1, warmup=0)
    t["plain_steps"], t["plain_us_per_step"] = Tp, t["plain_ms"] * 1e3 / Tp
    t["bound_ms"], t["bound_by"] = bound(*fused_ops_bytes(n, d, bs, kw["latent"], T))
    # the fit whose launch the main path counts: phase 3d's notebook fit
    e_main = NOTEBOOK_FIT["epochs"]
    x3m, startsm, packedm, kwm = fused_inputs(X, bs, e_main, seed=11, device=device)
    Tm = int(startsm.shape[0])
    ms_main = cuda_ms(lambda: FN.fused_no_kl_fit_cuda(x3m, startsm, *packedm, None, 99, n=n, **kwm))
    bound_main, _ = bound(*fused_ops_bytes(n, d, bs, kwm["latent"], Tm))
    barriers = FN.barriers_per_step(device)
    log(f"  fused_no_kl_fit_cuda {t['shape']}: {t['ms']:.4f} ms per fit, "
        f"{t['ms'] * 1e3 / T:.3f} us/step, {T / t['ms'] * 1e3:.1f} steps/s (plain "
        f"{t['plain_ms']:.4f} ms for its first {Tp} steps, {t['plain_us_per_step']:.3f} us/step; "
        f"bound {t['bound_ms']:.4f} ms by {t['bound_by']}, {t['bound_ms'] * 1e3 / T:.3f} us/step; "
        f"{barriers} grid barriers a step, one more at step 0)")
    log(f"  fused_no_kl_fit_cuda main-path fit n={n} d={d} bs={bs}, {e_main} epochs = {Tm} steps: "
        f"{ms_main:.4f} ms (bound {bound_main:.4f} ms)")
    t["phase_us"] = fused_phases(x3, starts, packed, kw, n, 99, t["shape"], log)

    config = TrainConfig(ndims=d, batch_size=bs, lr_g=NOTEBOOK_FIT["lr"])
    x = torch.from_numpy(X.astype(np.float32)).to(device)
    state = init_no_kl_state(config, 777, device)
    no_kl_train_epochs(state, x, config, 1)
    sync()
    t0 = time.perf_counter()
    _, losses = no_kl_train_epochs(state, x, config, SCAN_TIMED_EPOCHS)
    sync()
    scan_sps = SCAN_TIMED_EPOCHS * (n // bs) / (time.perf_counter() - t0)
    check(bool(torch.all(torch.isfinite(losses))), "non-finite losses in the timed scan fit")
    log(f"  scan path at the same shape ({SCAN_TIMED_EPOCHS} epochs, host clock): "
        f"{scan_sps:.1f} steps/s; the fused fit {T / t['ms'] * 1e3 / scan_sps:.1f}x that")

    nc, dc, bsc, ec = (FUSED_CORNER[k] for k in ("n", "d", "bs", "epochs"))
    Xc = np.random.default_rng(13).standard_normal((nc, dc), dtype=np.float32)
    x3c, startsc, packedc, kwc = fused_inputs(Xc, bsc, ec, seed=12, device=device)
    Tc = int(startsc.shape[0])
    ms_c = cuda_ms(lambda: FN.fused_no_kl_fit_cuda(x3c, startsc, *packedc, None, 98, n=nc, **kwc),
                   iters=3, warmup=1)
    noise_c, startsc_host = FN.philox_normal(98, Tc, bsc, kwc["latent"], device), startsc.cpu().numpy()
    plain_c = cuda_ms(lambda: FN.fused_no_kl_fit_reference(x3c, startsc_host, *packedc, noise_c,
                                                           **kwc), iters=1, warmup=0)
    bound_c, by_c = bound(*fused_ops_bytes(nc, dc, bsc, kwc["latent"], Tc))
    log(f"  fused_no_kl_fit_cuda corner n={nc} d={dc} bs={bsc}, {ec} epochs = {Tc} steps: "
        f"{ms_c:.4f} ms, {ms_c * 1e3 / Tc:.3f} us/step (plain {plain_c:.4f} ms, bound "
        f"{bound_c * 1e3 / Tc:.3f} us/step by {by_c})")
    phases_c = fused_phases(x3c, startsc, packedc, kwc, nc, 98, f"corner n={nc} d={dc} bs={bsc}", log)
    return {
        "name": "fused_no_kl_fit_cuda", "route": "cuda",
        "source": "vgan_tpu_torch/ops/cuda/csrc/fused_no_kl.cu",
        "replaces": "vgan_tpu/ops/pallas/fused_no_kl.py:102 _kernel_body", **t,
        "us_per_step": t["ms"] * 1e3 / T, "steps_per_s": T / t["ms"] * 1e3,
        "main_path_fit": {"epochs": e_main, "steps": Tm, "ms": ms_main, "bound_ms": bound_main},
        "scan_steps_per_s": scan_sps, "barriers_per_step": barriers,
        "launches": launches, "max_abs_err": errs["fused_no_kl_fit_cuda", (n, d, bs)],
        "tol": f"losses rtol {FUSED_LOSS_RTOL}, bw rtol {FUSED_BW_RTOL}, each state leaf's "
               f"change {FUSED_LEAF_FRAC} of its largest change (lr {FUSED_CHECK_LR})",
        "library_ms": None,
        "at_other_shapes": [{"shape": f"n={nc} d={dc} bs={bsc}, {Tc} steps", "ms": ms_c,
                             "us_per_step": ms_c * 1e3 / Tc, "plain_ms": plain_c, "bound_ms": bound_c,
                             "bound_by": by_c, "phase_us": phases_c}],
    }


def ensemble_rates(runs, log) -> None:
    """API-level decision_function wall time (host clock; the call ends in
    the host fetch of the scores), as subspace-scorings/s."""
    for (config, base), (ens, Xt) in runs.items():
        iters = 3 if config == "stress" else 10
        ens.decision_function(Xt)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            ens.decision_function(Xt)
            times.append(time.perf_counter() - t0)
        sec = statistics.median(times)
        log(f"  {config} ensemble {base} decision_function ({len(ens.subspaces)} masks, "
            f"{len(Xt)} test rows): {sec * 1e3:.3f} ms, {len(ens.subspaces) / sec:.1f} "
            f"subspace-scorings/s (median of {iters})")


def fit_steps_per_s(device, n, d, batch, epochs: int = 2, **options) -> float:
    from vgan_tpu_torch.train.steps import TrainConfig, init_no_kl_state, no_kl_train_epochs

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)).to(device)
    config = TrainConfig(ndims=d, batch_size=batch, **options)
    state = init_no_kl_state(config, 777, device)
    sync()
    t0 = time.perf_counter()
    _, losses = no_kl_train_epochs(state, x, config, epochs)
    sync()
    dt = time.perf_counter() - t0
    check(bool(torch.all(torch.isfinite(losses))), "non-finite losses in the timed fit")
    return epochs * (n // batch) / dt


def kl_fit_steps_per_s(device, n, d, batch, **options) -> float:
    """The kl stress fit over one cycle of AlternationSchedule(1, 5): one
    detector epoch, then five generator epochs (the detached generator's
    loss evaluations)."""
    from vgan_tpu_torch.train.steps import (
        AlternationSchedule,
        TrainConfig,
        init_kl_state,
        kl_train_epochs,
    )

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)).to(device)
    config = TrainConfig(ndims=d, batch_size=batch, **options)
    phases = AlternationSchedule(1, 5).phase_array(6)
    state = init_kl_state(config, 777, device)
    sync()
    t0 = time.perf_counter()
    _, det, gen = kl_train_epochs(state, x, phases, config)
    sync()
    dt = time.perf_counter() - t0
    check(bool(torch.all(torch.isfinite(det)) and torch.all(torch.isfinite(gen[1:]))),
          "non-finite losses in the timed kl fit")
    return len(phases) * (n // batch) / dt


def profile_stress_epoch(device, n, d, batch, log, kl: bool = False, top: int = 12) -> None:
    """Device time by kernel over one stress epoch (kl: one detector and one
    generator epoch) after a warm-up, and the device's busy share of that
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vgan_tpu_torch.train import steps as S

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)).to(device)
    config = S.TrainConfig(ndims=d, batch_size=batch)
    if kl:
        def run(state):
            state, _ = S.kl_detector_epoch(state, x, config)
            return S.kl_generator_epoch(state, x, config)[0]

        state, steps, label = S.init_kl_state(config, 777, device), 2 * (n // batch), "kl stress"
    else:
        def run(state):
            return S.no_kl_epoch(state, x, config)[0]

        state, steps, label = S.init_no_kl_state(config, 777, device), n // batch, "stress"
    state = run(state)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"  profiled {label} epoch{'s' if kl else ''}: {steps} steps, wall {wall_us / 1e3:.3f} ms "
        f"({wall_us / 1e3 / steps:.3f} ms/step), device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall; the profiler's own cost included)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {100 * e.self_device_time_total / max(busy_us, 1e-9):5.1f}%"
            f"  x{e.count:<4d} {e.key[:90]}")


def variant_dirs(name: str, csrc: Path, texts: dict, root: Path) -> dict:
    """``{label: directory}``: each text of ``texts`` (label -> a variant of
    ``<csrc>/<name>.cu``) written as ``<name>.cu`` into a directory of its
    own under ``root``, beside ``csrc``'s headers, and all of them built
    together through ``_build.load``, for ``_build.built_from``."""
    from vgan_tpu_torch.ops.cuda import _build

    dirs = {}
    for i, (label, text) in enumerate(texts.items()):
        dirs[label] = root / f"{name}_{i}"
        dirs[label].mkdir(parents=True)
        for header in Path(csrc).glob("*.cuh"):
            (dirs[label] / header.name).write_bytes(header.read_bytes())
        (dirs[label] / f"{name}.cu").write_text(text)
    with ThreadPoolExecutor(max(1, len(dirs))) as pool:
        list(pool.map(lambda d: _build.load(name, d), dirs.values()))
    return dirs


def sass_sizes() -> dict:
    """SASS instructions of each kernel of the loaded libraries
    (``cuobjdump`` beside ``nvcc``): a kernel far past the instruction cache
    stalls on instruction fetch."""
    import re

    from vgan_tpu_torch.ops.cuda import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sizes = {}
    for lib in sorted(Path(cdll._name) for cdll in _build._libs.values()):
        out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                             timeout=300, check=True).stdout
        for body in re.split(r"\n\s*Function : ", out)[1:]:
            mangled = body.split("\n", 1)[0].strip()
            sizes[f"{lib.stem.rsplit('_', 1)[0][3:]}.{kernel_name(mangled)}"] = len(
                re.findall(r"/\*[0-9a-f]{4,}\*/", body))
    return sizes


def kernel_name(mangled: str) -> str:
    """The innermost name of a mangled ``_ZN<len><name>...`` symbol, with
    its operand type and bool template arguments (``tile_kernel<bf16,1>``;
    a float operand is left out: ``tile_kernel<1>``)."""
    import re

    i, name = mangled.find("_ZN") + 3, mangled
    while 3 <= i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    if 3 <= i < len(mangled) and mangled[i] == "I":  # template arguments, up to their "E"
        rest = mangled[i:]
        head = rest[:rest.find("EE") + 2]
        args = (["bf16"] if head.startswith("I13__nv_bfloat16") else []) + re.findall(
            r"Lb([01])E", head)
        if args:
            name += f"<{','.join(args)}>"
    return name


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import vgan_tpu_torch
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import adadelta as A
    from vgan_tpu_torch.ops.cuda import fused_no_kl as FN
    from vgan_tpu_torch.ops.cuda import gof_gram as GG
    from vgan_tpu_torch.ops.cuda import knn_score as KS
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    here = Path(__file__).resolve().parent
    check(Path(vgan_tpu_torch.__file__).resolve().parent.parent == here,
          f"vgan_tpu_torch was imported from {vgan_tpu_torch.__file__}, not from {here}")

    def log(msg):
        print(msg, flush=True)

    device = torch.device("cuda")
    t_start = time.perf_counter()
    log("phase 1: card")
    card = card_identity()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision is not 'highest'")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:  # one nvcc per source, started together
        for build in [pool.submit(lib) for lib in (G._lib, GG._lib, KS._lib, FN._lib, A._lib)]:
            build.result()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in _build.build_info.items()) + ")")
    for name, info in _build.build_info.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: " + line.strip())
    for name, count in sass_sizes().items():
        log(f"  sass {name}: {count} instructions")

    n, d, batch = STRESS["n"], STRESS["d"], STRESS["batch"]
    d_flash = 1024
    stress_shape = (batch, batch, d)   # the stress and panel fits' Gram
    flash_shape = (batch, batch, d_flash)  # the flash fit's Gram
    kl_shape = (batch, batch, d // 16)  # the kl fit's Gram: encodings of width L = d // 16
    gof_f64 = (GOF_ROWS, GOF_COUNT_F64, GOF_COUNT_F64, d, GOF_PERMUTATIONS, GOF_ALPHAS, 0)
    gof_f32 = (GOF_ROWS, GOF_COUNT_F32, GOF_COUNT_F32, d, GOF_PERMUTATIONS, GOF_ALPHAS, 0)
    log("phase 2: kernels against their plain versions")
    errs = phase_kernels(device, [
        # (n1, n2, d, K1's mode): the fits' Grams, a ragged m in mode (b)
        # (28 tile pairs) and one in mode (a) (153 tile pairs)
        (*stress_shape, "b"), (*flash_shape, "b"), (*kl_shape, "b"), (333, 517, 2500, "b"),
        (1100, 1013, 700, "a"),
    ], [kl_shape, flash_shape, (4096, 4096, 1024), (333, 517, 2000)], log)
    phase_core(device, stress_shape, (333, 517, 2000), log)
    log("phase 2: the bf16-operand variants of K1-K4 (gram_matmul_dtype='bfloat16')")
    rp = K4_REAL_PANEL
    m_rp = rp["n1"] + rp["n2"]
    m_st = stress_shape[0] + stress_shape[1]
    bf16_rows = phase_bf16_kernels(device, {
        # the kl cycle's Gram first (its main path), the flash fit's, a ragged
        # mode (a), the panel fit's forward
        "gram_quadrant_sums_bf16": [kl_shape, flash_shape, (1100, 1013, 700), stress_shape],
        "gram_quadrant_sums_stash_bf16": [stress_shape],
        # the kl cycle's Gram (5 CTAs a cluster, 3 splits), m=8192 (8 CTAs,
        # one split), and a ragged m with d past 16 chunks (two output groups)
        "gram_backward_flash_bf16": [kl_shape, (4096, 4096, 1024), (333, 517, 2000)],
        # (n1, n2, d, R timed at offset 0, checks (r0, r1, offset)): the panel
        # fit's square panel, a ragged one at an offset and an ordered one (d
        # split in clusters); past half a wave of tiles (one CTA a tile) on a
        # ragged d, an offset panel whose columns lie on both sides of its
        # block and an ordered one with ragged rows; then one real panel
        "kprime_panel_bf16": [
            (*stress_shape, m_st, [(0, m_st, 0), (256, 576, 256), (0, m_st, None)]),
            (2048, 2048, 2100, 640, [(0, 640, 0), (640, 1280, 640), (0, 520, None)]),
            (rp["n1"], rp["n2"], rp["d"], G._panel_rows(m_rp),
             [(0, G._panel_rows(m_rp), 0)]),
        ],
    }, log)
    gof_errs = phase_gof_kernel(device, [
        # (rows of the data, n1, n2, d, permutations, alphas, panel rows or 0)
        gof_f64,
        (2000, 333, 517, 2500, 35, (0.01, 1.0, 7.5), 0),
        # the panel regime at a ragged shape, four panels; ten alphas (the
        # stress width's recommended one last): two launches of pass 2 on
        # each panel's d2
        (2000, 333, 517, 2500, 35,
         (0.01, 0.03, 0.1, 0.3, 0.5, 1.0, 2.0, 5.0, 7.5, GOF_RECOMMENDED_ALPHA), 256),
        # the panel regime at the float32 route's width, four panels
        (GOF_ROWS, 1300, 1300, d, 100, GOF_ALPHAS, 768),
    ], log)
    errs.update({("a_times_k", shape): e for shape, e in gof_errs.items()})
    bench, se, rs = BENCH_ENSEMBLE, STRESS_ENSEMBLE, RNASEQ_ENSEMBLE
    nt_b, ntr_b, d_b, nm_b, k_b = (bench["n_test"], bench["n_train"], bench["d"],
                                   bench["n_masks"], bench["k"])
    errs.update(phase_knn_kernels(device, [
        # (label, nt, ntr, d, masks, k, exclude_self, integer rows)
        ("bench ensemble", nt_b, ntr_b, d_b, nm_b, k_b, False, False),
        ("bench predict", ntr_b + nt_b, ntr_b, d_b, nm_b, k_b, True, False),
        ("stress ensemble", se["n_test"], n, d, se["subspace_count"], se["k"], False, False),
        ("stress predict", n + se["n_test"], n, d, se["subspace_count"], se["k"], True, False),
        ("rnaseq ensemble", rs["n_test"], rs["n_train"], rs["d"], rs["n_masks"], rs["k"],
         False, False),
        ("rnaseq predict", rs["n_train"] + rs["n_test"], rs["n_train"], rs["d"], rs["n_masks"],
         rs["k"], True, False),
        ("ragged", 333, 517, 100, 37, 64, True, False),
        ("ragged", 333, 5170, 2500, 13, 10, False, False),
        ("integer ties", 300, 260, 20, 11, 5, True, True),
        ("integer ties", 200, 3000, 3000, 9, 7, True, True),
    ], log))
    errs.update({("fused_no_kl_fit_cuda", shape): e for shape, e in phase_fused_kernel(device, [
        # (label, n, d, bs, epochs): the notebook shape, the gate's widest
        # corner (2 round_up(bs, 64) = 2048 Gram rows), n < BSP, bs not a
        # multiple of 64
        ("notebook", 2000, 10, 500, 3),
        ("corner", 8192, 128, 1000, 2),
        ("n < BSP", 50, 16, 50, 2),
        ("ragged bs", 300, 12, 100, 2),
    ], log).items()})

    log("phase 2: the multi-tensor Adadelta update against its plain path")
    adadelta_row = phase_adadelta_kernel(device, d, log)

    log("phase 3: no-kl main path at full width")
    k2_launches, stress_model, X_stress, updates = phase_main_path(device, n, d, batch, log)

    main_losses = np.asarray(stress_model.train_history["generator_loss"])

    log("phase 3b: kl main path at full width")
    kl_launches, kl_results = phase_kl_main_path(device, n, d, batch, log)

    log("phase 3c: the subspace ensemble at full width (knn, knn_mean)")
    knn_launches, ensembles = phase_ensembles(device, stress_model, X_stress, log)

    log("phase 3d: the fused whole-fit path (fit_impl='fused'), notebook configuration")
    k8_launches = phase_fused_main_path(device, log)

    log("phase 3e: the other native bases at full width (" + ", ".join(OTHER_BASES) + ")")
    base_rates = phase_other_bases(device, stress_model, X_stress, log)

    log("phase 3f: the heterogeneous ensemble (knn, lof, ecod) at full width, distilled")
    hetero = phase_hetero(device, stress_model, X_stress, log)

    log("phase 3g: serving and the CLI at full width")
    cli_launches = phase_serving(device, stress_model, X_stress, log)

    log("phase 3h: the multi-device paths in a world of one (NCCL over loopback)")
    mesh_runs = {}
    mesh_launches = phase_multidevice(device, n, d, batch, main_losses, kl_results, ensembles,
                                      log, mesh_runs)

    log("phase 3i: the bf16 options (gram, model and optimizer-state dtypes) at full width")
    bf16_launches = phase_bf16_options(device, n, d, batch, main_losses, kl_results["losses"], log,
                                       mesh_runs["no-kl bf16"])

    log("phase 4: the other regimes through fit, the notebook configurations")
    launches = phase_other_regimes(device, n, d_flash, d, batch, log)
    launches["gram_quadrant_sums_stash"] = k2_launches
    launches.update(kl_launches)

    log("phase 5: times")
    rows = phase_times(device, {"kl": kl_shape, "flash": flash_shape, "stress": stress_shape,
                                "k1_large": K1_LARGE, "k4_real_panel": K4_REAL_PANEL,
                                "gof": [gof_f64, gof_f32]}, errs, launches, log)
    rows += knn_times(ensembles, errs, knn_launches, hetero["launches"], log)
    for row in rows:
        if row["name"] in cli_launches:  # phase 3g's CLI: fit (K2) and score (K7)
            row["launches_cli"] = cli_launches[row["name"]]
        if row["name"] in mesh_launches:  # phase 3h's sharded paths (K1-K3, K5-K7)
            row["launches_mesh"] = mesh_launches[row["name"]]
    rows.append(fused_times(device, errs, k8_launches, log))
    adadelta_row["launches"] = {"no-kl stress fit": updates, **kl_results["updates"]}
    adadelta_row["launches_mesh"] = mesh_launches["adadelta_multi"]  # phase 3h's dp fits
    rows.append(adadelta_row)
    pallas = "vgan_tpu/ops/pallas/mmd_gram.py"
    for name, replaces in (("gram_quadrant_sums_bf16", f"{pallas}:207 _fwd_kernel"),
                           ("gram_quadrant_sums_stash_bf16", f"{pallas}:269 _fwd_stash_kernel"),
                           ("gram_backward_flash_bf16", f"{pallas}:469 _flash_bwd_kernel"),
                           ("kprime_panel_bf16", f"{pallas}:606 _kprime_panel_kernel")):
        row = {"name": name, "route": "cuda",
               "source": "vgan_tpu_torch/ops/cuda/csrc/mmd_gram.cu",
               "replaces": replaces + " with matmul_dtype='bfloat16' (bf16 z_dot, :779)",
               **bf16_rows[name], "launches": bf16_launches[name], "library_ms": None,
               "bound_peak_tflops": PEAK_BF16_FLOPS / 1e12}
        if name == "gram_quadrant_sums_bf16":
            row["launches_panel_fit"] = bf16_launches["gram_quadrant_sums_bf16", "panel fit"]
        if name in mesh_launches:  # phase 3h's dp no-kl fit with the options (K2 bf16)
            row["launches_mesh"] = mesh_launches[name]
        rows.append(row)
    rates = panel_fit_rates(device, log)
    next(row for row in rows if row["name"] == "kprime_panel")["panel_fit_steps_per_s"] = rates
    rates = flash_fit_rates(device, log)
    next(row for row in rows if row["name"] == "gram_backward_flash")["fit_steps_per_s"] = rates
    ensemble_rates(ensembles, log)
    for base, r in base_rates.items():
        log(f"  {base} decision_function ({r['n_masks']} masks): {r['ms']:.3f} ms, "
            f"{r['subspace_scorings_per_s']:.1f} subspace-scorings/s")
    for name, sec in hetero["times"].items():
        log(f"  hetero {name}: {sec * 1e3:.3f} ms")
    sps = fit_steps_per_s(device, n, d, batch)
    log(f"  stress fit (n={n}, d={d}, batch {batch}): {sps:.2f} steps/s")
    kl_sps = kl_fit_steps_per_s(device, n, d, batch)
    log(f"  kl stress fit (n={n}, d={d}, batch {batch}, one detector and five generator "
        f"epochs): {kl_sps:.2f} steps/s")
    log(f"  with the bf16 options (phase 3i's), for information: stress fit "
        f"{fit_steps_per_s(device, n, d, batch, **BF16_OPTIONS):.2f} steps/s, kl stress fit "
        f"{kl_fit_steps_per_s(device, n, d, batch, **BF16_OPTIONS):.2f} steps/s")
    profile_stress_epoch(device, n, d, batch, log)
    profile_stress_epoch(device, n, d, batch, log, kl=True)
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    for row in rows:  # the datapath of every kernel row but the bf16 variants'
        row.setdefault("bound_peak_tflops", PEAK_F32_FLOPS / 1e12)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
