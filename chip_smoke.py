#!/usr/bin/env python3
"""GPU smoke test of the PyTorch / CUDA port (`generative_recommenders_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero, printing no result, without one.

1. prints the card's name and power limit, then builds every CUDA kernel
   from its source through the warm-up CLI (`cli/warm_cache.py`, one nvcc
   per source, all at once) and prints each build's time;
2. kernel phase: calls each kernel's wrapper at the shapes the serving and
   training paths give it (on contiguous tensors and on the strided views
   of the uvqk projection that the paths pass) and at edge cases, and holds
   the result against the plain PyTorch version on the same inputs
   (float32, TF32 off); the backward kernels K2 and K3 + K4 against the
   plain backward (autograd of the plain forward); the relative-bias pair
   K6 and K7 at the research preset's shapes, on a batch of the synthetic
   corpus, against their plain versions (and a float64 run of them), and at
   the ml-20m large preset's heads under length buckets (N = 75 and 139
   against a position table of Nm = 211), K6 and K7 timed at N = 139 and
   211; K1, K5,
   K6 and K7 also at the seams of their tilings (chunk and tile edges, row
   and head counts that do not fill a tile or a group), K2 and K4 at the
   widths, lengths and contextual rows where their tiling ends and beside a
   row of length 0, K3 also at its own tiling's seams (lengths at its query-
   and key-tile edges, a window with full-attention rows), the outputs of K1,
   K3, K4 and K5 and the dk and dv of K2 and K7 the same bits on a second
   run; K1 and K2 also timed at the training and deterministic shapes; K6
   and K7 on bfloat16 q, k, v and dO (the first HSTU block's types under
   compute_dtype="bfloat16") against their bfloat16 plain versions, at the
   ml-3b layer-0 shape on a corpus batch and (in the ml-1m phase) at the
   ml-1m large preset's, timed, with their bounds; K7-det (the fixed-order
   relative-bias backward, float32 and bfloat16) against the plain backward
   at the research shape, at the seams of its tilings (tile edges, head
   groups that end unfilled, N > Nm) and (in the ml-1m phase) at the ml-1m
   large preset's, every output the same bits on a second run, timed
   against K7 in the same call; K1 and K2 on bfloat16 (the bias-free
   research model's first block) against their bfloat16 plain versions at
   the ml-3b layer-0 shape, at bench.py's shape (B 8, N 2048, H 4, D 64,
   alpha 1/8) and at their seams, timed, with their bounds;
3. serving phase: runs the port's serving CLI in the Offline scenario at the
   full width of the `debug` preset, once dense and once with --mfalcon,
   with the launch counters set to 0 just before each run and read just
   after; checks that the dense and M-FALCON predictions agree, and that
   the GPU path agrees with the CPU path (plain versions) on a small model;
4. training phase: trains the full-width `debug` preset through the port's
   `train_loop` (2 warm-up steps, then 20 counted and timed ones), checks
   the losses and that every attention forward and backward went through
   K1 and K2; then a deterministic phase (`torch.use_deterministic_algorithms`)
   at uih 1024 that must take K3 + K4 and give the same bits twice (and a
   profile of one of its steps); then one
   training step's gradients on a small model, GPU kernels against the CPU
   plain versions; every ranker step here runs under the default STU
   recompute flags. Then the dynamic-STU ranker (`train_ranker
   --stochastic_depth 0.1 --l2_max_len 128`, 2 + 20 steps; K1 and K2 held to
   the layers the recorded coins ran, each attention's width to the L2
   windows); the recompute phase (the default flags against all off, one
   seed, dropout on: gradients, launches, the bytes kept for the backward,
   peak memory and median step of each); the jagged attention phase
   (`ops/hstu_attention.py`: `hstu_mha` through K1 and `delta_hstu_mha`
   through K5 at the serving shape against their plain versions); the
   interleave preprocessor at the training widths, forward and backward,
   GPU against CPU; and `train_ranker --output_trace` over 36 steps of a
   small ranker, whose Chrome trace must hold K1's and K2's events;
5. research phase: trains the HSTU retrieval model of the full-width
   preset `ml-3b/hstu-sampled-softmax-n96-seqlen500-large` (16 blocks, 8
   heads, d 256, N 511, batch 96, 128 negatives, 855,776 items) through the
   port's research `train_loop` on a synthetic corpus (2 warm-up steps, 10
   timed ones), written as the 16 shards of a fractal-expansion corpus under
   `tmp/ml-3b/` and read through the registry (`get_reco_dataset("ml-3b")`)
   on the native reader (a sample of rows held against the Python path and
   the in-memory rows, both readers' rows/s printed), evaluates it against
   the preset's items, checks that every attention went through K6 and K7
   (and none through K1 / K2); then one training step's loss and gradients
   on a small research model, GPU kernels against the CPU plain versions;
   then the same preset with compute_dtype="bfloat16" (2 + 10 steps and the
   eval; block 0 through K6-bf16 / K7-bf16, the other 15 through K6 / K7),
   one small bfloat16 step GPU against CPU; then the same preset bias-free
   (enable_relative_attention_bias=False) in bfloat16, 2 + 10 steps and the
   eval (block 0 through K1-bf16 / K2-bf16, the other 15 through K1 / K2),
   profiled, and a small bias-free bfloat16 model's embeddings and one step
   GPU against CPU; then the preset in float32 with
   remat=True and with loss_activation_checkpoint=True (2 + 5 steps each,
   K6 32 a step under remat), their peaks and medians against the research
   phase's, and one small step with dropout on with and without each,
   gradients held to each other on the card;
6. SASRec phase: trains the baseline preset `ml-20m/sasrec-sampled-softmax-n128`
   uncut (4 blocks, 4 heads, d 256, N 211, batch 128, 128 negatives, 131,262
   items) through `train_loop` on a 4,000-user synthetic corpus (2 warm-up
   steps, 10 timed ones, an eval of 10 batches), checks that no HSTU kernel
   launched; then one step of a small SASRec model, GPU against CPU;
7. bucketed phase: trains `ml-20m/hstu-sampled-softmax-n128-large` uncut
   (16 blocks, 8 heads, dqk = dv = 32, Nm 211, batch 128) with in-batch
   negatives, stochastic length (alpha 1.6) and length buckets (64, 128,
   200) on a corpus whose batches take the 128 bucket (N = 139), 2 + 10
   steps through `ResearchTrainer.train_step`, each step's width (as the
   trainer's encoder received it) printed and checked, and its 16 K6 and 16
   K7 launches; then one `train_step` of a small in-batch model, which
   cuts the batch to a bucket, GPU against CPU, with injected offsets;
8. KV-cached retrieval phase: on that model at its full width, for 128
   users and M = 1 and 4, `encode_with_cache(reserved_slots=M)` (16 K6
   launches), `encode_delta` of M tokens (none) held to a full re-encode,
   the host wall of each (first call and median of 5 more), then `CandidateIndex.get_top_k_outputs` (top 100 of 131,262 items, each
   row's history filtered) against the same call on the CPU;
9. ml-1m phase: writes `tmp/movielens1m.zip` in GroupLens' format at the
   published scale (6,040 users, 1,000,209 ratings, 3,706 movies), runs
   `preprocess_public_data --dataset_name ml-1m`, trains
   `ml-1m/hstu-sampled-softmax-n128-large` for one epoch through
   `train_research` on the registry's files with `--ckpt_dir` (K6 8 x
   (steps + eval batches), K7 8 x steps), restores the checkpoint bit-equal;
   then the same preset with the MoL similarity (the default MoLConfig,
   mi_loss weighted 0.001) one epoch through `train_loop` on the registry's
   files and a full MoL eval, `MoLBruteForceTopK` top-100 for 128 users
   through `CandidateIndex(top_k_module=...)` against the same on the CPU,
   and one small MoL step GPU against CPU. After the first: the deterministic
   research phase, in a process of its own, the only one with
   CUBLAS_WORKSPACE_CONFIG set (torch.use_deterministic_algorithms(True)
   needs it before the first cuBLAS call): the ml-1m large preset
   twice from one seed, 2 + 10 steps each, losses and every parameter
   bit-identical and the relative-bias backward on K7-det; the ml-3b preset
   in float32, 2 + 5 steps, its median against the research phase's, both
   profiled; a small bfloat16 model twice (K7-det-bf16 in block 0). Between
   the two: the preset with
   attention dropout 0.2 (2 + 10 steps through the plain composite, 0 K6 /
   K7 a step, K6 in the eval) and the position-only bias (no timestamps:
   K6 / K7 on zero timestamps and a one-entry time table against their plain
   versions at the preset's shape, timed; a small encoder GPU against CPU);
10. movielens-1m ranker phase: `train_ranker --dataset movielens-1m` on
   that `sasrec_format.csv` at full width with `--ckpt_dir` (K1, K2 3 a
   step), `--mode eval` from the checkpoint, then `inference.main
   --accuracy` from it (int8 tables, float tables, `--mfalcon`: K1, K5) and
   from fresh weights, dense against M-FALCON within `PRED_TOL`;
11. KuaiRand-1K phase: writes the two logs and the user features of 1,000
   users in the published columns, runs `preprocess_dlrm_data --skip_download`
   and a few `train_ranker --dataset kuairand-1k` steps (8 tasks, 7 tables);
12. distribution phase (`parallel/`): the ranks as processes on free ports
   of 127.0.0.1, the ranker CLI as ranks, at the training phase's shape, 2 +
   10 steps: (a) `train_ranker --distributed --mesh 1x1`, one rank over
   NCCL; (b) `--mesh 1x2 --dist_backend gloo`, two ranks on the one card,
   each with half the rows of every table, each rank's K1 / K2 launches,
   table rows, peak memory and steps printed (times labelled "2 ranks on
   one H100 over gloo": they are not multi-GPU numbers); (c) a small ranker
   (dropout off) and (d) a small research model (its item table sharded,
   negatives injected), each on a 1 x 2 mesh over gloo for 2 steps, against
   one rank on the same global batches: losses rtol 1e-5, parameters rtol
   5e-5 / atol 1e-6; and `train_research --distributed` on two ranks over
   gloo, the ml-1m large preset over the ml-1m phase's files, 2 + 10 steps
   and a full eval, K6 and K7 on both ranks. A rank that fails fails the
   run;
13. prints one JSON line with every kernel's launches, error and times, the
   script's time, and as the last line the device JSON.

Every file the script reads it writes itself, under `tmp/`. Any failed check
exits nonzero. ``python3 chip_smoke.py rank ...`` is one rank of the
distribution phase (the script starts them itself).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

# H100 SXM published peaks: float32 FMA outside the tensor cores; dense TF32
# in the tensor cores, of which a 3xTF32 product (three TF32 products per
# float32-accurate one) can reach a third; HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12
# dense bfloat16 in the tensor cores: the bound of the kernels on bfloat16
# operands (K1, K2, K6, K7, K7-det), which by their own choice multiply with
# one exact TF32 product each, at half this rate
PEAK_BF16_FLOPS = 989e12

# the full-width debug preset, as served
B, MAX_UIH, MAX_CANDS, CHUNK = 32, 512, 160, 5
HASH_SIZE = 1_000_000  # cut from the reference's 10M rows to keep set-up short
NUM_QUERIES, NUM_WARMUPS, QSL_BATCHES = 24, 2, 4
# the full-width debug preset, as trained (the train CLI's defaults)
TRAIN_UIH, TRAIN_CANDS, TRAIN_WARMUPS, TRAIN_STEPS = 256, 10, 2, 20
DET_UIH, DET_STEPS = 1024, 3  # the deterministic phase, one layer
# the research phase: the preset at full width over a synthetic corpus
RESEARCH_PRESET = "ml-3b/hstu-sampled-softmax-n96-seqlen500-large"
RESEARCH_USERS, RESEARCH_WARMUPS, RESEARCH_STEPS = 2000, 2, 10
# the SASRec baseline at full width, the same steps
SASREC_PRESET = "ml-20m/sasrec-sampled-softmax-n128"
SASREC_USERS, SASREC_EVAL_BATCHES = 4000, 10
# in-batch negatives, stochastic length and length buckets on the ml-20m
# large HSTU preset, the same steps; its corpus keeps every batch in the 128
# bucket (N = 139 against Nm = 211)
BUCKET_PRESET = "ml-20m/hstu-sampled-softmax-n128-large"
BUCKET_USERS, BUCKET_MAX_LEN = 2000, 120
SL_ALPHA, LENGTH_BUCKETS = 1.6, (64, 128, 200)
# the KV-cached encode and the candidate index on that preset's model
CACHE_USERS, CACHE_DELTAS, TOP_K = 128, (1, 4), 100
# the research phase's corpus as 16 shards of a fractal-expansion corpus, read
# through the dataset registry (`get_reco_dataset("ml-3b")`) and the native
# reader; rows held against the Python path and the in-memory rows
ML3B_SHARDS, SHARD_CHECK_ROWS = 16, 200
# real-data phases: files written in the published formats under tmp/
DATA_ROOT = "tmp"
ML1M_USERS, ML1M_RATINGS, ML1M_MOVIES, ML1M_MAX_ID = 6040, 1_000_209, 3706, 3952
ML1M_PRESET = "ml-1m/hstu-sampled-softmax-n128-large"
# the ranker CLI's defaults on the real datasets (full width)
RANKER_STEPS, RANKER_EVAL_BATCHES, ACC_QSL_BATCHES = 12, 8, 8
# KuaiRand-1K: 1,000 users; the events cut from ~11.7 million to 300 a user
KUAI_USERS, KUAI_EVENTS_PER_FILE = 1000, 150
# kernel vs plain: both float32; they differ only in summation order (for
# K2's dq, an order that changes from run to run: atomics) and in the exp of
# silu, so the error is held to a small fraction of the output's max
REL_TOL = 2e-5
# K7's table gradients: each entry of dpos_w / dts_w sums up to B H N^2 / 2
# float32 terms (1e8 at the research shape), with atomics in an order that
# changes from run to run. Against a float64 run of the plain backward at
# that shape the kernel stood at 6.9e-7 to 8.9e-7 (dpos_w) and 5.4e-7 to
# 1.2e-6 (dts_w) of each gradient's max over four runs, the float32 plain
# version at 1.8e-7 and 3.7e-6, and kernel against plain version at 4.6e-6
# at most over all cases (H100; all printed below on every run), so the
# same share of the max as the other outputs holds them, with a margin of
# more than four
TABLE_TOL = 2e-5
# dense vs M-FALCON predictions, and GPU vs CPU predictions (sigmoid outputs)
PRED_TOL = 1e-4
# one training step's gradients, GPU kernels vs CPU plain versions, as a
# fraction of each gradient's max (float32; sums in other orders)
GRAD_TOL = 1e-4
# the bfloat16 K6 / K7 against their bfloat16 plain versions: both round P,
# dS and the outputs to bfloat16 at the same points from float32 sums taken in
# other orders, so an output lands on the other side of a rounding boundary
# now and then: one rounding (2^-8 relative) at its own size, at most 2^-7 of
# the output's max; 2^-6 leaves a factor of two. The table gradients are
# float32 sums of float32 dS: TABLE_TOL
BF16_TOL = 2.0**-6
# a bfloat16 step, GPU kernels vs CPU plain versions: the float32 uvqk
# product rounds to bfloat16 on each device from sums in other orders, and a
# flipped rounding reaches every gradient: the JAX package's own bfloat16
# tolerance (tests/test_relbias_attention.py, 3e-2), the loss 1e-3 relative
BF16_GRAD_TOL, BF16_LOSS_RTOL = 3e-2, 1e-3
# the bias-free bfloat16 model, GPU against CPU: tests/test_torch_bf16.py's
# tolerances (outputs l2-normalised, 4e-3 absolute; the loss 1e-4 relative;
# gradients BF16_GRAD_TOL of their max)
BF16_MODEL_ATOL, BF16_FREE_LOSS_RTOL = 4e-3, 1e-4
# K7-det on bfloat16: its float32 table gradients, now summed in one fixed
# order, against the plain version's (1e-5 of the max; the outputs BF16_TOL)
DET_BF16_TABLE_TOL = 1e-5
# the deterministic research phase: the ml-1m large preset twice from one
# seed, 2 + 10 steps each; then the ml-3b preset in float32, 2 + 5 steps
DET_RESEARCH_STEPS, DET_ML3B_STEPS = 10, 5
# its process's cuBLAS workspace (its alone) and time limit
DET_CUBLAS_WORKSPACE, DET_TIMEOUT = ":4096:8", 600
# bench.py's attention pair, used here as a kernel shape only (B, N, H, D;
# alpha 1 / sqrt(D); lengths from default_rng(0))
BENCH_SHAPE = (8, 2048, 4, 64)
# one step's gradients with and without per-block recomputation, dropout on,
# on the card: the same kernels on the same inputs, but K7 sums dq and the
# tables with atomics in an order that changes from run to run
REMAT_TOL = 1e-5
# the remat phase's steps at the ml-3b preset: 2 warm-ups, then timed ones
REMAT_WARMUPS, REMAT_STEPS = 2, 5
# the dynamic-STU ranker (the train CLI's flags), the recompute phase's timed
# steps, the traced run (the profiler records steps 30 to 34)
SD_RATIO, L2_LEN, REC_STEPS, TRACE_STEPS = 0.1, 128, 10, 36
# the ml-1m large preset with attention dropout: 2 warm-ups, then timed steps
ATTN_DROPOUT, DROPOUT_STEPS = 0.2, 10
# the distribution phase: 2 + 10 steps of each run, a rank's time limit; a
# mesh against one rank on the same global batches: `tests/test_parallel.py`'s
# tolerances (losses, parameters)
DIST_WARMUPS, DIST_STEPS, DIST_TIMEOUT = 2, 10, 600
MESH_LOSS_RTOL, MESH_PARAM_TOL = 1e-5, dict(rtol=5e-5, atol=1e-6)
# the parity checks' small models: a ranker with 128-row tables, a research
# model with 127 items (128 rows), global batches of 8
PARITY_HASH, PARITY_ITEMS, PARITY_BATCH = 128, 127, 8


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def device_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls: a sleep
    kernel keeps the card busy while the host enqueues them, so launch
    overhead does not show as idle time between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(name: str, fn) -> None:
    """Prints one call's host wall time, the card's busy time in it (the sum
    of its kernels' device times; one stream, so they do not overlap), the
    idle share, the kernels that take the most device time, and the
    collectives' host times where there are any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU ops that launched them repeat their
    # time, and a user annotation on the device (Optimizer.step#...) spans
    # kernels that are counted on their own
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"  profile {name}: wall {wall_ms:.2f} ms, device time not measured (no CUDA events)")
        return
    print(
        f"  profile {name}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in events)} kernels"
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    # a rank's collectives, as their backends record them on the host (from
    # start to end, a wait for the other ranks included)
    comm = [e for e in prof.key_averages() if e.key.startswith(("gloo:", "nccl:"))]
    if comm:
        print("    collectives: " + ", ".join(f"{e.key} {e.cpu_time_total / 1e3:.2f} ms x{e.count}"
                                         for e in sorted(comm, key=lambda e: -e.cpu_time_total)))


def kernel_function(mangled: str) -> str:
    """The unqualified function name of a mangled `ns::fn<...>` symbol (the
    last name of its `_ZN <length><name> ...` prefix), or the symbol."""
    names, i = [], 3
    while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    return names[-1] if names else mangled


def median(xs) -> float:
    s = sorted(xs)
    return (s[(len(s) - 1) // 2] + s[len(s) // 2]) / 2


def write_movielens_1m_zip(path: str, seed: int = 0) -> None:
    """`movielens1m.zip` in GroupLens' published format and at its published
    scale: `ml-1m/ratings.dat` (UserID::MovieID::Rating::Timestamp, 1,000,209
    ratings on 1-5 by 6,040 users, each with at least 20, of exactly 3,706
    distinct movies within 1..3,952; a user's timestamps tie in places),
    `users.dat` (sex, age group, occupation, zip) and `movies.dat` (3,883
    movies, "Title (YYYY)", `|`-joined genres, iso-8859-1). Popularity and
    activity are heavy-tailed; the ratings themselves are random."""
    import zipfile

    import numpy as np

    rng = np.random.default_rng(seed)
    n_users, n_ratings, n_movies = ML1M_USERS, ML1M_RATINGS, ML1M_MOVIES
    w = rng.lognormal(0.0, 1.2, n_users)
    counts = 20 + rng.multinomial(n_ratings - 20 * n_users, w / w.sum())
    rated = np.sort(rng.choice(np.arange(1, ML1M_MAX_ID + 1), n_movies, replace=False))
    pop = rng.lognormal(0.0, 1.5, n_movies)
    items = rated[rng.choice(n_movies, n_ratings, p=pop / pop.sum())]
    items[rng.choice(n_ratings, n_movies, replace=False)] = rated  # every movie rated at least once
    users = np.repeat(np.arange(1, n_users + 1), counts)
    stars = rng.choice(np.arange(1, 6), n_ratings, p=[0.06, 0.11, 0.26, 0.35, 0.22])
    # seconds since 2000-04-25, a minute's resolution within a user: ties
    ts = 956_703_932 + np.repeat(rng.integers(0, 3 * 10**7, n_users), counts) + rng.integers(0, 2000, n_ratings) * 60
    ratings = "".join(f"{u}::{m}::{r}::{t}\n" for u, m, r, t in zip(
        users.tolist(), items.tolist(), stars.tolist(), ts.tolist()))
    zips = rng.integers(1000, 99999, n_users)
    ages = [1, 18, 25, 35, 45, 50, 56]
    users_dat = "".join(
        f"{u}::{'FM'[int(g)]}::{ages[int(a)]}::{int(o)}::{z:05d}{'-1234' if u % 97 == 0 else ''}\n"
        for u, g, a, o, z in zip(range(1, n_users + 1), rng.integers(0, 2, n_users),
                                 rng.integers(0, 7, n_users), rng.integers(0, 21, n_users), zips.tolist())
    )
    unrated = rng.choice(np.setdiff1d(np.arange(1, ML1M_MAX_ID + 1), rated), 3883 - n_movies, replace=False)
    genres = ["Action", "Adventure", "Animation", "Children's", "Comedy", "Crime", "Documentary", "Drama",
              "Fantasy", "Film-Noir", "Horror", "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War",
              "Western"]
    titles = ["Toy Story", "City of Lost Children, The", "Misérables, Les", "Heat", "Seven (Se7en)"]
    movies = "".join(
        f"{m}::{titles[m % 5]} {m} ({1919 + m % 81})::"
        f"{'|'.join(genres[(m * 7 + j) % 18] for j in range(1 + m % 3))}\n"
        for m in np.sort(np.concatenate([rated, unrated])).tolist()
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as z:
        z.writestr("ml-1m/ratings.dat", ratings)
        z.writestr("ml-1m/users.dat", users_dat)
        z.writestr("ml-1m/movies.dat", movies.encode("iso-8859-1"))


def write_kuairand_1k(data_path: str, events_per_file: int, seed: int = 0) -> None:
    """`KuaiRand-1K/data/` in the published format: the two
    `log_standard_*_1k.csv` logs (their 19 columns, in time order) of 1,000
    users, ``events_per_file`` events a user in each (the published logs
    hold about 11.7 million in all), and `user_features_1k.csv` (31
    columns; the five range features as text)."""
    import csv
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    root = os.path.join(data_path, "KuaiRand-1K", "data")
    os.makedirs(root, exist_ok=True)
    n_users = KUAI_USERS
    cols = ["user_id", "video_id", "date", "hourmin", "time_ms", "is_click", "is_like", "is_follow",
            "is_comment", "is_forward", "is_hate", "long_view", "play_time_ms", "duration_ms",
            "profile_stay_time", "comment_stay_time", "is_profile_enter", "is_rand", "tab"]
    t0 = 1_649_347_200_000  # 2022-04-08, in milliseconds
    for f, name in enumerate(("log_standard_4_08_to_4_21_1k.csv", "log_standard_4_22_to_5_08_1k.csv")):
        n = n_users * events_per_file
        time_ms = np.sort(t0 + f * 14 * 86_400_000 + rng.integers(0, 14 * 86_400_000, n))
        user = rng.permutation(np.repeat(np.arange(n_users), events_per_file))
        flags = (rng.random((n, 8)) < [0.35, 0.02, 0.003, 0.002, 0.002, 0.001, 0.25, 0.01]).astype(np.int64)
        day = (time_ms - t0) // 86_400_000
        table = [user, rng.zipf(1.3, n) % 4_000_000, 20220408 + day, (time_ms // 60_000) % 1440, time_ms,
                 *flags[:, :7].T, rng.integers(0, 60_000, n), rng.integers(1_000, 300_000, n),
                 np.zeros(n, np.int64), np.zeros(n, np.int64), flags[:, 7], rng.integers(0, 2, n),
                 rng.integers(0, 15, n)]
        with open(os.path.join(root, name), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(cols)
            w.writerows(zip(*(c.tolist() for c in table)))
    ranges = {
        "user_active_degree": ["high_active", "full_active", "middle_active", "UNKNOWN"],
        "follow_user_num_range": ["0", "(0,10]", "(10,50]", "(50,100]", "(100,150]", "(150,250]", "500+"],
        "fans_user_num_range": ["0", "[1,10)", "[10,100)", "[100,1k)", "[1k,5k)"],
        "friend_user_num_range": ["0", "[1,5)", "[5,30)", "[30,60)", "[60,120)"],
        "register_days_range": ["15-30", "31-60", "61-90", "91-180", "181-365", "366-730", "730+"],
    }
    pick = {c: [v[i] for i in rng.integers(0, len(v), n_users)] for c, v in ranges.items()}
    with open(os.path.join(root, "user_features_1k.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["user_id", "user_active_degree", "is_lowactive_period", "is_live_streamer",
                    "is_video_author", "follow_user_num", "follow_user_num_range", "fans_user_num",
                    "fans_user_num_range", "friend_user_num", "friend_user_num_range", "register_days",
                    "register_days_range"] + [f"onehot_feat{i}" for i in range(18)])
        for u in range(n_users):
            w.writerow([u, pick["user_active_degree"][u], 0, 0, u % 2, u * 3, pick["follow_user_num_range"][u],
                        u * 7, pick["fans_user_num_range"][u], u % 40, pick["friend_user_num_range"][u], 100 + u,
                        pick["register_days_range"][u]] + rng.integers(0, 9, 18).tolist())


def write_ml3b_shards(prefix: str, seqs, num_shards: int) -> None:
    """A fractal-expansion corpus from in-memory sequences: shards
    ``<prefix>_{i}.csv`` of ``user_id,"items","ratings"`` rows with 0-based
    item ids and float ratings, as `run_fractal_expansion` writes them, and
    the ``<prefix>_users.csv`` index of each shard's row count."""
    import csv

    U = len(seqs)
    bounds = [U * i // num_shards for i in range(num_shards + 1)]
    for i in range(num_shards):
        with open(f"{prefix}_{i}.csv", "w", newline="") as f:
            csv.writer(f).writerows(
                (int(seqs.user_ids[u]), ",".join(map(str, (seqs.item_ids[u] - 1).tolist())),
                 ",".join(f"{r}.0" for r in seqs.ratings[u].tolist()))
                for u in range(bounds[i], bounds[i + 1])
            )
    with open(f"{prefix}_users.csv", "w", newline="") as f:
        csv.writer(f).writerows((i, bounds[i + 1] - bounds[i]) for i in range(num_shards))


def tree_difference(a, b, path: str = "") -> str:
    """The first path at which two nested checkpoints differ ("" if none):
    a tensor's dtype or bits (wherever it lies: `torch.load` puts an
    optimizer's step counters on the card, AdamW keeps them on the host),
    a key, a length or another value."""
    import torch

    if isinstance(a, dict):
        if a.keys() != b.keys():
            return f"{path}: keys"
        return next((d for k in a if (d := tree_difference(a[k], b[k], f"{path}/{k}"))), "")
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: length"
        return next((d for i, (x, y) in enumerate(zip(a, b)) if (d := tree_difference(x, y, f"{path}/{i}"))), "")
    if isinstance(a, torch.Tensor):
        return "" if a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) else path
    return "" if a == b else path


def poison_allocator(nbytes: int) -> None:
    """Leaves a NaN-filled block in the caching allocator, so an output that
    a kernel fails to write shows as NaN."""
    import torch

    x = torch.full((nbytes // 4 + 1024,), float("nan"), device="cuda")
    del x


class FixedNegatives:
    """Local negatives a function of the positives (the devices' and the
    ranks' random streams differ)."""

    def __init__(self, sampler):
        self.sampler = sampler

    def __call__(self, gen_, positive_ids, num_to_sample, item_embedding_fn):
        import torch

        ids_ = self.sampler.all_item_ids
        r = torch.arange(num_to_sample, device=ids_.device)
        sampled = ids_[(positive_ids[..., None] * 7 + r * 13 + 1) % ids_.shape[0]]
        return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))


# ------------------------------------------------------ distribution ranks
def kernel_counters() -> dict:
    """Every kernel's launch counter, by name (the bfloat16 kernels and
    K7-det apart)."""
    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
        delta_hstu_mha_cuda,
        hstu_mha_bwd_cuda,
        hstu_mha_dense_cuda,
    )
    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import (
        hstu_mha_dense_relbias_cuda,
        hstu_mha_relbias_bwd_cuda,
    )

    bwd = hstu_mha_bwd_cuda.launches
    return {
        "K1": hstu_mha_dense_cuda.launches, "K5": delta_hstu_mha_cuda.launches,
        "K2": bwd["hstu_mha_bwd_fused"], "K3": bwd["hstu_mha_bwd_dq"], "K4": bwd["hstu_mha_bwd_dkv"],
        "K6": hstu_mha_dense_relbias_cuda.launches, "K7": hstu_mha_relbias_bwd_cuda.launches,
        "K1-bf16": hstu_mha_dense_cuda.launches_bf16, "K2-bf16": hstu_mha_bwd_cuda.launches_bf16,
        "K6-bf16": hstu_mha_dense_relbias_cuda.launches_bf16, "K7-bf16": hstu_mha_relbias_bwd_cuda.launches_bf16,
        "K7-det": hstu_mha_relbias_bwd_cuda.launches_det,
        "K7-det-bf16": hstu_mha_relbias_bwd_cuda.launches_det_bf16,
    }


# the counters a run reports only where they launched
OPTIONAL_KERNELS = ("K1-bf16", "K2-bf16", "K6-bf16", "K7-bf16", "K7-det", "K7-det-bf16")


def small_research():
    """The small research model's settings (3 blocks, 300 items, N 60), its
    float32 config and its corpus of 16 users: (model keywords, config,
    dataset)."""
    from generative_recommenders_tpu_torch.data.dataset import SequenceDataset, synthetic_user_sequences
    from generative_recommenders_tpu_torch.models.sequential import ModelConfig
    from generative_recommenders_tpu_torch.train.train_loop import TrainConfig

    sseqs = synthetic_user_sequences(num_users=16, num_items=300, max_len=60, min_len=2, seed=3)
    sds = SequenceDataset(sseqs, 56, ignore_last_n=1)
    small_model = dict(num_items=300, max_sequence_len=56, gr_output_length=3, item_embedding_dim=32,
                       num_blocks=3, num_heads=2, linear_dropout_rate=0.0, dropout_rate=0.0)
    small_cfg = TrainConfig(model=ModelConfig(dqk=16, dv=16, **small_model), local_batch_size=8, num_negatives=16)
    return small_model, small_cfg, sds


def parity_configs():
    """The parity checks' small ranker (dropout off) with its tables, and
    small research model (dropout off)."""
    from generative_recommenders_tpu_torch.configs.dlrm import get_embedding_table_config, get_hstu_configs
    from generative_recommenders_tpu_torch.models.sequential import ModelConfig
    from generative_recommenders_tpu_torch.train.train_loop import TrainConfig

    ranker = dataclasses.replace(
        get_hstu_configs("debug", max_uih_len=48, max_num_candidates=6), hstu_attn_num_layers=2,
        hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=64, hstu_attn_linear_dim=32,
        hstu_attn_qk_dim=32, hstu_num_heads=2, hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0,
    )
    research = TrainConfig(
        model=ModelConfig(num_items=PARITY_ITEMS, max_sequence_len=40, gr_output_length=1,
                          item_embedding_dim=32, num_blocks=2, num_heads=2, dqk=16, dv=16,
                          linear_dropout_rate=0.0, dropout_rate=0.0),
        local_batch_size=PARITY_BATCH, eval_batch_size=PARITY_BATCH, num_negatives=16, num_workers=0,
    )
    return ranker, get_embedding_table_config("debug", hash_size=PARITY_HASH, dim=16), research


def rank_main(argv) -> None:
    """One rank: ``cli <train_ranker | train_research> <its arguments>``
    runs the CLI (the ranker's then profiles one more step, outside its
    launch counts); ``parity <port> <rank> <dir>`` trains the parity checks'
    small models on a 1 x 2 mesh over gloo. Prints its result as one line
    ``RANK_RESULT <json>``."""
    import importlib

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job, rest = argv[0], argv[1:]

    def launches():
        return {k: c.count for k, c in kernel_counters().items()}

    if job == "cli":
        out = importlib.import_module(f"generative_recommenders_tpu_torch.cli.{rest[0]}").main(rest[1:])
        trainer = out["trainer"]
        result = dict(
            counts=launches(), losses=out["losses"], step_s=out["step_s"], history=out.get("history"),
            tables={n: list(p.shape) for n, p in trainer.model.named_parameters()
                    if n.startswith("embedding_tables_") or n == "embedding_module.item_emb"},
        )
        if rest[0] == "train_ranker":
            # one more step of this rank's rows of a global batch (the phase's
            # shape), profiled: where a rank's step time goes
            from generative_recommenders_tpu_torch.data.dlrm_factory import make_dlrm_batches
            from generative_recommenders_tpu_torch.parallel.sharding import rank_rows
            from generative_recommenders_tpu_torch.train.dlrm_train import to_device

            world, rank = dist.get_world_size(), dist.get_rank()
            raw = next(make_dlrm_batches("debug", trainer.hstu_cfg, hash_size=HASH_SIZE, batch_size=B * world,
                                         num_batches=1, seed=9))
            batch = to_device(rank_rows(raw, world, rank), trainer.device)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                profile(f"rank {rank} of {world} ({dist.get_backend()}), a training step",
                        lambda: trainer.train_step(batch))
            result["profile"] = printed.getvalue()
    elif job == "parity":
        from generative_recommenders_tpu_torch.parallel.distributed import initialize_distributed
        from generative_recommenders_tpu_torch.parallel.mesh import make_mesh
        from generative_recommenders_tpu_torch.parallel.sharding import rank_rows, shard_rows
        from generative_recommenders_tpu_torch.parallel.train import DistributedTrainer
        from generative_recommenders_tpu_torch.train.dlrm_train import DlrmTrainConfig, DlrmTrainer, to_device

        port, rank, work = rest[0], int(rest[1]), rest[2]
        initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda")
        mesh = make_mesh((1, 2))
        rcfg, tables, scfg = parity_configs()
        ranker = DlrmTrainer(rcfg, tables, DlrmTrainConfig(), device="cuda", mesh=mesh)
        ranker.restore(os.path.join(work, "ranker_init"), 0)
        batches = torch.load(os.path.join(work, "ranker_batches.pt"), weights_only=False)
        r_losses = [ranker.train_step(to_device(rank_rows(b, 2, rank), ranker.device))[0].item() for b in batches]
        r_state = {k: v.cpu() for k, v in ranker.state_dict().items()}
        init = torch.load(os.path.join(work, "research_init.pt"), weights_only=False)
        rbatches = torch.load(os.path.join(work, "research_batches.pt"), weights_only=False)
        research = DistributedTrainer(scfg, init["ids"], mesh, device="cuda")
        research.model.load_state_dict({k: shard_rows(v, mesh) if k in research.sharded else v
                                        for k, v in init["state"].items()})
        research.sampler = FixedNegatives(research.sampler)
        s_losses = [research.train_step(research.to_global_batch(b)).item() for b in rbatches]
        s_state = {k: v.cpu() for k, v in research.checkpoint_state()["params"].items()}
        if rank == 0:
            torch.save(dict(ranker=(r_losses, r_state), research=(s_losses, s_state)),
                       os.path.join(work, "parity.pt"))
        result = dict(ranker_losses=r_losses, research_losses=s_losses, sharded=list(research.sharded),
                      tables={n: list(p.shape) for n, p in ranker.model.named_parameters()
                              if n.startswith("embedding_tables_")})
    else:
        raise SystemExit(f"unknown rank job {job}")
    result.setdefault("counts", launches())
    result.update(rank=dist.get_rank(), world=dist.get_world_size(), backend=str(dist.get_backend()),
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print("RANK_RESULT " + json.dumps(result), flush=True)
    dist.destroy_process_group()


def det_main(argv) -> None:
    """The deterministic research phase, in a process of its own:
    ``chip_smoke.py det <the ml-1m phase's median step, ms> <the research
    phase's, ms>``, started by `main` with CUBLAS_WORKSPACE_CONFIG set for
    it alone (torch.use_deterministic_algorithms needs it before the first
    cuBLAS call). Under deterministic algorithms the relative-bias backward
    takes K7-det, so two runs from one seed give the same bits: the ml-1m
    large preset twice, the ml-3b preset in float32 against the research
    phase's median, a small bfloat16 model twice. Reads the files the
    earlier phases wrote under DATA_ROOT. Prints its report, then its
    launches as one line ``DET_RESULT <json>``."""
    import torch

    from generative_recommenders_tpu_torch.configs.research import RESEARCH_PRESETS
    from generative_recommenders_tpu_torch.data.dataset import batch_iterator
    from generative_recommenders_tpu_torch.data.reco_dataset import get_reco_dataset
    from generative_recommenders_tpu_torch.train import train_loop as research

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m_med, r_median = map(float, argv)
    all_counters = kernel_counters()
    total = dict.fromkeys(all_counters, 0)

    def count_reset():
        for c in all_counters.values():
            c.reset()

    def counts():
        """The launches since `count_reset` (the optional kernels' where
        they launched), also added to the phase's totals."""
        now = {k_: c.count for k_, c in all_counters.items() if c.count or k_ not in OPTIONAL_KERNELS}
        for k_, n_ in now.items():
            total[k_] += n_
        return now

    mcfg, rcfg = RESEARCH_PRESETS[ML1M_PRESET], RESEARCH_PRESETS[RESEARCH_PRESET]
    mm1, rm = mcfg.model, rcfg.model
    shard_train = get_reco_dataset("ml-3b", rm.max_sequence_len, data_root=DATA_ROOT).train_dataset
    rbatch = next(batch_iterator(shard_train, rcfg.local_batch_size, shuffle=True, seed=7))
    _, small_cfg, sds = small_research()
    d_reco = get_reco_dataset("ml-1m", mm1.max_sequence_len, data_root=DATA_ROOT)
    print(
        f"deterministic research phase: torch.use_deterministic_algorithms(True), CUBLAS_WORKSPACE_CONFIG="
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}; preset {ML1M_PRESET} uncut over the ml-1m phase's files, "
        f"{RESEARCH_WARMUPS} + {DET_RESEARCH_STEPS} steps of ResearchTrainer.train_step, twice from one seed"
    )
    row = next(batch_iterator(d_reco.train_dataset, mcfg.local_batch_size, shuffle=True, seed=0))
    det_mode = {"warn_only": False}

    def det_steps(cfg_, ds_, n_steps, seed):
        """``n_steps`` train steps of a fresh trainer under deterministic
        algorithms: (trainer, losses, step seconds, launches). warn_only is
        off until an operation of the step refuses (it has no deterministic
        implementation): that one is named, and the steps run again, and
        from then on, with warn_only=True, as the ranker's deterministic
        phase runs."""
        torch.use_deterministic_algorithms(True, warn_only=det_mode["warn_only"])
        try:
            trainer_ = research.ResearchTrainer(cfg_, ds_.all_item_ids(), device="cuda")
            it_ = batch_iterator(ds_, cfg_.local_batch_size, shuffle=True, seed=seed)
            count_reset()
            losses_, steps_ = [], []
            for _ in range(n_steps):
                b_ = next(it_)
                t0_ = time.perf_counter()
                losses_.append(float(trainer_.train_step(b_)))
                steps_.append(time.perf_counter() - t0_)
            return trainer_, losses_, steps_, counts()
        except RuntimeError as e:
            if det_mode["warn_only"] or "deterministic" not in str(e):
                raise
            print(f"  warn_only=False refused: {str(e).splitlines()[0]}; the runs take warn_only=True")
            det_mode["warn_only"] = True
        finally:
            torch.use_deterministic_algorithms(False)
        return det_steps(cfg_, ds_, n_steps, seed)

    def det_twice(name, cfg_, ds_, n_steps, want):
        """Two runs of ``det_steps`` from one seed: their losses and every
        parameter bit-identical, ``want`` launches in each. Returns the
        second run's trainer and median step (ms)."""
        runs_ = []
        for _ in range(2):
            trainer_, losses_, steps_, n_ = det_steps(cfg_, ds_, n_steps, 21)
            check(all(math.isfinite(x) for x in losses_), f"{name}: losses {losses_}")
            check(n_ == want, f"{name}: launched {n_}, expected {want}")
            runs_.append((losses_, {k_: p_.detach().clone() for k_, p_ in trainer_.model.named_parameters()},
                          steps_))
            if len(runs_) == 1:
                del trainer_
        (la, pa, _), (lb, pb, sb) = runs_
        same = la == lb and pa.keys() == pb.keys() and all(torch.equal(pa[k_], pb[k_]) for k_ in pa)
        med = 1e3 * median(sb[RESEARCH_WARMUPS:] or sb)
        print(f"  {name}: median step {med:.2f} ms; losses {[round(x, 5) for x in la]}; launches {n_} a run; "
              f"the two runs' losses and every parameter bit-identical: {same} (warn_only {det_mode['warn_only']})")
        check(same, f"{name}: two deterministic runs from one seed differ")
        return trainer_, med

    d_steps = RESEARCH_WARMUPS + DET_RESEARCH_STEPS
    blocks1 = mm1.num_blocks
    torch.cuda.reset_peak_memory_stats()
    d_trainer, d_med = det_twice(f"{ML1M_PRESET}, deterministic", mcfg, d_reco.train_dataset, d_steps,
                                 {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": blocks1 * d_steps, "K7": 0,
                                  "K7-det": blocks1 * d_steps})
    print(f"  against the ml-1m phase's median step without deterministic algorithms {m_med:.2f} ms; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.use_deterministic_algorithms(True, warn_only=det_mode["warn_only"])
    try:
        profile("deterministic ml-1m research training step", lambda: d_trainer.train_step(row))
    finally:
        torch.use_deterministic_algorithms(False)
    del d_trainer, d_reco
    torch.cuda.empty_cache()
    # the ml-3b preset in float32 under deterministic algorithms, against the
    # research phase's median (both in this call)
    torch.cuda.reset_peak_memory_stats()
    n3 = RESEARCH_WARMUPS + DET_ML3B_STEPS
    t3, l3, s3, n_3 = det_steps(rcfg, shard_train, n3, 11)
    want_n = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": rm.num_blocks * n3, "K7": 0,
              "K7-det": rm.num_blocks * n3}
    check(n_3 == want_n and all(math.isfinite(x) for x in l3), f"deterministic ml-3b: launched {n_3}, losses {l3}")
    det3_med = 1e3 * median(s3[RESEARCH_WARMUPS:])
    print(f"  {RESEARCH_PRESET} in float32, deterministic, {RESEARCH_WARMUPS} + {DET_ML3B_STEPS} steps: median "
          f"step {det3_med:.2f} ms against the research phase's {r_median:.2f} ms ({det3_med / r_median:.2f}x); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {n_3}")
    torch.use_deterministic_algorithms(True, warn_only=det_mode["warn_only"])
    try:
        profile("deterministic ml-3b research training step", lambda: t3.train_step(rbatch))
    finally:
        torch.use_deterministic_algorithms(False)
    del t3
    torch.cuda.empty_cache()
    small16 = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, compute_dtype="bfloat16"))
    # a small bfloat16 model twice, over its corpus' two batches: block 0 on
    # K7-det-bf16
    det_twice("small bfloat16 research model, deterministic", small16, sds, 2,
              {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 4, "K7": 0, "K6-bf16": 2,
               "K7-det": 4, "K7-det-bf16": 2})
    print("DET_RESULT " + json.dumps(total), flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(label: str, argv_of_rank, world: int) -> list:
    """Starts ``world`` ranks (``argv_of_rank(rank, port)``: arguments of
    ``chip_smoke.py rank``), each logging to ``tmp/dist/<label>_<rank>.log``,
    and waits for all: a rank that fails, or outlives ``DIST_TIMEOUT``, fails
    the run (the others are stopped first). Returns each rank's result."""
    port = free_port()
    logs = [os.path.join(DATA_ROOT, "dist", f"{label}_{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f_:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "rank",
                                           *argv_of_rank(r, port)], stdout=f_, stderr=subprocess.STDOUT))
    t0 = time.time()
    while any(p.poll() is None for p in procs):
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed or time.time() - t0 > DIST_TIMEOUT:
            for p in procs:
                p.kill()
                p.wait()
            r = failed[0] if failed else 0
            with open(logs[r]) as f_:
                tail = f_.read()[-3000:]
            fail(f"{label}: rank {r} " + ("failed" if failed else f"ran past {DIST_TIMEOUT} s") + f":\n{tail}")
        time.sleep(0.5)
    results = []
    for r, p in enumerate(procs):
        with open(logs[r]) as f_:
            text = f_.read()
        check(p.returncode == 0 and "RANK_RESULT " in text, f"{label}: rank {r} exited {p.returncode}:\n{text[-3000:]}")
        results.append(json.loads(text.split("RANK_RESULT ", 1)[1].splitlines()[0]))
    return results


def main() -> None:
    t_start = time.perf_counter()
    try:
        import numpy as np
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from generative_recommenders_tpu_torch.configs.dlrm import (
            get_embedding_table_config,
            get_hstu_configs,
        )
        from generative_recommenders_tpu_torch.configs.research import RESEARCH_PRESETS
        from generative_recommenders_tpu_torch.cli import (
            preprocess_dlrm_data,
            preprocess_public_data,
            train_ranker,
            train_research,
            warm_cache,
        )
        from generative_recommenders_tpu_torch.data.dataset import (
            MultiFileSequenceDataset,
            SequenceDataset,
            batch_iterator,
            synthetic_user_sequences,
            synthetic_user_sequences_vectorized,
        )
        from generative_recommenders_tpu_torch.data.dlrm_dataset import DLRMv3RandomDataset
        from generative_recommenders_tpu_torch.data.features import seq_features_from_row
        from generative_recommenders_tpu_torch.data.reco_dataset import get_reco_dataset
        from generative_recommenders_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
        from generative_recommenders_tpu_torch.indexing.candidate_index import CandidateIndex
        from generative_recommenders_tpu_torch.indexing.mol_top_k import MoLBruteForceTopK
        from generative_recommenders_tpu_torch.models.samplers import LocalNegativesSampler, maybe_l2_norm
        from generative_recommenders_tpu_torch.utils.bucketing import bucket_batch
        from generative_recommenders_tpu_torch.inference import main as serve
        from generative_recommenders_tpu_torch.inference.model_family import HSTUModelFamily
        from generative_recommenders_tpu_torch.models.hstu import HSTUEncoder
        from generative_recommenders_tpu_torch.modules import dynamic_stu
        from generative_recommenders_tpu_torch.modules import stu as stu_module
        from generative_recommenders_tpu_torch.modules.action_encoder import ActionEncoder, ContentEncoder
        from generative_recommenders_tpu_torch.modules.contextual_interleave_preprocessor import (
            ContextualInterleavePreprocessor,
        )
        from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTU
        from generative_recommenders_tpu_torch.ops import hstu_attention as jagged_attention
        from generative_recommenders_tpu_torch.ops import jagged
        from generative_recommenders_tpu_torch.ops.attention_mask import (
            apply_padding_guard,
            make_delta_attn_mask,
            make_valid_attn_mask,
        )
        from generative_recommenders_tpu_torch.ops.cuda import build
        from generative_recommenders_tpu_torch.data.dlrm_factory import make_dlrm_batches
        from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
            _bwd_kernel,
            delta_hstu_mha_cuda,
            delta_hstu_mha_plain,
            hstu_mha_bwd_cuda,
            hstu_mha_bwd_plain,
            hstu_mha_dense_cuda,
            hstu_mha_dense_plain,
        )
        from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import (
            hstu_mha_dense_relbias_cuda,
            hstu_mha_dense_relbias_plain,
            hstu_mha_relbias_bwd_cuda,
            hstu_mha_relbias_bwd_plain,
        )
        from generative_recommenders_tpu_torch.ops.hstu_compute import hstu_compute_uqvk
        from generative_recommenders_tpu_torch.train.dlrm_train import (
            DlrmTrainConfig,
            DlrmTrainer,
            to_device,
            train_loop,
        )
        from generative_recommenders_tpu_torch.models.sequential import ModelConfig
        from generative_recommenders_tpu_torch.train import train_loop as research
    except ImportError as e:
        fail(f"the port is not importable here: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------------- build
    # through the warm-up CLI: one nvcc per source, all started together
    t0 = time.perf_counter()
    warmed = warm_cache.warm(force=True)
    logs = {name: r["log"] for name, r in warmed.items()}
    print(f"kernel build (cli/warm_cache.py): {time.perf_counter() - t0:.1f} s for {len(logs)} kernels; each "
          f"kernel's nvcc: " + ", ".join(f"{name} {r['seconds']:.1f} s" for name, r in warmed.items()))
    check(all(r["built"] for r in warmed.values()) and not any(build._stale(name) for name in warmed),
          "the warm-up CLI left a kernel unbuilt or stale")
    for name, log in logs.items():
        # ptxas -v: per entry point (named by its function and its template
        # arguments: the padded width first, bf16 for a bfloat16 instance) its
        # registers and its spill stores / loads
        entries, entry = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                args = ",".join(a or b or "bf16" for a, b, c in re.findall(
                    r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)(?!Ex)", mangled))
                entry = f"{kernel_function(mangled)} {args}".strip()
                entries[entry] = ["?", ""]
            elif entry and "bytes spill stores" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
                entries[entry][1] = f", spill {stores} / {loads} bytes"
            elif entry and line.lstrip().startswith("ptxas info") and "registers" in line:
                entries[entry][0] = re.search(r"Used (\d+) registers", line).group(1)
        print(f"  {name}: " + "; ".join(f"<{k}> {r} registers{sp}" for k, (r, sp) in entries.items()))

    # -------------------------------------------------------- kernel phase
    cfg = get_hstu_configs("debug", max_uih_len=MAX_UIH, max_num_candidates=MAX_CANDS)
    C = sum(n for _, n in cfg.contextual_feature_to_max_length)
    H, D, V = cfg.hstu_num_heads, cfg.hstu_attn_qk_dim, cfg.hstu_attn_linear_dim
    norm = C + MAX_UIH + MAX_CANDS
    alpha = 1.0 / D**0.5
    ds = DLRMv3RandomDataset(cfg, hash_size=HASH_SIZE, batch_size=B, seed=0)
    _, ul_np, _, nc_np = ds.batch()
    ul = torch.as_tensor(ul_np, device="cuda")
    nc = torch.as_tensor(nc_np, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen) * 0.5

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), device="cuda", generator=gen, dtype=torch.int32)

    Dm = cfg.hstu_transducer_embedding_dim

    def uvqk_views(Bc, N):
        """q, k, v as the serving path gives them: strided views split from
        one [Bc, N, (2V + 2D) * H] projection by `hstu_compute_uqvk`."""
        width = (2 * V + 2 * D) * H
        _, q, k, v = hstu_compute_uqvk(
            rand(Bc, N, Dm), torch.ones(Dm, device="cuda"), torch.zeros(Dm, device="cuda"),
            rand(Dm, width) / Dm**0.5, rand(width), num_heads=H, attn_dim=D, hidden_dim=V,
        )
        check(all(t.stride(1) == width and not t.is_contiguous() for t in (q, k, v)),
              "the uvqk views are not strided as on the serving path")
        return q, k, v

    def compare(name, got, want, dead_rows=None, rel_tol=REL_TOL):
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = rel_tol * scale + 1e-7
        status = "ok" if err <= tol else "FAIL"
        print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e}, max|plain| {scale:.3e}) {status}")
        check(err <= tol, f"{name}: kernel disagrees with its plain version")
        if dead_rows is not None:
            check(bool((got[dead_rows] == 0).all()), f"{name}: rows >= length are not 0")
        return err

    def dense_case(name, Bc, N, lengths, nt=None, Dc=D, Vc=V, qkv=None, **kw):
        q, k, v = qkv or (rand(Bc, N, H, Dc), rand(Bc, N, H, Dc), rand(Bc, N, H, Vc))
        args = dict(alpha=1.0 / Dc**0.5, max_seq_len=kw.pop("max_seq_len", N), num_targets=nt, **kw)
        poison_allocator(Bc * N * H * Vc * 4)
        got = hstu_mha_dense_cuda(q, k, v, lengths, **args)
        want = hstu_mha_dense_plain(q, k, v, lengths, **args)
        torch.cuda.synchronize()
        # no atomics, key tiles summed in a fixed order: the deterministic
        # training phase needs the same bits on every run
        check(torch.equal(got, hstu_mha_dense_cuda(q, k, v, lengths, **args)),
              f"K1 {name}: two runs differ in their bits")
        dead = torch.arange(N, device="cuda")[None, :] >= lengths[:, None]
        return compare(f"K1 {name}", got, want, dead)

    def delta_case(name, Bc, M, Nc, cache_lengths, nt=None, Dc=D, Vc=V, qkv=None, **kw):
        N = Nc + M
        q, k, v = qkv or (rand(Bc, M, H, Dc), rand(Bc, N, H, Dc), rand(Bc, N, H, Vc))
        lengths = cache_lengths + M
        args = dict(alpha=1.0 / Dc**0.5, num_targets=nt, **kw)
        poison_allocator(Bc * M * H * Vc * 4)
        got = delta_hstu_mha_cuda(q, k, v, lengths, **args)
        want = delta_hstu_mha_plain(q, k, v, lengths, **args)
        torch.cuda.synchronize()
        # the chunks' partial sums are added in chunk order
        check(torch.equal(got, delta_hstu_mha_cuda(q, k, v, lengths, **args)),
              f"K5 {name}: two runs differ in their bits")
        return compare(f"K5 {name}", got, want)

    print("kernel phase (kernel vs plain, float32):")
    N_full = C + MAX_UIH + MAX_CANDS
    fwd_edges = torch.tensor([31, 32, 33, 63, 64, 65, 127, 128, 129], dtype=torch.int32, device="cuda")
    serve_len = (ul + nc + C).int()
    errs = {"K1": [], "K5": []}
    errs["K1"] += [
        dense_case("serving shape (predict), q/k/v split from the uvqk projection", B, N_full,
                   serve_len, nc, qkv=uvqk_views(B, N_full), max_seq_len=norm, contextual_seq_len=C),
        dense_case("serving shape (predict)", B, N_full, serve_len, nc,
                   max_seq_len=norm, contextual_seq_len=C),
        dense_case("serving shape (prefill)", B, C + MAX_UIH, (ul + C).int(), None,
                   max_seq_len=norm, contextual_seq_len=C),
        dense_case("length 1", 4, 70, torch.ones(4, dtype=torch.int32, device="cuda")),
        dense_case("full length", 3, 130, torch.full((3,), 130, dtype=torch.int32, device="cuda"),
                   ints(0, 20, 3), contextual_seq_len=C),
        dense_case("num_targets = 0", 4, 96, ints(3, 97, 4), torch.zeros(4, dtype=torch.int32, device="cuda"),
                   contextual_seq_len=C),
        dense_case("unaligned N, no targets", 5, 97, ints(1, 98, 5)),
        dense_case("contextual rows", 4, 75, ints(8, 76, 4), ints(0, 2, 4), contextual_seq_len=6),
        dense_case("max_attn_len window", 4, 150, ints(20, 151, 4), ints(0, 10, 4),
                   max_attn_len=16, min_full_attn_seq_len=8),
        dense_case("non-causal", 3, 66, ints(1, 67, 3), causal=False),
        dense_case("D=64, V=64", 3, 100, ints(1, 101, 3), ints(0, 5, 3), Dc=64, Vc=64,
                   contextual_seq_len=C),
        dense_case("D=40, V=16", 2, 45, ints(1, 46, 2), Dc=40, Vc=16),
        dense_case("D=32, V=32", 2, 45, ints(1, 46, 2), Dc=32, Vc=32),
        # the seams of the forward's tiling: key tiles of 32 columns, query
        # tiles of 64 rows (width 128) or 128 rows (widths 32 and 64, heads
        # in groups of 2)
        dense_case("lengths at the tile edges (31 .. 129), q/k/v split from the uvqk projection", 9, 140,
                   fwd_edges, ints(0, 20, 9).clamp(max=fwd_edges - C - 1), qkv=uvqk_views(9, 140),
                   contextual_seq_len=C),
        dense_case("D=V=32, H=3 (a head group H does not fill), lengths at the tile edges", 9, 140,
                   fwd_edges, Dc=32, Vc=32, qkv=(rand(9, 140, 3, 32), rand(9, 140, 3, 32), rand(9, 140, 3, 32))),
        dense_case("D=V=64, H=3, lengths at the tile edges", 9, 140, fwd_edges, ints(0, 9, 9), Dc=64, Vc=64,
                   qkv=(rand(9, 140, 3, 64), rand(9, 140, 3, 64), rand(9, 140, 3, 64))),
        dense_case("D=25, V=25 (scalar loads)", 3, 97, ints(1, 98, 3), Dc=25, Vc=25),
        dense_case("D=256, V=128 (the widest head)", 2, 80, ints(1, 81, 2), Dc=256, Vc=128),
    ]
    cache_len = (ul + C).int()
    m5 = torch.full((B,), CHUNK, dtype=torch.int32, device="cuda")
    errs["K5"] += [
        delta_case("serving shape (M=5), q/k/v split from the uvqk projection", B, CHUNK,
                   C + MAX_UIH, cache_len, m5,
                   qkv=(uvqk_views(B, CHUNK)[0], *uvqk_views(B, C + MAX_UIH + CHUNK)[1:]),
                   norm_len=norm, contextual_seq_len=C),
        delta_case("serving shape (M=5)", B, CHUNK, C + MAX_UIH, cache_len, m5,
                   norm_len=norm, contextual_seq_len=C),
        delta_case("M=160", B, MAX_CANDS, C + MAX_UIH, cache_len,
                   torch.full((B,), MAX_CANDS, dtype=torch.int32, device="cuda"),
                   norm_len=norm, contextual_seq_len=C),
        delta_case("cache shorter than M", 4, 5, 30, torch.tensor([0, 1, 3, 30], dtype=torch.int32, device="cuda"),
                   torch.full((4,), 5, dtype=torch.int32, device="cuda"), contextual_seq_len=C),
        delta_case("no targets", 4, 7, 61, ints(1, 62, 4)),
        delta_case("max_attn_len window", 4, 5, 140, ints(10, 141, 4),
                   torch.full((4,), 5, dtype=torch.int32, device="cuda"),
                   max_attn_len=16, min_full_attn_seq_len=8),
        delta_case("D=64, V=64", 3, 5, 50, ints(1, 51, 3), Dc=64, Vc=64, contextual_seq_len=C),
        # the seams of the chunked walk: 64 key columns and 8 query rows per block
        delta_case("lengths at the chunk edges (63, 64, 65, 127, 128, 129)", 6, 5, 195,
                   torch.tensor([58, 59, 60, 122, 123, 124], dtype=torch.int32, device="cuda"),
                   torch.full((6,), 5, dtype=torch.int32, device="cuda")),
        delta_case("an empty cache beside a full one", 2, 5, 195,
                   torch.tensor([0, 195], dtype=torch.int32, device="cuda"),
                   torch.full((2,), 5, dtype=torch.int32, device="cuda"), contextual_seq_len=C),
        delta_case("M=1", 4, 1, 130, torch.tensor([0, 63, 64, 130], dtype=torch.int32, device="cuda")),
        delta_case("M=17 (three row tiles)", 4, 17, 150, ints(0, 151, 4),
                   torch.full((4,), 17, dtype=torch.int32, device="cuda")),
        delta_case("D=40, V=40 (16-byte loads, padded tail)", 3, 5, 140, ints(0, 141, 3), Dc=40, Vc=40),
        delta_case("D=25, V=25 (scalar loads)", 3, 5, 140, ints(0, 141, 3), Dc=25, Vc=25),
    ]

    # times and bounds at the serving shapes, on strided views as served
    q, k, v = uvqk_views(B, N_full)
    k1_args = dict(alpha=alpha, max_seq_len=norm, num_targets=nc, contextual_seq_len=C)
    k1_ms = device_time_ms(lambda: hstu_mha_dense_cuda(q, k, v, serve_len, **k1_args), 50)
    k1_plain_ms = device_time_ms(lambda: hstu_mha_dense_plain(q, k, v, serve_len, **k1_args), 5)
    live = apply_padding_guard(
        make_valid_attn_mask(N_full, serve_len, num_targets=nc, contextual_seq_len=C), serve_len
    ).sum().item()
    k1_flops = live * H * 2 * (D + V)
    k1_bytes = 4 * (serve_len.sum().item() * H * (2 * D + V) + B * N_full * H * V + B * 2)

    Nd = C + MAX_UIH + CHUNK
    # M-FALCON pads the cache, so its k and v are contiguous; q is a view
    dq, dk, dv = uvqk_views(B, CHUNK)[0], rand(B, Nd, H, D), rand(B, Nd, H, V)
    d_len = (cache_len + CHUNK).int()
    k5_args = dict(alpha=alpha, num_targets=m5, contextual_seq_len=C, norm_len=norm)
    k5_ms = device_time_ms(lambda: delta_hstu_mha_cuda(dq, dk, dv, d_len, **k5_args), 200)
    k5_plain_ms = device_time_ms(lambda: delta_hstu_mha_plain(dq, dk, dv, d_len, **k5_args), 20)
    rows = (d_len.long()[:, None] - CHUNK + torch.arange(CHUNK, device="cuda")[None, :]).clamp(0, Nd - 1)
    live5 = make_delta_attn_mask(Nd, d_len, rows, num_targets=m5, contextual_seq_len=C).sum().item()
    k5_flops = live5 * H * 2 * (D + V)
    k5_bytes = 4 * (B * CHUNK * H * D + d_len.sum().item() * H * (D + V) + B * CHUNK * H * V + B * 2)
    torch.cuda.synchronize()

    # ------------------------------------------------ backward kernel phase
    def bwd_case(name, Bc, N, lengths, nt=None, Dc=D, Vc=V, qkv=None, **kw):
        """K2, and K3 + K4, against the plain backward; dO is not contiguous
        (a transposed buffer), as the gradient of a reshape may be. dk and dv
        are summed without atomics (K2's dq with them), and so is K3's dq:
        the same bits on a second run."""
        q, k, v = qkv or (rand(Bc, N, H, Dc), rand(Bc, N, H, Dc), rand(Bc, N, H, Vc))
        do = rand(N, Bc, H, Vc).transpose(0, 1)
        args = dict(alpha=1.0 / Dc**0.5, max_seq_len=kw.pop("max_seq_len", N), num_targets=nt, **kw)
        want = hstu_mha_bwd_plain(q, k, v, lengths, do, **args)
        dead = torch.arange(N, device="cuda")[None, :] >= lengths[:, None]
        errs_k = {}
        for kname, run in (
            ("K2", lambda: hstu_mha_bwd_cuda(q, k, v, lengths, do, **args)),
            ("K3+K4", lambda: hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **args)),
        ):
            poison_allocator(3 * Bc * N * H * max(Dc, Vc) * 4)
            got = run()
            torch.cuda.synchronize()
            again = run()
            check(torch.equal(got[1], again[1]) and torch.equal(got[2], again[2]),
                  f"{kname} {name}: dk or dv differ between two runs")
            check(kname == "K2" or torch.equal(got[0], again[0]), f"K3 {name}: dq differs between two runs")
            del again
            errs_k[kname] = [compare(f"{kname} {name} {g}", a, w, dead)
                             for g, a, w in zip(("dq", "dk", "dv"), got, want)]
        return errs_k

    print("backward kernel phase (K2 and K3 + K4 vs the plain backward, float32):")
    tcfg = get_hstu_configs("debug", max_uih_len=TRAIN_UIH, max_num_candidates=TRAIN_CANDS)
    det_cfg = dataclasses.replace(
        get_hstu_configs("debug", max_uih_len=DET_UIH, max_num_candidates=TRAIN_CANDS),
        hstu_attn_num_layers=1,
    )

    def train_shape(cfg_, seed):
        """N, lengths and num_targets of one training batch of ``cfg_``."""
        _, ul_, _, nc_ = DLRMv3RandomDataset(cfg_, hash_size=HASH_SIZE, batch_size=B, seed=seed).batch()
        lens = torch.as_tensor(ul_ + nc_ + C, device="cuda", dtype=torch.int32)
        return C + cfg_.max_uih_len + cfg_.max_num_candidates, lens, torch.as_tensor(nc_, device="cuda")

    N_tr, tr_len, tr_nt = train_shape(tcfg, 0)
    N_det, det_len, det_nt = train_shape(det_cfg, 0)
    bwd_errs = {"K2": [], "K3+K4": []}
    ones = lambda n: torch.ones(n, dtype=torch.int32, device="cuda")  # noqa: E731
    dq_edges = torch.tensor([63, 64, 65, 95, 96, 97, 127, 128, 129, 191, 192, 193], dtype=torch.int32, device="cuda")
    for case in (
        bwd_case(f"training shape (N={N_tr}), q/k/v split from the uvqk projection", B, N_tr,
                 tr_len, tr_nt, qkv=uvqk_views(B, N_tr), contextual_seq_len=C),
        bwd_case(f"uih {DET_UIH} (N={N_det}), q/k/v split from the uvqk projection", B, N_det,
                 det_len, det_nt, qkv=uvqk_views(B, N_det), contextual_seq_len=C),
        bwd_case("length 1", 4, 70, ones(4)),
        bwd_case("full length", 3, 130, torch.full((3,), 130, dtype=torch.int32, device="cuda"),
                 ints(0, 20, 3), contextual_seq_len=C),
        bwd_case("num_targets = 0", 4, 96, ints(3, 97, 4), 0 * ones(4), contextual_seq_len=C),
        bwd_case("unaligned N, no targets", 5, 97, ints(1, 98, 5)),
        bwd_case("max_attn_len window", 4, 150, ints(20, 151, 4), ints(0, 10, 4),
                 max_attn_len=16, min_full_attn_seq_len=8),
        bwd_case("non-causal", 3, 66, ints(1, 67, 3), causal=False),
        bwd_case("D=64, V=64", 3, 100, ints(1, 101, 3), ints(0, 5, 3), Dc=64, Vc=64,
                 contextual_seq_len=C),
        bwd_case("D=40, V=16", 2, 45, ints(1, 46, 2), Dc=40, Vc=16),
        bwd_case("D=32, V=32", 2, 45, ints(1, 46, 2), Dc=32, Vc=32),
        # the seams of K2's and K4's tiling: 64-column key tiles, query tiles
        # of 32 rows (widths 128 and 256) or 64 (widths 32 and 64)
        bwd_case("lengths at the tile edges (31 .. 129), q/k/v split from the uvqk projection", 9, 140,
                 fwd_edges, ints(0, 20, 9).clamp(max=fwd_edges - C - 1), qkv=uvqk_views(9, 140),
                 contextual_seq_len=C),
        bwd_case("D=200, V=96 (width 256)", 3, 150, ints(1, 151, 3), ints(0, 5, 3), Dc=200, Vc=96,
                 contextual_seq_len=C),
        bwd_case("a row of length 0 beside live rows", 4, 100,
                 torch.tensor([0, 100, 0, 37], dtype=torch.int32, device="cuda")),
        bwd_case("contextual rows past a query tile (40)", 3, 200, ints(41, 201, 3), ints(0, 5, 3),
                 contextual_seq_len=40),
        # the seams of K3's tiling: query tiles of 64 rows, key tiles of 64
        # columns (32 at width 256)
        bwd_case("lengths at K3's tile edges (63 .. 193), q/k/v split from the uvqk projection", 12, 200,
                 dq_edges, ints(0, 20, 12).clamp(max=dq_edges - C - 1), qkv=uvqk_views(12, 200),
                 contextual_seq_len=C),
        bwd_case("window with full-attention rows, lengths at K3's tile edges", 12, 200, dq_edges,
                 ints(0, 20, 12).clamp(max=dq_edges - C - 1), max_attn_len=40, min_full_attn_seq_len=24,
                 contextual_seq_len=C),
        bwd_case("D=25, V=25 (scalar loads), contextual rows past K3's query tile (70)", 3, 200,
                 torch.tensor([200, 71, 129], dtype=torch.int32, device="cuda"),
                 torch.tensor([3, 0, 2], dtype=torch.int32, device="cuda"), Dc=25, Vc=25,
                 contextual_seq_len=70),
    ):
        for kname, e in case.items():
            bwd_errs[kname] += e
    # the dynamic-STU ranker's L2 window (layers 1 and 2 of the training
    # batch): w = min(L2_LEN, N) rows, lengths clip(len - C, 0, w), the
    # batch's targets, no contextual rows, and the full sequence's silu
    # normaliser (max_seq_len N > w)
    w_l2 = min(L2_LEN, N_tr)
    l2_len = (tr_len - C).clamp(0, w_l2)
    l2_name = f"L2 window (w={w_l2} of N={N_tr}, normaliser {N_tr}), q/k/v split from the uvqk projection"
    errs["K1"].append(dense_case(l2_name, B, w_l2, l2_len, tr_nt, qkv=uvqk_views(B, w_l2), max_seq_len=N_tr))
    for kname, e in bwd_case(l2_name, B, w_l2, l2_len, tr_nt, qkv=uvqk_views(B, w_l2), max_seq_len=N_tr).items():
        bwd_errs[kname] += e

    def bwd_timing(N, lens, nt):
        """Device ms of K2, K3, K4 and the plain backward at one training
        shape on the uvqk views, and the work the backward needs there."""
        q, k, v = uvqk_views(B, N)
        do = rand(N, B, H, V).transpose(0, 1)
        a = dict(alpha=alpha, max_seq_len=N, num_targets=nt, contextual_seq_len=C)
        # K3 and K4 are timed one at a time, on the arguments the wrapper
        # passes them
        one = dict(alpha=alpha, max_seq_len=N, causal=True, max_attn_len=0,
                   contextual_seq_len=C, min_full_attn_seq_len=0)
        nt_c = nt.int()
        ms = {
            "K2": device_time_ms(lambda: hstu_mha_bwd_cuda(q, k, v, lens, do, **a), 20),
            "K3": device_time_ms(lambda: _bwd_kernel("hstu_mha_bwd_dq", q, k, v, lens, nt_c, do, one), 20),
            "K4": device_time_ms(lambda: _bwd_kernel("hstu_mha_bwd_dkv", q, k, v, lens, nt_c, do, one), 20),
            "plain": device_time_ms(lambda: hstu_mha_bwd_plain(q, k, v, lens, do, **a), 3),
        }
        live_ = apply_padding_guard(
            make_valid_attn_mask(N, lens, num_targets=nt, contextual_seq_len=C), lens
        ).sum().item()
        rows_in = 4 * lens.sum().item() * H * (2 * D + 2 * V) + 4 * B * 2  # q, k, v, dO, lengths, targets
        work = {  # (flops, bytes): each input read once, each output written once
            "K2": (live_ * H * 2 * (3 * D + 2 * V), rows_in + 4 * B * N * H * (2 * D + V)),
            "K3": (live_ * H * 2 * (2 * D + V), rows_in + 4 * B * N * H * D),
            "K4": (live_ * H * 2 * (2 * D + 2 * V), rows_in + 4 * B * N * H * (D + V)),
        }
        print(f"  N={N}: K2 {ms['K2']:.4f} ms, K3 {ms['K3']:.4f} ms, K4 {ms['K4']:.4f} ms, "
              f"plain backward {ms['plain']:.4f} ms; {live_} live mask elements per head")
        return ms, work

    bwd_tr = bwd_timing(N_tr, tr_len, tr_nt)
    bwd_det = bwd_timing(N_det, det_len, det_nt)
    # K2 where the deterministic phase would run it, beside K4 (the report
    # line holds K2 at the training shape), and K3 where it runs
    for kname in ("K2", "K3"):
        t_ops, t_bytes = (x / r * 1e3 for x, r in zip(bwd_det[1][kname], (PEAK_3XTF32_FLOPS, PEAK_BYTES_PER_S)))
        print(f"  {kname} at N={N_det}: {bwd_det[0][kname]:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
              f"(operations {t_ops:.4f} at 3xTF32, bytes {t_bytes:.4f}), "
              f"{max(t_ops, t_bytes) / bwd_det[0][kname]:.1%} of the bound's rate")
    # K1 where the ranker's training launches it, beside the serving shape
    for N_, lens_, nt_ in ((N_tr, tr_len, tr_nt), (N_det, det_len, det_nt)):
        q_, k_, v_ = uvqk_views(B, N_)
        a_ = dict(alpha=alpha, max_seq_len=N_, num_targets=nt_, contextual_seq_len=C)
        ms_ = device_time_ms(lambda: hstu_mha_dense_cuda(q_, k_, v_, lens_, **a_), 50)
        plain_ = device_time_ms(lambda: hstu_mha_dense_plain(q_, k_, v_, lens_, **a_), 5)
        live_ = apply_padding_guard(
            make_valid_attn_mask(N_, lens_, num_targets=nt_, contextual_seq_len=C), lens_).sum().item()
        t_ops = live_ * H * 2 * (D + V) / PEAK_3XTF32_FLOPS * 1e3
        t_bytes = 4 * (lens_.sum().item() * H * (2 * D + V) + B * N_ * H * V + B * 2) / PEAK_BYTES_PER_S * 1e3
        print(f"  K1 at N={N_}: {ms_:.4f} ms (plain {plain_:.4f}), bound {max(t_ops, t_bytes):.4f} ms "
              f"(operations {t_ops:.4f} at 3xTF32, bytes {t_bytes:.4f})")
    del q_, k_, v_  # views of a 271 MB projection at N = 1036: not alive into the research phase
    torch.cuda.synchronize()


    # ------------------------------------- relative-bias kernel phase (K6, K7)
    rcfg = RESEARCH_PRESETS[RESEARCH_PRESET]
    rm = rcfg.model
    RB, RN, RH, RD, RV = rcfg.local_batch_size, rm.total_seq_len, rm.num_heads, rm.dqk, rm.dv
    print(
        f"research corpus: synthetic_user_sequences_vectorized, {RESEARCH_USERS} users, "
        f"{rm.num_items:,} items, lengths up to {rm.max_sequence_len + 1}, seed 0"
    )
    t0 = time.perf_counter()
    seqs = synthetic_user_sequences_vectorized(
        num_users=RESEARCH_USERS, num_items=rm.num_items, max_len=rm.max_sequence_len + 1, seed=0
    )
    research_train = SequenceDataset(seqs, rm.max_sequence_len, ignore_last_n=1)
    print(f"  made in {time.perf_counter() - t0:.1f} s")
    # the same corpus as the sharded files of a fractal expansion, read as the
    # registry reads ML-3B: 0-based ids shifted by one, timestamps = item ids
    shard_dir = os.path.join(DATA_ROOT, "ml-3b")
    shutil.rmtree(shard_dir, ignore_errors=True)
    os.makedirs(shard_dir)
    t0 = time.perf_counter()
    write_ml3b_shards(os.path.join(shard_dir, "16x32"), seqs, ML3B_SHARDS)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    reco = get_reco_dataset("ml-3b", rm.max_sequence_len, data_root=DATA_ROOT)
    t_open = time.perf_counter() - t0
    shard_train, shard_eval = reco.train_dataset, reco.eval_dataset
    check(shard_train._native is not None and len(shard_train) == RESEARCH_USERS,
          "the registry's ml-3b is not read through the native reader")
    py_train = MultiFileSequenceDataset(os.path.join(shard_dir, "16x32"), rm.max_sequence_len, ignore_last_n=1,
                                        shift_id_by=1, num_items_hint=rm.num_items, native=False)
    sample = range(0, RESEARCH_USERS, RESEARCH_USERS // SHARD_CHECK_ROWS)
    read_s = {}
    for name_, ds_ in (("native", shard_train), ("python", py_train)):
        t0 = time.perf_counter()
        rows_ = [ds_.get_row(i) for i in range(RESEARCH_USERS)]
        read_s[name_] = time.perf_counter() - t0
        if name_ == "native":
            native_rows = rows_
    for i in sample:
        a, b, m = native_rows[i], py_train.get_row(i), research_train.get_row(i)
        check(all(np.array_equal(a[k], b[k]) for k in a), f"shard row {i}: native and Python paths differ")
        check(all(np.array_equal(a[k], m[k]) for k in ("user_id", "historical_ids", "historical_ratings",
                                                         "history_lengths", "target_ids", "target_ratings")),
              f"shard row {i} differs from the in-memory row")
        check(np.array_equal(a["historical_timestamps"], a["historical_ids"]), f"shard row {i}: timestamps")
    print(
        f"  as {ML3B_SHARDS} shards of a fractal-expansion corpus ({DATA_ROOT}/ml-3b/16x32_*.csv, 0-based ids): "
        f"written in {t_write:.2f} s, opened through get_reco_dataset('ml-3b') in {t_open:.3f} s; "
        f"{len(sample)} rows equal on the native reader, the Python path and in memory; all "
        f"{RESEARCH_USERS} rows read natively at {RESEARCH_USERS / read_s['native']:.0f} rows/s, "
        f"by Python at {RESEARCH_USERS / read_s['python']:.0f} rows/s (one thread, this host)"
    )
    del native_rows, rows_, py_train

    def relbias_views(Bc, N, Hc, Dc, Vc, dtype=torch.float32):
        """q, k, v as the research STU gives them: views of the split of one
        [Bc, N, (2V + 2D) * H] projection (u, v, q, k) of ``dtype``, never
        copied."""
        proj = rand(Bc, N, Hc * (2 * Vc + 2 * Dc)).to(dtype)
        _, v, q, k = torch.split(proj, [Hc * Vc, Hc * Vc, Hc * Dc, Hc * Dc], dim=-1)
        return q.reshape(Bc, N, Hc, Dc), k.reshape(Bc, N, Hc, Dc), v.reshape(Bc, N, Hc, Vc)

    def dataset_batch(Bc, max_len, gr, seed):
        """(lengths, timestamps [Bc, max_len + gr + 1]) of one training batch
        as the trainer's features hold them: the target's timestamp sits at
        index ``length``, past the history, and zeros follow it."""
        ds_ = research_train if max_len == rm.max_sequence_len else SequenceDataset(
            seqs, max_len, ignore_last_n=1)
        row = next(batch_iterator(ds_, Bc, shuffle=True, seed=seed))
        f, _, _ = seq_features_from_row(
            {k_: torch.as_tensor(v_, device="cuda") for k_, v_ in row.items()}, gr + 1)
        return f.past_lengths.int(), f.past_payloads["timestamps"]

    def random_ts(Bc, N, lengths, step_hi=86400):
        """Sorted unix-like timestamps; the one at index ``length`` is kept
        (the target's), those after it are 0 as the padding is."""
        steps = torch.randint(1, step_hi, (Bc, N), device="cuda", generator=gen)
        ts = 1_500_000_000 + torch.cumsum(steps, dim=1)
        return ts * (torch.arange(N, device="cuda")[None, :] <= lengths[:, None])

    def bias_tables(Nm, nb):
        return rand(2 * Nm - 1) * 0.1, rand(nb + 1) * 0.1

    rel_errs = {"K6": [], "K7": []}

    def relbias_case(name, Bc, N, lengths, ts, Nm=None, nb=128, nt=None, Hc=2, Dc=RD, Vc=RV,
                     f64=False, **kw):
        """K6 against the plain forward, K7 against the plain backward, on
        uvqk views and a non-contiguous dO; dead rows exactly 0."""
        q, k, v = relbias_views(Bc, N, Hc, Dc, Vc)
        pos_w, ts_w = bias_tables(Nm or N, nb)
        do = rand(N, Bc, Hc, Vc).transpose(0, 1)
        # the research STU's scales: alpha 1, the runtime N as the normaliser
        args = dict(alpha=1.0, max_seq_len=N, num_buckets=nb, num_targets=nt, **kw)
        dead = torch.arange(N, device="cuda")[None, :] >= lengths[:, None]
        poison_allocator(Bc * N * Hc * Vc * 4)
        got = hstu_mha_dense_relbias_cuda(q, k, v, lengths, ts, pos_w, ts_w, **args)
        want = hstu_mha_dense_relbias_plain(q, k, v, lengths, ts, pos_w, ts_w, **args)
        torch.cuda.synchronize()
        rel_errs["K6"].append(compare(f"K6 {name}", got, want, dead))
        del got, want
        poison_allocator(3 * Bc * N * Hc * max(Dc, Vc) * 4)
        grads = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, do, **args)
        torch.cuda.synchronize()
        # dk and dv are summed without atomics (dq and the tables with them)
        again = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, do, **args)
        check(torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2]),
              f"K7 {name}: dk or dv differ between two runs")
        del again
        wants = hstu_mha_relbias_bwd_plain(q, k, v, lengths, ts, pos_w, ts_w, do, **args)
        for g, a, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), grads, wants):
            table = g in ("dpos_w", "dts_w")
            rel_errs["K7"].append(compare(f"K7 {name} {g}", a, w, None if table else dead,
                                          rel_tol=TABLE_TOL if table else REL_TOL))
        if f64:
            # what the tolerance of the table gradients rests on: both float32
            # results against a float64 run of the plain backward
            d = lambda t: t.double()  # noqa: E731
            w64 = hstu_mha_relbias_bwd_plain(d(q), d(k), d(v), lengths, ts, d(pos_w), d(ts_w), d(do), **args)
            for g, a, w, w8 in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), grads, wants, w64):
                m = w8.abs().max().item()
                print(f"    {g} vs float64 plain, of its max {m:.3e}: kernel "
                      f"{(a - w8).abs().max().item() / m:.3e}, float32 plain {(w - w8).abs().max().item() / m:.3e}")
        return q, k, v, pos_w, ts_w, do, args

    print("relative-bias kernel phase (K6 vs the plain forward, K7 vs the plain backward, float32):")
    r_len, r_ts = dataset_batch(RB, rm.max_sequence_len, rm.gr_output_length, 0)
    check(tuple(r_ts.shape) == (RB, RN), f"research timestamps have shape {tuple(r_ts.shape)}")
    past = r_ts[torch.arange(RB, device="cuda"), r_len.long()]
    check(bool((past > 1_000_000_000).all()), "the target's timestamp is not past the length")
    slice_case = relbias_case(
        f"research shape (B={RB}, N={RN}, H={RH}, D=V={RD}), lengths and timestamps of a corpus batch",
        RB, RN, r_len, r_ts, Hc=RH, f64=True)
    m20 = RESEARCH_PRESETS[BUCKET_PRESET]
    m_len, m_ts = dataset_batch(m20.local_batch_size, m20.model.max_sequence_len, m20.model.gr_output_length, 1)
    m20_case = relbias_case(f"ml-20m shape (B={m20.local_batch_size}, N={m20.model.total_seq_len})",
                            m20.local_batch_size, m20.model.total_seq_len, m_len, m_ts, Hc=m20.model.num_heads)
    # the same preset under length buckets and stochastic length (the bucketed
    # phase below): the runtime width N below the position table's Nm = 211.
    # Its corpus has histories of 4..119 events, so that a batch of 128 takes
    # the 128 bucket (N = 128 + 11 = 139); with histories up to 200 a batch
    # almost always spans the full width and the buckets would never cut
    mB, mm = m20.local_batch_size, m20.model
    Nm20 = mm.total_seq_len
    print(
        f"bucketed corpus: synthetic_user_sequences_vectorized, {BUCKET_USERS} users, {mm.num_items:,} items, "
        f"lengths 5..{BUCKET_MAX_LEN}, seed 1"
    )
    bseqs = synthetic_user_sequences_vectorized(
        num_users=BUCKET_USERS, num_items=mm.num_items, max_len=BUCKET_MAX_LEN, seed=1
    )
    bucket_train = SequenceDataset(bseqs, mm.max_sequence_len, ignore_last_n=1)
    brow = bucket_batch(next(batch_iterator(bucket_train, mB, shuffle=True, seed=2)), LENGTH_BUCKETS)
    bf, _, _ = seq_features_from_row(
        {k_: torch.as_tensor(v_, device="cuda") for k_, v_ in brow.items()}, mm.gr_output_length + 1)
    b_len, b_ts = bf.past_lengths.int(), bf.past_payloads["timestamps"]
    N139 = b_ts.shape[1]
    bucket_w = min(w for w in LENGTH_BUCKETS if w >= BUCKET_MAX_LEN - 1)
    check(N139 == bucket_w + mm.gr_output_length + 1, f"a corpus batch took width {N139}, not the {bucket_w} bucket's")
    b139_case = relbias_case(f"ml-20m under buckets (B={mB}, N={N139}, Nm={Nm20}, H={mm.num_heads}), a corpus batch",
                             mB, N139, b_len, b_ts, Nm=Nm20, Hc=mm.num_heads)
    N75 = LENGTH_BUCKETS[0] + mm.gr_output_length + 1
    l75 = ints(1, LENGTH_BUCKETS[0] + 1, mB)
    relbias_case(f"ml-20m under buckets (B={mB}, N={N75}, Nm={Nm20}, H={mm.num_heads})", mB, N75, l75,
                 random_ts(mB, N75, l75), Nm=Nm20, Hc=mm.num_heads)
    full = lambda n, x: torch.full((n,), x, dtype=torch.int32, device="cuda")  # noqa: E731
    l4 = ints(3, 97, 4)
    relbias_case("length 1", 4, 70, full(4, 1), random_ts(4, 70, full(4, 1)))
    relbias_case("full length", 3, 130, full(3, 130), random_ts(3, 130, full(3, 130)))
    relbias_case("num_targets", 4, 96, l4, random_ts(4, 96, l4), nt=torch.minimum(ints(0, 6, 4), l4 - 1))
    l150 = ints(20, 151, 4)
    relbias_case("max_attn_len window", 4, 150, l150, random_ts(4, 150, l150), nt=ints(0, 10, 4),
                 max_attn_len=37, min_full_attn_seq_len=16)
    l66 = ints(1, 67, 3)
    relbias_case("non-causal", 3, 66, l66, random_ts(3, 66, l66), causal=False)
    l97 = ints(1, 98, 5)
    relbias_case("unaligned N, 40 buckets, Nm > N", 5, 97, l97, random_ts(5, 97, l97), Nm=200, nb=40)
    l45 = ints(2, 46, 3)
    relbias_case("equal timestamps (every |dt| < 1)", 3, 45, l45,
                 torch.full((3, 45), 1_500_000_000, dtype=torch.int64, device="cuda"))
    relbias_case("steps of seconds (low buckets)", 3, 45, l45, random_ts(3, 45, l45, step_hi=4))
    relbias_case("D=V=25 (the ml-1m preset's heads), float timestamps", 2, 211, ints(1, 212, 2),
                 random_ts(2, 211, full(2, 211)).float(), Dc=25, Vc=25)
    # the seams of K7's tiling: 64 x 64 tile pairs, groups of 4 (or 2) heads
    edges = torch.tensor([63, 64, 65, 127, 128, 129], dtype=torch.int32, device="cuda")
    relbias_case("lengths at the tile edges (63 .. 129)", 6, 140, edges, random_ts(6, 140, edges))
    # the forward's seams: key tiles of 32 columns, groups of 2 heads
    relbias_case("D=V=64, H=3, lengths at the forward's key tiles (31 .. 129)", 9, 140, fwd_edges,
                 random_ts(9, 140, fwd_edges), Hc=3, Dc=64, Vc=64)
    l140 = ints(1, 141, 3)
    for heads in (1, 3, 8):
        relbias_case(f"H={heads}", 3, 140, l140, random_ts(3, 140, l140), Hc=heads)
    relbias_case("D=V=50, H=1 (the ml-1m preset's one head: width 64)", 2, 211, ints(1, 212, 2),
                 random_ts(2, 211, full(2, 211)), Hc=1, Dc=50, Vc=50)
    relbias_case("N > Nm (clipped diagonals)", 3, 140, l140, random_ts(3, 140, l140), Nm=100)
    relbias_case("num_targets with contextual rows", 4, 96, l4, random_ts(4, 96, l4),
                 nt=torch.minimum(ints(0, 6, 4), l4 - 1), contextual_seq_len=3)

    # times and bounds at the research shape, on the views and the strided dO
    q, k, v, pos_w, ts_w, do, r_args = slice_case
    k6_ms = device_time_ms(lambda: hstu_mha_dense_relbias_cuda(q, k, v, r_len, r_ts, pos_w, ts_w, **r_args), 20)
    k7_ms = device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(q, k, v, r_len, r_ts, pos_w, ts_w, do, **r_args), 10)
    k6_plain_ms = device_time_ms(
        lambda: hstu_mha_dense_relbias_plain(q, k, v, r_len, r_ts, pos_w, ts_w, **r_args), 3)
    k7_plain_ms = device_time_ms(
        lambda: hstu_mha_relbias_bwd_plain(q, k, v, r_len, r_ts, pos_w, ts_w, do, **r_args), 2)
    # what the bias costs: the kernels without it (K1, K2) on the same inputs
    nobias = dict(alpha=1.0, max_seq_len=RN)
    k1_same_ms = device_time_ms(lambda: hstu_mha_dense_cuda(q, k, v, r_len, **nobias), 20)
    k2_same_ms = device_time_ms(lambda: hstu_mha_bwd_cuda(q, k, v, r_len, do, **nobias), 10)
    live_r = apply_padding_guard(make_valid_attn_mask(RN, r_len), r_len).sum().item()
    rows_r = r_len.sum().item() * RH
    small_in = 4 * (RB * RN + pos_w.numel() + ts_w.numel() + RB)  # timestamps, tables, lengths
    k6_work = (live_r * RH * 2 * (RD + RV), 4 * (rows_r * (2 * RD + RV) + RB * RN * RH * RV) + small_in)
    k7_work = (live_r * RH * 2 * (3 * RD + 2 * RV),
               4 * (rows_r * (2 * RD + 2 * RV) + RB * RN * RH * (2 * RD + RV) + pos_w.numel() + ts_w.numel())
               + small_in)
    print(
        f"  research shape: K6 {k6_ms:.4f} ms (plain {k6_plain_ms:.4f}), K7 {k7_ms:.4f} ms (plain "
        f"{k7_plain_ms:.4f}); {live_r} live mask elements per head, mean length {r_len.float().mean().item():.1f}. "
        f"Outside the bound's count, the bias adds per live element one logf, two table reads from shared "
        f"memory and about ten float32 operations: K6 once per group of 2 heads, K7 once per group of 4, "
        f"which sums dS over the group before the table sums. Without the bias, on the same inputs: K1 "
        f"{k1_same_ms:.4f} ms, K2 {k2_same_ms:.4f} ms"
    )
    # K6 and K7 at N = 139 (the 128 bucket) against N = 211 (the full width),
    # ml-20m large preset, on a corpus batch of each width
    bucket_ms = {}
    for N_, (case, lens_, ts_) in ((Nm20, (m20_case, m_len, m_ts)), (N139, (b139_case, b_len, b_ts))):
        q_, k_, v_, pw_, tw_, do_, a_ = case
        bucket_ms[N_] = (
            device_time_ms(lambda: hstu_mha_dense_relbias_cuda(q_, k_, v_, lens_, ts_, pw_, tw_, **a_), 20),
            device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(q_, k_, v_, lens_, ts_, pw_, tw_, do_, **a_), 10),
        )
        print(f"  ml-20m large preset at N={N_} (Nm={Nm20}, B={mB}, H={mm.num_heads}, mean length "
              f"{lens_.float().mean().item():.1f}): K6 {bucket_ms[N_][0]:.4f} ms, K7 {bucket_ms[N_][1]:.4f} ms")

    # K7-det: the same function summed in one fixed order (the dq pass on
    # K3's body with the bias; K7's body without dq, each block's table sums
    # to its own row of a partial buffer; the rows added in block order)
    det_errs = {"K7-det": [], "K7-det-bf16": []}

    def det_case(name, Bc, N, lengths, ts, Nm=None, nb=128, nt=None, Hc=2, Dc=RD, Vc=RV, bf16=False,
                 qkv=None, **kw):
        """K7-det (bfloat16: K7-det-bf16, alpha 1) against the plain backward
        on uvqk views and a strided dO: every output, the tables included, the
        same bits on a second run; dead rows exactly 0."""
        label = "K7-det-bf16" if bf16 else "K7-det"
        dtype = torch.bfloat16 if bf16 else torch.float32
        q, k, v = qkv or relbias_views(Bc, N, Hc, Dc, Vc, dtype)
        pos_w, ts_w = bias_tables(Nm or N, nb)
        do = rand(N, Bc, Hc, Vc).to(dtype).transpose(0, 1)
        args = dict(alpha=1.0, max_seq_len=N, num_buckets=nb, num_targets=nt, **kw)
        dead = torch.arange(N, device="cuda")[None, :] >= lengths[:, None]
        poison_allocator(3 * Bc * N * Hc * max(Dc, Vc) * 4)
        grads = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, do, deterministic=True, **args)
        again = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, do, deterministic=True, **args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(grads, again)), f"{label} {name}: an output differs between two runs")
        del again
        wants = hstu_mha_relbias_bwd_plain(q, k, v, lengths, ts, pos_w, ts_w, do, **args)
        for g, a, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), grads, wants):
            table = g in ("dpos_w", "dts_w")
            check(a.dtype == w.dtype, f"{label} {name} {g}: type {a.dtype}, plain {w.dtype}")
            tol = (DET_BF16_TABLE_TOL if table else BF16_TOL) if bf16 else REL_TOL
            det_errs[label].append(compare(f"{label} {name} {g}", a.float(), w.float(), None if table else dead,
                                           rel_tol=tol))
        return q, k, v, pos_w, ts_w, do, args

    print(f"K7-det, the fixed-order relative-bias backward, vs the plain backward (float32, {REL_TOL} of each "
          "output's max, the tables included; every output the same bits twice):")
    det_case(f"research shape (B={RB}, N={RN}, H={RH}, D=V={RD}) on the research case's q, k, v", RB, RN, r_len,
             r_ts, Hc=RH, qkv=slice_case[:3])
    det_case("lengths at the tile edges (63 .. 129)", 6, 140, edges, random_ts(6, 140, edges))
    for heads in (3, 5):  # groups of 4 heads: one group unfilled, and one whole with one unfilled
        det_case(f"H={heads}, a head group unfilled", 3, 140, l140, random_ts(3, 140, l140), Hc=heads)
    det_case("D=V=50, H=3 (width 64: groups of 2 heads)", 2, 211, ints(1, 212, 2),
             random_ts(2, 211, full(2, 211)), Hc=3, Dc=50, Vc=50)
    det_case("N > Nm (clipped diagonals summed in order)", 3, 140, l140, random_ts(3, 140, l140), Nm=100)
    det_case("num_targets with contextual rows", 4, 96, l4, random_ts(4, 96, l4),
             nt=torch.minimum(ints(0, 6, 4), l4 - 1), contextual_seq_len=3)
    det_case("max_attn_len window", 4, 150, l150, random_ts(4, 150, l150), nt=ints(0, 10, 4),
             max_attn_len=37, min_full_attn_seq_len=16)
    # K7-det against K7 in the same call, on the research case's inputs: the
    # same function, so K7's bound is its bound and its share shows what the
    # fixed order costs
    k7_again_ms = device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(q, k, v, r_len, r_ts, pos_w, ts_w, do, **r_args), 10)
    k7det_ms = device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(
        q, k, v, r_len, r_ts, pos_w, ts_w, do, deterministic=True, **r_args), 10)
    print(f"  research shape: K7-det {k7det_ms:.4f} ms against K7 {k7_again_ms:.4f} ms in this call "
          f"({k7det_ms / k7_again_ms:.2f}x; K7 earlier {k7_ms:.4f} ms)")
    del slice_case, m20_case, b139_case, q, k, v, do, q_, k_, v_, do_
    torch.cuda.empty_cache()

    # K6 and K7 on bfloat16 q, k, v and dO: the first HSTU block's types
    # under compute_dtype="bfloat16"
    bf16_errs = {"K6-bf16": [], "K7-bf16": []}

    def relbias_bf16_case(name, Bc, N, lengths, ts, Hc, Dc, Vc):
        """K6 and K7 on bfloat16 views of one bfloat16 uvqk projection and a
        strided bfloat16 dO, against their bfloat16 plain versions (the same
        rounding points); dead rows exactly 0, dk and dv the same bits on a
        second run."""
        bf = torch.bfloat16
        proj = rand(Bc, N, Hc * (2 * Vc + 2 * Dc)).to(bf)
        _, v, q, k = torch.split(proj, [Hc * Vc, Hc * Vc, Hc * Dc, Hc * Dc], dim=-1)
        q, k, v = q.reshape(Bc, N, Hc, Dc), k.reshape(Bc, N, Hc, Dc), v.reshape(Bc, N, Hc, Vc)
        pos_w, ts_w = bias_tables(N, 128)
        do = rand(N, Bc, Hc, Vc).to(bf).transpose(0, 1)
        args = dict(alpha=1.0, max_seq_len=N, num_buckets=128)
        dead = torch.arange(N, device="cuda")[None, :] >= lengths[:, None]
        poison_allocator(Bc * N * Hc * Vc * 2)
        got = hstu_mha_dense_relbias_cuda(q, k, v, lengths, ts, pos_w, ts_w, **args)
        want = hstu_mha_dense_relbias_plain(q, k, v, lengths, ts, pos_w, ts_w, **args)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == bf, f"K6-bf16 {name}: output types {got.dtype}, {want.dtype}")
        bf16_errs["K6-bf16"].append(compare(f"K6-bf16 {name}", got.float(), want.float(), dead, rel_tol=BF16_TOL))
        del got, want
        grads = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, do, **args)
        again = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, do, **args)
        torch.cuda.synchronize()
        check(torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2]),
              f"K7-bf16 {name}: dk or dv differ between two runs")
        del again
        wants = hstu_mha_relbias_bwd_plain(q, k, v, lengths, ts, pos_w, ts_w, do, **args)
        for g, a, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), grads, wants):
            table = g in ("dpos_w", "dts_w")
            check(a.dtype == w.dtype == (torch.float32 if table else bf), f"K7-bf16 {name} {g}: type {a.dtype}")
            bf16_errs["K7-bf16"].append(compare(f"K7-bf16 {name} {g}", a.float(), w.float(),
                                                None if table else dead, rel_tol=TABLE_TOL if table else BF16_TOL))
        return q, k, v, pos_w, ts_w, do, args

    def bf16_times(case, lengths, ts, Bc, N, Hc, Dc, Vc):
        """(K6 ms, K7 ms, plain K6 ms, plain K7 ms, K6's work, K7's work) of a
        bfloat16 case; the work is (operations, bytes) with 2 bytes for every
        element of q, k, v, dO and their gradients and outputs."""
        q_, k_, v_, pw_, tw_, do_, a_ = case
        times = (
            device_time_ms(lambda: hstu_mha_dense_relbias_cuda(q_, k_, v_, lengths, ts, pw_, tw_, **a_), 20),
            device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(q_, k_, v_, lengths, ts, pw_, tw_, do_, **a_), 10),
            device_time_ms(lambda: hstu_mha_dense_relbias_plain(q_, k_, v_, lengths, ts, pw_, tw_, **a_), 3),
            device_time_ms(lambda: hstu_mha_relbias_bwd_plain(q_, k_, v_, lengths, ts, pw_, tw_, do_, **a_), 2),
        )
        live = apply_padding_guard(make_valid_attn_mask(N, lengths), lengths).sum().item()
        rows = lengths.sum().item() * Hc
        small = 4 * (Bc * N + pw_.numel() + tw_.numel() + Bc)  # timestamps, tables, lengths
        w6 = (live * Hc * 2 * (Dc + Vc), 2 * (rows * (2 * Dc + Vc) + Bc * N * Hc * Vc) + small)
        w7 = (live * Hc * 2 * (3 * Dc + 2 * Vc),
              2 * (rows * (2 * Dc + 2 * Vc) + Bc * N * Hc * (2 * Dc + Vc)) + 4 * (pw_.numel() + tw_.numel()) + small)
        return times + (w6, w7)

    def bound_ms(work, peak):
        return max(work[0] / peak, work[1] / PEAK_BYTES_PER_S) * 1e3

    print("relative-bias kernel phase in bfloat16 (K6 and K7 on bfloat16 q, k, v, dO, against their bfloat16 "
          f"plain versions; outputs to {BF16_TOL:.4g} of their max, the float32 tables to {TABLE_TOL}):")
    rb_case = relbias_bf16_case(
        f"ml-3b layer 0 (B={RB}, N={RN}, H={RH}, D=V={RD}), lengths and timestamps of a corpus batch",
        RB, RN, r_len, r_ts, RH, RD, RV)
    *k6b_times, k6b_work, k7b_work = bf16_times(rb_case, r_len, r_ts, RB, RN, RH, RD, RV)
    k6b_ms, k7b_ms, k6b_plain_ms, k7b_plain_ms = k6b_times
    print(
        f"  ml-3b layer 0: K6-bf16 {k6b_ms:.4f} ms (plain {k6b_plain_ms:.4f}, bound "
        f"{bound_ms(k6b_work, PEAK_BF16_FLOPS):.4f}; float32 K6 {k6_ms:.4f}), K7-bf16 {k7b_ms:.4f} ms (plain "
        f"{k7b_plain_ms:.4f}, bound {bound_ms(k7b_work, PEAK_BF16_FLOPS):.4f}; float32 K7 {k7_ms:.4f})"
    )
    print(f"K7-det-bf16 vs the bfloat16 plain backward (outputs {BF16_TOL:.4g} of their max, the tables "
          f"{DET_BF16_TABLE_TOL}; every output the same bits twice):")
    det_case(f"ml-3b layer 0 (B={RB}, N={RN}, H={RH}, D=V={RD}) on the bfloat16 case's q, k, v", RB, RN, r_len,
             r_ts, Hc=RH, bf16=True, qkv=rb_case[:3])
    det_case("H=3, lengths at the tile edges (63 .. 129)", 6, 140, edges, random_ts(6, 140, edges), Hc=3, bf16=True)
    det_case("N > Nm, num_targets", 3, 140, l140, random_ts(3, 140, l140), Nm=100, bf16=True,
             nt=torch.minimum(ints(0, 6, 3), l140 - 1))
    q_, k_, v_, pw_, tw_, do_, a_ = rb_case
    k7b_again_ms = device_time_ms(
        lambda: hstu_mha_relbias_bwd_cuda(q_, k_, v_, r_len, r_ts, pw_, tw_, do_, **a_), 10)
    k7db_ms = device_time_ms(
        lambda: hstu_mha_relbias_bwd_cuda(q_, k_, v_, r_len, r_ts, pw_, tw_, do_, deterministic=True, **a_), 10)
    print(f"  ml-3b layer 0: K7-det-bf16 {k7db_ms:.4f} ms against K7-bf16 {k7b_again_ms:.4f} ms in this call "
          f"({k7db_ms / k7b_again_ms:.2f}x)")
    del rb_case, q_, k_, v_, do_
    torch.cuda.empty_cache()

    # K1 and K2 on bfloat16: the first block of the bias-free research model
    # under compute_dtype="bfloat16" (enable_relative_attention_bias=False)
    d16_errs = {"K1-bf16": [], "K2-bf16": []}

    def dense_bf16_case(name, Bc, N, lengths, Hc, Dc, Vc, nt=None, alpha_=1.0, qkv=None, **kw):
        """K1-bf16 and K2-bf16 against their bfloat16 plain versions on
        bfloat16 views of one uvqk projection (or ``qkv``) and a strided dO:
        dead rows exactly 0, K1's output and K2's dk and dv the same bits on
        a second run."""
        bf = torch.bfloat16
        q, k, v = qkv or relbias_views(Bc, N, Hc, Dc, Vc, bf)
        do = rand(N, Bc, Hc, Vc).to(bf).transpose(0, 1)
        args = dict(alpha=alpha_, max_seq_len=N, num_targets=nt, **kw)
        dead = torch.arange(N, device="cuda")[None, :] >= lengths[:, None]
        poison_allocator(Bc * N * Hc * Vc * 2)
        got = hstu_mha_dense_cuda(q, k, v, lengths, **args)
        want = hstu_mha_dense_plain(q, k, v, lengths, **args)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == bf, f"K1-bf16 {name}: output types {got.dtype}, {want.dtype}")
        check(torch.equal(got, hstu_mha_dense_cuda(q, k, v, lengths, **args)), f"K1-bf16 {name}: two runs differ")
        d16_errs["K1-bf16"].append(compare(f"K1-bf16 {name}", got.float(), want.float(), dead, rel_tol=BF16_TOL))
        del got, want
        poison_allocator(3 * Bc * N * Hc * max(Dc, Vc) * 4)
        grads = hstu_mha_bwd_cuda(q, k, v, lengths, do, **args)
        again = hstu_mha_bwd_cuda(q, k, v, lengths, do, **args)
        torch.cuda.synchronize()
        check(torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2]),
              f"K2-bf16 {name}: dk or dv differ between two runs")
        del again
        wants = hstu_mha_bwd_plain(q, k, v, lengths, do, **args)
        for g, a, w in zip(("dq", "dk", "dv"), grads, wants):
            check(a.dtype == w.dtype == bf, f"K2-bf16 {name} {g}: type {a.dtype}")
            d16_errs["K2-bf16"].append(compare(f"K2-bf16 {name} {g}", a.float(), w.float(), dead, rel_tol=BF16_TOL))
        return q, k, v, do, args

    def dense_bf16_times(case, lengths, Bc, N, Hc, Dc, Vc):
        """(K1-bf16 ms, K2-bf16 ms, plain K1 ms, plain K2 ms, K1's work, K2's
        work) of a case; the work is (operations, bytes), 2 bytes for every
        element of q, k, v, dO and the outputs (the live rows of the inputs,
        every row of the outputs) and the lengths."""
        q_, k_, v_, do_, a_ = case
        times = (
            device_time_ms(lambda: hstu_mha_dense_cuda(q_, k_, v_, lengths, **a_), 20),
            device_time_ms(lambda: hstu_mha_bwd_cuda(q_, k_, v_, lengths, do_, **a_), 10),
            device_time_ms(lambda: hstu_mha_dense_plain(q_, k_, v_, lengths, **a_), 3),
            device_time_ms(lambda: hstu_mha_bwd_plain(q_, k_, v_, lengths, do_, **a_), 2),
        )
        live = apply_padding_guard(make_valid_attn_mask(N, lengths, num_targets=a_.get("num_targets")),
                                   lengths).sum().item()
        rows = lengths.sum().item() * Hc
        w1 = (live * Hc * 2 * (Dc + Vc), 2 * (rows * (2 * Dc + Vc) + Bc * N * Hc * Vc) + 4 * Bc)
        w2 = (live * Hc * 2 * (3 * Dc + 2 * Vc), 2 * (rows * (2 * Dc + 2 * Vc) + Bc * N * Hc * (2 * Dc + Vc)) + 4 * Bc)
        return times + (w1, w2)

    print(f"K1 and K2 on bfloat16 (K1-bf16, K2-bf16) vs their bfloat16 plain versions (outputs {BF16_TOL:.4g} of "
          "their max):")
    d16_case = dense_bf16_case(f"ml-3b layer 0 (B={RB}, N={RN}, H={RH}, D=V={RD}, alpha 1), bfloat16 uvqk views, "
                               "lengths of a corpus batch", RB, RN, r_len, RH, RD, RV)
    *d16_times, d16_w1, d16_w2 = dense_bf16_times(d16_case, r_len, RB, RN, RH, RD, RV)
    del d16_case
    bB, bN, bH, bD = BENCH_SHAPE
    brng = np.random.default_rng(0)
    bench_len = torch.as_tensor(np.clip(brng.integers(bN // 8, bN, size=(bB,)), 1, bN), dtype=torch.int32,
                                device="cuda")
    bench_qkv = tuple(torch.as_tensor(brng.standard_normal((bB, bN, bH, bD), np.float32) * 0.1, device="cuda")
                      .to(torch.bfloat16) for _ in range(3))
    bench_case = dense_bf16_case(f"bench.py's shape (B={bB}, N={bN}, H={bH}, D={bD}, alpha 1/{bD**0.5:g}), "
                                 "lengths from default_rng(0)", bB, bN, bench_len, bH, bD, bD, alpha_=bD**-0.5,
                                 qkv=bench_qkv)
    *b16_times, b16_w1, b16_w2 = dense_bf16_times(bench_case, bench_len, bB, bN, bH, bD, bD)
    del bench_case, bench_qkv
    dense_bf16_case("lengths at the tile edges (31 .. 129), contextual rows and targets", 9, 140, fwd_edges, 2, 32,
                    32, nt=ints(0, 20, 9).clamp(max=fwd_edges - 4), contextual_seq_len=3)
    dense_bf16_case("a row of length 0 beside live rows", 4, 100,
                    torch.tensor([0, 100, 0, 37], dtype=torch.int32, device="cuda"), 2, 32, 32)
    dense_bf16_case("D=V=64, H=3, lengths at the tile edges", 9, 140, fwd_edges, 3, 64, 64)
    dense_bf16_case("D=V=128 (one head a block), targets and contextual rows", 3, 150, ints(8, 151, 3), 4, 128, 128,
                    nt=ints(0, 5, 3), contextual_seq_len=6)
    dense_bf16_case("alpha 1/8, a window with full-attention rows", 4, 150, ints(20, 151, 4), 2, 32, 32,
                    nt=ints(0, 10, 4), alpha_=0.125, max_attn_len=16, min_full_attn_seq_len=8)
    dense_bf16_case("D=V=25 (scalar loads), non-causal", 3, 97, ints(1, 98, 3), 2, 25, 25, causal=False)
    for label, (t1, t2, p1, p2), w1, w2 in (("ml-3b layer 0", d16_times, d16_w1, d16_w2),
                                            (f"bench.py's shape (N={bN})", b16_times, b16_w1, b16_w2)):
        print(f"  {label}: K1-bf16 {t1:.4f} ms (plain {p1:.4f}, bound {bound_ms(w1, PEAK_BF16_FLOPS):.4f}), "
              f"K2-bf16 {t2:.4f} ms (plain {p2:.4f}, bound {bound_ms(w2, PEAK_BF16_FLOPS):.4f})")
    torch.cuda.empty_cache()

    # -------------------------------------------------------- serving phase
    all_counters = kernel_counters()
    # the bfloat16 kernels and K7-det, counted apart
    counters_bf16 = {k_: all_counters[k_] for k_ in OPTIONAL_KERNELS}
    counters = {k_: c for k_, c in all_counters.items() if k_ not in counters_bf16}
    main_path_launches = dict.fromkeys(all_counters, 0)

    def count_reset():
        for c in all_counters.values():
            c.reset()

    def counts():
        """The launch counts since `count_reset`, also added to the main
        path's totals: every float32 kernel's, and the bfloat16 kernels'
        where they launched."""
        now = {name: c.count for name, c in counters.items()}
        now.update({name: c.count for name, c in counters_bf16.items() if c.count})
        for name, n in now.items():
            main_path_launches[name] += n
        return now

    argv = [
        "--device", "cuda", "--scenario", "Offline",
        "--num_queries", str(NUM_QUERIES), "--num_warmups", str(NUM_WARMUPS),
        "--batch_size", str(B), "--max_uih_len", str(MAX_UIH),
        "--max_num_candidates", str(MAX_CANDS), "--hash_size", str(HASH_SIZE),
        "--num_qsl_batches", str(QSL_BATCHES),
    ]
    L = cfg.hstu_attn_num_layers
    chunks = -(-MAX_CANDS // cfg.max_num_candidates_inference)
    print(
        f"serving phase: debug preset, {L} layers, H={H}, qk=v={D}, "
        f"d_model={cfg.hstu_transducer_embedding_dim}, table dim {cfg.hstu_embedding_table_dim}, "
        f"uih {MAX_UIH} + {MAX_CANDS} candidates (N={N_full}), batch {B}, int8 tables of "
        f"{HASH_SIZE:,} rows each (cut from the reference's 10,000,000)"
    )
    for mode, extra in (("dense", []), ("mfalcon", ["--mfalcon"])):
        count_reset()
        result = serve.main(argv + extra)
        n = counts()
        k1_n, k5_n = n["K1"], n["K5"]
        check(n["K2"] == n["K3"] == n["K4"] == n["K6"] == n["K7"] == 0,
              f"{mode}: serving launched a kernel that is not its own: {n}")
        predicts = NUM_WARMUPS + int(result["query_count"])
        print(
            f"  {mode}: qps {result['qps']:.3f}, scored (real, unpadded) candidates/s "
            f"{result['scored_candidates_per_s']:.1f}, p50 {result['p50_ms']:.2f} ms, "
            f"p99 {result['p99_ms']:.2f} ms; launches K1 {k1_n}, K5 {k5_n} over {predicts} predicts"
        )
        check(result["qps"] > 0 and int(result["query_count"]) == NUM_QUERIES, f"{mode}: bad result {result}")
        check(k1_n == L * predicts, f"{mode}: K1 launched {k1_n} times, expected {L * predicts}")
        want_k5 = L * chunks * predicts if mode == "mfalcon" else 0
        check(k5_n == want_k5, f"{mode}: K5 launched {k5_n} times, expected {want_k5}")

    # dense vs M-FALCON on one batch (tests/test_mfalcon.py's invariance):
    # every candidate valid, one query time per row, the contextual features
    # kept (uih >= their min uih length), float tables on both paths
    tables = get_embedding_table_config("debug", hash_size=HASH_SIZE, dim=cfg.hstu_embedding_table_dim)
    with torch.device("cuda"):
        model = DlrmHSTU(cfg, tables, torch.Generator("cuda").manual_seed(1))
    family = HSTUModelFamily(model, quantize=False)
    uih, ul_b, cands, _ = DLRMv3RandomDataset(cfg, hash_size=HASH_SIZE, batch_size=B, seed=1).batch()
    min_uih = max(n for _, n in cfg.contextual_feature_to_min_uih_length)
    ul_b = ul_b.clip(min_uih, None)
    qt = uih["uih_action_time"].max(axis=1) + 1
    cands["item_query_time"] = qt[:, None].repeat(MAX_CANDS, axis=1).astype("int32")
    T = lambda d: {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}  # noqa: E731
    uih_t, cands_t, ul_t = T(uih), T(cands), torch.as_tensor(ul_b, device="cuda")
    nc_t = torch.full((B,), MAX_CANDS, dtype=torch.int32, device="cuda")
    dense = family.predict(uih_t, ul_t, cands_t, nc_t)
    mf = family.predict_mfalcon(uih_t, ul_t, cands_t, torch.as_tensor(qt, device="cuda"))
    T_tasks = len(cfg.multitask_configs)
    check(tuple(dense.shape) == (T_tasks, B, MAX_CANDS), f"predict shape {tuple(dense.shape)}")
    check(bool(torch.isfinite(dense).all() and torch.isfinite(mf).all()), "non-finite predictions")
    inv_err = (dense - mf).abs().max().item()
    print(f"  dense vs M-FALCON predictions, one batch: max_abs_diff {inv_err:.3e} (tol {PRED_TOL})")
    check(inv_err <= PRED_TOL, "dense and M-FALCON predictions disagree")

    # where one served query's time goes (int8 tables as served)
    served = HSTUModelFamily(model, quantize=True)
    qt_t = cands_t["item_query_time"][:, 0]
    profile("dense predict", lambda: served.predict(uih_t, ul_t, cands_t, nc_t))
    profile("M-FALCON predict", lambda: served.predict_mfalcon(uih_t, ul_t, cands_t, qt_t))
    del model, family, served

    # GPU (kernels) vs CPU (plain versions) on a small model
    small = dict(
        hstu_attn_num_layers=2, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
        hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_num_heads=2,
    )
    scfg = dataclasses.replace(get_hstu_configs("debug", max_uih_len=40, max_num_candidates=12), **small)
    cpu_model = DlrmHSTU(scfg, get_embedding_table_config("debug", hash_size=100, dim=16),
                         torch.Generator().manual_seed(2))
    uih, ul_s, cands, nc_s = DLRMv3RandomDataset(scfg, hash_size=100, batch_size=4, seed=2).batch()
    qt_s = torch.as_tensor(cands["item_query_time"][:, 0])
    outs = {}
    for dev in ("cpu", "cuda"):
        fam = HSTUModelFamily(cpu_model.to(dev), quantize=True)
        to = lambda d: {k: torch.as_tensor(v, device=dev) for k, v in d.items()}  # noqa: E731
        args = (to(uih), torch.as_tensor(ul_s, device=dev), to(cands))
        outs[dev] = (
            fam.predict(*args, torch.as_tensor(nc_s, device=dev)).cpu(),
            fam.predict_mfalcon(*args, qt_s.to(dev)).cpu(),
        )
    small_err = max((a - b).abs().max().item() for a, b in zip(outs["cpu"], outs["cuda"]))
    print(f"  small model, GPU kernels vs CPU plain versions: max_abs_diff {small_err:.3e} (tol {PRED_TOL})")
    check(small_err <= PRED_TOL, "GPU and CPU predictions disagree")

    # ------------------------------------------------------- training phase
    L_tr = tcfg.hstu_attn_num_layers
    print(
        f"training phase: debug preset, {L_tr} layers, H={H}, qk=v={D}, "
        f"d_model={tcfg.hstu_transducer_embedding_dim}, table dim {tcfg.hstu_embedding_table_dim}, "
        f"uih {TRAIN_UIH} + {TRAIN_CANDS} candidates (N={N_tr}), batch {B}, float32 tables of "
        f"{HASH_SIZE:,} rows each (cut from the reference's 10,000,000), dropout "
        f"{tcfg.hstu_input_dropout_ratio} / {tcfg.hstu_linear_dropout_rate}"
    )
    train_tables = get_embedding_table_config("debug", hash_size=HASH_SIZE, dim=tcfg.hstu_embedding_table_dim)

    def batches(cfg_, n, seed):
        return make_dlrm_batches("debug", cfg_, hash_size=HASH_SIZE, batch_size=B, num_batches=n, seed=seed)

    trainer = DlrmTrainer(tcfg, train_tables, DlrmTrainConfig(), device="cuda", seed=0)
    warm = train_loop(trainer, batches(tcfg, TRAIN_WARMUPS, 0))
    count_reset()
    out = train_loop(trainer, batches(tcfg, TRAIN_STEPS, 1))
    n = counts()
    losses = warm["losses"] + out["losses"]
    step_ms = sorted(1e3 * t for t in out["step_s"])
    median_ms = (step_ms[(TRAIN_STEPS - 1) // 2] + step_ms[TRAIN_STEPS // 2]) / 2
    print(
        f"  {TRAIN_STEPS} steps after {TRAIN_WARMUPS} warm-ups: {out['examples_per_s']:.1f} examples/s, "
        f"median step {median_ms:.2f} ms (min {step_ms[0]:.2f}, max {step_ms[-1]:.2f}); loss "
        f"{losses[0]:.5f} at the first step, {losses[-1]:.5f} at the last; metrics "
        f"{ {k: round(v, 5) for k, v in out['metrics'].items()} }; launches {n}"
    )
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    want_n = {"K1": L_tr * TRAIN_STEPS, "K2": L_tr * TRAIN_STEPS, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}
    check(n == want_n, f"training launched {n}, expected {want_n}")
    batch = to_device(next(batches(tcfg, 1, 2)), trainer.device)
    profile("training step", lambda: trainer.train_step(batch))
    del trainer, batch

    # ------------------------------------------------- deterministic phase
    print(
        f"deterministic phase: torch.use_deterministic_algorithms(True), {det_cfg.hstu_attn_num_layers} "
        f"layer, uih {DET_UIH} + {TRAIN_CANDS} candidates (N={N_det}), the same widths, {DET_STEPS} steps, twice"
    )
    det_tables = get_embedding_table_config("debug", hash_size=HASH_SIZE, dim=det_cfg.hstu_embedding_table_dim)
    det_runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for run in range(2):
            trainer = DlrmTrainer(det_cfg, det_tables, DlrmTrainConfig(), device="cuda", seed=3)
            count_reset()
            det_out = train_loop(trainer, batches(det_cfg, DET_STEPS, 4))
            n = counts()
            want_n = {"K1": DET_STEPS, "K2": 0, "K3": DET_STEPS, "K4": DET_STEPS, "K5": 0, "K6": 0, "K7": 0}
            check(n == want_n, f"deterministic run launched {n}, expected {want_n}")
            check(all(math.isfinite(x) for x in det_out["losses"]), "non-finite deterministic loss")
            det_runs.append((det_out["losses"], [p.detach().clone() for p in trainer.model.parameters()]))
            if run == 1:  # where a deterministic step's time goes, after the runs' parameters are kept
                batch = to_device(next(batches(det_cfg, 1, 5)), trainer.device)
                profile("deterministic training step", lambda: trainer.train_step(batch))
                del batch
            del trainer
    finally:
        torch.use_deterministic_algorithms(False)
    (l1, p1), (l2, p2) = det_runs
    same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
    print(f"  losses {l1} and {l2}; every parameter bit-identical: {same}")
    check(same, "two deterministic runs from one seed differ")
    del det_runs, p1, p2

    def small_step_grads(cfg_, coins=()):
        """One training forward and backward of a small ranker from one seed
        on each device, dropout off (the devices' random streams differ) and
        the given stochastic-depth coins on both: the largest gradient error
        of the card against the CPU, relative to each gradient's max, the
        parameters given gradients, and the card's K1 and K2 launches."""
        raw = next(DLRMv3RandomDataset(cfg_, hash_size=100, batch_size=4, seed=5).batches(1))
        grads, launched = {}, {}
        for dev in ("cpu", "cuda"):
            queue = list(coins)
            dynamic_stu.SDSTU.skip = lambda self_, gen_: queue.pop(0)
            try:
                trainer = DlrmTrainer(cfg_, get_embedding_table_config("debug", hash_size=100, dim=16),
                                      DlrmTrainConfig(), device="cpu", seed=6)
                trainer.model.to(dev)
                trainer.device = torch.device(dev)
                before = {k: counters[k].count for k in ("K1", "K2")}
                loss, *_ = trainer.loss(to_device(raw, trainer.device))
                loss.backward()
            finally:
                dynamic_stu.SDSTU.skip = real_skip
            check(not queue, f"{len(queue)} stochastic-depth coins were not drawn")
            if dev == "cuda":
                launched = {k: counters[k].count - n_ for k, n_ in before.items()}
            grads[dev] = {name: p.grad.cpu() for name, p in trainer.model.named_parameters() if p.grad is not None}
        check(grads["cpu"].keys() == grads["cuda"].keys(), "the two devices give gradients to other parameters")
        err = max(
            (grads["cuda"][k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
            for k, g in grads["cpu"].items()
        )
        return err, sorted(grads["cpu"]), launched

    # one training step's gradients on a small model: GPU kernels vs CPU
    # plain versions
    real_skip = dynamic_stu.SDSTU.skip
    gcfg = dataclasses.replace(scfg, hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0)
    grad_err, g_names, g_n = small_step_grads(gcfg)
    print(f"  small model, one step's gradients, GPU kernels vs CPU plain versions: largest error "
          f"{grad_err:.3e} of the gradient's max over {len(g_names)} parameters (tol {GRAD_TOL})")
    check(g_n["K2"] == gcfg.hstu_attn_num_layers, f"small-model step launched K2 {g_n['K2']} times")
    check(grad_err <= GRAD_TOL, "GPU and CPU gradients disagree")
    # and wrapped as the dynamic-STU ranker wraps its layers: stochastic
    # depth on each of 3 layers (coins run, skip, run) and an L2 window of 16
    # rows on layers 1 and 2, so layer 2 runs K1 and K2 in the window
    wcfg = dataclasses.replace(gcfg, hstu_attn_num_layers=3, hstu_stochastic_depth_ratio=0.5, hstu_l2_max_len=16)
    w_err, w_names, w_n = small_step_grads(wcfg, (False, True, False))
    print(f"  small wrapped model (stochastic depth, coins run / skip / run; L2 window 16 of N="
          f"{C + wcfg.max_uih_len + wcfg.max_num_candidates}), one step's gradients, GPU kernels vs CPU "
          f"plain versions: largest error {w_err:.3e} of the gradient's max over {len(w_names)} parameters "
          f"(tol {GRAD_TOL}); K1 {w_n['K1']}, K2 {w_n['K2']}")
    check(w_n == {"K1": 2, "K2": 2}, f"the wrapped small-model step launched {w_n}, expected K1 = K2 = 2")
    check(not any(".layer_1." in name for name in w_names), "the skipped layer got gradients")
    check(w_err <= GRAD_TOL, "GPU and CPU gradients of the wrapped model disagree")

    # ---------------------------------------------- dynamic-STU ranker phase
    # train_ranker with stochastic depth 0.1 on every layer and the L2 window
    # (w = 128) on layers 1 and 2: each coin and each attention's width
    # recorded, the launches held to what the coins predict
    coins, widths = [], []
    real_attention = stu_module.STULayer._attention

    def recording_skip(self_, sd_gen_):
        coins.append(real_skip(self_, sd_gen_))
        return coins[-1]

    def recording_attention(self_, q_, *a_):
        widths.append(q_.shape[1])
        return real_attention(self_, q_, *a_)

    dyn_steps = TRAIN_WARMUPS + TRAIN_STEPS
    dynamic_stu.SDSTU.skip, stu_module.STULayer._attention = recording_skip, recording_attention
    try:
        count_reset()
        dyn = train_ranker.main([
            "--device", "cuda", "--num_batches", str(dyn_steps), "--batch_size", str(B), "--max_uih_len",
            str(TRAIN_UIH), "--max_num_candidates", str(TRAIN_CANDS), "--hash_size", str(HASH_SIZE),
            "--stochastic_depth", str(SD_RATIO), "--l2_max_len", str(L2_LEN),
        ])
        n = counts()
    finally:
        dynamic_stu.SDSTU.skip, stu_module.STULayer._attention = real_skip, real_attention
    ran = [[not c for c in coins[i * L_tr:(i + 1) * L_tr]] for i in range(dyn_steps)]
    want_widths = [N_tr if layer == 0 else min(L2_LEN, N_tr) for step in ran for layer, r in enumerate(step) if r]
    runs = sum(map(sum, ran))
    dyn_ms = sorted(1e3 * t for t in dyn["step_s"][TRAIN_WARMUPS:])
    print(
        f"dynamic-STU ranker phase: train_ranker --stochastic_depth {SD_RATIO} --l2_max_len {L2_LEN}, the "
        f"training phase's preset and batches ({L_tr} layers, layers {L_tr // 2}..{L_tr - 1} in L2 windows of "
        f"{min(L2_LEN, N_tr)} of N={N_tr}), {dyn_steps} steps: {B * TRAIN_STEPS / sum(dyn['step_s'][TRAIN_WARMUPS:]):.1f}"
        f" examples/s over the last {TRAIN_STEPS}, median step {median(dyn_ms):.2f} ms (the training phase: "
        f"{median_ms:.2f}); {coins.count(True)} of {len(coins)} layer runs skipped; launches {n}"
    )
    check(len(coins) == L_tr * dyn_steps and all(math.isfinite(x) for x in dyn["losses"]),
          f"dynamic-STU run: {len(coins)} coins, losses {dyn['losses']}")
    check(n == {**dict.fromkeys(n, 0), "K1": runs, "K2": runs},
          f"the dynamic-STU run launched {n}, expected K1 = K2 = {runs} (the layers the coins ran)")
    check(widths == want_widths, "the dynamic-STU run's attention widths differ from the L2 windows")
    dyn_trainer = dyn["trainer"]
    dyn_batch = to_device(next(batches(tcfg, 1, 2)), dyn_trainer.device)
    profile("dynamic-STU training step", lambda: dyn_trainer.train_step(dyn_batch))
    del dyn, dyn_trainer, dyn_batch
    gc.collect()

    # ------------------------------------------------------ recompute phase
    # the default STU recompute flags (all on: each layer keeps its input and
    # attention output, and recomputes the rest in its backward without
    # running K1) against all off, from one seed with dropout on
    rec = {}
    for label, on in (("recompute", True), ("no recompute", False)):
        torch.cuda.empty_cache()
        rtr = DlrmTrainer(tcfg, train_tables, DlrmTrainConfig(), device="cuda", seed=0)
        if not on:
            for layer in rtr.model.hstu_transducer.stu_module.layers:
                layer.config = dataclasses.replace(layer.config, recompute_normed_x=False, recompute_uvqk=False,
                                                   recompute_y=False)
        gb = to_device(next(batches(tcfg, 1, 7)), rtr.device)
        count_reset()
        # what the forward leaves allocated until the backward, its saved
        # activations; counted by the allocator, not by saved_tensors_hooks,
        # which left the trainer's parameters allocated after the phase
        torch.cuda.synchronize()
        before_fwd = torch.cuda.memory_allocated()
        rloss = rtr.loss(gb)[0]  # the predictions' graph would keep the model alive
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - before_fwd
        rloss.backward()
        n_grad = counts()
        # on the host, so that the next trainer starts from the same memory
        rgrads = {k_: p.grad.cpu() for k_, p in rtr.model.named_parameters() if p.grad is not None}
        rtr.sparse_opt.zero_grad(set_to_none=True)
        rtr.dense_opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        count_reset()
        rout = train_loop(rtr, batches(tcfg, TRAIN_WARMUPS + REC_STEPS, 8))
        n_steps = counts()
        peak = torch.cuda.max_memory_allocated()
        profile(f"{label} training step", lambda: rtr.train_step(gb))
        rec[label] = dict(loss=rloss.item(), grads=rgrads, kept=kept, launches=n_grad, step_launches=n_steps,
                          peak=peak / 2**30, above=(peak - held) / 2**30,
                          median=1e3 * median(rout["step_s"][TRAIN_WARMUPS:]))
        check(n_grad == {**dict.fromkeys(n_grad, 0), "K1": L_tr, "K2": L_tr},
              f"{label}: one step launched {n_grad}, expected K1 = K2 = {L_tr}")
        want_n = L_tr * (TRAIN_WARMUPS + REC_STEPS)
        check(n_steps == {**dict.fromkeys(n_steps, 0), "K1": want_n, "K2": want_n},
              f"{label}: the steps launched {n_steps}, expected K1 = K2 = {want_n}")
        del rtr, rgrads, gb, rout, rloss
        gc.collect()  # the trainer's modules hold reference cycles
    a_, b_ = rec["recompute"], rec["no recompute"]
    rec_err = max((a_["grads"][k_] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                  for k_, g in b_["grads"].items())
    print(
        f"recompute phase: the training phase's preset, dropout {tcfg.hstu_input_dropout_ratio} / "
        f"{tcfg.hstu_linear_dropout_rate}, one seed: the default flags (recompute_normed_x, recompute_uvqk, "
        f"recompute_y all on) against all off: loss {a_['loss']:.6f} vs {b_['loss']:.6f}; gradients "
        f"{rec_err:.3e} of their max apart (tol {REMAT_TOL}) over {len(b_['grads'])} parameters; allocated by the "
        f"forward until the backward {a_['kept'] / 2**20:.1f} MiB vs {b_['kept'] / 2**20:.1f} MiB; peak "
        f"device memory over {TRAIN_WARMUPS} + {REC_STEPS} steps {a_['peak']:.2f} vs {b_['peak']:.2f} GiB ("
        f"{a_['above']:.2f} vs {b_['above']:.2f} GiB above what the trainer held before them); median "
        f"step {a_['median']:.2f} vs {b_['median']:.2f} ms; launches per step K1 {L_tr}, K2 {L_tr} in both (the "
        f"deterministic phase above ran under the default flags too: K1, K3, K4 once a step)"
    )
    check(a_["grads"].keys() == b_["grads"].keys() and abs(a_["loss"] - b_["loss"]) <= 1e-6 * abs(b_["loss"])
          and rec_err <= REMAT_TOL, "the step with recomputation differs from the one without")
    check(a_["kept"] < b_["kept"], "recomputation kept no fewer bytes for the backward")
    del rec, a_, b_
    torch.cuda.empty_cache()

    # -------------------------------------------------- jagged attention phase
    # ops/hstu_attention.py's jagged entry points at the serving shape: K1
    # through hstu_mha, K5 through delta_hstu_mha (the M = 160 newest rows of
    # each sequence), against their plain versions on the same rows
    JN, JM = N_full, MAX_CANDS
    jrng = np.random.default_rng(11)
    jl = torch.as_tensor(jrng.integers(JM + 1, JN + 1, size=B), dtype=torch.int32, device="cuda")
    joff = jagged.lengths_to_offsets(jl)
    cap = B * JN
    jq, jk = (torch.as_tensor(jrng.standard_normal((cap, H, D)), dtype=torch.float32, device="cuda") * 0.5
              for _ in range(2))
    jv = torch.as_tensor(jrng.standard_normal((cap, H, V)), dtype=torch.float32, device="cuda") * 0.5
    count_reset()
    j_got = jagged_attention.hstu_mha(JN, alpha, jq, jk, jv, joff, causal=True, contextual_seq_len=C)
    n_j = counts()
    pad_ = lambda t_, d_: jagged.jagged_to_padded_dense(t_.reshape(cap, H * d_), joff, JN).reshape(B, JN, H, d_)  # noqa: E731
    pq, pk, pv = pad_(jq, D), pad_(jk, D), pad_(jv, V)
    j_want = jagged.dense_to_jagged(
        hstu_mha_dense_plain(pq, pk, pv, jl, alpha=alpha, max_seq_len=JN, causal=True,
                             contextual_seq_len=C).reshape(B, JN, H * V), joff, total=cap).reshape(cap, H, V)
    j_err = compare("K1 jagged hstu_mha", j_got, j_want, None)
    rows = (joff[1:, None].long() - JM + torch.arange(JM, device="cuda")[None, :]).reshape(-1)
    count_reset()
    d_got = jagged_attention.delta_hstu_mha(JN, alpha, jq[rows], jk, jv, joff, contextual_seq_len=C)
    n_d = counts()
    d_want = delta_hstu_mha_plain(jq[rows].reshape(B, JM, H, D), pk, pv, jl, alpha=alpha,
                                  contextual_seq_len=C, norm_len=JN).reshape(B * JM, H, V)
    d_err = compare("K5 jagged delta_hstu_mha", d_got, d_want, None)
    dd_err = (d_got - j_got[rows]).abs().max().item() / max(j_got[rows].abs().max().item(), 1e-30)
    errs["K1"].append(j_err)
    errs["K5"].append(d_err)
    print(f"jagged attention phase: B={B}, N={JN} (lengths {int(jl.min())}..{int(jl.max())}, {int(joff[-1]):,} of "
          f"{cap:,} slots live), H={H}, D=V={D}, M={JM}: hstu_mha launched {n_j}, delta_hstu_mha {n_d}; the delta "
          f"rows against the full attention's rows {dd_err:.3e} of their max")
    check(n_j == {**dict.fromkeys(n_j, 0), "K1": 1} and n_d == {**dict.fromkeys(n_d, 0), "K5": 1},
          f"the jagged entry points launched {n_j} and {n_d}")
    check(dd_err <= REL_TOL, "the jagged delta rows differ from the full attention's")
    del jq, jk, jv, pq, pk, pv, j_got, j_want, d_got, d_want

    # --------------------------------------------- interleave preprocessor
    # ContextualInterleavePreprocessor at the training phase's widths (table
    # dim 256 in, d_model 512 out, the preset's contextual features and
    # actions, parameterized MLPs), training layout, forward and backward:
    # the card against the CPU on the same weights and inputs
    ipre = ContextualInterleavePreprocessor(
        input_embedding_dim=tcfg.hstu_embedding_table_dim, output_embedding_dim=tcfg.hstu_transducer_embedding_dim,
        contextual_feature_to_max_length=tcfg.contextual_feature_to_max_length,
        contextual_feature_to_min_uih_length=tcfg.contextual_feature_to_min_uih_length,
        content_encoder=ContentEncoder(tcfg.hstu_embedding_table_dim),
        action_encoder=ActionEncoder(8, tcfg.uih_weight_feature_name, tuple(tcfg.action_weights)),
        use_parameterized_mlps=True, gen=torch.Generator().manual_seed(12),
    )
    irng = np.random.default_rng(12)
    INU = TRAIN_UIH + TRAIN_CANDS
    i_uih = irng.integers(TRAIN_UIH // 2, TRAIN_UIH + 1, size=B)
    i_nt = np.full(B, TRAIN_CANDS)
    i_in = dict(
        emb=irng.standard_normal((B, INU, tcfg.hstu_embedding_table_dim)).astype(np.float32),
        ts=np.sort(irng.integers(1, 10**9, size=(B, INU)), axis=1),
        payloads={tcfg.uih_weight_feature_name: irng.integers(0, 1 << len(tcfg.action_weights), size=(B, INU)),
                  **{name_: irng.standard_normal((B, n_ * tcfg.hstu_embedding_table_dim)).astype(np.float32)
                     for name_, n_ in tcfg.contextual_feature_to_max_length}},
    )
    i_w = irng.standard_normal((B, C + 2 * INU, tcfg.hstu_transducer_embedding_dim)).astype(np.float32)
    i_out, i_grads = {}, {}
    for dev in ("cpu", "cuda"):
        mod = ipre.to(dev)
        mod.zero_grad(set_to_none=True)
        to = lambda a_: torch.as_tensor(a_, device=dev)  # noqa: E731
        o_ = mod(to(i_in["emb"]), to(i_uih + i_nt), to(i_in["ts"]), to(i_uih), to(i_nt),
                 {k_: to(v_) for k_, v_ in i_in["payloads"].items()}, deterministic=False,
                 gen=torch.Generator(dev).manual_seed(0))
        (o_.seq_embeddings * to(i_w)).sum().backward()
        # copies: moving the module moves its gradients' storage too
        i_out[dev] = tuple(t_.detach().to("cpu", copy=True) for t_ in (o_.seq_embeddings, o_.seq_lengths,
                                                                       o_.seq_timestamps))
        i_grads[dev] = {k_: p.grad.to("cpu", copy=True) for k_, p in mod.named_parameters()}
    i_err = (i_out["cuda"][0] - i_out["cpu"][0]).abs().max().item() / i_out["cpu"][0].abs().max().item()
    ig_err = max((i_grads["cuda"][k_] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                 for k_, g in i_grads["cpu"].items())
    print(f"interleave preprocessor phase: B={B}, uih up to {TRAIN_UIH} + {TRAIN_CANDS} candidates interleaved to "
          f"{C} + {2 * INU} tokens, {tcfg.hstu_embedding_table_dim} -> {tcfg.hstu_transducer_embedding_dim}, "
          f"parameterized MLPs: GPU vs CPU output {i_err:.3e} of its max (tol {PRED_TOL}), gradients {ig_err:.3e} "
          f"of their max over {len(i_grads['cpu'])} parameters (tol {GRAD_TOL})")
    check(all(torch.equal(a__, b__) for a__, b__ in zip(i_out["cuda"][1:], i_out["cpu"][1:])),
          "the interleaved lengths or timestamps differ between the devices")
    check(i_err <= PRED_TOL and ig_err <= GRAD_TOL, "GPU and CPU interleave preprocessors disagree")
    del ipre, i_out, i_grads

    # --------------------------------------------------------- trace phase
    # train_ranker --output_trace on a small ranker: the profiler's schedule
    # (skip 10, warm up 20, record 5) writes one Chrome trace of steps 30..34
    # under tmp/trace
    trace_dir = os.path.join("tmp", "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    count_reset()
    tr = train_ranker.main(["--device", "cuda", "--num_batches", str(TRACE_STEPS), "--batch_size", "8",
                            "--max_uih_len", "64", "--max_num_candidates", "6", "--hash_size", "1000",
                            "--output_trace"])
    n = counts()
    check(tr["trace_paths"] == [os.path.join(trace_dir, "trace_0.json")] and os.path.exists(tr["trace_paths"][0]),
          f"train_ranker --output_trace wrote {tr['trace_paths']}")
    with open(tr["trace_paths"][0]) as f_:
        events = json.load(f_)["traceEvents"]
    dev_events = [e for e in events if e.get("cat") == "kernel"]
    k1_events = [e for e in dev_events if "fwd_kernel" in e.get("name", "")]
    k2_events = [e for e in dev_events if "dkv_kernel" in e.get("name", "")]
    print(f"trace phase: train_ranker --output_trace, {TRACE_STEPS} steps of the debug preset at uih 64, batch 8: "
          f"{tr['trace_paths'][0]} holds {len(events)} events, {len(dev_events)} kernels, K1 {len(k1_events)} "
          f"({sum(e.get('dur', 0) for e in k1_events):.1f} us), K2 {len(k2_events)}; launches {n}")
    check(n == {**dict.fromkeys(n, 0), "K1": L_tr * TRACE_STEPS, "K2": L_tr * TRACE_STEPS},
          f"the traced run launched {n}")
    check(len(k1_events) == L_tr * 5 and len(k2_events) == L_tr * 5,
          f"the trace holds {len(k1_events)} K1 and {len(k2_events)} K2 events, expected {L_tr * 5} each")
    del tr, events, dev_events

    # ------------------------------------------------------- research phase
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps_total = RESEARCH_WARMUPS + RESEARCH_STEPS
    eval_batches = len(shard_eval) // rcfg.eval_batch_size
    print(
        f"research phase: preset {RESEARCH_PRESET}: {rm.num_blocks} blocks, H={RH}, dqk=dv={RD}, "
        f"d={rm.item_embedding_dim}, N={RN}, batch {RB}, {rcfg.num_negatives} negatives, "
        f"{rm.num_items:,} items, float32, dropout {rm.dropout_rate} / {rm.linear_dropout_rate}; "
        f"{steps_total} steps, then an eval of {eval_batches} batches; the corpus read from its shards "
        f"through the registry (get_reco_dataset('ml-3b'), native reader)"
    )
    count_reset()
    t0 = time.perf_counter()
    rout = research.train_loop(
        dataclasses.replace(rcfg, num_epochs=1), shard_train, shard_eval,
        log_every=1, max_steps=steps_total, device="cuda",
    )
    loop_s = time.perf_counter() - t0
    n = counts()
    rtrainer = rout["trainer"]
    rlosses, rsteps = rout["losses"], rout["step_s"]
    check(len(rlosses) == steps_total and all(math.isfinite(x) for x in rlosses),
          f"research losses: {rlosses}")
    timed = sorted(1e3 * t for t in rsteps[RESEARCH_WARMUPS:])
    r_median = (timed[(RESEARCH_STEPS - 1) // 2] + timed[RESEARCH_STEPS // 2]) / 2
    r_eps = RB * RESEARCH_STEPS / sum(rsteps[RESEARCH_WARMUPS:])
    metrics = rout["history"][-1]
    corpus = int(rtrainer.all_item_ids.shape[0])
    print(
        f"  {RESEARCH_STEPS} steps after {RESEARCH_WARMUPS} warm-ups: {r_eps:.1f} examples/s, median step "
        f"{r_median:.2f} ms (min {timed[0]:.2f}, max {timed[-1]:.2f}); losses "
        f"{[round(x, 4) for x in rlosses]}; the whole loop with its eval {loop_s:.1f} s"
    )
    r_peak = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"  eval over {eval_batches * rcfg.eval_batch_size} users against the corpus' {corpus:,} items: "
        f"HR@10 {metrics['hr@10']:.4f}, HR@50 {metrics['hr@50']:.4f}, HR@1000 {metrics['hr@1000']:.4f}, "
        f"NDCG@10 {metrics['ndcg@10']:.4f}, MRR {metrics['mrr']:.6f}; launches {n}; "
        f"peak device memory {r_peak:.2f} GiB"
    )
    first, last = sum(rlosses[:3]) / 3, sum(rlosses[-3:]) / 3
    check(last <= first * 1.02, f"the research loss rises: {first:.4f} -> {last:.4f}")
    check(all(math.isfinite(v_) and 0.0 <= v_ <= 1.0 for k_, v_ in metrics.items() if k_ != "epoch"),
          f"eval metrics out of range: {metrics}")
    want_n = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
              "K6": rm.num_blocks * (steps_total + eval_batches), "K7": rm.num_blocks * steps_total}
    check(n == want_n, f"the research loop launched {n}, expected {want_n}")
    rbatch = next(batch_iterator(shard_train, RB, shuffle=True, seed=7))
    profile("research training step", lambda: rtrainer.train_step(rbatch))
    # the optimizer alone (dense AdamW over every parameter, the whole item
    # table and its two moments included), on the gradients the step left
    n_params = sum(p_.numel() for p_ in rtrainer.model.parameters())
    opt_ms = device_time_ms(rtrainer.optimizer.step, 3)
    print(f"  AdamW step over {n_params:,} parameters: {opt_ms:.2f} ms of device time")
    item_embs = rtrainer.item_embeddings()
    profile("research eval batch", lambda: rtrainer.encode_step(rbatch, item_embs))
    del rtrainer, rout, item_embs
    torch.cuda.empty_cache()

    # one training step's loss and gradients on a small research model: GPU
    # kernels vs CPU plain versions, dropout off and the negatives a function
    # of the positives (the devices' random streams differ)
    class FixedInBatchOffsets:
        """The in-batch sampler's own state, offsets a function of the
        positives and the state's count."""

        def __init__(self, sampler):
            self.sampler = sampler

        def process_batch(self, **kw):
            return self.sampler.process_batch(**kw)

        def __call__(self, gen_, state, positive_ids, num_to_sample):
            r = torch.arange(num_to_sample, device=positive_ids.device)
            offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % state.count.clamp_min(1)
            return state.ids[offsets], state.embeddings[offsets]

    def gpu_vs_cpu_step(name, cfg_, ds_, batch_, wrap, want_kernels, loss_rtol=1e-5, grad_tol=GRAD_TOL):
        """One `train_step`'s loss and every gradient of a small research
        model, weights drawn on the CPU: the card (kernels) against the CPU
        (plain versions). ``want_kernels``: the launches expected on the
        card. Returns the width the card's encoder ran at."""
        grads_, loss_, width_ = {}, {}, []
        for dev in ("cpu", "cuda"):
            st = research.ResearchTrainer(cfg_, ds_.all_item_ids(), device="cpu")
            if dev == "cuda":
                st.model.to(dev)
                st.device = torch.device(dev)
                st.all_item_ids = st.all_item_ids.to(dev)
                if isinstance(st.sampler, LocalNegativesSampler):
                    st.sampler = st.sampler._replace(all_item_ids=st.all_item_ids)
            st.sampler = wrap(st.sampler)
            before = {k_: c.count for k_, c in all_counters.items()}
            hook = st.model.encoder.register_forward_pre_hook(lambda m_, a_: width_.append(a_[0].shape[1]))
            loss = st.train_step(batch_)  # the gradients stay in .grad after the optimizer's step
            hook.remove()
            if dev == "cuda":
                got_n = {k_: c.count - before[k_] for k_, c in all_counters.items() if c.count != before[k_]}
                check(got_n == want_kernels, f"the small {name} step launched {got_n}, expected {want_kernels}")
            loss_[dev] = loss.item()
            grads_[dev] = {n_: p.grad.cpu() for n_, p in st.model.named_parameters() if p.grad is not None}
            n_params = len(list(st.model.parameters()))
        check(grads_["cpu"].keys() == grads_["cuda"].keys() and len(grads_["cpu"]) == n_params,
              f"{name}: the two devices give gradients to other parameters")
        g_err = {
            k_: (grads_["cuda"][k_] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
            for k_, g in grads_["cpu"].items()
        }
        worst_ = max(g_err, key=g_err.get)
        tables_ = [e for k_, e in g_err.items() if k_.endswith(("pos_w", "ts_w"))]
        print(
            f"  small {name}, one step, GPU kernels vs CPU plain versions: loss {loss_['cuda']:.6f} vs "
            f"{loss_['cpu']:.6f}; largest gradient error {g_err[worst_]:.3e} of the gradient's max "
            f"({worst_}" + (f"; the bias tables' largest {max(tables_):.3e}" if tables_ else "")
            + f") over {len(g_err)} parameters (tol {grad_tol}; the loss {loss_rtol} relative)"
        )
        check(abs(loss_["cuda"] - loss_["cpu"]) <= loss_rtol * abs(loss_["cpu"]), f"GPU and CPU {name} losses disagree")
        check(g_err[worst_] <= grad_tol, f"GPU and CPU {name} gradients disagree")
        check(len(width_) == 2 and width_[0] == width_[1], f"{name}: the encoder's widths {width_}")
        return width_[1]

    small_model, small_cfg, sds = small_research()
    sbatch = next(batch_iterator(sds, 8, shuffle=False))
    gpu_vs_cpu_step("research model", small_cfg, sds, sbatch, FixedNegatives, {"K6": 3, "K7": 3})

    # ------------------------------------------- bfloat16 research phase
    # the same preset with compute_dtype="bfloat16": the first block runs in
    # bfloat16 (K6-bf16, K7-bf16), the other 15 in float32 (its float32
    # output projection promotes the residual stream, as flax does), and the
    # negatives come from a bfloat16 copy of the item table
    L = rm.num_blocks
    hcfg = dataclasses.replace(rcfg, num_epochs=1, model=dataclasses.replace(rm, compute_dtype="bfloat16"))
    print(
        f"bfloat16 research phase: preset {RESEARCH_PRESET} with compute_dtype='bfloat16' (block 0 in bfloat16, "
        f"blocks 1..{L - 1} in float32; the negatives [{RB}, {RN - 1}, {rcfg.num_negatives}, {rm.item_embedding_dim}] "
        f"gathered from a bfloat16 copy of the table); {steps_total} steps, then an eval of {eval_batches} batches, "
        f"over the research phase's shards"
    )
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    t0 = time.perf_counter()
    hout = research.train_loop(hcfg, shard_train, shard_eval, log_every=1, max_steps=steps_total, device="cuda")
    loop_s = time.perf_counter() - t0
    n = counts()
    hlosses, hsteps, hmetrics = hout["losses"], hout["step_s"], hout["history"][-1]
    check(len(hlosses) == steps_total and all(math.isfinite(x) for x in hlosses), f"bfloat16 losses: {hlosses}")
    h_median = 1e3 * median(hsteps[RESEARCH_WARMUPS:])
    print(
        f"  {RESEARCH_STEPS} steps after {RESEARCH_WARMUPS} warm-ups: "
        f"{RB * RESEARCH_STEPS / sum(hsteps[RESEARCH_WARMUPS:]):.1f} examples/s, median step {h_median:.2f} ms "
        f"(float32: {r_median:.2f}); losses {[round(x, 4) for x in hlosses]}; the whole loop with its eval "
        f"{loop_s:.1f} s; eval HR@10 {hmetrics['hr@10']:.4f}, NDCG@10 {hmetrics['ndcg@10']:.4f}; launches {n}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (float32: {r_peak:.2f})"
    )
    want_n = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
              "K6": (L - 1) * (steps_total + eval_batches), "K7": (L - 1) * steps_total,
              "K6-bf16": steps_total + eval_batches, "K7-bf16": steps_total}
    check(n == want_n, f"the bfloat16 research loop launched {n}, expected {want_n}")
    check(sum(hlosses[-3:]) <= sum(hlosses[:3]) * 1.02, "the bfloat16 research loss rises")
    htrainer = hout["trainer"]
    profile("bfloat16 research training step", lambda: htrainer.train_step(rbatch))
    del htrainer, hout
    torch.cuda.empty_cache()
    small16 = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, compute_dtype="bfloat16"))
    gpu_vs_cpu_step("bfloat16 research model", small16, sds, sbatch, FixedNegatives,
                    {"K6": 2, "K7": 2, "K6-bf16": 1, "K7-bf16": 1},
                    loss_rtol=BF16_LOSS_RTOL, grad_tol=BF16_GRAD_TOL)

    # -------------------------------- bias-free bfloat16 research phase
    # the same preset with enable_relative_attention_bias=False and
    # compute_dtype="bfloat16": block 0's attention on K1-bf16 / K2-bf16, the
    # other 15 blocks' on K1 / K2, as the JAX package runs
    # hstu_mha_dense_pallas on bfloat16 and float32 under attn_kernel="pallas"
    fcfg = dataclasses.replace(rcfg, num_epochs=1, model=dataclasses.replace(
        rm, compute_dtype="bfloat16", enable_relative_attention_bias=False))
    print(
        f"bias-free bfloat16 research phase: preset {RESEARCH_PRESET} with enable_relative_attention_bias=False "
        f"and compute_dtype='bfloat16' (block 0 on K1-bf16 / K2-bf16, blocks 1..{L - 1} on K1 / K2); "
        f"{steps_total} steps, then an eval of {eval_batches} batches, over the research phase's shards"
    )
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    t0 = time.perf_counter()
    fout = research.train_loop(fcfg, shard_train, shard_eval, log_every=1, max_steps=steps_total, device="cuda")
    loop_s = time.perf_counter() - t0
    n = counts()
    flosses, fsteps, fmetrics = fout["losses"], fout["step_s"], fout["history"][-1]
    check(len(flosses) == steps_total and all(math.isfinite(x) for x in flosses), f"bias-free losses: {flosses}")
    f_median = 1e3 * median(fsteps[RESEARCH_WARMUPS:])
    print(
        f"  {RESEARCH_STEPS} steps after {RESEARCH_WARMUPS} warm-ups: "
        f"{RB * RESEARCH_STEPS / sum(fsteps[RESEARCH_WARMUPS:]):.1f} examples/s, median step {f_median:.2f} ms "
        f"(bfloat16 with the bias: {h_median:.2f}; float32: {r_median:.2f}); losses {[round(x, 4) for x in flosses]}; "
        f"the whole loop with its eval {loop_s:.1f} s; eval HR@10 {fmetrics['hr@10']:.4f}, NDCG@10 "
        f"{fmetrics['ndcg@10']:.4f}; launches {n}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    want_n = {"K1": (L - 1) * (steps_total + eval_batches), "K2": (L - 1) * steps_total, "K3": 0, "K4": 0,
              "K5": 0, "K6": 0, "K7": 0, "K1-bf16": steps_total + eval_batches, "K2-bf16": steps_total}
    check(n == want_n, f"the bias-free bfloat16 research loop launched {n}, expected {want_n}")
    check(sum(flosses[-3:]) <= sum(flosses[:3]) * 1.02, "the bias-free bfloat16 research loss rises")
    ftrainer = fout["trainer"]
    profile("bias-free bfloat16 research training step", lambda: ftrainer.train_step(rbatch))
    del ftrainer, fout
    torch.cuda.empty_cache()
    # a small bias-free bfloat16 model, GPU against CPU: its embeddings, then
    # one step's loss and gradients
    free16 = dataclasses.replace(small16, model=dataclasses.replace(small16.model, enable_relative_attention_bias=False))
    fm_cpu = research.ResearchTrainer(free16, sds.all_item_ids(), device="cpu").model
    fm_gpu = copy.deepcopy(fm_cpu).to("cuda")
    sf, _, _ = seq_features_from_row({k_: torch.as_tensor(v_) for k_, v_ in sbatch.items()},
                                     free16.model.gr_output_length + 1)
    embs = {}
    before = {k_: c.count for k_, c in all_counters.items()}
    for dev, m_ in (("cpu", fm_cpu), ("cuda", fm_gpu)):
        ids_ = sf.past_ids.to(dev)
        with torch.no_grad():
            embs[dev] = m_(sf.past_lengths.to(dev), ids_, m_.get_item_embeddings(ids_),
                           {k_: v_.to(dev) for k_, v_ in sf.past_payloads.items()}, deterministic=True).cpu()
    counts_now = {k_: c.count - before[k_] for k_, c in all_counters.items() if c.count != before[k_]}
    e_err = (embs["cuda"] - embs["cpu"]).abs().max().item()
    print(f"  small bias-free bfloat16 model, embeddings GPU kernels vs CPU plain versions: max_abs_err {e_err:.3e} "
          f"(tol {BF16_MODEL_ATOL}); launches {counts_now}")
    check(e_err <= BF16_MODEL_ATOL and counts_now == {"K1": 2, "K1-bf16": 1},
          "GPU and CPU bias-free bfloat16 embeddings disagree, or took other kernels")
    del fm_cpu, fm_gpu, embs
    gpu_vs_cpu_step("bias-free bfloat16 research model", free16, sds, sbatch, FixedNegatives,
                    {"K1": 2, "K2": 2, "K1-bf16": 1, "K2-bf16": 1},
                    loss_rtol=BF16_FREE_LOSS_RTOL, grad_tol=BF16_GRAD_TOL)

    # ------------------------------------------------------ remat phase
    # the same preset in float32, each block recomputed in the backward
    # (remat), then the sampled softmax recomputed (loss_activation_checkpoint)
    remat_ms = {}
    for label, m_over, t_over, want_k6 in (
            ("remat=True", dict(remat=True), {}, 2 * L),
            ("loss_activation_checkpoint=True", {}, dict(loss_activation_checkpoint=True), L)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        qcfg = dataclasses.replace(rcfg, model=dataclasses.replace(rm, **m_over), **t_over)
        qtrainer = research.ResearchTrainer(qcfg, shard_train.all_item_ids(), device="cuda")
        qbatches = batch_iterator(shard_train, RB, shuffle=True, seed=11)
        count_reset()
        qsteps = []
        for _ in range(REMAT_WARMUPS + REMAT_STEPS):
            qb = next(qbatches)
            t0 = time.perf_counter()
            qloss = float(qtrainer.train_step(qb))
            qsteps.append(time.perf_counter() - t0)
            check(math.isfinite(qloss), f"{label}: loss {qloss}")
        n = counts()
        nq = REMAT_WARMUPS + REMAT_STEPS
        want_n = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": want_k6 * nq, "K7": L * nq}
        check(n == want_n, f"{label}: the steps launched {n}, expected {want_n}")
        remat_ms[label] = 1e3 * median(qsteps[REMAT_WARMUPS:])
        print(
            f"{label} phase: preset {RESEARCH_PRESET} in float32, {REMAT_WARMUPS} + {REMAT_STEPS} steps of "
            f"ResearchTrainer.train_step: median step {remat_ms[label]:.2f} ms (the research phase: "
            f"{r_median:.2f}), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the research "
            f"phase: {r_peak:.2f}); launches {n}"
        )
        if m_over:
            profile("remat research training step", lambda: qtrainer.train_step(rbatch))
        del qtrainer
    torch.cuda.empty_cache()
    # one step's gradients with and without recomputation, dropout on (0.2 in
    # the preprocessor and every block), from one seed on the card
    drop_model = dict(small_model, linear_dropout_rate=0.2, dropout_rate=0.2)

    def card_step_grads(m_over, t_over):
        qcfg = research.TrainConfig(model=ModelConfig(dqk=16, dv=16, **drop_model, **m_over),
                                    local_batch_size=8, num_negatives=16, **t_over)
        st = research.ResearchTrainer(qcfg, sds.all_item_ids(), device="cuda")
        loss, _ = st.loss(research.to_device(sbatch, st.device))
        loss.backward()
        return loss.item(), {n_: p.grad.clone() for n_, p in st.model.named_parameters()}

    base_loss, base_g = card_step_grads({}, {})
    for label, m_over, t_over in (("remat", dict(remat=True), {}),
                                  ("loss checkpoint", {}, dict(loss_activation_checkpoint=True))):
        loss_q, g_q = card_step_grads(m_over, t_over)
        err = max((g_q[k_] - g).abs().max().item() / max(g.abs().max().item(), 1e-30) for k_, g in base_g.items())
        print(f"  small research model, dropout 0.2, one step on the card with {label} against without: loss "
              f"{loss_q:.7f} vs {base_loss:.7f}, largest gradient difference {err:.3e} of the gradient's max "
              f"(tol {REMAT_TOL}; K7's atomics reorder dq and the tables' sums from run to run)")
        check(g_q.keys() == base_g.keys() and abs(loss_q - base_loss) <= 1e-6 * abs(base_loss) and err <= REMAT_TOL,
              f"{label}: the recomputed step's gradients differ")
    del base_g, g_q

    # -------------------------------------------------------- SASRec phase
    acfg = dataclasses.replace(RESEARCH_PRESETS[SASREC_PRESET], num_epochs=1)
    am = acfg.model
    AB, AN = acfg.local_batch_size, am.total_seq_len
    n_eval = SASREC_EVAL_BATCHES * acfg.eval_batch_size
    print(
        f"SASRec phase: preset {SASREC_PRESET}: {am.num_blocks} blocks, {am.num_heads} heads, d={am.item_embedding_dim}, "
        f"ffn {am.ffn_hidden_dim}, N={AN}, batch {AB}, {acfg.num_negatives} negatives, {am.num_items:,} items, "
        f"float32, dropout {am.dropout_rate} / {am.linear_dropout_rate}; corpus synthetic_user_sequences_vectorized, "
        f"{SASREC_USERS} users, lengths 5..{am.max_sequence_len}, seed 2; {steps_total} steps, then an eval of "
        f"{SASREC_EVAL_BATCHES} batches ({n_eval} users) against the corpus; the negatives "
        f"[{AB}, {AN - 1}, {acfg.num_negatives}, {am.item_embedding_dim}] float32, "
        f"{AB * (AN - 1) * acfg.num_negatives * am.item_embedding_dim * 4 / 1e9:.1f} GB a pass"
    )
    t0 = time.perf_counter()
    aseqs = synthetic_user_sequences_vectorized(
        num_users=SASREC_USERS, num_items=am.num_items, max_len=am.max_sequence_len, seed=2
    )
    a_train = SequenceDataset(aseqs, am.max_sequence_len, ignore_last_n=1)
    a_eval = SequenceDataset(
        dataclasses.replace(aseqs, user_ids=aseqs.user_ids[:n_eval], item_ids=aseqs.item_ids[:n_eval],
                            ratings=aseqs.ratings[:n_eval], timestamps=aseqs.timestamps[:n_eval]),
        am.max_sequence_len, ignore_last_n=0,
    )
    print(f"  corpus made in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    t0 = time.perf_counter()
    aout = research.train_loop(acfg, a_train, a_eval, log_every=1, max_steps=steps_total, device="cuda")
    loop_s = time.perf_counter() - t0
    n = counts()
    atrainer, alosses, asteps = aout["trainer"], aout["losses"], aout["step_s"]
    check(len(alosses) == steps_total and all(math.isfinite(x) for x in alosses), f"SASRec losses: {alosses}")
    timed = sorted(1e3 * t for t in asteps[RESEARCH_WARMUPS:])
    a_median = (timed[(RESEARCH_STEPS - 1) // 2] + timed[RESEARCH_STEPS // 2]) / 2
    am_metrics = aout["history"][-1]
    print(
        f"  {RESEARCH_STEPS} steps after {RESEARCH_WARMUPS} warm-ups: "
        f"{AB * RESEARCH_STEPS / sum(asteps[RESEARCH_WARMUPS:]):.1f} examples/s, median step {a_median:.2f} ms "
        f"(min {timed[0]:.2f}, max {timed[-1]:.2f}); losses {[round(x, 4) for x in alosses]}; the whole loop "
        f"with its eval {loop_s:.1f} s"
    )
    print(
        f"  eval over {n_eval} users against the corpus' {int(atrainer.all_item_ids.shape[0]):,} items: "
        f"HR@10 {am_metrics['hr@10']:.4f}, HR@50 {am_metrics['hr@50']:.4f}, NDCG@10 {am_metrics['ndcg@10']:.4f}, "
        f"MRR {am_metrics['mrr']:.6f}; launches {n}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    check(all(c == 0 for c in n.values()), f"SASRec launched an HSTU kernel: {n}")
    check(sum(alosses[-3:]) <= sum(alosses[:3]) * 1.02, "the SASRec loss rises")
    check(all(math.isfinite(v_) and 0.0 <= v_ <= 1.0 for k_, v_ in am_metrics.items() if k_ != "epoch"),
          f"SASRec eval metrics out of range: {am_metrics}")
    abatch = next(batch_iterator(a_train, AB, shuffle=True, seed=7))
    profile("SASRec training step", lambda: atrainer.train_step(abatch))
    a_items = atrainer.item_embeddings()
    profile("SASRec eval batch", lambda: atrainer.encode_step(abatch, a_items))
    del atrainer, aout, a_items
    torch.cuda.empty_cache()
    sas_cfg = research.TrainConfig(
        model=ModelConfig(main_module="SASRec", ffn_hidden_dim=48, **small_model),
        local_batch_size=8, num_negatives=16,
    )
    gpu_vs_cpu_step("SASRec model", sas_cfg, sds, sbatch, FixedNegatives, {})

    # ------------------------- in-batch negatives, stochastic length, buckets
    bcfg = dataclasses.replace(
        RESEARCH_PRESETS[BUCKET_PRESET], sampling_strategy="in-batch",
        stochastic_length_alpha=SL_ALPHA, seq_len_buckets=LENGTH_BUCKETS,
    )
    bm = bcfg.model
    print(
        f"bucketed phase: preset {BUCKET_PRESET}: {bm.num_blocks} blocks, H={bm.num_heads}, "
        f"dqk=dv={bm.dqk}, d={bm.item_embedding_dim}, Nm={bm.total_seq_len}, batch {bcfg.local_batch_size}, "
        f"in-batch negatives ({bcfg.num_negatives} a position, deduplicated), stochastic length alpha {SL_ALPHA} "
        f"(threshold {int(bm.max_sequence_len ** (SL_ALPHA / 2))}), buckets {LENGTH_BUCKETS}; the bucketed "
        f"corpus (histories of 4..{BUCKET_MAX_LEN - 1} events); {steps_total} steps"
    )
    torch.cuda.reset_peak_memory_stats()
    btrainer = research.ResearchTrainer(bcfg, bucket_train.all_item_ids(), device="cuda")
    widths, blosses, bsteps = [], [], []
    # the width each step's encoder (and so K6 and K7) ran at, as train_step
    # cut the batch
    hook = btrainer.model.encoder.register_forward_pre_hook(lambda m_, a_: widths.append(a_[0].shape[1]))
    count_reset()
    for batch in batch_iterator(bucket_train, bcfg.local_batch_size, shuffle=True, seed=3):
        if len(blosses) == steps_total:
            break
        before = (counters["K6"].count, counters["K7"].count)
        t0 = time.perf_counter()
        blosses.append(float(btrainer.train_step(batch)))
        bsteps.append(time.perf_counter() - t0)
        step_n = (counters["K6"].count - before[0], counters["K7"].count - before[1])
        check(step_n == (bm.num_blocks, bm.num_blocks),
              f"a bucketed step launched K6, K7 {step_n} times, expected {bm.num_blocks} each")
    n = counts()
    hook.remove()
    timed = sorted(1e3 * t for t in bsteps[RESEARCH_WARMUPS:])
    b_median = (timed[(RESEARCH_STEPS - 1) // 2] + timed[RESEARCH_STEPS // 2]) / 2
    print(
        f"  widths N {widths}; {RESEARCH_STEPS} steps after {RESEARCH_WARMUPS} warm-ups: "
        f"{bcfg.local_batch_size * RESEARCH_STEPS / sum(bsteps[RESEARCH_WARMUPS:]):.1f} examples/s, median step "
        f"{b_median:.2f} ms (min {timed[0]:.2f}, max {timed[-1]:.2f}); losses {[round(x, 4) for x in blosses]}; "
        f"launches {n}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    check(len(blosses) == steps_total and all(math.isfinite(x) for x in blosses), f"bucketed losses: {blosses}")
    check(len(widths) == steps_total and all(w == N139 for w in widths),
          f"the bucketed steps did not all run at the {bucket_w} bucket's width {N139}: {widths}")
    check(n == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": bm.num_blocks * steps_total,
                "K7": bm.num_blocks * steps_total}, f"the bucketed steps launched {n}")
    bbatch = next(batch_iterator(bucket_train, bcfg.local_batch_size, shuffle=True, seed=8))
    profile("bucketed in-batch training step", lambda: btrainer.train_step(bbatch))
    ib_cfg = dataclasses.replace(small_cfg, sampling_strategy="in-batch", seq_len_buckets=(16, 40))
    ib_rows = [r for r in map(sds.get_row, range(len(sds))) if r["history_lengths"] <= 40][:8]
    ib_batch = {k_: torch.stack([torch.as_tensor(r[k_]) for r in ib_rows]).numpy() for k_ in ib_rows[0]}
    ib_w = gpu_vs_cpu_step("in-batch model under buckets (N=44, Nm=60)", ib_cfg, sds, ib_batch,
                           FixedInBatchOffsets, {"K6": 3, "K7": 3})
    check(ib_w == 40 + small_model["gr_output_length"] + 1,
          f"train_step ran the small in-batch batch (width {ib_batch['historical_ids'].shape[1]}) at {ib_w}, "
          f"not at its bucket's")

    # --------------------------------------------------- KV-cached retrieval
    cmodel = btrainer.model
    Mmax = max(CACHE_DELTAS)
    CB = CACHE_USERS
    print(
        f"KV-cached retrieval phase: the bucketed phase's model ({BUCKET_PRESET}, trained {steps_total} steps) at "
        f"its full width N={bm.total_seq_len}; {CB} users of synthetic_user_sequences_vectorized (seed 4) with "
        f"histories of at most {bm.max_sequence_len - Mmax} events; encode_with_cache(reserved_slots=M), "
        f"encode_delta of M tokens and a full re-encode, M in {CACHE_DELTAS}; then top-{TOP_K} over "
        f"{bm.num_items:,} items with each row's history ({bm.max_sequence_len} ids) filtered"
    )
    cseqs = synthetic_user_sequences_vectorized(
        num_users=CB, num_items=bm.num_items, max_len=bm.max_sequence_len + 1 - Mmax, seed=4
    )
    crow = next(batch_iterator(SequenceDataset(cseqs, bm.max_sequence_len, ignore_last_n=0), CB, shuffle=False))
    cf, c_tgt, _ = seq_features_from_row(
        {k_: torch.as_tensor(v_, device="cuda") for k_, v_ in crow.items()}, bm.gr_output_length + 1)
    c_len, c_ids, c_ts = cf.past_lengths, cf.past_ids, cf.past_payloads["timestamps"]
    check(int(c_len.max()) <= bm.max_sequence_len - Mmax and c_ids.shape[1] == bm.total_seq_len,
          "the cached batch's lengths or width")
    rows_c = torch.arange(CB, device="cuda")[:, None]
    emb_fn = cmodel.get_item_embeddings
    torch.cuda.reset_peak_memory_stats()

    def median_wall_ms(fn, reps=5):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0_))
        return sorted(walls)[reps // 2]

    with torch.no_grad():
        for M in CACHE_DELTAS:
            # the M appended tokens: the held-out target (its timestamp already
            # sits at position `length`, as the prefill needs), then M - 1
            # random items a minute apart
            d_ids = torch.cat([c_tgt, torch.randint(1, bm.num_items + 1, (CB, M - 1), device="cuda", generator=gen)], 1)
            cols_c = c_len[:, None] + torch.arange(M, device="cuda")[None, :]
            d_ts = c_ts[torch.arange(CB, device="cuda"), c_len][:, None] + 60 * torch.arange(M, device="cuda")[None, :]
            full_ids, full_ts = c_ids.clone(), c_ts.clone()
            full_ids[rows_c, cols_c], full_ts[rows_c, cols_c] = d_ids, d_ts
            count_reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, caches = cmodel.encode_with_cache(c_len, c_ids, emb_fn(c_ids), cf.past_payloads, reserved_slots=M)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n_pre = counts()
            count_reset()
            got_q, _ = cmodel.encode_delta(c_len, d_ids, emb_fn(d_ids), {"timestamps": full_ts}, caches)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_delta = counts()
            want_q = cmodel.encode(c_len + M, full_ids, emb_fn(full_ids), {"timestamps": full_ts})
            err_c = (got_q - want_q).abs()
            worst_c = (err_c / (2e-5 + 2e-4 * want_q.abs())).max().item()
            print(
                f"  M={M}: prefill {1e3 * (t1 - t0):.2f} ms, delta {1e3 * (t2 - t1):.2f} ms of host wall; delta vs "
                f"re-encode max_abs_err {err_c.max().item():.3e} ({worst_c:.3f} of rtol 2e-4 / atol 2e-5); "
                f"launches: prefill {n_pre}, delta {n_delta}"
            )
            check(bool(torch.isfinite(got_q).all()) and tuple(got_q.shape) == (CB, bm.item_embedding_dim),
                  "the delta encode's output")
            check(worst_c <= 1.0, f"M={M}: the delta encode disagrees with the full re-encode")
            zero = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K7"), 0)
            check(n_pre == {**zero, "K6": bm.num_blocks}, f"the prefill launched {n_pre}")
            check(n_delta == {**zero, "K6": 0}, f"the delta step launched {n_delta}")
            walls_c = [median_wall_ms(f_) for f_ in (
                lambda: cmodel.encode_with_cache(c_len, c_ids, emb_fn(c_ids), cf.past_payloads, reserved_slots=M),
                lambda: cmodel.encode_delta(c_len, d_ids, emb_fn(d_ids), {"timestamps": full_ts}, caches),
                lambda: cmodel.encode(c_len + M, full_ids, emb_fn(full_ids), {"timestamps": full_ts}),
            )]
            print(
                f"  M={M}, median host wall of 5 further calls: prefill {walls_c[0]:.2f} ms, delta {walls_c[1]:.2f} ms, "
                f"full re-encode {walls_c[2]:.2f} ms; the delta step below the prefill: {walls_c[1] < walls_c[0]}"
            )
        pay = cf.past_payloads
        profile("KV-cached prefill", lambda: cmodel.encode_with_cache(c_len, c_ids, emb_fn(c_ids), pay, Mmax))
        profile("KV-cached delta step", lambda: cmodel.encode_delta(
            c_len, d_ids, emb_fn(d_ids), {"timestamps": full_ts}, caches))

        # top-k over the whole item corpus, each row's history filtered
        all_ids = torch.arange(1, bm.num_items + 1, device="cuda")
        index = CandidateIndex(ids=all_ids, embeddings=maybe_l2_norm(emb_fn(all_ids), bcfg.item_l2_norm,
                                                                    bcfg.l2_norm_eps))
        invalid = c_ids[:, : bm.max_sequence_len]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        top_ids, top_s = index.get_top_k_outputs(got_q, TOP_K, invalid)
        torch.cuda.synchronize()
        topk_s = time.perf_counter() - t0
        profile("top-k with filtering", lambda: index.get_top_k_outputs(got_q, TOP_K, invalid))
        cpu_index = CandidateIndex(ids=all_ids.cpu(), embeddings=index.embeddings.cpu())
        c_top_ids, c_top_s = cpu_index.get_top_k_outputs(got_q.cpu(), TOP_K, invalid.cpu())
        s_err = (top_s.cpu() - c_top_s).abs().max().item()
        differ = (top_ids.cpu() != c_top_ids).nonzero().tolist()
        # a differing id must be a near tie: its CPU score within 1e-5 of the CPU's at that place
        tie_err = max((abs((cpu_index.embeddings[int(top_ids[b, j]) - 1] @ got_q[b].cpu()).item()
                           - c_top_s[b, j].item()) for b, j in differ), default=0.0)
        seen = bool((top_ids[:, :, None] == invalid[:, None, :]).any())
        print(
            f"  top-{TOP_K} (k'={TOP_K + invalid.shape[1]}) of {CB} queries over {bm.num_items:,} items: host wall "
            f"{1e3 * topk_s:.2f} ms; GPU vs CPU: {len(differ)} ids differ (largest near-tie gap {tie_err:.3e}), "
            f"scores max_abs_err {s_err:.3e} (tol 1e-5); a history id returned: {seen}; "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        )
        check(s_err <= 1e-5 and tie_err <= 1e-5, "GPU and CPU top-k disagree")
        check(not seen, "the top-k returned an id of the row's history")
    del btrainer, cmodel, caches, index
    torch.cuda.empty_cache()

    # --------------------------------------------------- ml-1m, end to end
    # the published archive, preprocessed by the CLI into tmp/, then the
    # large HSTU preset trained through the research CLI on the registry's
    # files, with a checkpoint
    for d_ in ("ml-1m", "processed/ml-1m", "ckpt"):
        shutil.rmtree(os.path.join(DATA_ROOT, d_), ignore_errors=True)
    os.makedirs(DATA_ROOT, exist_ok=True)
    t0 = time.perf_counter()
    write_movielens_1m_zip(os.path.join(DATA_ROOT, "movielens1m.zip"))
    t_zip = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_items = preprocess_public_data.main(["--dataset_name", "ml-1m", "--data_root", DATA_ROOT])
    t_pre = time.perf_counter() - t0
    check(n_items == ML1M_MOVIES, f"ml-1m preprocessing found {n_items} movies")
    sasrec_csv = os.path.join(DATA_ROOT, "ml-1m", "sasrec_format.csv")
    mcfg = RESEARCH_PRESETS[ML1M_PRESET]
    t0 = time.perf_counter()
    ml1m_reco = get_reco_dataset("ml-1m", mcfg.model.max_sequence_len, data_root=DATA_ROOT)
    t_load = time.perf_counter() - t0
    check(len(ml1m_reco.train_dataset) == ML1M_USERS and ml1m_reco.item_features is not None,
          "the registry's ml-1m")
    mm1 = mcfg.model
    m_steps = ML1M_USERS // mcfg.local_batch_size
    m_eval = ML1M_USERS // mcfg.eval_batch_size
    print(
        f"ml-1m phase: movielens1m.zip in the published format ({ML1M_USERS:,} users, {ML1M_RATINGS:,} ratings, "
        f"{ML1M_MOVIES:,} movies) written in {t_zip:.1f} s; preprocess_public_data --dataset_name ml-1m "
        f"{t_pre:.1f} s; get_reco_dataset('ml-1m') {t_load:.1f} s of host time; preset {ML1M_PRESET} "
        f"({mm1.num_blocks} blocks, H={mm1.num_heads}, dqk=dv={mm1.dqk}, d={mm1.item_embedding_dim}, "
        f"N={mm1.total_seq_len}, batch {mcfg.local_batch_size}) through train_research, one epoch: "
        f"{m_steps} steps and a full eval of {m_eval} batches, --ckpt_dir"
    )
    # K6 and K7 at this preset's shape (D = V = 25, H = 2, N = 211) on a
    # batch of the preprocessed data: held to their plain versions and timed
    row = next(batch_iterator(ml1m_reco.train_dataset, mcfg.local_batch_size, shuffle=True, seed=0))
    f1, _, _ = seq_features_from_row({k_: torch.as_tensor(v_, device="cuda") for k_, v_ in row.items()},
                                     mm1.gr_output_length + 1)
    l1, ts1 = f1.past_lengths.int(), f1.past_payloads["timestamps"]
    N1 = ts1.shape[1]
    q_, k_, v_, pw_, tw_, do_, a_ = relbias_case(
        f"ml-1m large preset (B={mcfg.local_batch_size}, N={N1}, H={mm1.num_heads}, D=V={mm1.dqk}), a batch of "
        f"the preprocessed ml-1m", mcfg.local_batch_size, N1, l1, ts1, Hc=mm1.num_heads, Dc=mm1.dqk, Vc=mm1.dv)
    ml1m_ms = (
        device_time_ms(lambda: hstu_mha_dense_relbias_cuda(q_, k_, v_, l1, ts1, pw_, tw_, **a_), 20),
        device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(q_, k_, v_, l1, ts1, pw_, tw_, do_, **a_), 10),
        device_time_ms(lambda: hstu_mha_dense_relbias_plain(q_, k_, v_, l1, ts1, pw_, tw_, **a_), 3),
        device_time_ms(lambda: hstu_mha_relbias_bwd_plain(q_, k_, v_, l1, ts1, pw_, tw_, do_, **a_), 2),
    )
    live1 = apply_padding_guard(make_valid_attn_mask(N1, l1), l1).sum().item()
    rows1, H1, D1 = l1.sum().item() * mm1.num_heads, mm1.num_heads, mm1.dqk
    small1 = 4 * (mcfg.local_batch_size * N1 + pw_.numel() + tw_.numel() + mcfg.local_batch_size)
    b6 = max(live1 * H1 * 4 * D1 / PEAK_3XTF32_FLOPS,
             (4 * (rows1 * 3 * D1 + mcfg.local_batch_size * N1 * H1 * D1) + small1) / PEAK_BYTES_PER_S) * 1e3
    b7 = max(live1 * H1 * 10 * D1 / PEAK_3XTF32_FLOPS,
             (4 * (rows1 * 4 * D1 + mcfg.local_batch_size * N1 * H1 * 3 * D1 + pw_.numel() + tw_.numel())
              + small1) / PEAK_BYTES_PER_S) * 1e3
    print(f"  ml-1m large preset at N={N1} (mean length {l1.float().mean().item():.1f}): K6 {ml1m_ms[0]:.4f} ms "
          f"(plain {ml1m_ms[2]:.4f}, bound {b6:.4f}), K7 {ml1m_ms[1]:.4f} ms (plain {ml1m_ms[3]:.4f}, bound {b7:.4f})")
    del ml1m_reco, q_, k_, v_, do_
    m16_case = relbias_bf16_case(
        f"ml-1m large preset (B={mcfg.local_batch_size}, N={N1}, H={mm1.num_heads}, D=V={mm1.dqk}), a batch of "
        f"the preprocessed ml-1m", mcfg.local_batch_size, N1, l1, ts1, mm1.num_heads, mm1.dqk, mm1.dv)
    *m16_times, m16_w6, m16_w7 = bf16_times(m16_case, l1, ts1, mcfg.local_batch_size, N1, mm1.num_heads,
                                            mm1.dqk, mm1.dv)
    print(f"  ml-1m large preset at N={N1} in bfloat16: K6-bf16 {m16_times[0]:.4f} ms (plain {m16_times[2]:.4f}, "
          f"bound {bound_ms(m16_w6, PEAK_BF16_FLOPS):.4f}), K7-bf16 {m16_times[1]:.4f} ms (plain "
          f"{m16_times[3]:.4f}, bound {bound_ms(m16_w7, PEAK_BF16_FLOPS):.4f})")
    del m16_case
    ml1m_name = f"ml-1m large preset (B={mcfg.local_batch_size}, N={N1}, H={mm1.num_heads}, D=V={mm1.dqk})"
    for bf16_ in (False, True):
        dq_, dk_, dv_, dpw_, dtw_, ddo_, da_ = det_case(
            f"{ml1m_name}, a batch of the preprocessed ml-1m", mcfg.local_batch_size, N1, l1, ts1,
            Hc=mm1.num_heads, Dc=mm1.dqk, Vc=mm1.dv, bf16=bf16_)
        t7 = device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(dq_, dk_, dv_, l1, ts1, dpw_, dtw_, ddo_, **da_), 10)
        t7d = device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(
            dq_, dk_, dv_, l1, ts1, dpw_, dtw_, ddo_, deterministic=True, **da_), 10)
        label_ = "K7-det-bf16 against K7-bf16" if bf16_ else "K7-det against K7"
        print(f"  {ml1m_name}: {label_} {t7d:.4f} ms against {t7:.4f} ms in this call ({t7d / t7:.2f}x)")
        del dq_, dk_, dv_, ddo_
    ck_research = os.path.join(DATA_ROOT, "ckpt", "ml-1m-research")
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    t0 = time.perf_counter()
    mout = train_research.main(["--preset", ML1M_PRESET, "--num_epochs", "1", "--ckpt_dir", ck_research,
                                "--device", "cuda"])
    m_wall = time.perf_counter() - t0
    n = counts()
    mlosses, msteps, mmetrics = mout["losses"], mout["step_s"], mout["history"][-1]
    m_med = 1e3 * median(msteps[RESEARCH_WARMUPS:])
    print(
        f"  {len(msteps)} steps: {mcfg.local_batch_size * (len(msteps) - RESEARCH_WARMUPS) / sum(msteps[RESEARCH_WARMUPS:]):.1f} "
        f"examples/s after {RESEARCH_WARMUPS} warm-ups, median step {m_med:.2f} ms; loss {mlosses[0]:.4f} -> "
        f"{mlosses[-1]:.4f}; eval HR@10 {mmetrics['hr@10']:.4f}, NDCG@10 {mmetrics['ndcg@10']:.4f}, MRR "
        f"{mmetrics['mrr']:.5f}; the CLI's wall time {m_wall:.1f} s; launches {n}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    check(len(mlosses) == m_steps and all(math.isfinite(x) for x in mlosses), f"ml-1m losses: {mlosses}")
    check(sum(mlosses[-5:]) < sum(mlosses[:5]), "the ml-1m loss does not fall")
    want_n = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
              "K6": mm1.num_blocks * (m_steps + m_eval), "K7": mm1.num_blocks * m_steps}
    check(n == want_n, f"the ml-1m run launched {n}, expected {want_n}")
    saved = restore_checkpoint(ck_research, "cuda")
    diff = tree_difference(saved, mout["trainer"].checkpoint_state())
    print(f"  checkpoint {ck_research}/1.pt restored: every tensor bit-equal to the trainer's: {not diff}")
    check(not diff, f"the restored research checkpoint differs from the trainer's state at {diff}")
    m_trainer = mout["trainer"]
    profile("ml-1m research training step", lambda: m_trainer.train_step(row))
    del mout, saved, m_trainer
    torch.cuda.empty_cache()

    # ------------------------------------------ deterministic research phase
    # in a process of its own, the only one with CUBLAS_WORKSPACE_CONFIG set
    # (torch.use_deterministic_algorithms needs it before the process's first
    # cuBLAS call): every other phase's GEMMs keep cuBLAS's default workspace
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2**30
    sys.stdout.flush()
    try:
        det = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "det", repr(m_med), repr(r_median)],
            env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": DET_CUBLAS_WORKSPACE},
            capture_output=True, text=True, timeout=DET_TIMEOUT,
        )
    except subprocess.TimeoutExpired:
        fail(f"the deterministic research phase ran past {DET_TIMEOUT} s")
    report, _, result = det.stdout.partition("DET_RESULT ")
    print(report, end="")
    check(det.returncode == 0 and result, f"the deterministic research phase exited {det.returncode}:\n"
          f"{det.stderr[-3000:]}")
    print(f"  (its own process; this one held {held:.2f} GiB of device memory meanwhile)")
    for k_, n_ in json.loads(result.splitlines()[0]).items():
        main_path_launches[k_] += n_

    # ---------------------------------------------- attention dropout phase
    # the ml-1m large preset with attn_dropout_rate 0.2 on the registry's
    # files: a training step takes the plain composite (no kernel has
    # dropout: 0 K6 / K7), its eval K6 (8 a batch)
    acfg = dataclasses.replace(mcfg, model=dataclasses.replace(mm1, attn_dropout_rate=ATTN_DROPOUT))
    a_reco = get_reco_dataset("ml-1m", mm1.max_sequence_len, data_root=DATA_ROOT)
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    aout = research.train_loop(acfg, a_reco.train_dataset, a_reco.eval_dataset, log_every=10,
                               max_steps=RESEARCH_WARMUPS + DROPOUT_STEPS, device="cuda")
    n = counts()
    alosses, asteps = aout["losses"], aout["step_s"]
    a_med = 1e3 * median(asteps[RESEARCH_WARMUPS:])
    print(
        f"attention dropout phase: preset {ML1M_PRESET} with attn_dropout_rate {ATTN_DROPOUT}, "
        f"{RESEARCH_WARMUPS} + {DROPOUT_STEPS} steps through train_loop and a full eval ({m_eval} batches): "
        f"{mcfg.local_batch_size * DROPOUT_STEPS / sum(asteps[RESEARCH_WARMUPS:]):.1f} examples/s, median step "
        f"{a_med:.2f} ms (without attention dropout, the ml-1m phase: {m_med:.2f}); loss {alosses[0]:.4f} -> "
        f"{alosses[-1]:.4f}; eval HR@10 {aout['history'][-1]['hr@10']:.4f}; launches {n}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    check(len(alosses) == RESEARCH_WARMUPS + DROPOUT_STEPS and all(math.isfinite(x) for x in alosses),
          f"attention dropout losses: {alosses}")
    check(n == {**dict.fromkeys(n, 0), "K6": mm1.num_blocks * m_eval},
          f"the attention dropout run launched {n}, expected K6 = {mm1.num_blocks * m_eval} (its eval) and nothing else")
    a_trainer = aout["trainer"]
    a_batch = next(batch_iterator(a_reco.train_dataset, mcfg.local_batch_size, shuffle=True, seed=1))
    profile("attention dropout training step", lambda: a_trainer.train_step(a_batch))
    del aout, a_trainer, a_reco
    torch.cuda.empty_cache()

    # ------------------------------------------------- position-only bias
    # the encoder without timestamps: K6 / K7 on zero timestamps and a
    # one-entry time table (num_buckets 0) at the ml-1m shape against their
    # plain versions, then a small encoder's forward and every gradient, the
    # card against the CPU
    zero_ts = torch.zeros_like(ts1)
    pq_, pk_, pv_, ppw_, ptw_, pdo_, pa_ = relbias_case(
        f"position-only bias, ml-1m large preset (B={mcfg.local_batch_size}, N={N1}, H={mm1.num_heads}, "
        f"D=V={mm1.dqk}), zero timestamps, num_buckets 0", mcfg.local_batch_size, N1, l1, zero_ts,
        nb=0, Hc=mm1.num_heads, Dc=mm1.dqk, Vc=mm1.dv)
    pos_ms = (device_time_ms(lambda: hstu_mha_dense_relbias_cuda(pq_, pk_, pv_, l1, zero_ts, ppw_, ptw_, **pa_), 20),
              device_time_ms(lambda: hstu_mha_relbias_bwd_cuda(pq_, pk_, pv_, l1, zero_ts, ppw_, ptw_, pdo_, **pa_), 10))
    print(f"  position-only K6 {pos_ms[0]:.4f} ms, K7 {pos_ms[1]:.4f} ms (with timestamps at this shape: "
          f"{ml1m_ms[0]:.4f}, {ml1m_ms[1]:.4f})")
    del pq_, pk_, pv_, pdo_
    enc_kw = dict(embedding_dim=32, num_blocks=3, num_heads=2, attention_dim=16, linear_dim=16,
                  linear_dropout_rate=0.0, max_total_seq_len=64)
    penc = HSTUEncoder(**enc_kw, gen=torch.Generator().manual_seed(13))
    prng = np.random.default_rng(13)
    px = prng.standard_normal((8, 60, 32)).astype(np.float32) * 0.3
    plen = prng.integers(1, 61, size=8)
    pw = prng.standard_normal((8, 60, 32)).astype(np.float32)
    p_out, p_grads = {}, {}
    for dev in ("cpu", "cuda"):
        penc.to(dev).zero_grad(set_to_none=True)
        to = lambda a__: torch.as_tensor(a__, device=dev)  # noqa: E731
        before = {k_: c.count for k_, c in all_counters.items()}
        o_ = penc(to(px), to(plen), None, deterministic=True)
        (o_ * to(pw) * (torch.arange(60, device=dev)[None, :] < to(plen)[:, None])[:, :, None]).sum().backward()
        if dev == "cuda":
            got_n = {k_: c.count - before[k_] for k_, c in all_counters.items() if c.count != before[k_]}
            check(got_n == {"K6": 3, "K7": 3}, f"the position-only encoder launched {got_n}")
        valid_ = torch.arange(60)[None, :] < torch.as_tensor(plen)[:, None]
        p_out[dev] = o_.detach().to("cpu", copy=True)[valid_]
        p_grads[dev] = {k_: p.grad.to("cpu", copy=True) for k_, p in penc.named_parameters() if p.grad is not None}
    p_err = (p_out["cuda"] - p_out["cpu"]).abs().max().item() / p_out["cpu"].abs().max().item()
    pg_err = max((p_grads["cuda"][k_] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                 for k_, g in p_grads["cpu"].items())
    print(f"  small position-only encoder (3 blocks, N=60), GPU kernels vs CPU plain versions: output {p_err:.3e} "
          f"of its max (tol {PRED_TOL}), gradients {pg_err:.3e} of their max over {len(p_grads['cpu'])} parameters "
          f"(tol {GRAD_TOL}; the time tables get none)")
    check(p_grads["cpu"].keys() == p_grads["cuda"].keys() and not any(k_.endswith("ts_w") for k_ in p_grads["cpu"]),
          "the position-only encoder's gradients go to other parameters on the two devices")
    check(p_err <= PRED_TOL and pg_err <= GRAD_TOL, "GPU and CPU position-only encoders disagree")
    del penc, p_out, p_grads

    # ------------------------------------------------------------ MoL phase
    # the same preset with the learned MoL similarity (default MoLConfig:
    # 4 x 4 components of width 32, the three gating MLPs) and its
    # load-balancing loss, one epoch on the registry's ml-1m and a full MoL
    # eval; then MoL top-k through the candidate index
    lcfg = dataclasses.replace(mcfg, num_epochs=1, loss_weights=(("mi_loss", 0.001),),
                               model=dataclasses.replace(mm1, interaction_module_type="MoL"))
    mol_reco = get_reco_dataset("ml-1m", mm1.max_sequence_len, data_root=DATA_ROOT)
    LB, LN, LR = lcfg.local_batch_size, mm1.total_seq_len, lcfg.num_negatives
    print(
        f"MoL phase: preset {ML1M_PRESET} with interaction_module_type='MoL' (the default MoLConfig), "
        f"loss_weights mi_loss 0.001, one epoch through train_loop on the registry's ml-1m ({m_steps} steps) and "
        f"a full MoL eval ({m_eval} batches, chunks of {lcfg.eval_item_chunk_size} items); the item side over "
        f"B (N - 1) (1 + R) = {LB * (LN - 1) * (1 + LR):,} rows a step"
    )
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    t0 = time.perf_counter()
    lout = research.train_loop(lcfg, mol_reco.train_dataset, mol_reco.eval_dataset, log_every=10, device="cuda")
    l_wall = time.perf_counter() - t0
    n = counts()
    llosses, lsteps, lmetrics = lout["losses"], lout["step_s"], lout["history"][-1]
    l_med = 1e3 * median(lsteps[RESEARCH_WARMUPS:])
    print(
        f"  {len(lsteps)} steps: {LB * (len(lsteps) - RESEARCH_WARMUPS) / sum(lsteps[RESEARCH_WARMUPS:]):.1f} "
        f"examples/s after {RESEARCH_WARMUPS} warm-ups, median step {l_med:.2f} ms (without MoL, the ml-1m "
        f"phase: {m_med:.2f}); loss {llosses[0]:.4f} -> {llosses[-1]:.4f}; eval HR@10 {lmetrics['hr@10']:.4f}, "
        f"NDCG@10 {lmetrics['ndcg@10']:.4f}, MRR {lmetrics['mrr']:.5f}; the loop's wall time {l_wall:.1f} s; "
        f"launches {n}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    check(len(llosses) == m_steps and all(math.isfinite(x) for x in llosses), f"MoL losses: {llosses}")
    check(sum(llosses[-5:]) < sum(llosses[:5]), "the MoL loss does not fall")
    check(all(math.isfinite(v_) and 0.0 <= v_ <= 1.0 for k_, v_ in lmetrics.items() if k_ != "epoch"),
          f"MoL eval metrics out of range: {lmetrics}")
    want_n = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
              "K6": mm1.num_blocks * (m_steps + m_eval), "K7": mm1.num_blocks * m_steps}
    check(n == want_n, f"the MoL run launched {n}, expected {want_n}")
    l_trainer = lout["trainer"]
    profile("MoL training step", lambda: l_trainer.train_step(row))
    l_items = l_trainer.item_embeddings()
    profile("MoL eval batch", lambda: l_trainer.encode_step(row, l_items))
    # MoL top-k of 128 users' queries over the corpus, each row's history
    # filtered, through the candidate index; against the same on the CPU
    urow = next(batch_iterator(mol_reco.eval_dataset, CACHE_USERS, shuffle=False))
    uf, _, _ = seq_features_from_row({k_: torch.as_tensor(v_, device="cuda") for k_, v_ in urow.items()},
                                     mm1.gr_output_length + 1)
    with torch.no_grad():
        lq = l_trainer.model.encode(uf.past_lengths, uf.past_ids, l_trainer.model.get_item_embeddings(uf.past_ids),
                                    uf.past_payloads)
    lids = l_trainer.all_item_ids
    l_topk = MoLBruteForceTopK(l_trainer.model, lids, l_items, item_chunk_size=lcfg.eval_item_chunk_size)
    l_index = CandidateIndex(ids=lids, embeddings=l_items)
    linvalid = uf.past_ids
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top_ids, top_s = l_index.get_top_k_outputs(lq, TOP_K, linvalid, top_k_module=l_topk)
    torch.cuda.synchronize()
    ltopk_s = time.perf_counter() - t0
    profile("MoL top-k with filtering", lambda: l_index.get_top_k_outputs(lq, TOP_K, linvalid, top_k_module=l_topk))
    cpu_model = copy.deepcopy(l_trainer.model).cpu()
    c_topk = MoLBruteForceTopK(cpu_model, lids.cpu(), l_items.cpu(), item_chunk_size=lcfg.eval_item_chunk_size)
    c_index = CandidateIndex(ids=lids.cpu(), embeddings=l_items.cpu())
    c_top_ids, c_top_s = c_index.get_top_k_outputs(lq.cpu(), TOP_K, linvalid.cpu(), top_k_module=c_topk)
    c_scores = c_topk.scores(lq.cpu())
    col = l_trainer._id_to_col.cpu()
    s_scale = c_top_s.abs().max().item()
    s_err = (top_s.cpu() - c_top_s).abs().max().item()
    differ = (top_ids.cpu() != c_top_ids).nonzero().tolist()
    # a differing id must be a near tie: its CPU score within the tolerance of the CPU's at that place
    tie_err = max((abs(c_scores[b, col[int(top_ids[b, j])]].item() - c_top_s[b, j].item()) for b, j in differ),
                  default=0.0)
    seen = bool((top_ids[:, :, None] == linvalid[:, None, :]).any())
    print(
        f"  MoL top-{TOP_K} (k'={TOP_K + linvalid.shape[1]}) of {CACHE_USERS} queries over {int(lids.shape[0]):,} "
        f"items: host wall {1e3 * ltopk_s:.2f} ms; GPU vs CPU: {len(differ)} ids differ (largest near-tie gap "
        f"{tie_err:.3e}), scores max_abs_err {s_err:.3e} (tol 1e-5 of the largest score, {s_scale:.3e}); a "
        f"history id returned: {seen}"
    )
    check(s_err <= 1e-5 * s_scale and tie_err <= 1e-5 * s_scale, "GPU and CPU MoL top-k disagree")
    check(not seen, "the MoL top-k returned an id of the row's history")
    del lout, l_trainer, l_items, l_topk, l_index, cpu_model, c_topk, mol_reco
    torch.cuda.empty_cache()
    # one MoL step on a small model, GPU kernels vs CPU plain versions
    small_mol = dataclasses.replace(small_cfg, loss_weights=(("mi_loss", 0.001),),
                                    model=dataclasses.replace(small_cfg.model, interaction_module_type="MoL"))
    gpu_vs_cpu_step("MoL research model", small_mol, sds, sbatch, FixedNegatives, {"K6": 3, "K7": 3})

    # ------------------------------------------- ranker on movielens-1m
    ck_ranker = os.path.join(DATA_ROOT, "ckpt", "ml-1m-ranker")
    rk_common = ["--dataset", "movielens-1m", "--data_file", sasrec_csv, "--device", "cuda"]
    mr_cfg = get_hstu_configs("movielens-1m")
    L_mr = mr_cfg.hstu_attn_num_layers
    print(
        f"movielens-1m ranker phase: train_ranker's defaults (hash 100,000, uih {mr_cfg.max_uih_len} + "
        f"{mr_cfg.max_num_candidates} candidates, batch 32), {L_mr} layers, H={mr_cfg.hstu_num_heads}, "
        f"qk=v={mr_cfg.hstu_attn_qk_dim}, d_model {mr_cfg.hstu_transducer_embedding_dim}, table dim "
        f"{mr_cfg.hstu_embedding_table_dim}; {RANKER_STEPS} steps with --ckpt_dir, then --mode eval over "
        f"{RANKER_EVAL_BATCHES} batches, then inference.main --accuracy from the checkpoint; the checkpoint "
        f"restored bit-equal to the trainer's parameters"
    )
    count_reset()
    rk_out = train_ranker.main(rk_common + ["--num_batches", str(RANKER_STEPS), "--ckpt_dir", ck_ranker])
    n = counts()
    check(len(rk_out["losses"]) == RANKER_STEPS and all(math.isfinite(x) for x in rk_out["losses"]),
          f"movielens-1m ranker losses {rk_out['losses']}")
    check(n == {"K1": L_mr * RANKER_STEPS, "K2": L_mr * RANKER_STEPS, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0},
          f"the movielens-1m ranker's steps launched {n}")
    rk_trainer = rk_out.pop("trainer")
    diff = tree_difference(restore_checkpoint(ck_ranker, "cuda"), rk_trainer.model.state_dict())
    check(not diff, f"the restored ranker checkpoint differs from the trainer's parameters at {diff}")
    rk_batch = to_device(next(make_dlrm_batches("movielens-1m", rk_trainer.hstu_cfg, data_file=sasrec_csv,
                                                hash_size=100_000, batch_size=32, num_batches=1)),
                         rk_trainer.device)
    profile("movielens-1m ranker training step", lambda: rk_trainer.train_step(rk_batch))
    del rk_trainer, rk_batch
    print(
        f"  train: {rk_out['examples_per_s']:.1f} examples/s, median step {1e3 * median(rk_out['step_s'][2:]):.2f} ms, "
        f"loss {rk_out['losses'][0]:.4f} -> {rk_out['losses'][-1]:.4f}, metrics "
        f"{ {k: round(v, 5) for k, v in rk_out['metrics'].items()} }; launches {n}"
    )
    count_reset()
    rk_eval = train_ranker.main(rk_common + ["--mode", "eval", "--num_batches", str(RANKER_EVAL_BATCHES),
                                             "--ckpt_dir", ck_ranker])["metrics"]
    n = counts()
    check(n == {"K1": L_mr * RANKER_EVAL_BATCHES, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0},
          f"train_ranker --mode eval launched {n}")
    print(f"  --mode eval from the checkpoint: { {k: round(v, 5) for k, v in rk_eval.items()} }; launches {n}")
    serve_args = rk_common + [
        "--accuracy", "--hash_size", "100000", "--max_uih_len", str(mr_cfg.max_uih_len),
        "--max_num_candidates", str(mr_cfg.max_num_candidates), "--batch_size", "32",
        "--num_qsl_batches", str(ACC_QSL_BATCHES), "--num_warmups", "2",
    ]
    acc, logs = {}, {}
    mr_chunks = -(-mr_cfg.max_num_candidates // mr_cfg.max_num_candidates_inference)
    predicts = 2 + ACC_QSL_BATCHES
    for name_, extra in (("checkpoint, int8 tables (as served)", ["--ckpt_dir", ck_ranker]),
                         ("checkpoint, float tables", ["--ckpt_dir", ck_ranker, "--no_quantize"]),
                         ("checkpoint, M-FALCON", ["--ckpt_dir", ck_ranker, "--mfalcon"]),
                         ("fresh weights, int8 tables", [])):
        log_path = os.path.join(DATA_ROOT, "ckpt", f"accuracy_{len(acc)}.json")
        count_reset()
        acc[name_] = serve.main(serve_args + extra + ["--accuracy_log", log_path])
        n = counts()
        mf = "--mfalcon" in extra
        want_n = {"K1": L_mr * predicts, "K2": 0, "K3": 0, "K4": 0,
                  "K5": L_mr * mr_chunks * predicts if mf else 0, "K6": 0, "K7": 0}
        check(n == want_n, f"accuracy serving ({name_}) launched {n}, expected {want_n}")
        with open(log_path) as f_:
            logs[name_] = np.asarray([x for r in json.load(f_) for x in r["data"]], dtype=np.float64)
        print(f"  inference.main --accuracy, {name_}: { {k: round(v, 5) for k, v in acc[name_].items()} }; "
              f"launches K1 {n['K1']}, K5 {n['K5']} over {predicts} predicts")
        check(logs[name_].size == ACC_QSL_BATCHES * 32 * mr_cfg.max_num_candidates
              and np.isfinite(logs[name_]).all(), f"accuracy log of {name_}")
    mf_err = np.abs(logs["checkpoint, float tables"] - logs["checkpoint, M-FALCON"]).max()
    print(f"  dense vs M-FALCON predictions (float tables, {logs['checkpoint, M-FALCON'].size} scores): "
          f"max_abs_diff {mf_err:.3e} (tol {PRED_TOL})")
    check(mf_err <= PRED_TOL, "dense and M-FALCON accuracy predictions disagree")
    # the same 8 batches in file order, the model's float tables: accuracy
    # mode and --mode eval compute the same predictions
    acc_f = acc["checkpoint, float tables"]
    eval_gap = max(abs(acc_f[k] - rk_eval[k]) / max(abs(rk_eval[k]), 1e-12) for k in rk_eval)
    print(f"  accuracy mode (float tables) against --mode eval on the same batches: largest relative "
          f"difference of a metric {eval_gap:.3e} (tol 1e-4)")
    check(acc_f.keys() == rk_eval.keys() and eval_gap <= 1e-4, "accuracy mode and --mode eval disagree")
    torch.cuda.empty_cache()

    # ------------------------------------------------------- KuaiRand-1K
    kuai_root = os.path.join(DATA_ROOT, "KuaiRand-1K")
    shutil.rmtree(kuai_root, ignore_errors=True)
    t0 = time.perf_counter()
    write_kuairand_1k(DATA_ROOT, KUAI_EVENTS_PER_FILE)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    kuai_csv = preprocess_dlrm_data.main(["--dataset", "kuairand-1k", "--data_path", DATA_ROOT, "--skip_download"])
    t_pre = time.perf_counter() - t0
    kr_cfg = get_hstu_configs("kuairand-1k")
    print(
        f"KuaiRand-1K phase: the published logs' format, {KUAI_USERS} users x {2 * KUAI_EVENTS_PER_FILE} events "
        f"(cut from ~11.7 million events in all) written in {t_write:.1f} s; preprocess_dlrm_data --skip_download "
        f"{t_pre:.1f} s of host time; train_ranker --dataset kuairand-1k, {RANKER_STEPS} steps, "
        f"{len(kr_cfg.multitask_configs)} tasks, {len(get_embedding_table_config('kuairand-1k'))} tables"
    )
    count_reset()
    kr_out = train_ranker.main(["--dataset", "kuairand-1k", "--data_file", kuai_csv, "--device", "cuda",
                                "--num_batches", str(RANKER_STEPS)])
    n = counts()
    L_kr = kr_cfg.hstu_attn_num_layers
    check(len(kr_out["losses"]) == RANKER_STEPS and all(math.isfinite(x) for x in kr_out["losses"]),
          f"KuaiRand losses {kr_out['losses']}")
    check(n == {"K1": L_kr * RANKER_STEPS, "K2": L_kr * RANKER_STEPS, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0},
          f"the KuaiRand steps launched {n}")
    check(len([k for k in kr_out["metrics"] if k.endswith("/ne")]) == 8, f"KuaiRand metrics {kr_out['metrics']}")
    print(
        f"  {kr_out['examples_per_s']:.1f} examples/s, median step {1e3 * median(kr_out['step_s'][2:]):.2f} ms, "
        f"loss {kr_out['losses'][0]:.4f} -> {kr_out['losses'][-1]:.4f}; NE per task "
        f"{ {k.split('/')[0]: round(v, 4) for k, v in kr_out['metrics'].items() if k.endswith('/ne')} }; "
        f"launches {n}"
    )
    torch.cuda.empty_cache()

    # -------------------------------------------------- distribution phase
    shutil.rmtree(os.path.join(DATA_ROOT, "dist"), ignore_errors=True)
    os.makedirs(os.path.join(DATA_ROOT, "dist"))
    torch.cuda.empty_cache()
    n_dist = DIST_WARMUPS + DIST_STEPS
    print(
        f"distribution phase: ranks as processes on free ports of 127.0.0.1, {n_dist} steps each "
        f"({DIST_WARMUPS} + {DIST_STEPS}); (a) one rank over NCCL; (b)-(d) two ranks on this one card over "
        f"gloo, which runs all_reduce, all_gather and all_to_all_single on CUDA tensors itself (staging them "
        f"through the host; the port stages none itself). Times of two ranks are '2 ranks on one H100 over "
        f"gloo': the ranks share one card, so they are not multi-GPU numbers"
    )
    dist_args = ["--device", "cuda", "--max_uih_len", str(TRAIN_UIH), "--max_num_candidates", str(TRAIN_CANDS),
                 "--batch_size", str(B), "--hash_size", str(HASH_SIZE), "--num_batches", str(n_dist)]

    def dist_counts(results):
        """Every rank's launches, added to the main paths' totals."""
        for res in results:
            for k_, n_ in res["counts"].items():
                if n_:
                    main_path_launches[k_] += n_
        return [{k_: n_ for k_, n_ in res["counts"].items() if n_} for res in results]

    def dist_report(name, results):
        for res in results:
            ms = sorted(1e3 * t_ for t_ in res["step_s"][DIST_WARMUPS:])
            print(f"  {name}, rank {res['rank']} of {res['world']} ({res['backend']}): median step "
                  f"{median(ms):.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), peak {res['peak_gib']:.2f} GiB, "
                  f"tables {res['tables']}, loss {res['losses'][0]:.5f} -> {res['losses'][-1]:.5f}, launches "
                  f"{ {k_: n_ for k_, n_ in res['counts'].items() if n_} }")
            print(res.get("profile", ""), end="")

    want_tr = {"K1": L_tr * n_dist, "K2": L_tr * n_dist}
    one = run_ranks("nccl_1x1", lambda r, port: ["cli", "train_ranker", *dist_args, "--distributed", "--coordinator",
                                                  f"127.0.0.1:{port}", "--num_processes", "1", "--process_id",
                                                  str(r), "--mesh", "1x1"], 1)
    dist_report("(a) train_ranker --mesh 1x1, one rank over NCCL", one)
    check(one[0]["backend"] == "nccl" and dist_counts(one) == [want_tr], f"(a) launched {one[0]['counts']}")
    check(all(math.isfinite(x) for x in one[0]["losses"]), f"(a) losses {one[0]['losses']}")
    two = run_ranks("gloo_1x2", lambda r, port: ["cli", "train_ranker", *dist_args, "--distributed", "--coordinator",
                                                  f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
                                                  str(r), "--mesh", "1x2", "--dist_backend", "gloo"], 2)
    dist_report("(b) train_ranker --mesh 1x2, 2 ranks on one H100 over gloo", two)
    check(all(res["backend"] == "gloo" for res in two) and dist_counts(two) == [want_tr, want_tr],
          f"(b) launched {[res['counts'] for res in two]}")
    check(all(shape == [HASH_SIZE // 2, tcfg.hstu_embedding_table_dim] for res in two
              for shape in res["tables"].values()), f"(b) table shards {[res['tables'] for res in two]}")
    check(two[0]["losses"] == two[1]["losses"] and all(math.isfinite(x) for x in two[0]["losses"]),
          "(b) the ranks report different or non-finite global losses")

    # (c), (d): a 1 x 2 mesh against one rank on the same global batches
    work = os.path.join(DATA_ROOT, "dist")
    rcfg, ptables, pcfg = parity_configs()
    ref = DlrmTrainer(rcfg, ptables, DlrmTrainConfig(), device="cuda", seed=3)
    save_checkpoint(os.path.join(work, "ranker_init"), ref.model.state_dict(), 0)
    pbatches = list(make_dlrm_batches("debug", rcfg, hash_size=PARITY_HASH, batch_size=PARITY_BATCH, num_batches=2,
                                      seed=4))
    torch.save(pbatches, os.path.join(work, "ranker_batches.pt"))
    ref_r = ([ref.train_step(to_device(b, ref.device))[0].item() for b in pbatches],
             {k_: v_.cpu() for k_, v_ in ref.model.state_dict().items()})
    pseqs = synthetic_user_sequences(num_users=64, num_items=PARITY_ITEMS, max_len=40, min_len=2, seed=5)
    pds = SequenceDataset(pseqs, 40, ignore_last_n=1)
    sref = research.ResearchTrainer(pcfg, pds.all_item_ids(), device="cuda")
    torch.save(dict(state={k_: v_.cpu() for k_, v_ in sref.model.state_dict().items()}, ids=pds.all_item_ids()),
               os.path.join(work, "research_init.pt"))
    rbatches = list(itertools.islice(batch_iterator(pds, PARITY_BATCH, shuffle=True, seed=6), 2))
    torch.save(rbatches, os.path.join(work, "research_batches.pt"))
    sref.sampler = FixedNegatives(sref.sampler)
    ref_s = ([sref.train_step(b).item() for b in rbatches],
             {k_: v_.cpu() for k_, v_ in sref.model.state_dict().items()})
    del ref, sref
    par = run_ranks("parity_1x2", lambda r, port: ["parity", str(port), str(r), work], 2)
    dist_counts(par)
    got = torch.load(os.path.join(work, "parity.pt"))
    for name, (want_l, want_p), what in (("ranker", ref_r, "(c) a small ranker, dropout off"),
                                         ("research", ref_s, "(d) a small research model, negatives injected")):
        got_l, got_p = got[name]
        l_err = max(abs(a - b) / abs(b) for a, b in zip(got_l, want_l))
        p_err = max(((got_p[k_] - w_).abs() - MESH_PARAM_TOL["rtol"] * w_.abs()).max().item()
                    for k_, w_ in want_p.items())
        print(f"  {what}: 1 x 2 mesh over gloo vs one rank, 2 steps: losses {got_l} vs {want_l}, largest relative "
              f"error {l_err:.3e} (tol {MESH_LOSS_RTOL}); parameters' largest |error| - rtol |want| {p_err:.3e} "
              f"(atol {MESH_PARAM_TOL['atol']})")
        check(got_p.keys() == want_p.keys() and l_err <= MESH_LOSS_RTOL and p_err <= MESH_PARAM_TOL["atol"],
              f"{what}: the mesh and one rank disagree")
    check(par[0]["sharded"] == ["embedding_module.item_emb"]
          and all(shape == [PARITY_HASH // 2, 16] for shape in par[0]["tables"].values()),
          f"(c), (d): the shards {par[0]['tables']}, {par[0]['sharded']}")

    # (d) train_research --distributed on the ml-1m phase's files
    m_blocks = RESEARCH_PRESETS[ML1M_PRESET].model.num_blocks
    m_eval_batches = ML1M_USERS // RESEARCH_PRESETS[ML1M_PRESET].eval_batch_size
    rs = run_ranks("research_gloo_2", lambda r, port: [
        "cli", "train_research", "--preset", ML1M_PRESET, "--num_epochs", "1", "--max_steps", str(n_dist),
        "--device", "cuda", "--distributed", "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
        "--process_id", str(r), "--dist_backend", "gloo"], 2)
    dist_report(f"(d) train_research --distributed, {ML1M_PRESET}, 2 ranks on one H100 over gloo", rs)
    want_rs = {"K6": m_blocks * (n_dist + m_eval_batches), "K7": m_blocks * n_dist}
    check(dist_counts(rs) == [want_rs, want_rs], f"(d) launched {[res['counts'] for res in rs]}, expected {want_rs}")
    check(rs[0]["history"] == rs[1]["history"] and 0.0 <= rs[0]["history"][-1]["hr@10"] <= 1.0,
          f"(d) the ranks' evals {[res['history'] for res in rs]}")
    print(f"  (d) full eval of {m_eval_batches} global batches: { {k_: round(v_, 4) for k_, v_ in rs[0]['history'][-1].items()} }")

    # --------------------------------------------------------------- report
    peaks = {PEAK_F32_FLOPS: "float32 FMA, 67e12", PEAK_3XTF32_FLOPS: "3xTF32, 495e12 / 3",
             PEAK_BF16_FLOPS: "bfloat16, 989e12 (the kernel multiplies with one exact TF32 product, at half)"}

    def entry(name, src, replaces, launches, err, ms, plain_ms, flops, nbytes, peak=PEAK_F32_FLOPS):
        """``peak``: the rate the kernel's operations are held to, float32
        FMA for a kernel outside the tensor cores, a third of dense TF32 for
        a 3xTF32 one, dense bfloat16 for a kernel on bfloat16 operands (the
        card's rate for the type, whatever product the kernel takes)."""
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "operations_ms": t_ops, "bytes_ms": t_bytes,
            "operations_peak": peaks[peak],
            # no single PyTorch call computes masked silu attention, with or
            # without the relative bias, or its backward
            "library_ms": None,
        }

    src = "generative_recommenders_tpu_torch/csrc/"
    tpu = "generative_recommenders_tpu/ops/pallas/hstu_attention.py:"
    tpu_rel = "generative_recommenders_tpu/ops/pallas/hstu_attention_relbias.py:"
    ms_tr, work_tr = bwd_tr
    ms_det, work_det = bwd_det
    launches = main_path_launches
    kernels = [
        entry("hstu_mha_fwd", src + "hstu_mha_fwd.cu", tpu + "163", launches["K1"],
              max(errs["K1"]), k1_ms, k1_plain_ms, k1_flops, k1_bytes, peak=PEAK_3XTF32_FLOPS),
        entry("delta_hstu_mha_fwd", src + "delta_hstu_mha_fwd.cu", tpu + "1412", launches["K5"],
              max(errs["K5"]), k5_ms, k5_plain_ms, k5_flops, k5_bytes),
        # K2 at the training shape; K3 and K4 at the deterministic phase's
        # (uih 1024), where their path runs. The plain version of each is the
        # plain backward, which computes dq, dk and dv together.
        entry("hstu_mha_bwd_fused", src + "hstu_mha_bwd_fused.cu", tpu + "403", launches["K2"],
              max(bwd_errs["K2"]), ms_tr["K2"], ms_tr["plain"], *work_tr["K2"], peak=PEAK_3XTF32_FLOPS),
        entry("hstu_mha_bwd_dq", src + "hstu_mha_bwd_dq.cu", tpu + "895", launches["K3"],
              max(bwd_errs["K3+K4"][0::3]), ms_det["K3"], ms_det["plain"], *work_det["K3"],
              peak=PEAK_3XTF32_FLOPS),
        entry("hstu_mha_bwd_dkv", src + "hstu_mha_bwd_dkv.cu", tpu + "951", launches["K4"],
              max(bwd_errs["K3+K4"][1::3] + bwd_errs["K3+K4"][2::3]), ms_det["K4"], ms_det["plain"],
              *work_det["K4"], peak=PEAK_3XTF32_FLOPS),
        # K6 and K7 at the research preset's shape, on a batch of the corpus
        entry("hstu_mha_relbias_fwd", src + "hstu_mha_relbias_fwd.cu", tpu_rel + "172", launches["K6"],
              max(rel_errs["K6"]), k6_ms, k6_plain_ms, *k6_work, peak=PEAK_3XTF32_FLOPS),
        entry("hstu_mha_relbias_bwd", src + "hstu_mha_relbias_bwd.cu", tpu_rel + "298", launches["K7"],
              max(rel_errs["K7"]), k7_ms, k7_plain_ms, *k7_work, peak=PEAK_3XTF32_FLOPS),
        # K6 and K7 on bfloat16 at the ml-3b preset's layer 0; max_abs_err
        # is the largest of their cases' (outputs and tables alike)
        entry("hstu_mha_relbias_fwd_bf16", src + "hstu_mha_relbias_fwd.cu", tpu_rel + "172", launches["K6-bf16"],
              max(bf16_errs["K6-bf16"]), k6b_ms, k6b_plain_ms, *k6b_work, peak=PEAK_BF16_FLOPS),
        entry("hstu_mha_relbias_bwd_bf16", src + "hstu_mha_relbias_bwd.cu", tpu_rel + "298", launches["K7-bf16"],
              max(bf16_errs["K7-bf16"]), k7b_ms, k7b_plain_ms, *k7b_work, peak=PEAK_BF16_FLOPS),
        # K1 and K2 on bfloat16 at the ml-3b preset's layer 0 (the bias-free
        # model's first block)
        entry("hstu_mha_fwd_bf16", src + "hstu_mha_fwd.cu", tpu + "163", launches["K1-bf16"],
              max(d16_errs["K1-bf16"]), d16_times[0], d16_times[2], *d16_w1, peak=PEAK_BF16_FLOPS),
        entry("hstu_mha_bwd_fused_bf16", src + "hstu_mha_bwd_fused.cu", tpu + "403", launches["K2-bf16"],
              max(d16_errs["K2-bf16"]), d16_times[1], d16_times[3], *d16_w2, peak=PEAK_BF16_FLOPS),
        # K7-det: K7's function, so K7's work and bound, at the research
        # shape (float32) and the ml-3b layer 0 (bfloat16)
        entry("hstu_mha_relbias_bwd_det", src + "hstu_mha_relbias_bwd.cu", tpu_rel + "298", launches["K7-det"],
              max(det_errs["K7-det"]), k7det_ms, k7_plain_ms, *k7_work, peak=PEAK_3XTF32_FLOPS),
        entry("hstu_mha_relbias_bwd_det_bf16", src + "hstu_mha_relbias_bwd.cu", tpu_rel + "298",
              launches["K7-det-bf16"], max(det_errs["K7-det-bf16"]), k7db_ms, k7b_plain_ms, *k7b_work,
              peak=PEAK_BF16_FLOPS),
    ]
    shapes = [f"serving N={N_full}", f"M-FALCON M={CHUNK}", f"training N={N_tr}",
              f"uih {DET_UIH} N={N_det}", f"uih {DET_UIH} N={N_det}",
              f"research B={RB} N={RN}", f"research B={RB} N={RN}",
              f"research layer 0 B={RB} N={RN} bfloat16", f"research layer 0 B={RB} N={RN} bfloat16",
              f"research layer 0 B={RB} N={RN} bfloat16", f"research layer 0 B={RB} N={RN} bfloat16",
              f"research B={RB} N={RN}", f"research layer 0 B={RB} N={RN} bfloat16"]
    check(all(kr["launches"] > 0 for kr in kernels),
          "a kernel of the main paths was launched no time: "
          + ", ".join(kr["name"] for kr in kernels if kr["launches"] == 0))
    for kr, shape in zip(kernels, shapes):
        print(
            f"  {kr['name']}: {kr['ms']:.4f} ms at {shape}, bound {kr['bound_ms']:.4f} ms "
            f"({kr['bound_by']}; operations {kr['operations_ms']:.4f} ms at {kr['operations_peak']}, bytes "
            f"{kr['bytes_ms']:.4f} ms), plain {kr['plain_ms']:.4f} ms, {kr['launches']} launches on the main paths"
        )
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        rank_main(sys.argv[2:])
    elif sys.argv[1:2] == ["det"]:
        det_main(sys.argv[2:])
    else:
        main()
