#!/usr/bin/env python3
"""GPU smoke test of the PyTorch / CUDA port (`generative_recommenders_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero, printing no result, without one.

1. prints the card's name and power limit, then builds every CUDA kernel
   from its source and prints the build time;
2. kernel phase: calls each kernel's wrapper at the shapes the serving and
   training paths give it (on contiguous tensors and on the strided views
   of the uvqk projection that the paths pass) and at edge cases, and holds
   the result against the plain PyTorch version on the same inputs
   (float32, TF32 off); the backward kernels K2 and K3 + K4 against the
   plain backward (autograd of the plain forward); the relative-bias pair
   K6 and K7 at the research preset's shapes, on a batch of the synthetic
   corpus, against their plain versions (and a float64 run of them); K5 and
   K7 also at the seams of their tilings (chunk and tile edges, row and head
   counts that do not fill a tile or a group), K5's output and K7's dk and
   dv the same bits on a second run;
3. serving phase: runs the port's serving CLI in the Offline scenario at the
   full width of the `debug` preset, once dense and once with --mfalcon,
   with the launch counters set to 0 just before each run and read just
   after; checks that the dense and M-FALCON predictions agree, and that
   the GPU path agrees with the CPU path (plain versions) on a small model;
4. training phase: trains the full-width `debug` preset through the port's
   `train_loop` (2 warm-up steps, then 20 counted and timed ones), checks
   the losses and that every attention forward and backward went through
   K1 and K2; then a deterministic phase (`torch.use_deterministic_algorithms`)
   at uih 1024 that must take K3 + K4 and give the same bits twice; then one
   training step's gradients on a small model, GPU kernels against the CPU
   plain versions;
5. research phase: trains the HSTU retrieval model of the full-width
   preset `ml-3b/hstu-sampled-softmax-n96-seqlen500-large` (16 blocks, 8
   heads, d 256, N 511, batch 96, 128 negatives, 855,776 items) through the
   port's research `train_loop` on a synthetic corpus (2 warm-up steps, 10
   timed ones), evaluates it against the corpus' items, checks that every
   attention went through K6 and K7 (and none through K1 / K2); then one
   training step's loss and gradients on a small research model, GPU kernels
   against the CPU plain versions;
6. prints one JSON line with every kernel's launches, error and times, and
   as the last line the device JSON.

Any failed check exits nonzero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

# H100 SXM published peaks: float32 FMA outside the tensor cores; dense TF32
# in the tensor cores, of which a 3xTF32 product (three TF32 products per
# float32-accurate one) can reach a third; HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12

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
    idle share, and the kernels that take the most device time."""
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


def poison_allocator(nbytes: int) -> None:
    """Leaves a NaN-filled block in the caching allocator, so an output that
    a kernel fails to write shows as NaN."""
    import torch

    x = torch.full((nbytes // 4 + 1024,), float("nan"), device="cuda")
    del x


def main() -> None:
    try:
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
        from generative_recommenders_tpu_torch.data.dataset import (
            SequenceDataset,
            batch_iterator,
            synthetic_user_sequences,
            synthetic_user_sequences_vectorized,
        )
        from generative_recommenders_tpu_torch.data.dlrm_dataset import DLRMv3RandomDataset
        from generative_recommenders_tpu_torch.data.features import seq_features_from_row
        from generative_recommenders_tpu_torch.inference import main as serve
        from generative_recommenders_tpu_torch.inference.model_family import HSTUModelFamily
        from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTU
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
    t0 = time.perf_counter()
    logs = build.build(force=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s for {len(logs)} kernels")
    for name, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"  {name}: {len(regs)} instantiations, at most {max(regs, default=0)} registers; "
              f"{'spills: ' + '; '.join(spills) if spills else 'no spills'}")

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
        (a transposed buffer), as the gradient of a reshape may be."""
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
    ):
        for kname, e in case.items():
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
    research_eval = SequenceDataset(seqs, rm.max_sequence_len, ignore_last_n=0)
    print(f"  made in {time.perf_counter() - t0:.1f} s")

    def relbias_views(Bc, N, Hc, Dc, Vc):
        """q, k, v as the research STU gives them: views of the split of one
        [Bc, N, (2V + 2D) * H] projection (u, v, q, k), never copied."""
        proj = rand(Bc, N, Hc * (2 * Vc + 2 * Dc))
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

    def tables(Nm, nb):
        return rand(2 * Nm - 1) * 0.1, rand(nb + 1) * 0.1

    rel_errs = {"K6": [], "K7": []}

    def relbias_case(name, Bc, N, lengths, ts, Nm=None, nb=128, nt=None, Hc=2, Dc=RD, Vc=RV,
                     f64=False, **kw):
        """K6 against the plain forward, K7 against the plain backward, on
        uvqk views and a non-contiguous dO; dead rows exactly 0."""
        q, k, v = relbias_views(Bc, N, Hc, Dc, Vc)
        pos_w, ts_w = tables(Nm or N, nb)
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
    m20 = RESEARCH_PRESETS["ml-20m/hstu-sampled-softmax-n128-large"]
    m_len, m_ts = dataset_batch(m20.local_batch_size, m20.model.max_sequence_len, m20.model.gr_output_length, 1)
    relbias_case(f"ml-20m shape (B={m20.local_batch_size}, N={m20.model.total_seq_len})",
                 m20.local_batch_size, m20.model.total_seq_len, m_len, m_ts, Hc=m20.model.num_heads)
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
        f"memory and about ten float32 operations: K6 rebuilds it per head, {RH} times per (row, column); "
        f"K7 once per group of 4 heads, and sums dS over the group before the table sums. Without the "
        f"bias, on the same inputs: K1 {k1_same_ms:.4f} ms, K2 {k2_same_ms:.4f} ms"
    )
    del slice_case, q, k, v, do
    torch.cuda.empty_cache()

    # -------------------------------------------------------- serving phase
    bwd_counters = hstu_mha_bwd_cuda.launches
    counters = {
        "K1": hstu_mha_dense_cuda.launches, "K5": delta_hstu_mha_cuda.launches,
        "K2": bwd_counters["hstu_mha_bwd_fused"], "K3": bwd_counters["hstu_mha_bwd_dq"],
        "K4": bwd_counters["hstu_mha_bwd_dkv"],
        "K6": hstu_mha_dense_relbias_cuda.launches, "K7": hstu_mha_relbias_bwd_cuda.launches,
    }
    main_path_launches = dict.fromkeys(counters, 0)

    def count_reset():
        for c in counters.values():
            c.reset()

    def counts():
        """The launch counts since `count_reset`, also added to the main
        path's totals."""
        now = {name: c.count for name, c in counters.items()}
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
        for _ in range(2):
            trainer = DlrmTrainer(det_cfg, det_tables, DlrmTrainConfig(), device="cuda", seed=3)
            count_reset()
            det_out = train_loop(trainer, batches(det_cfg, DET_STEPS, 4))
            n = counts()
            want_n = {"K1": DET_STEPS, "K2": 0, "K3": DET_STEPS, "K4": DET_STEPS, "K5": 0, "K6": 0, "K7": 0}
            check(n == want_n, f"deterministic run launched {n}, expected {want_n}")
            check(all(math.isfinite(x) for x in det_out["losses"]), "non-finite deterministic loss")
            det_runs.append((det_out["losses"], [p.detach().clone() for p in trainer.model.parameters()]))
            del trainer
    finally:
        torch.use_deterministic_algorithms(False)
    (l1, p1), (l2, p2) = det_runs
    same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
    print(f"  losses {l1} and {l2}; every parameter bit-identical: {same}")
    check(same, "two deterministic runs from one seed differ")
    del det_runs, p1, p2

    # one training step's gradients on a small model: GPU kernels vs CPU
    # plain versions, dropout off (the devices' random streams differ)
    gcfg = dataclasses.replace(scfg, hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0)
    graw = next(DLRMv3RandomDataset(gcfg, hash_size=100, batch_size=4, seed=5).batches(1))
    grads = {}
    for dev in ("cpu", "cuda"):
        trainer = DlrmTrainer(gcfg, get_embedding_table_config("debug", hash_size=100, dim=16),
                              DlrmTrainConfig(), device="cpu", seed=6)
        trainer.model.to(dev)
        trainer.device = torch.device(dev)
        k2_before = counters["K2"].count
        loss, *_ = trainer.loss(to_device(graw, trainer.device))
        loss.backward()
        if dev == "cuda":
            k2_n = counters["K2"].count - k2_before
            check(k2_n == gcfg.hstu_attn_num_layers, f"small-model step launched K2 {k2_n} times")
        grads[dev] = {name: p.grad.cpu() for name, p in trainer.model.named_parameters() if p.grad is not None}
    check(grads["cpu"].keys() == grads["cuda"].keys(), "the two devices give gradients to other parameters")
    grad_err = max(
        (grads["cuda"][k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        for k, g in grads["cpu"].items()
    )
    print(f"  small model, one step's gradients, GPU kernels vs CPU plain versions: largest error "
          f"{grad_err:.3e} of the gradient's max over {len(grads['cpu'])} parameters (tol {GRAD_TOL})")
    check(grad_err <= GRAD_TOL, "GPU and CPU gradients disagree")

    # ------------------------------------------------------- research phase
    del trainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps_total = RESEARCH_WARMUPS + RESEARCH_STEPS
    eval_batches = len(research_eval) // rcfg.eval_batch_size
    print(
        f"research phase: preset {RESEARCH_PRESET}: {rm.num_blocks} blocks, H={RH}, dqk=dv={RD}, "
        f"d={rm.item_embedding_dim}, N={RN}, batch {RB}, {rcfg.num_negatives} negatives, "
        f"{rm.num_items:,} items, float32, dropout {rm.dropout_rate} / {rm.linear_dropout_rate}; "
        f"{steps_total} steps, then an eval of {eval_batches} batches"
    )
    count_reset()
    t0 = time.perf_counter()
    rout = research.train_loop(
        dataclasses.replace(rcfg, num_epochs=1), research_train, research_eval,
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
    print(
        f"  eval over {eval_batches * rcfg.eval_batch_size} users against the corpus' {corpus:,} items: "
        f"HR@10 {metrics['hr@10']:.4f}, HR@50 {metrics['hr@50']:.4f}, HR@1000 {metrics['hr@1000']:.4f}, "
        f"NDCG@10 {metrics['ndcg@10']:.4f}, MRR {metrics['mrr']:.6f}; launches {n}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    first, last = sum(rlosses[:3]) / 3, sum(rlosses[-3:]) / 3
    check(last <= first * 1.02, f"the research loss rises: {first:.4f} -> {last:.4f}")
    check(all(math.isfinite(v_) and 0.0 <= v_ <= 1.0 for k_, v_ in metrics.items() if k_ != "epoch"),
          f"eval metrics out of range: {metrics}")
    want_n = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
              "K6": rm.num_blocks * (steps_total + eval_batches), "K7": rm.num_blocks * steps_total}
    check(n == want_n, f"the research loop launched {n}, expected {want_n}")
    rbatch = next(batch_iterator(research_train, RB, shuffle=True, seed=7))
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
    class FixedNegatives:
        def __init__(self, sampler):
            self.sampler = sampler

        def __call__(self, gen_, positive_ids, num_to_sample, item_embedding_fn):
            ids_ = self.sampler.all_item_ids
            r = torch.arange(num_to_sample, device=ids_.device)
            sampled = ids_[(positive_ids[..., None] * 7 + r * 13 + 1) % ids_.shape[0]]
            return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))

    sseqs = synthetic_user_sequences(num_users=16, num_items=300, max_len=60, min_len=2, seed=3)
    sds = SequenceDataset(sseqs, 56, ignore_last_n=1)
    small_cfg = research.TrainConfig(
        model=ModelConfig(num_items=300, max_sequence_len=56, gr_output_length=3, item_embedding_dim=32,
                          num_blocks=3, num_heads=2, dqk=16, dv=16, linear_dropout_rate=0.0, dropout_rate=0.0),
        local_batch_size=8, num_negatives=16,
    )
    sbatch = next(batch_iterator(sds, 8, shuffle=False))
    rgrads, rloss = {}, {}
    for dev in ("cpu", "cuda"):
        st = research.ResearchTrainer(small_cfg, sds.all_item_ids(), device="cpu")
        if dev == "cuda":
            st.model.to(dev)
            st.device = torch.device(dev)
            st.all_item_ids = st.all_item_ids.to(dev)
            st.sampler = st.sampler._replace(all_item_ids=st.all_item_ids)
        st.sampler = FixedNegatives(st.sampler)
        before = (counters["K6"].count, counters["K7"].count)
        loss, _ = st.loss(research.to_device(sbatch, st.device))
        loss.backward()
        if dev == "cuda":
            got_n = (counters["K6"].count - before[0], counters["K7"].count - before[1])
            check(got_n == (3, 3), f"the small research step launched K6, K7 {got_n} times")
        rloss[dev] = loss.item()
        rgrads[dev] = {name: p.grad.cpu() for name, p in st.model.named_parameters() if p.grad is not None}
    check(rgrads["cpu"].keys() == rgrads["cuda"].keys() and len(rgrads["cpu"]) == 2 + 5 * 3,
          "the two devices give gradients to other parameters")
    rgrad_err = {
        k_: (rgrads["cuda"][k_] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        for k_, g in rgrads["cpu"].items()
    }
    worst = max(rgrad_err, key=rgrad_err.get)
    table_err = max(e for k_, e in rgrad_err.items() if k_.endswith(("pos_w", "ts_w")))
    print(
        f"  small research model, one step, GPU kernels vs CPU plain versions: loss {rloss['cuda']:.6f} vs "
        f"{rloss['cpu']:.6f}; largest gradient error {rgrad_err[worst]:.3e} of the gradient's max "
        f"({worst}; the bias tables' largest {table_err:.3e}) over {len(rgrad_err)} parameters (tol {GRAD_TOL})"
    )
    check(abs(rloss["cuda"] - rloss["cpu"]) <= 1e-5 * abs(rloss["cpu"]), "GPU and CPU research losses disagree")
    check(rgrad_err[worst] <= GRAD_TOL, "GPU and CPU research gradients disagree")

    # --------------------------------------------------------------- report
    def entry(name, src, replaces, launches, err, ms, plain_ms, flops, nbytes, peak=PEAK_F32_FLOPS):
        """``peak``: the rate the kernel's operations are held to, float32
        FMA for a kernel outside the tensor cores, a third of dense TF32 for
        a 3xTF32 one."""
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "operations_ms": t_ops, "bytes_ms": t_bytes,
            "operations_peak": "3xTF32, 495e12 / 3" if peak == PEAK_3XTF32_FLOPS else "float32 FMA, 67e12",
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
              max(errs["K1"]), k1_ms, k1_plain_ms, k1_flops, k1_bytes),
        entry("delta_hstu_mha_fwd", src + "delta_hstu_mha_fwd.cu", tpu + "1412", launches["K5"],
              max(errs["K5"]), k5_ms, k5_plain_ms, k5_flops, k5_bytes),
        # K2 at the training shape; K3 and K4 at the deterministic phase's
        # (uih 1024), where their path runs. The plain version of each is the
        # plain backward, which computes dq, dk and dv together.
        entry("hstu_mha_bwd_fused", src + "hstu_mha_bwd_fused.cu", tpu + "403", launches["K2"],
              max(bwd_errs["K2"]), ms_tr["K2"], ms_tr["plain"], *work_tr["K2"]),
        entry("hstu_mha_bwd_dq", src + "hstu_mha_bwd_dq.cu", tpu + "895", launches["K3"],
              max(bwd_errs["K3+K4"][0::3]), ms_det["K3"], ms_det["plain"], *work_det["K3"]),
        entry("hstu_mha_bwd_dkv", src + "hstu_mha_bwd_dkv.cu", tpu + "951", launches["K4"],
              max(bwd_errs["K3+K4"][1::3] + bwd_errs["K3+K4"][2::3]), ms_det["K4"], ms_det["plain"],
              *work_det["K4"]),
        # K6 and K7 at the research preset's shape, on a batch of the corpus
        entry("hstu_mha_relbias_fwd", src + "hstu_mha_relbias_fwd.cu", tpu_rel + "172", launches["K6"],
              max(rel_errs["K6"]), k6_ms, k6_plain_ms, *k6_work),
        entry("hstu_mha_relbias_bwd", src + "hstu_mha_relbias_bwd.cu", tpu_rel + "298", launches["K7"],
              max(rel_errs["K7"]), k7_ms, k7_plain_ms, *k7_work, peak=PEAK_3XTF32_FLOPS),
    ]
    shapes = [f"serving N={N_full}", f"M-FALCON M={CHUNK}", f"training N={N_tr}",
              f"uih {DET_UIH} N={N_det}", f"uih {DET_UIH} N={N_det}",
              f"research B={RB} N={RN}", f"research B={RB} N={RN}"]
    for kr, shape in zip(kernels, shapes):
        print(
            f"  {kr['name']}: {kr['ms']:.4f} ms at {shape}, bound {kr['bound_ms']:.4f} ms "
            f"({kr['bound_by']}; operations {kr['operations_ms']:.4f} ms at {kr['operations_peak']}, bytes "
            f"{kr['bytes_ms']:.4f} ms), plain {kr['plain_ms']:.4f} ms, {kr['launches']} launches on the main paths"
        )
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
    main()
