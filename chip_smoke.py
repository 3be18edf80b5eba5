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
   plain backward (autograd of the plain forward);
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
5. prints one JSON line with every kernel's launches, error and times, and
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

# H100 SXM published peaks: float32 FMA outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# the full-width debug preset, as served
B, MAX_UIH, MAX_CANDS, CHUNK = 32, 512, 160, 5
HASH_SIZE = 1_000_000  # cut from the reference's 10M rows to keep set-up short
NUM_QUERIES, NUM_WARMUPS, QSL_BATCHES = 24, 2, 4
# the full-width debug preset, as trained (the train CLI's defaults)
TRAIN_UIH, TRAIN_CANDS, TRAIN_WARMUPS, TRAIN_STEPS = 256, 10, 2, 20
DET_UIH, DET_STEPS = 1024, 3  # the deterministic phase, one layer
# kernel vs plain: both float32; they differ only in summation order (for
# K2's dq, an order that changes from run to run: atomics) and in the exp of
# silu, so the error is held to a small fraction of the output's max
REL_TOL = 2e-5
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
        from generative_recommenders_tpu_torch.data.dlrm_dataset import DLRMv3RandomDataset
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
        from generative_recommenders_tpu_torch.ops.hstu_compute import hstu_compute_uqvk
        from generative_recommenders_tpu_torch.train.dlrm_train import (
            DlrmTrainConfig,
            DlrmTrainer,
            to_device,
            train_loop,
        )
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

    def compare(name, got, want, dead_rows=None):
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = REL_TOL * scale + 1e-7
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

    # -------------------------------------------------------- serving phase
    bwd_counters = hstu_mha_bwd_cuda.launches
    counters = {
        "K1": hstu_mha_dense_cuda.launches, "K5": delta_hstu_mha_cuda.launches,
        "K2": bwd_counters["hstu_mha_bwd_fused"], "K3": bwd_counters["hstu_mha_bwd_dq"],
        "K4": bwd_counters["hstu_mha_bwd_dkv"],
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
        check(n["K2"] == n["K3"] == n["K4"] == 0, f"{mode}: serving launched a backward kernel: {n}")
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
    want_n = {"K1": L_tr * TRAIN_STEPS, "K2": L_tr * TRAIN_STEPS, "K3": 0, "K4": 0, "K5": 0}
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
            want_n = {"K1": DET_STEPS, "K2": 0, "K3": DET_STEPS, "K4": DET_STEPS, "K5": 0}
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

    # --------------------------------------------------------------- report
    def entry(name, src, replaces, launches, err, ms, plain_ms, flops, nbytes):
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            # no single PyTorch call computes masked silu attention
            "library_ms": None,
        }

    src = "generative_recommenders_tpu_torch/csrc/"
    tpu = "generative_recommenders_tpu/ops/pallas/hstu_attention.py:"
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
    ]
    shapes = [f"serving N={N_full}", f"M-FALCON M={CHUNK}", f"training N={N_tr}",
              f"uih {DET_UIH} N={N_det}", f"uih {DET_UIH} N={N_det}"]
    for kr, shape in zip(kernels, shapes):
        print(
            f"  {kr['name']}: {kr['ms']:.4f} ms at {shape}, bound {kr['bound_ms']:.4f} ms "
            f"({kr['bound_by']}), plain {kr['plain_ms']:.4f} ms, {kr['launches']} launches on the main paths"
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
