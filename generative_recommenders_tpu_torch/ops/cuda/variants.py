"""Times knock-out variants of the redesigned kernels K1 to K7 on the card.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants [KERNEL ...]

A variant is the kernel's source, or a header it includes, with one phase
taken out by text substitution (its table sums, its atomics, its
tensor-core instructions replaced by plain adds, its loads of K and V, ...),
built beside the real library and launched through the same wrapper on the
same inputs. Each variant's directory holds the kernel's source and every
shared header, edited or not, and is searched first. Most
variants compute wrong numbers: only their times are read. What the time
does not lose when a phase goes, that phase did not cost; `PERF.md` quotes
the table this prints. Needs a CUDA card and nvcc. Names of C entry points
(``hstu_mha_fwd``, ...) as arguments time only those kernels' variants.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants KERNEL ... --against DIR

times instead each named kernel as shipped against the same kernel built from
the sources of another checkout at DIR (``git archive <commit> | tar -x -C
DIR``), in the order other, shipped, shipped, other, twice, on the same
inputs through the same wrapper; the kernel's C signature must be the same
in both trees.

Inputs, from seed 0: K5 at the serving chunk (B 32, M 5, H 4, D = V = 128,
N 523, lengths 100..329, q a strided view); K6 and K7 at the research shape
(B 96, N 511, H 8, D = V = 32, lengths 1..511, q/k/v views of one
projection, a strided dO); K1 at the serving shape (B 32, N 674, H 4, D = V
= 128, lengths 300..674, up to 159 targets, 2 contextual rows, q/k/v views
of one uvqk projection); K2 at the ranker's training shape (B 32, N 268, H 4,
D = V = 128, lengths 100..268, 1..10 targets, 2 contextual rows, q/k/v views
of one uvqk projection, a strided dO) and K3 and K4 at their deterministic
shape (the same with N 1036, lengths 300..1036). K3 is also timed with other
tilings at that width (its `Tiling` line substituted).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Dict, List, Optional, Tuple

from generative_recommenders_tpu_torch.ops.cuda import build

Edit = Callable[[Dict[str, str], str], None]


def _sub(old: str, new: str, where: str = "") -> Edit:
    """An edit of the kernel's own source, or of the shared header ``where``."""

    def edit(texts: Dict[str, str], source: str) -> None:
        name = where or source
        if texts[name].count(old) != 1:
            raise ValueError(f"{name} no longer holds exactly one {old[:60]!r}")
        texts[name] = texts[name].replace(old, new)

    return edit


def _both(*edits: Edit) -> Edit:
    def edit(texts: Dict[str, str], source: str) -> None:
        for e in edits:
            e(texts, source)

    return edit


_MMA = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
'''
_TF32 = "tf32_mma.cuh"
# the tensor cores do nothing, the fragments are still loaded and split
_NO_MMA = _sub(
    _MMA,
    "  c[0] += __uint_as_float(a[0] ^ b[0]); c[1] += __uint_as_float(a[1] ^ b[1]);\n"
    "  c[2] += __uint_as_float(a[2] ^ b[0]); c[3] += __uint_as_float(a[3] ^ b[1]);\n", _TF32)
_NO_SPLIT = _sub(
    "  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
    "  small = __float_as_uint(x - __uint_as_float(big));\n",
    "  big = __float_as_uint(x);\n  small = 0;\n", _TF32)
_K7: Dict[str, Edit] = {
    "table sums": _both(_sub("unsigned rest = __ballot_sync(kFull, ok);", "unsigned rest = 0;"),
                        _sub("for (int r = part; r < kT; r += 4) {", "for (int r = part; r < 0; r += 4) {")),
    "dq atomics": _sub("if (row < length && d < p.D) {\n                  const float4 x",
                       "if (false) {\n                  const float4 x"),
    "sigmoid": _sub("const float sig = __fdividef(1.f, 1.f + __expf(-x));", "const float sig = x;"),
    "bucket logf": _sub("const int bucket = hstu::ts_bucket(tq, tk[j * 2 + c], p.NB);", "const int bucket = 3;"),
    "S and dP": _sub("if (!dead) {", "if (false) {"),
    "dV and dK": _sub("for (int ks = row_step_first; ks < row_steps; ++ks) {",
                      "for (int ks = row_step_first; ks < 0; ++ks) {"),
    "dQ": _sub("for (int ks = 0; ks < my_col_steps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {"),
    "mma.sync (plain adds instead)": _NO_MMA,
    "the split (big = x, small = 0)": _NO_SPLIT,
}
# K1 and K6: edits of their shared body
_FWD = "hstu_attention_fwd.cuh"
_BIAS = "the bias (its logf, its table reads)"
_K16: Dict[str, Edit] = {
    "silu": _sub("s[j][c] = __fdividef(x, 1.f + __expf(-x));", "s[j][c] = x;", _FWD),
    _BIAS: _sub(
        "bias[RELBIAS ? 4 * j + c : 0] = pos_s[hstu::pos_index(row, col, p.Nm)] +\n"
        "                                            ts_s[hstu::ts_bucket(tq[c >> 1], tk_s[col], p.NB)];",
        "bias[RELBIAS ? 4 * j + c : 0] = 0.f;", _FWD),
    "mma.sync (plain adds instead)": _NO_MMA,
    "the split (big = x, small = 0)": _NO_SPLIT,
    "K and V loads": _both(
        _sub("p.k_sn, kt * BK, length, p.D,", "p.k_sn, kt * BK, 0, p.D,", _FWD),
        _sub("p.v_sn, kt * BK, length,\n", "p.v_sn, kt * BK, 0,\n", _FWD)),
    "the products": _sub("          if (!dead) {", "          if (false) {", _FWD),
    # every element live: no mask to compute, no warp skipped
    "the mask": _both(_sub("      if (!interior) {\n        ok_bits = 0;", "      if (false) {\n        ok_bits = 0;", _FWD),
                      _sub("            if (!interior) {\n#pragma unroll", "            if (false) {\n#pragma unroll", _FWD)),
    "Q's loads": _sub("for (int hh = 0; hh < nh; ++hh) {\n      if constexpr (kBf16)",
                      "for (int hh = 0; hh < 0; ++hh) {\n      if constexpr (kBf16)", _FWD),
}
# K2 and K4: edits of their shared body
_BWD = "hstu_attention_bwd_dkv.cuh"
_K24: Dict[str, Edit] = {
    "mma.sync (plain adds instead)": _NO_MMA,
    "the split (big = x, small = 0)": _NO_SPLIT,
    # the float32 branch's loads: the variants time the float32 entry points
    "Q and dO loads": _both(
        _sub("(Q, qb, p.q_sn, r0, length, p.D, p.vec_q != 0);", "(Q, qb, p.q_sn, r0, 0, p.D, p.vec_q != 0);", _BWD),
        _sub("(Q + BQ * PK, ob, p.do_sn, r0, length, p.V, p.vec_do != 0);",
             "(Q + BQ * PK, ob, p.do_sn, r0, 0, p.V, p.vec_do != 0);", _BWD)),
    "sigmoid": _sub("const float sig = __fdividef(1.f, 1.f + __expf(-x));", "const float sig = x;", _BWD),
    "S and dP": _both(_sub("for (int ks = 0; ks < W / 8; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _BWD),
                      _sub("for (int ks = 0; ks < WV / 8; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _BWD)),
    "dV and dK": _sub("for (int ks = next_step(0); ks < row_steps;", "for (int ks = next_step(0); ks < 0;", _BWD),
    "dQ": _sub("for (int ks = 0; ks < my_col_steps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _BWD),
    "dq atomics": _sub("if (row < length && d < p.D) {\n              const float4 x",
                       "if (false) {\n              const float4 x", _BWD),
}
# K3: edits of its body
_DQ = "hstu_attention_bwd_dq.cuh"
_DQ_TILING_128 = "template <> struct Tiling<128> { static constexpr int BQ = 64, BK = 64, NG = 4; };"
_K3: Dict[str, Edit] = {
    "mma.sync (plain adds instead)": _NO_MMA,
    "the split (big = x, small = 0)": _NO_SPLIT,
    "K and V loads": _both(
        _sub("(K, kb, p.k_sn, c0, length, p.D,", "(K, kb, p.k_sn, c0, 0, p.D,", _DQ),
        _sub("(K + BK * PK, vb, p.v_sn, c0, length, p.V,", "(K + BK * PK, vb, p.v_sn, c0, 0, p.V,", _DQ)),
    "sigmoid": _sub("const float sig = __fdividef(1.f, 1.f + __expf(-x));", "const float sig = x;", _DQ),
    "S and dP": _both(_sub("for (int ks = 0; ks < W / 8; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _DQ),
                      _sub("for (int ks = 0; ks < WV / 8; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _DQ)),
    "the dQ product": _sub("for (int ks = 0; ks < my_col_steps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _DQ),
    # other tilings at the ranker's width, for choosing one
    "BQ 64, BK 32": _sub(_DQ_TILING_128, _DQ_TILING_128.replace("BK = 64", "BK = 32"), _DQ),
    "BQ 32, BK 64": _sub(_DQ_TILING_128, _DQ_TILING_128.replace("BQ = 64, BK = 64, NG = 4", "BQ = 32, BK = 64, NG = 2"), _DQ),
    "BQ 128, BK 32": _sub(_DQ_TILING_128, _DQ_TILING_128.replace("BQ = 64, BK = 64", "BQ = 128, BK = 32"), _DQ),
}
_K3_TILINGS = ("BQ 64, BK 32", "BQ 32, BK 64", "BQ 128, BK 32")
_K5: Dict[str, Edit] = {
    "the last block's sum": _sub("  if (!s_last) return;\n", "  return;\n"),
    "K loads": _sub("      kr[i] = (col < length && at < p.D) ? load4", "      kr[i] = (col < length && at < 0) ? load4"),
    "V loads": _sub("      vr[j] = (c0 + j < length && at < p.V)", "      vr[j] = (c0 + j < length && at < 0)"),
    "silu": _sub("const float pv = ok ? x / (1.f + expf(-x)) : 0.f;", "const float pv = ok ? x : 0.f;"),
    "P shuffles": _sub("          const float pm = __shfl_sync(kFull, pv, j * 8 + m);", "          const float pm = pv;"),
}
# (kernel, label, phases taken out)
VARIANTS: List[Tuple[str, str, Tuple[str, ...]]] = (
    [("hstu_mha_relbias_bwd", "as shipped", ())]
    + [("hstu_mha_relbias_bwd", f"without {name}", (name,)) for name in _K7]
    + [
        ("hstu_mha_relbias_bwd", "without the three products' loops", ("S and dP", "dV and dK", "dQ")),
        ("hstu_mha_relbias_bwd", "loads, barriers and stores alone",
         ("S and dP", "dV and dK", "dQ", "dq atomics", "table sums", "sigmoid", "bucket logf")),
        ("delta_hstu_mha_fwd", "as shipped", ()),
    ]
    + [("delta_hstu_mha_fwd", f"without {name}", (name,)) for name in _K5]
    + [("delta_hstu_mha_fwd", "without K and V loads", ("K loads", "V loads"))]
    + [
        (kernel, label, phases)
        for kernel in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dkv")
        for label, phases in (
            [("as shipped", ())]
            + [(f"without {name}", (name,)) for name in _K24
               if kernel == "hstu_mha_bwd_fused" or name not in ("dQ", "dq atomics")]
            + [("without the products", ("S and dP", "dV and dK")
                + (("dQ",) if kernel == "hstu_mha_bwd_fused" else ())),
               ("loads, barriers and stores alone", ("S and dP", "dV and dK", "sigmoid")
                + (("dQ", "dq atomics") if kernel == "hstu_mha_bwd_fused" else ()))]
        )
    ]
    + [("hstu_mha_bwd_dq", "as shipped", ())]
    + [("hstu_mha_bwd_dq", f"without {name}", (name,)) for name in _K3 if name not in _K3_TILINGS]
    + [("hstu_mha_bwd_dq", "loads, barriers and stores alone", ("S and dP", "the dQ product", "sigmoid"))]
    + [("hstu_mha_bwd_dq", f"tiling at width 128: {name}", (name,)) for name in _K3_TILINGS]
    + [
        (kernel, label, phases)
        for kernel in ("hstu_mha_fwd", "hstu_mha_relbias_fwd")
        for label, phases in (
            [("as shipped", ())]
            + [(f"without {name}", (name,)) for name in _K16
               if kernel == "hstu_mha_relbias_fwd" or name != _BIAS]
            + [("loads, barriers and stores alone", ("the products", "the mask")
                + ((_BIAS,) if kernel == "hstu_mha_relbias_fwd" else ()))]
        )
    ]
)
_EDITS = {"hstu_mha_relbias_bwd": _K7, "delta_hstu_mha_fwd": _K5, "hstu_mha_fwd": _K16,
          "hstu_mha_relbias_fwd": _K16, "hstu_mha_bwd_fused": _K24, "hstu_mha_bwd_dkv": _K24,
          "hstu_mha_bwd_dq": _K3}


def shipped_sources(kernel: str) -> Dict[str, str]:
    """The kernel's source and every shared header, by file name."""
    texts = {}
    for name in (build.KERNEL_SOURCES[kernel],) + build._HEADERS:
        with open(os.path.join(build.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    return texts


def variant_source(kernel: str, phases: Tuple[str, ...]) -> Dict[str, str]:
    """The kernel's source and the shared headers, by file name, with the
    named phases taken out; raises if a substitution no longer finds its
    text."""
    texts = shipped_sources(kernel)
    for name in phases:
        _EDITS[kernel][name](texts, build.KERNEL_SOURCES[kernel])
    return texts


def _build_all(root: str, chosen: List[int]) -> None:
    """One nvcc per variant, all started together, each into its own
    directory under ``root``, which holds the variant's source and headers
    and is searched first."""
    nvcc = build._nvcc()
    failures = []

    def make(i: int, kernel: str, phases: Tuple[str, ...]) -> None:
        d = os.path.join(root, f"v{i}")
        os.makedirs(d, exist_ok=True)
        for name, text in variant_source(kernel, phases).items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        r = subprocess.run(
            [nvcc, *build.NVCC_FLAGS, "-I", d, "-I", build.CSRC_DIR, "-o", os.path.join(d, f"lib{kernel}.so"),
             os.path.join(d, build.KERNEL_SOURCES[kernel])],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            failures.append(r.stdout + r.stderr)

    threads = [threading.Thread(target=make, args=(i, *VARIANTS[i][::2])) for i in chosen]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def _build_other(root: str, csrc: str, kernels: List[str]) -> None:
    """Each kernel's library built from another checkout's sources ``csrc``
    into ``root/<kernel>/``, one nvcc per kernel, all started together."""
    nvcc = build._nvcc()
    procs = []
    for kernel in kernels:
        d = os.path.join(root, kernel)
        os.makedirs(d, exist_ok=True)
        procs.append(subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", csrc, "-o", os.path.join(d, f"lib{kernel}.so"),
             os.path.join(csrc, build.KERNEL_SOURCES[kernel])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))


def main(argv: Optional[List[str]] = None) -> None:
    import sys

    import torch

    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
        _bwd_kernel,
        delta_hstu_mha_cuda,
        hstu_mha_dense_cuda,
    )
    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import (
        hstu_mha_dense_relbias_cuda,
        hstu_mha_relbias_bwd_cuda,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator("cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen) * 0.5  # noqa: E731
    ints = lambda lo, hi, n: torch.randint(lo, hi, (n,), device="cuda", generator=gen, dtype=torch.int32)  # noqa: E731

    B, N, H, D = 96, 511, 8, 32
    _, v, q, k = torch.split(rand(B, N, 4 * H * D), [H * D] * 4, dim=-1)
    q, k, v = (x.reshape(B, N, H, D) for x in (q, k, v))
    lens = ints(1, N + 1, B)
    steps = torch.randint(1, 86400, (B, N), device="cuda", generator=gen)
    ts = (1_500_000_000 + torch.cumsum(steps, 1)) * (torch.arange(N, device="cuda")[None] <= lens[:, None])
    pos_w, ts_w, do = rand(2 * N - 1) * 0.1, rand(129) * 0.1, rand(N, B, H, D).transpose(0, 1)

    def k7():
        hstu_mha_relbias_bwd_cuda(q, k, v, lens, ts, pos_w, ts_w, do, alpha=1.0, max_seq_len=N)

    def k6():
        hstu_mha_dense_relbias_cuda(q, k, v, lens, ts, pos_w, ts_w, alpha=1.0, max_seq_len=N)

    _, sv, sq, sk = torch.split(rand(32, 674, 4 * 512), [512] * 4, dim=-1)
    sq, sk, sv = (x.reshape(32, 674, 4, 128) for x in (sq, sk, sv))
    s_len, s_nt = ints(300, 675, 32), ints(1, 160, 32)

    def k1():
        hstu_mha_dense_cuda(sq, sk, sv, s_len, alpha=128**-0.5, max_seq_len=674, num_targets=s_nt,
                            contextual_seq_len=2)

    dq = rand(32, 5, 4 * 512)[..., 1024:1536].reshape(32, 5, 4, 128)
    dk, dv, dlen = rand(32, 523, 4, 128), rand(32, 523, 4, 128), ints(100, 330, 32)
    m5 = torch.full((32,), 5, dtype=torch.int32, device="cuda")

    def k5():
        delta_hstu_mha_cuda(dq, dk, dv, dlen, alpha=128**-0.5, num_targets=m5, norm_len=678, contextual_seq_len=6)

    # K2 at the training shape, K4 at the deterministic one, each called as
    # the wrapper calls it (the mask's keywords, int32 lengths and targets)
    def bwd_inputs(N, lo):
        _, bv, bq, bk = torch.split(rand(32, N, 4 * 512), [512] * 4, dim=-1)
        bq, bk, bv = (x.reshape(32, N, 4, 128) for x in (bq, bk, bv))
        kw = dict(alpha=128**-0.5, max_seq_len=N, causal=True, max_attn_len=0, contextual_seq_len=2,
                  min_full_attn_seq_len=0)
        return bq, bk, bv, ints(lo, N + 1, 32), ints(1, 11, 32), rand(N, 32, 4, 128).transpose(0, 1), kw

    k2_in, k4_in = bwd_inputs(268, 100), bwd_inputs(1036, 300)

    def k2():
        _bwd_kernel("hstu_mha_bwd_fused", *k2_in[:4], k2_in[4], k2_in[5], k2_in[6])

    def k4():
        _bwd_kernel("hstu_mha_bwd_dkv", *k4_in[:4], k4_in[4], k4_in[5], k4_in[6])

    def k3():
        _bwd_kernel("hstu_mha_bwd_dq", *k4_in[:4], k4_in[4], k4_in[5], k4_in[6])

    def device_ms(fn, reps):
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

    timed = {"hstu_mha_relbias_bwd": (k7, 10), "delta_hstu_mha_fwd": (k5, 300),
             "hstu_mha_relbias_fwd": (k6, 20), "hstu_mha_fwd": (k1, 50),
             "hstu_mha_bwd_fused": (k2, 50), "hstu_mha_bwd_dkv": (k4, 20),
             "hstu_mha_bwd_dq": (k3, 20)}
    args = list(sys.argv[1:] if argv is None else argv)
    other = None
    if "--against" in args:
        at = args.index("--against")
        other = args[at + 1]
        del args[at : at + 2]
    only = set(args)
    chosen = [i for i, (kernel, _, _) in enumerate(VARIANTS) if not only or kernel in only]
    shipped_dir = build.BUILD_DIR
    try:
        if other is not None:
            kernels = sorted({VARIANTS[i][0] for i in chosen})
            root = os.path.join(shipped_dir, "against")
            _build_other(root, os.path.join(os.path.abspath(other), "generative_recommenders_tpu_torch", "csrc"),
                         kernels)
            for kernel in kernels:
                for which in ("other", "shipped", "shipped", "other") * 2:
                    build._libs.clear()
                    if which == "other":
                        _preload(kernel, os.path.join(root, kernel))
                    fn, reps = timed[kernel]
                    label = f"as in {other}" if which == "other" else "as shipped"
                    print(f"{kernel:22s} {label:45s} {device_ms(fn, reps):.4f} ms")
            return
        root = os.path.join(build.BUILD_DIR, "variants")
        _build_all(root, chosen)
        for i in chosen:
            kernel, label, _ = VARIANTS[i]
            build._libs.clear()
            _preload(kernel, os.path.join(root, f"v{i}"))
            fn, reps = timed[kernel]
            print(f"{kernel:22s} {label:45s} {device_ms(fn, reps):.4f} ms")
    finally:
        build._libs.clear()


def _preload(kernel: str, directory: str) -> None:
    """Makes the wrappers launch the kernel's library in ``directory`` (a
    variant's, built here; `build.load` would rebuild the shipped source,
    whose hash its stamp does not hold)."""
    build._libs[kernel] = ctypes.CDLL(os.path.join(directory, f"lib{kernel}.so"))


if __name__ == "__main__":
    main()
