"""Times knock-out variants of the redesigned kernels K5 and K7 on the card.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants

A variant is the kernel's source with one phase taken out by text
substitution (its table sums, its atomics, its tensor-core instructions
replaced by plain adds, its loads of K and V, ...), built beside the real
library and launched through the same wrapper on the same inputs. Most
variants compute wrong numbers: only their times are read. What the time
does not lose when a phase goes, that phase did not cost; `PERF.md` quotes
the table this prints. Needs a CUDA card and nvcc.

Inputs, from seed 0: K5 at the serving chunk (B 32, M 5, H 4, D = V = 128,
N 523, lengths 100..329, q a strided view); K7 at the research shape (B 96,
N 511, H 8, D = V = 32, lengths 1..511, q/k/v views of one projection, a
strided dO).
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Callable, Dict, List, Tuple

from generative_recommenders_tpu_torch.ops.cuda import build

Edit = Callable[[str], str]


def _sub(old: str, new: str) -> Edit:
    def edit(text: str) -> str:
        if text.count(old) != 1:
            raise ValueError(f"the kernel source no longer holds exactly one {old[:60]!r}")
        return text.replace(old, new)

    return edit


_MMA = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
'''
_K7: Dict[str, Edit] = {
    "table sums": lambda t: _sub("unsigned rest = __ballot_sync(kFull, ok);", "unsigned rest = 0;")(
        _sub("for (int r = part; r < kT; r += 4) {", "for (int r = part; r < 0; r += 4) {")(t)),
    "dq atomics": _sub("if (row < length && d < p.D) {\n                const float4 x",
                       "if (false) {\n                const float4 x"),
    "sigmoid": _sub("const float sig = __fdividef(1.f, 1.f + __expf(-x));", "const float sig = x;"),
    "bucket logf": _sub("const int bucket = hstu::ts_bucket(tq, tk[j * 2 + c], p.NB);", "const int bucket = 3;"),
    "S and dP": _sub("if (!dead) {", "if (false) {"),
    "dV and dK": _sub("for (int ks = row_step_first; ks < row_steps; ++ks) {",
                      "for (int ks = row_step_first; ks < 0; ++ks) {"),
    "dQ": _sub("for (int ks = 0; ks < my_col_steps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {"),
    # the fragments are still loaded and split, the tensor cores do nothing
    "mma.sync (plain adds instead)": _sub(
        _MMA,
        "  c[0] += __uint_as_float(a[0] ^ b[0]); c[1] += __uint_as_float(a[1] ^ b[1]);\n"
        "  c[2] += __uint_as_float(a[2] ^ b[0]); c[3] += __uint_as_float(a[3] ^ b[1]);\n"),
    "the split (big = x, small = 0)": _sub(
        "  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "  small = __float_as_uint(x - __uint_as_float(big));\n",
        "  big = __float_as_uint(x);\n  small = 0;\n"),
}
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
)


def variant_source(kernel: str, phases: Tuple[str, ...]) -> str:
    """The kernel's source with the named phases taken out; raises if a
    substitution no longer finds its text."""
    with open(os.path.join(build.CSRC_DIR, build.KERNEL_SOURCES[kernel])) as f:
        text = f.read()
    edits = _K7 if kernel == "hstu_mha_relbias_bwd" else _K5
    for name in phases:
        text = edits[name](text)
    return text


def _build_all(root: str) -> None:
    """One nvcc per variant, all started together, each into its own
    directory under ``root``."""
    nvcc = build._nvcc()
    failures = []

    def make(i: int, kernel: str, phases: Tuple[str, ...]) -> None:
        d = os.path.join(root, f"v{i}")
        os.makedirs(d, exist_ok=True)
        cu = os.path.join(d, f"{kernel}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(kernel, phases))
        r = subprocess.run(
            [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", os.path.join(d, f"lib{kernel}.so"), cu],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            failures.append(r.stdout + r.stderr)

    threads = [threading.Thread(target=make, args=(i, k, p)) for i, (k, _, p) in enumerate(VARIANTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def main() -> None:
    import torch

    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import delta_hstu_mha_cuda
    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import hstu_mha_relbias_bwd_cuda

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

    dq = rand(32, 5, 4 * 512)[..., 1024:1536].reshape(32, 5, 4, 128)
    dk, dv, dlen = rand(32, 523, 4, 128), rand(32, 523, 4, 128), ints(100, 330, 32)
    m5 = torch.full((32,), 5, dtype=torch.int32, device="cuda")

    def k5():
        delta_hstu_mha_cuda(dq, dk, dv, dlen, alpha=128**-0.5, num_targets=m5, norm_len=678, contextual_seq_len=6)

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

    root = os.path.join(build.BUILD_DIR, "variants")
    _build_all(root)
    shipped_dir = build.BUILD_DIR
    try:
        for i, (kernel, label, _) in enumerate(VARIANTS):
            build.BUILD_DIR = os.path.join(root, f"v{i}")
            build._libs.clear()
            fn, reps = (k7, 10) if kernel == "hstu_mha_relbias_bwd" else (k5, 300)
            print(f"{kernel:22s} {label:45s} {device_ms(fn, reps):.4f} ms")
    finally:
        build.BUILD_DIR = shipped_dir
        build._libs.clear()


if __name__ == "__main__":
    main()
