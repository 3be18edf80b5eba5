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
tilings at that width (its `Tiling` line substituted). K7's variants are
timed as K7 and as K7-det (the same body with DET), on the same inputs, and
K7-det also at the long-history layer (B 2, N = Nm = 4096, lengths
3600..4096); one of them is K7-det's other design for dq's ordered sum
(the last block to reach a query tile sums its slots), checked bit for bit
against the shipped one.

    python PATH/TO/variants.py --bf16

(run as a file, with ``PYTHONPATH`` naming the checkout whose package to
time, as ``--det``) times the bfloat16 kernels K1-bf16 to K4-bf16 through
their wrappers at bench.py's shape (B 8, N 2048, H 4, D 64, alpha 1/8,
lengths from default_rng(0)) and at N 4096; K1-bf16 to K4-bf16, K6-bf16,
K1-bias-bf16, K7-bf16 and K7-det-bf16 at ml-3b's block 0 (B 96, N 511, H
8, D 32, alpha 1, lengths 1..511); and K7-bf16 and K7-det-bf16 at the
long-history layer (B 2, N = Nm = 4096, H 8, D 32, lengths 3600..4096);
with the split K3-bf16 + K4-bf16 against K2-bf16, and the pair K1-bf16 +
K2-bf16's TFLOP/s at bench.py's shape under bench.py's FLOP model (3.5 times
the forward's 2 H (2 D) L^2 / 2); in a checkout whose forward cuts walks in
chunks (`_FWD_CHUNK_BF16`) also K1-bf16 at other chunks and with none.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants --bf16-variants [KERNEL ...] [TEXT ...]

builds and times the knock-outs of the bfloat16 bodies (labels "bf16: ...";
of the named kernels' libraries, or those holding one of the TEXTs, beside
the shipped bodies):
the tiles copied synchronously in place of `cp.async`, the products as two
TF32 m16n8k8 each in place of one bfloat16 m16n8k16, the backward's phases
one at a time, and other tilings of the bodies, for K1-bf16, K2-bf16,
K3-bf16, K4-bf16 (bench.py's shapes and ml-3b's block 0), K6-bf16 (ml-3b's
block 0) and K7-bf16 with K7-det-bf16 (ml-3b's block 0 and the long-history
layer): K7's table sums and bucket logf taken out, its 4 heads a block
at width 32 against 8 and 2, and K3's dS through shared memory against
registers.

    python PATH/TO/variants.py --wide

(run as a file, with ``PYTHONPATH`` naming the checkout whose package to
time, as ``--bf16``) times K7, K7-det, K7-bf16 and K7-det-bf16 through the
public wrapper at the wide-head layer (ml-20m n128 with two heads of 128: B
128, N = Nm = 211, H 2, D = V = 128, 128 buckets, full rows), at D = V = 96
and D 128 / V 64 (the same B, N, H) and at D = V = 256 (the wide bodies in
every checkout), each also with the wide bodies forced on the same inputs;
and K5 and K5-bf16 at the serving chunk. Run it from the parent's checkout
and this one in turns (parent, new, new, parent) in one call.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants --wide-variants

builds and times the knock-outs of K7's width-128 instances (labels "w128:
..."; float32 and bfloat16, K7 and K7-det, at the wide-head layer): the
copies synchronous in place of `cp.async`, two TF32 m16n8k8 in place of one
m16n8k16 (bfloat16), the float32 body's steps of 64 query rows with one
(Q, dO) stage in place of 32 rows with two, without the table sums, and
one head a block on bfloat16 in place of two (label "bf16: width 128, 1
head a block").

    python PATH/TO/variants.py --wide-bwd

(run as a file, with ``PYTHONPATH`` naming the checkout whose package to
time, as ``--wide``) times the wide backward through the wrappers, float32
and bfloat16, each the mean of 10 launches: K2, K3 and K4 at D 512 / V 64
and at D 64 / V 256 (B 4, N 2048, H 2, lengths N / 2 .. N, one full row),
the same at the V-256 ranker's layer (B 32, N 268, H 4, D 128, V 256), K7
and K7-det at D = V = 256 (B 4, N 1024, H 2, 128 buckets); beside each shape
the plain backward (the mean of 2). Run it from the parent's checkout and
this one in turns (parent, new, new, parent) in one call.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants --wide-bwd-variants [KERNEL ...]

builds and times the knock-outs of the wide backward (labels "wbwd: ...";
of the named kernels' libraries: K2's at D 512 / V 64 and D 64 / V 256,
K3's there and at the V-256 ranker's layer, K7's at D = V = 256): the
copies synchronous in place of `cp.async`, two TF32 m16n8k8 in place of one
m16n8k16 (bfloat16), without the per-element work (the sigmoid and the
bias), the per-element work repeated in every block (each reading every
block's part of T) and split across the cluster by fragment at every
cluster size, in place of split from 5 blocks and repeated below,
without distributed shared memory (each block stores into and loads from
its own), without the step's cluster barriers, without the products, the
float32 step's share of dK, dV or dQ summed in two passes of four tiles or
in place across the walk (in place of one pass of fresh sums); K7's
`dpos_w` sums on the block of rank 0 in place of step by step across the
cluster, and without the table sums.

    python PATH/TO/variants.py --wide-fwd

(run as a file, with ``PYTHONPATH`` naming the checkout whose package to
time, as ``--wide-bwd``) times the wide forward through the public
wrappers, float32 and bfloat16, each the mean of 10 launches: K1 and K1-bias
at the V-256 ranker's layer (B 32, N 268, H 4, D 128, V 256, lengths N / 2
.. N with one full row), at the --attn_dim 256 serving layer (B 32, N 674,
H 4, D = V = 256) and at D 64 / V 256 and D 512 / V 64 (B 4, N 2048, H 2),
K6 at D = V = 256 (B 4, N 1024, H 2, 128 buckets) and K6-long (N 4096
against Nm 16384, D = V = 64, B 2, H 8, the wide bodies forced), beside
each shape the plain forward (the mean of 2). Run it from the parent's
checkout and this one in turns (parent, new, new, parent) in one call.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants --wide-fwd-routes

times the wide forward's routes on the same inputs, float32 and bfloat16,
each the mean of 10 launches: on the clusters (route ``wide``), on the
per-pair forward (``wide_chunks``) and, float32 where it takes the widths,
on the tile forward (``wide_tile``), K1 and K1-bias (K6 at its shape) at
`--wide-fwd`'s shapes but K6-long, at D 128, 192, 256 and 320 against V
256 and D 128 and 256 against V 384 (B 4, N 2048, H 2), and at D 128 and
256 against V 256 at (B 8, N 1024, H 2), (B 4, N 1536, H 2) and (B 32, N
2048, H 4): the measurements `hstu_attention._fwd_tile` follows.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants --wide-fwd-variants [KERNEL ...] [TEXT ...]

builds and times the knock-outs of the wide forward (labels "wfwd: ..."; of
the named kernels' libraries, or those whose label holds one of the other
arguments; of K1's library at its shapes, of K6's at D = V = 256). The tile
forward's ("wfwd: tile, ..."): the copies synchronous, S formed whole by
each warp of a row group (its products twice, no exchange), Q reloaded
every key step, Q in registers at D past 128, K and V split once into
tiles of their big and small parts as they land (D up to 128), and
without S's products, P V's, the per-element work, the exchange's barrier
or the K and V copies.
The clusters': the per-pair forward in their place (its route forced: no
build), the copies synchronous in place of `cp.async` a step
ahead, bfloat16 through two TF32 m16n8k8 in place of one m16n8k16, the
per-element work repeated in every block at every cluster size or split by
fragment at every size (shipped: split from 4 blocks), without distributed
shared memory (each block its own part: wrong sums), without the step's
cluster barriers, without the products, without the per-element work
(silu, the bias), a block per chunk of D too (shipped: per two chunks of
D).

    python PATH/TO/variants.py --wide-chunks-bwd

(run as a file, with ``PYTHONPATH`` naming the checkout whose package to
time, as ``--wide-bwd``) times the backward past the clusters (route
``wide_chunks``: the per-pair backward) through the wrappers, float32 and
bfloat16, each the mean of 10 launches: K2, K3 and K4, then K7 and K7-det
(128 buckets), at D 3968 / V 128, D 2048 / V 2049 and D 4352 / V 64 (B 1, N
300, H 1, a full row), and K2, K3 and K4 at the widest-heads ranker's layer
(B 8, N 268, H 4, D 3968 / V 128, lengths N / 2 .. N with one full row);
beside each shape the plain backward (the mean of 2). Run it from the
parent's checkout and this one in turns (parent, new, new, parent) in one
call.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants --wide-chunks-bwd-variants [KERNEL ...]

builds and times the per-pair backward's knock-outs (labels "wcb: ..."; of
the named kernels' libraries, K2's, K3's, K4's and K7's, at
``--wide-chunks-bwd``'s shapes): the copies synchronous (each step's tiles
waited for before its products, in both passes, in place of the ring), no
split of the S / dP steps across blocks (the plan patched: one block a
pair whatever the grid), and the bfloat16 products as two TF32 m16n8k8 in
place of one m16n8k16.

    python PATH/TO/variants.py --wide-chunks-fwd

(run as a file, with ``PYTHONPATH`` naming the checkout whose package to
time, as ``--wide-chunks-bwd``) times the forward past the clusters (route
``wide_chunks``: the per-pair forward) through the public wrappers, float32
and bfloat16, each the mean of 10 launches: K1 and K1-bias, then K6 (128
buckets), at D 4352 / V 64 and D 128 / V 4352 (B 1, N 300, H 1, a full
row), and K1 and K1-bias at the widest-heads ranker's forward layer (B 8, N
268, H 4, D 4352 / V 64, lengths N / 2 .. N with one full row); beside each
shape the plain forward (the mean of 2). Run it from the parent's checkout
and this one in turns (parent, new, new, parent) in one call.

    python -m generative_recommenders_tpu_torch.ops.cuda.variants --wide-chunks-fwd-variants [KERNEL ...]

builds and times the per-pair forward's knock-outs (labels "wcf: ..."; of
the named kernels' libraries, K1's and K6's, at ``--wide-chunks-fwd``'s
shapes): the copies synchronous (each step's tiles waited for before its
products, in both passes, in place of the ring), no split of the S steps
across blocks (the plan patched: one block a pair whatever the grid), the
bfloat16 products as two TF32 m16n8k8 in place of one m16n8k16, and
without the S pass's products, or its reads of Q and K (wrong sums: their
times alone are read).

    python PATH/TO/variants.py --det

(run as a file, with ``PYTHONPATH`` naming the checkout whose package to
time) times K7 and K7-det, float32 and bfloat16, through the public wrapper
alone, at the main paths' layer shapes: ml-3b's layer 0 (B 96, N 511, H 8,
D = V = 32, lengths 1..511) and the long-history layer (B 2, N = Nm = 4096,
H 8, D = V = 32, lengths 3600..4096), and the peak device memory of a
K7-det call there. Its wrapper is the same in every checkout since the
relative-bias kernels took ``deterministic``, so the same file times
another checkout's K7-det, whatever its C signature: run it from both, in
turns, in one call on one card.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
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
                        _sub("for (int r = part; r < QT; r += 4) {", "for (int r = part; r < 0; r += 4) {")),
    "dq atomics": _sub("if (row < length && d < p.D) {\n                  const float4 x",
                       "if (false) {\n                  const float4 x"),
    "sigmoid": _sub("const float sig = __fdividef(1.f, 1.f + __expf(-x));", "const float sig = x;"),
    "bucket logf": _sub("int bucket = hstu::ts_bucket(tq, tk[j * 2 + c], p.NB);", "int bucket = 3;"),
    "S and dP": _sub("if (!dead) {", "if (false) {"),
    "dV and dK": _sub("for (int ks = row_step_first; ks < row_steps; ++ks) {",
                      "for (int ks = row_step_first; ks < 0; ++ks) {"),
    "dQ": _sub("for (int ks = 0; ks < my_col_steps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {"),
    "mma.sync (plain adds instead)": _NO_MMA,
    "the split (big = x, small = 0)": _NO_SPLIT,
}
# K7-det's other design for dq's ordered sum: the last block to reach a
# (batch row, head group, query tile), counted by a device-wide counter as K5
# counts its chunks, sums that tile's slots over the key tiles in ascending
# order while they may still be in L2 and writes dq (rows past the length
# zeroed before the launch); the second launch adds the table rows alone.
# The same sums in the same order as the shipped design: the same bits.
_LAST_BLOCK = "K7-det's dq summed by the last block to reach a query tile"
_K7_DESIGNS: Dict[str, Edit] = {
    _LAST_BLOCK: _both(
        _sub("  int group_slabs = 0, splits = 0;\n};", "  int group_slabs = 0, splits = 0;\n  E* dq_final = nullptr;\n};"),
        _sub("template <typename E>\nstruct SumParams {",
             "__device__ int g_det_counters[1 << 16];  // zero, and left zero by the last block\n\n"
             "template <typename E>\nstruct SumParams {"),
        _sub("      // The tile pair's dS, summed over the group's heads, into the block's\n",
             """      if constexpr (DET) {
        __shared__ int s_last;
        __syncthreads();  // the block's slot stores of this query tile are issued
        const int qt = row0 / kT;
        const int need = lower_only ? qt + 1 : (length + kT - 1) / kT;
        if (threadIdx.x == 0) {
          int* counter = g_det_counters + ((long long)b * groups + h0 / HG) * tiles + qt;
          __threadfence();
          const int arrived = atomicAdd(counter, 1);
          __threadfence();
          s_last = arrived == need - 1;
          if (s_last) atomicExch(counter, 0);
        }
        __syncthreads();
        if (s_last) {
          const int rows = min(kT, length - row0);
          for (int idx = threadIdx.x; idx < rows * nh * p.D; idx += kThreads) {
            const int r = idx / (nh * p.D), hd = idx / p.D % nh, d = idx % p.D;
            float sum = 0.f;
            for (int kt = 0; kt < need; ++kt)
              sum += __ldcg(dq_slots + ((det_slot(qt, kt, tiles, lower_only) * kT + r) * p.H + h0 + hd) * p.D + d);
            p.dq_final[(((long long)b * p.N + row0 + r) * p.H + h0 + hd) * p.D + d] = E(sum);
          }
        }
      }
      // The tile pair's dS, summed over the group's heads, into the block's
"""),
        _sub("    const int err = launch<E, /*DET=*/true>(p, route, stream);",
             "    Params<E> last = p;\n    last.dq_final = dq;\n"
             "    cudaMemsetAsync(dq, 0, (size_t)p.B * p.N * p.H * p.D * sizeof(E), s);\n"
             "    const int err = launch<E, /*DET=*/true>(last, route, stream);"),
        _sub("    sp.rows = (int)((long long)tiles * ((p.H + hg - 1) / hg) * p.B);",
             "    sp.rows = (int)((long long)tiles * ((p.H + hg - 1) / hg) * p.B);\n    sp.tiles = 0;"),
    ),
}
_K7.update({
    # K7-det's own phases (K7 runs none of them)
    "K7-det's ordered sum of the slots": _sub("for (int kt = 0; kt < kts; ++kt) {", "for (int kt = 0; kt < 0; ++kt) {"),
    "K7-det's diagonal runs": _sub(
        "if (dd < QT + kT - 1 && (dd == 0 || hstu::pos_index(last, col0 + dd - 1, p.Nm) != idx)) {", "if (false) {"),
})
# The bfloat16 bodies' knock-outs: edits of their shared helpers. cp.async as
# a synchronous 16-byte copy through registers (the same zeros where !ok);
# m16n8k16 as two TF32 m16n8k8 products on the halves of each pair (the
# bfloat16 k = 2t, 2t + 1 as the TF32 k = t, t + 4: the same exact sums)
_BF16 = "bf16_mma.cuh"
_BF16_EDITS: Dict[str, Edit] = {
    "bf16: cp.async (a synchronous copy instead)": _sub(
        '''  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");''',
        '''  (void)d;
  *reinterpret_cast<uint4*>(dst) = ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);''',
        _BF16),
    "bf16: m16n8k16 (two TF32 m16n8k8 instead)": _sub(
        '''  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
        '''  const uint32_t lo[4] = {a[0] << 16, a[1] << 16, a[0] & 0xffff0000u, a[1] & 0xffff0000u};
  const uint32_t hi[4] = {a[2] << 16, a[3] << 16, a[2] & 0xffff0000u, a[3] & 0xffff0000u};
  const uint32_t blo[2] = {b0 << 16, b0 & 0xffff0000u}, bhi[2] = {b1 << 16, b1 & 0xffff0000u};
  hstu_tf32::mma_tf32(c, lo, blo);
  hstu_tf32::mma_tf32(c, hi, bhi);''',
        _BF16),
}
# the bfloat16 backward body's phases and both bodies' tilings
_BWD16, _FWD16 = "hstu_attention_bwd_dkv_bf16.cuh", "hstu_attention_fwd_bf16.cuh"
_T32B = "template <> struct TilingBf16<32> { static constexpr int BQ = 64, BK = 64, NG = 2, NW = 8, MINB = 2; };"
_T64B = "template <> struct TilingBf16<64> { static constexpr int BQ = 128, BK = 64, NG = 4, NW = 16, MINB = 1; };"
_T32F = "template <> struct TilingBf16<32> { static constexpr int NW = 4, HG = 2, BK = 32, MINB = 4; };"
_T64F = "template <> struct TilingBf16<64> { static constexpr int NW = 4, HG = 1, BK = 64, MINB = 3; };"
_BWD16_EDITS: Dict[str, Edit] = {
    "bf16: without S and dP": _both(
        _sub("for (int ks = 0; ks < W / 16; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _BWD16),
        _sub("for (int ks = 0; ks < WV / 16; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _BWD16)),
    "bf16: without the sigmoid": _sub("const float sig = __fdividef(1.f, 1.f + __expf(-x));", "const float sig = x;",
                                      _BWD16),
    "bf16: without dV and dK": _sub("for (int ks = next_step(0); ks < row_steps;", "for (int ks = next_step(0); ks < 0;",
                                    _BWD16),
    "bf16: without dQ": _sub("for (int ks = 0; ks < my_col_steps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _BWD16),
    "bf16: without dq atomics": _sub("if (row < length && d < p.D) {\n              const float4 x",
                                     "if (false) {\n              const float4 x", _BWD16),
    "bf16: width 32 at BK 128": _sub(_T32B, _T32B.replace("BK = 64", "BK = 128"), _BWD16),
    "bf16: width 32 at BK 32": _sub(_T32B, _T32B.replace("BK = 64", "BK = 32"), _BWD16),
    "bf16: width 32 at BK 32, 3 blocks an SM": _sub(
        _T32B, _T32B.replace("BK = 64", "BK = 32").replace("MINB = 2", "MINB = 3"), _BWD16),
    "bf16: width 64 at BK 32": _sub(_T64B, _T64B.replace("BK = 64, NG = 4", "BK = 32, NG = 2"), _BWD16),
    "bf16: width 64 at BQ 64, 8 warps": _sub(
        _T64B, _T64B.replace("BQ = 128", "BQ = 64").replace("NW = 16, MINB = 1", "NW = 8, MINB = 2"), _BWD16),
    "bf16: width 64 at BQ 64, 16 warps": _sub(_T64B, _T64B.replace("BQ = 128", "BQ = 64"), _BWD16),
    "bf16: width 64 at BQ 32, 8 warps": _sub(
        _T64B, _T64B.replace("BQ = 128", "BQ = 32").replace("NW = 16, MINB = 1", "NW = 8, MINB = 2"), _BWD16),
    "bf16: width 32 at BQ 128, 16 warps": _sub(
        _T32B, _T32B.replace("BQ = 64", "BQ = 128").replace("NW = 8, MINB = 2", "NW = 16, MINB = 1"), _BWD16),
    # one MUFU instruction a sigmoid instead of two (other numbers: a time alone)
    "bf16: the sigmoid by tanh.approx": _sub(
        "const float sig = __fdividef(1.f, 1.f + __expf(-x));",
        'float th;\n              asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(0.5f * x));\n'
        "              const float sig = fmaf(0.5f, th, 0.5f);", _BWD16),
}
# K7's and K7-det's bfloat16 body: its phases, and other head groups (the
# wrapper's plan patched to match, `_plan_patch`)
_R16 = "hstu_attention_relbias_bwd_bf16.cuh"
_R16_EDITS: Dict[str, Edit] = {
    "bf16: without the table sums": _both(
        _sub("unsigned rest = __ballot_sync(kFull, ok);", "unsigned rest = 0;", _R16),
        _sub("for (int r = part; r < kT; r += 4) {", "for (int r = part; r < 0; r += 4) {", _R16)),
    "bf16: without the bucket logf": _sub("int bucket = hstu::ts_bucket(tq, tk[j * 2 + c], p.NB);", "int bucket = 3;",
                                          _R16),
    "bf16: without S and dP": _sub("if (!dead) {", "if (false) {", _R16),
    "bf16: without the sigmoid": _sub("const float sig = __fdividef(1.f, 1.f + __expf(-x));", "const float sig = x;",
                                      _R16),
    "bf16: without dV and dK": _sub("if (ks < row_step_first || ks >= row_steps) continue;", "continue;", _R16),
    "bf16: without dQ": _both(
        _sub("for (int ks = 0; ks < kT / 16; ks += 2) {", "for (int ks = 0; ks < 0; ks += 2) {", _R16),
        _sub("                if (ks >= my_col_steps) continue;\n                uint32_t a[4], kf[4];\n"
             "                hstu_bf16::ldsm(a,", "                continue;\n                uint32_t a[4], kf[4];\n"
             "                hstu_bf16::ldsm(a,", _R16)),
    **{f"bf16: width {w}, {hg} head{'s' if hg > 1 else ''} a block": _sub(
        f"template <> struct TilingBf16<{w}> {{ static constexpr int HG = {shipped}; }};",
        f"template <> struct TilingBf16<{w}> {{ static constexpr int HG = {hg}; }};", _R16)
       for w, shipped, hg in ((32, 4, 8), (32, 4, 2), (128, 2, 1))},
}
# K3-bf16's body: dS through shared memory (each warp stores its 16 rows and
# reads them back by `ldmatrix`) in place of registers, and other tilings
_Q16 = "hstu_attention_bwd_dq_bf16.cuh"
_T32Q = "template <> struct TilingBf16<32> { static constexpr int NW = 4, BK = 64, MINB = 4; };"
_T64Q = "template <> struct TilingBf16<64> { static constexpr int NW = 4, BK = 64, MINB = 3; };"
_Q16_EDITS: Dict[str, Edit] = {
    "bf16: dS through shared memory": _both(
        _sub("  return 2 * (BQ + 2 * BK) * (W + 8 + WV + 8);",
             "  return 2 * (BQ + 2 * BK) * (W + 8 + WV + 8) + 2 * BQ * (BK + 8);", _Q16),
        _sub("      // dQ += dS K over the 16-column steps that reach the warp's rows: on a\n",
             """      {  // dS stored to the warp's 16 rows of a tile, read back as A fragments
        bf16* dSw = stages + 2 * STAGE + warp * 16 * (BK + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          *reinterpret_cast<uint32_t*>(dSw + g * (BK + 8) + j * 8 + 2 * t) = da[j / 2][(j & 1) * 2];
          *reinterpret_cast<uint32_t*>(dSw + (g + 8) * (BK + 8) + j * 8 + 2 * t) = da[j / 2][(j & 1) * 2 + 1];
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) hstu_bf16::ldsm(da[kk], hstu_bf16::a_at(dSw, BK + 8, 0, kk * 16));
        __syncwarp();
      }
      // dQ += dS K over the 16-column steps that reach the warp's rows: on a
""", _Q16)),
    "bf16: without S and dP": _both(
        _sub("for (int ks = 0; ks < W / 16; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _Q16),
        _sub("for (int ks = 0; ks < WV / 16; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", _Q16)),
    "bf16: without the sigmoid": _sub("const float sig = __fdividef(1.f, 1.f + __expf(-x));", "const float sig = x;",
                                      _Q16),
    "bf16: without dQ": _sub("        if (kk < kk_end) {", "        if (false) {", _Q16),
    "bf16: width 32 at BK 32": _sub(_T32Q, _T32Q.replace("BK = 64", "BK = 32"), _Q16),
    "bf16: width 32 at 3 blocks an SM": _sub(_T32Q, _T32Q.replace("MINB = 4", "MINB = 3"), _Q16),
    "bf16: width 32, 8 warps": _sub(_T32Q, _T32Q.replace("NW = 4", "NW = 8").replace("MINB = 4", "MINB = 2"), _Q16),
    "bf16: width 64 at BK 32": _sub(_T64Q, _T64Q.replace("BK = 64", "BK = 32"), _Q16),
    "bf16: width 64 at 2 blocks an SM": _sub(_T64Q, _T64Q.replace("MINB = 3", "MINB = 2"), _Q16),
    "bf16: width 64, 8 warps": _sub(_T64Q, _T64Q.replace("NW = 4", "NW = 8").replace("MINB = 3", "MINB = 1"), _Q16),
}
_FWD16_EDITS: Dict[str, Edit] = {
    "bf16: width 32 at 3 blocks an SM": _sub(_T32F, _T32F.replace("MINB = 4", "MINB = 3"), _FWD16),
    "bf16: width 64 at 2 blocks an SM": _sub(_T64F, _T64F.replace("MINB = 3", "MINB = 2"), _FWD16),
    "bf16: width 64, two heads a block": _sub(_T64F, _T64F.replace("HG = 1", "HG = 2"), _FWD16),
    "bf16: width 32, one head a block": _sub(_T32F, _T32F.replace("HG = 2", "HG = 1"), _FWD16),
    "bf16: width 32, 8 warps": _sub(_T32F, _T32F.replace("NW = 4", "NW = 8").replace("MINB = 4", "MINB = 2"), _FWD16),
    "bf16: width 32 at BK 64": _sub(_T32F, _T32F.replace("BK = 32", "BK = 64"), _FWD16),
}
# K7's width-128 instances (float32 and bfloat16): the copies synchronous
# (both bodies' `cp.async` as a copy through registers), the bfloat16
# products as two TF32 ones, the float32 body's other tiling (64-row steps,
# one (Q, dO) stage), the table sums taken out; and the bfloat16 body's one
# head a block (the plan patched to match, `_plan_patch`)
_T128 = "template <> struct Tiling<128> { static constexpr int HG = 1, QT = 32, ST = 2; };"
_W128_EDITS: Dict[str, Edit] = {
    "w128: synchronous copies": _both(
        _sub('''  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");''',
             '''  (void)d;
  *reinterpret_cast<float4*>(dst) = ok ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);''',
             _TF32),
        _BF16_EDITS["bf16: cp.async (a synchronous copy instead)"]),
    "w128: two TF32 m16n8k8 in place of m16n8k16": _BF16_EDITS["bf16: m16n8k16 (two TF32 m16n8k8 instead)"],
    "w128: 64-row steps, one (Q, dO) stage (float32)": _sub(_T128, _T128.replace("QT = 32, ST = 2", "QT = 64, ST = 1")),
    "w128: without the table sums": _both(_K7["table sums"], _R16_EDITS["bf16: without the table sums"]),
}
# The per-pair backward (route kWideChunks, `sdp_kernel` and `grad_kernel` in
# hstu_attention_wide.cuh): each step's copies waited for before its
# products (in place of the ring of stages), no split of the S / dP steps
# (the plan patched, `_wcb_plan`: no source edit), the bfloat16 products as
# two TF32 ones
_WCB_NO_SPLIT = "wcb: no split of the S / dP steps across blocks"
_WIDE_CHUNKS_BWD_EDITS: Dict[str, Edit] = {
    "wcb: synchronous copies": _both(
        _sub("    cp_async_commit();\n    if (!dead) {",
             "    cp_async_commit();\n    cp_async_wait<0>();\n    __syncthreads();\n    if (!dead) {", "hstu_attention_wide.cuh"),
        _sub("    cp_async_wait<1>();\n    __syncthreads();  // this step's tiles are in place",
             "    cp_async_wait<0>();\n    __syncthreads();  // this step's tiles are in place", "hstu_attention_wide.cuh")),
    "wcb: the bfloat16 products as two TF32 m16n8k8": _BF16_EDITS["bf16: m16n8k16 (two TF32 m16n8k8 instead)"],
}
# The per-pair forward (the same kernels in their FWD mode): the same
# knock-outs
_WCF_NO_SPLIT = "wcf: no split of the S steps across blocks"
_WIDE_CHUNKS_FWD_EDITS: Dict[str, Edit] = {
    "wcf: synchronous copies": _WIDE_CHUNKS_BWD_EDITS["wcb: synchronous copies"],
    "wcf: the bfloat16 products as two TF32 m16n8k8": _BF16_EDITS["bf16: m16n8k16 (two TF32 m16n8k8 instead)"],
    # what is left of the S pass without its products, or without its reads
    # of Q and K (the copies fill zeros: no global reads)
    "wcf: without the S products": _sub("    cp_async_commit();\n    if (!dead) {", "    cp_async_commit();\n    if (false) {",
                                        "hstu_attention_wide.cuh"),
    "wcf: without the Q and K reads": _sub(
        "      load_step(R, qb, p.q_sn, r0, length, p.D, u * kPK, p.vec_q != 0);\n"
        "      load_step(X, kb, p.k_sn, c0, length, p.D, u * kPK, p.vec_k != 0);",
        "      load_step(R, qb, p.q_sn, r0, 0, p.D, u * kPK, p.vec_q != 0);\n"
        "      load_step(X, kb, p.k_sn, c0, 0, p.D, u * kPK, p.vec_k != 0);", "hstu_attention_wide.cuh"),
}
# The wide backward (`bwd_kernel` in hstu_attention_wide.cuh): the copies
# synchronous, the bfloat16 products as two TF32 ones (both as the width-128
# knock-outs edit them), the per-element work taken out, K7's table sums on
# one block of the cluster, or taken out
_WIDE = "hstu_attention_wide.cuh"
_WIDE_TABLES = "const int tblock = step % cl.cs;  // the step's table block"
_WIDE_BWD_EDITS: Dict[str, Edit] = {
    "wbwd: synchronous copies": _W128_EDITS["w128: synchronous copies"],
    "wbwd: two TF32 m16n8k8 in place of m16n8k16": _BF16_EDITS["bf16: m16n8k16 (two TF32 m16n8k8 instead)"],
    # the shipped design splits the per-element work across clusters of 5
    # blocks and more by fragment and repeats it in every block of a smaller
    # one (each reading every block's part of T): each way at every size
    "wbwd: the per-element work repeated at every cluster size": _sub("constexpr int kSplitFrom = 5;",
                                                                      "constexpr int kSplitFrom = 17;", _WIDE),
    "wbwd: the per-element work split at every cluster size": _sub("constexpr int kSplitFrom = 5;",
                                                                   "constexpr int kSplitFrom = 1;", _WIDE),
    "wbwd: without the per-element work (sigmoid, bias)": _both(
        _sub("          const float x = RELBIAS ? fmaf(sv, s_alpha, bias[RELBIAS ? e : 0]) : sv * s_alpha;\n"
             "          const float sig = __fdividef(1.f, 1.f + __expf(-x));",
             "          const float x = sv;\n          const float sig = x;", _WIDE),
        _sub("        bias[e] = mine && (ok_bits >> e) & 1u", "        bias[e] = false && (ok_bits >> e) & 1u", _WIDE)),
    "wbwd: the table sums on one block": _sub(_WIDE_TABLES, "const int tblock = 0;", _WIDE),
    "wbwd: without the table sums": _both(
        _sub("const bool tables = kTables && tblock == rank;", "const bool tables = false;", _WIDE),
        _sub("        if (split || tables) {\n          float* Tb", "        if (false) {\n          float* Tb", _WIDE)),
    # what the cluster costs: the stores into (split) and the loads from the
    # other blocks' buffers kept in the block's own, and the step's cluster
    # barriers taken out (the last one, before the blocks leave, stays)
    "wbwd: without distributed shared memory": _both(
        _sub("cluster.map_shared_rank(xch, warp % cl.cs)", "(xch + 0 * (warp % cl.cs))", _WIDE),
        _sub("E* Ab = split ? cluster.map_shared_rank(As, r) : As;", "E* Ab = As + 0 * r;", _WIDE),
        _sub("float* Tb = split ? cluster.map_shared_rank(Ts, tblock) : Ts;", "float* Tb = Ts + 0 * tblock;", _WIDE),
        _sub("const float* src = cluster.map_shared_rank(xb, r);", "const float* src = xb + 0 * r;", _WIDE)),
    "wbwd: without the step's cluster barriers": _both(
        _sub("    cluster_arrive();\n    // the bias while the other blocks arrive", "    // the bias", _WIDE),
        _sub("    cluster_wait();\n    // the per-element work", "    // the per-element work", _WIDE),
        _sub("      cluster_arrive();\n      cluster_wait();\n    } else {", "    } else {", _WIDE)),
    # the float32 step's share of dK, dV or dQ: in two passes over k of four
    # tiles' fresh sums each, or summed in place across the walk (as
    # bfloat16 sums; off by up to 3e-5 of the max at N 4096)
    "wbwd: float32 step sums in two passes of four tiles": _sub(
        """  float part[8][4] = {};
  for (int ks = 0; ks < steps; ++ks) {
    const FragA a = load_a(A, kXP, wm * 16, ks * 8);
#pragma unroll
    for (int n = 0; n < 8; ++n) mma3(part[n], a, load_b_kn<true>(X, kP, ks * 8, wn * 64 + n * 8));
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += part[n][c];""", """#pragma unroll
  for (int n0 = 0; n0 < 8; n0 += 4) {
    float part[4][4] = {};
    for (int ks = 0; ks < steps; ++ks) {
      const FragA a = load_a(A, kXP, wm * 16, ks * 8);
#pragma unroll
      for (int n = 0; n < 4; ++n) mma3(part[n], a, load_b_kn<true>(X, kP, ks * 8, wn * 64 + (n0 + n) * 8));
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n0 + n][c] += part[n][c];
  }""", _WIDE),
    "wbwd: float32 summed in place across the walk": _sub(
        "mma3(part[n], a, load_b_kn<true>(X, kP, ks * 8, wn * 64 + n * 8));",
        "mma3(acc[n], a, load_b_kn<true>(X, kP, ks * 8, wn * 64 + n * 8));", _WIDE),
    "wbwd: without the products": _both(
        _sub("          part_product(tp, Rs", "          if (false) part_product(tp, Rs", _WIDE),
        _sub("    if ((kDkv || is_d) && (part_live[2 * wm] || part_live[2 * wm + 1])) {",
             "    if (false && (part_live[2 * wm] || part_live[2 * wm + 1])) {", _WIDE),
        _sub("          dq_product(dq, As, Rs", "          if (false) dq_product(dq, As, Rs", _WIDE)),
}
# The wide forward (`fwd_kernel` in hstu_attention_wide.cuh): the copies
# synchronous (the next step's rows waited for where they are asked for),
# bfloat16 through two TF32 products (the width-128 knock-out's edit of the
# shared m16n8k16), the split of the per-element work at every size or none,
# the cluster's remote accesses and barriers, the products
_WIDE_FWD_EDITS: Dict[str, Edit] = {
    "wfwd: synchronous copies": _sub(
        "    if (s0 + kS < end) load_step(stage ^ 1, s0 + kS);  // the next step's, into the other stage\n"
        "    cp_async_commit();\n",
        "    if (s0 + kS < end) load_step(stage ^ 1, s0 + kS);  // the next step's, into the other stage\n"
        "    cp_async_commit();\n    cp_async_wait_all();\n    __syncthreads();\n", _WIDE),
    "wfwd: bfloat16 through two TF32 m16n8k8 in place of m16n8k16":
        _BF16_EDITS["bf16: m16n8k16 (two TF32 m16n8k8 instead)"],
    "wfwd: the per-element work repeated at every cluster size": _sub("constexpr int kFwdSplitFrom = 4;",
                                                                      "constexpr int kFwdSplitFrom = 17;", _WIDE),
    "wfwd: the per-element work split at every cluster size": _sub("constexpr int kFwdSplitFrom = 4;",
                                                                   "constexpr int kFwdSplitFrom = 1;", _WIDE),
    "wfwd: without distributed shared memory": _both(
        _sub("cluster.map_shared_rank(xch, warp % cs)", "(xch + 0 * (warp % cs))", _WIDE),
        _sub("E* Pb = SPLIT ? cluster.map_shared_rank(Ps, r) : Pt;", "E* Pb = Pt + 0 * r;", _WIDE),
        _sub("const float* src = cluster.map_shared_rank(xs, r);", "const float* src = xs + 0 * r;", _WIDE)),
    "wfwd: without the step's cluster barriers": _both(
        _sub("    cluster_arrive();\n    // the bias, while the other blocks arrive", "    // the bias", _WIDE),
        _sub("    cluster_wait();\n    if (mine) {", "    if (mine) {", _WIDE),
        _sub("    } else {  // every block's P tile and the flags are whole\n      cluster_arrive();\n      cluster_wait();\n",
             "    } else {  // every block's P tile and the flags are whole\n", _WIDE)),
    "wfwd: without the products": _both(
        _sub("        if (kw > 0) part_product(sp,", "        if (false) part_product(sp,", _WIDE),
        _sub("        if (i < cl.mv && ntiles > 0) pv_product(", "        if (false) pv_product(", _WIDE)),
    "wfwd: without the per-element work (silu, bias)": _both(
        _sub("          pe[e] = __fdividef(x, 1.f + __expf(-x));", "          pe[e] = x;", _WIDE),
        _sub("        if (mine && (ok_bits >> e) & 1u) {\n          if constexpr (BIAS == kRelBias) {",
             "        if (false && (ok_bits >> e) & 1u) {\n          if constexpr (BIAS == kRelBias) {", _WIDE)),
    # a block per chunk of D too (twice the blocks where D is the wider,
    # each with half the columns)
    "wfwd: a block per chunk of D": _sub(
        "  const int cs = min(kMaxCluster, max((chunks(D) + 1) / 2, chunks(V)));",
        "  const int cs = min(kMaxCluster, max(chunks(D), chunks(V)));", _WIDE),
    # at D = V = 256 (two chunks of each): 3 or 4 blocks of 96 or 64
    # columns, whose float32 tiles let two blocks share an SM
    "wfwd: 3 blocks at D = V = 256": _sub(
        "  const int cs = min(kMaxCluster, max((chunks(D) + 1) / 2, chunks(V)));",
        "  const int cs = chunks(D) == 2 && chunks(V) == 2 ? 3 : min(kMaxCluster, max((chunks(D) + 1) / 2, chunks(V)));",
        _WIDE),
    "wfwd: 4 blocks at D = V = 256": _sub(
        "  const int cs = min(kMaxCluster, max((chunks(D) + 1) / 2, chunks(V)));",
        "  const int cs = chunks(D) == 2 && chunks(V) == 2 ? 4 : min(kMaxCluster, max((chunks(D) + 1) / 2, chunks(V)));",
        _WIDE),
}
# The tile forward (`tile_fwd_kernel`): the copies synchronous (each step's
# rows issued and waited for at its start), S formed whole by each warp of a
# row group (its half's products twice, no exchange), Q reloaded from device
# memory every key step, K and V split once as they land (below), and each
# phase taken out: S's products, P V's, the per-element work, the
# exchange's barrier, the K and V copies
# K and V split once as they land (where Q is in registers, D up to 128:
# the small parts' tiles of one stage fit beside the two raw stages): after
# the step's copies arrive, the block splits the stage in place into the big
# parts and writes the small parts to tiles of their own, one more barrier a
# step; the fragments then read both parts and split nothing
_TILE_SPLIT_ONCE = """\
__device__ __forceinline__ void tile_split(float* big, float* small, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kBwdThreads) {
    const float4 x = *reinterpret_cast<const float4*>(big + i);
    uint32_t b[4], s[4];
    split(x.x, b[0], s[0]);
    split(x.y, b[1], s[1]);
    split(x.z, b[2], s[2]);
    split(x.w, b[3], s[3]);
    *reinterpret_cast<float4*>(big + i) =
        make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]), __uint_as_float(b[3]));
    *reinterpret_cast<float4*>(small + i) =
        make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}
__device__ __forceinline__ FragB tile_b_nk(const float* X, const float* L, int pitch, int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3, o = (n0 + g) * pitch + k0 + 2 * t;
  const float2 x = *reinterpret_cast<const float2*>(X + o), y = *reinterpret_cast<const float2*>(L + o);
  return FragB{{__float_as_uint(x.x), __float_as_uint(x.y)}, {__float_as_uint(y.x), __float_as_uint(y.y)}};
}
__device__ __forceinline__ FragB tile_b_kn(const float* X, const float* L, int pitch, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3, o = (k0 + 2 * t) * pitch + n0 + g;
  return FragB{{__float_as_uint(X[o]), __float_as_uint(X[o + pitch])},
               {__float_as_uint(L[o]), __float_as_uint(L[o + pitch])}};
}
"""
_TILE_WAIT = ("    cp_async_wait_all();\n"
              "    __syncthreads();  // the step's K and V rows are in place; every warp is done with the last step's\n")
_WIDE_TILE_EDITS: Dict[str, Edit] = {
    "wfwd: tile, synchronous copies": _sub(
        _TILE_WAIT + "    if (s0 + kTileStep < end)\n"
        "      tile_issue(Ks + ((step + 1) & 1) * k_stage, Vs + ((step + 1) & 1) * v_stage, kb, vb, p, s0 + kTileStep, length,\n"
        "                 dp, vp);\n"
        "    cp_async_commit();\n",
        "    __syncthreads();\n"
        "    if (s0 > 0) tile_issue(Ks + (step & 1) * k_stage, Vs + (step & 1) * v_stage, kb, vb, p, s0, length, dp, vp);\n"
        "    cp_async_commit();\n" + _TILE_WAIT, _WIDE),
    "wfwd: tile, S formed per V half": _both(
        _sub("    for (int kq = 0; kq < (QK > 0 ? QK : kTileMaxD / 16); ++kq) {\n",
             "    for (int rep = 0; rep < 2; ++rep)\n    for (int kq = 0; kq < (QK > 0 ? QK : kTileMaxD / 16); ++kq) {\n",
             _WIDE),
        _sub("    pair_sync(wm);  // both parts of the row group's S are in place\n", "", _WIDE),
        _sub("const float4 x0 = mine[32 * j], x1 = other[32 * j];", "const float4 x0 = mine[32 * j], x1 = x0;", _WIDE)),
    "wfwd: tile, Q reloaded per key tile": _sub(
        _TILE_WAIT, "    if constexpr (QK > 0) tile_load_q<QK>(q, qb, p, r_first, length, d_lo, nks);\n"
        "    else tile_rows<kTileRows>(Qs, qb, p.q_sn, base, length, p.D, dp, kp, p.vec_q != 0);\n"
        "    cp_async_commit();\n" + _TILE_WAIT, _WIDE),
    "wfwd: tile, Q in registers at D past 128": _sub("tile_width(p.D) > 128 ? tile_fwd_kernel<BIAS, 0, 16>",
                                                     "tile_width(p.D) > 128 ? tile_fwd_kernel<BIAS, 16, 16>", _WIDE),
    "wfwd: tile, without S's products": _sub("      if (kq >= nks) break;\n      FragA a;",
                                             "      if (kq >= 0) break;\n      FragA a;", _WIDE),
    "wfwd: tile, without P V's products": _sub("        const FragA a = frag_a_c(pj[j]);\n",
                                               "        if (j >= 0) break;\n        const FragA a = frag_a_c(pj[j]);\n",
                                               _WIDE),
    "wfwd: tile, without the per-element work": _sub("        x = __fdividef(x, 1.f + __expf(-x));\n        pj[j][c]",
                                                     "        pj[j][c]", _WIDE),
    "wfwd: tile, without the exchange's barrier": _sub("    pair_sync(wm);  // both parts of the row group's S are in place\n",
                                                       "", _WIDE),
    "wfwd: tile, without K and V copies": _sub("    if (s0 + kTileStep < end)\n      tile_issue(",
                                               "    if (false)\n      tile_issue(", _WIDE),
    "wfwd: tile, K and V split once as they land (D up to 128)": _both(
        _sub("(tile_width(D) > 128 ? 4 * kTileRows * (tile_width(D) + 8) : 0);",
             "(tile_width(D) > 128 ? 4 * kTileRows * (tile_width(D) + 8)\n"
             "                             : 4 * kTileStep * (tile_width(D) + 8 + tile_width(V) + 4));", _WIDE),
        _sub("template <int BIAS, int QK, int NTV>\n__global__ void __launch_bounds__(kBwdThreads, 1) tile_fwd_kernel",
             _TILE_SPLIT_ONCE + "template <int BIAS, int QK, int NTV>\n"
             "__global__ void __launch_bounds__(kBwdThreads, 1) tile_fwd_kernel", _WIDE),
        _sub("  float* Qs = xch + 4 * NS * kBwdThreads;  // QK 0: [64][kp]\n",
             "  float* Qs = xch + 4 * NS * kBwdThreads;  // QK 0: [64][kp]\n"
             "  float* Kl = Qs;                         // QK > 0: the step's small parts, K [32][kp]\n"
             "  float* Vl = Kl + kTileStep * kp;        // and V [32][vpp]\n", _WIDE),
        _sub("s0 + kTileStep, length,\n                 dp, vp);\n    cp_async_commit();\n",
             "s0 + kTileStep, length,\n                 dp, vp);\n    cp_async_commit();\n"
             "    if constexpr (QK > 0) {\n"
             "      tile_split(const_cast<float*>(ks), Kl, k_stage);\n"
             "      tile_split(const_cast<float*>(vs), Vl, v_stage);\n"
             "      __syncthreads();\n"
             "    }\n", _WIDE),
        _sub("const FragB f = load_b_nk(ks, kp, 8 * j, d_lo + 8 * kq);",
             "const FragB f = QK > 0 ? tile_b_nk(ks, Kl, kp, 8 * j, d_lo + 8 * kq)\n"
             "                               : load_b_nk(ks, kp, 8 * j, d_lo + 8 * kq);", _WIDE),
        _sub("const FragB f = load_b_kn<true>(vw, vpp, 8 * j, (n0 + n) * 8);",
             "const FragB f = QK > 0 ? tile_b_kn(vw, Vl + wn * vh, vpp, 8 * j, (n0 + n) * 8)\n"
             "                                 : load_b_kn<true>(vw, vpp, 8 * j, (n0 + n) * 8);", _WIDE)),
}
# the knock-out that needs no build: the per-pair forward's route forced
_WFWD_CHUNKS = "wfwd: the per-pair forward (its route forced)"
# K1 and K6: edits of their shared body
_FWD = "hstu_attention_fwd.cuh"
_BIAS = "the bias (its logf, its table reads)"
_K16: Dict[str, Edit] = {
    "silu": _sub("s[j][c] = __fdividef(x, 1.f + __expf(-x));", "s[j][c] = x;", _FWD),
    _BIAS: _sub(
        "bias[RELBIAS ? 4 * j + c : 0] = pos_s[hstu::pos_index(row, col, p.Nm)] +\n"
        "                                              ts_s[hstu::ts_bucket(tq[c >> 1], tk_s[col], p.NB)];",
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
    "Q's loads": _sub("for (int hh = 0; hh < nh; ++hh)\n      load_tile<W, PQ, kRows, kThreads>",
                      "for (int hh = 0; hh < 0; ++hh)\n      load_tile<W, PQ, kRows, kThreads>", _FWD),
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
    "the last block's sum": _sub("  if (!*s_last) return;\n", "  return;\n"),
    "K loads": _sub("      kr[i] = (col < length && at < p.D) ? load4", "      kr[i] = (col < length && at < 0) ? load4"),
    "V loads": _sub("      vr[j] = (c0 + j < length && at < vw)", "      vr[j] = (c0 + j < length && at < 0)"),
    "silu": _sub("float pv = ok ? x / (1.f + expf(-x)) : 0.f;", "float pv = ok ? x : 0.f;"),
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
        ("hstu_mha_relbias_bwd", _LAST_BLOCK, (_LAST_BLOCK,)),
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
    + [(kernel, label, phases)
       for kernel in ("hstu_mha_fwd", "hstu_mha_bwd_fused", "hstu_mha_bwd_dkv")
       for label, phases in [("bf16: as shipped", ())] + [(name, (name,)) for name in _BF16_EDITS]
       + [(name, (name,)) for name in (_FWD16_EDITS if kernel == "hstu_mha_fwd" else _BWD16_EDITS)
          if kernel == "hstu_mha_bwd_fused" or name not in ("bf16: without dQ", "bf16: without dq atomics")]]
    + [("hstu_mha_relbias_fwd", "bf16: as shipped", ())]
    + [("hstu_mha_relbias_fwd", name, (name,)) for name in _FWD16_EDITS]
    + [(kernel, label, phases)
       for kernel, own in (("hstu_mha_relbias_bwd", _R16_EDITS), ("hstu_mha_bwd_dq", _Q16_EDITS))
       for label, phases in [("bf16: as shipped", ())] + [(name, (name,)) for name in {**_BF16_EDITS, **own}]]
    + [("hstu_mha_relbias_bwd", "bf16: without the table sums and the bucket logf",
        ("bf16: without the table sums", "bf16: without the bucket logf"))]
    + [("hstu_mha_relbias_bwd", "w128: as shipped", ())]
    + [("hstu_mha_relbias_bwd", name, (name,)) for name in _W128_EDITS]
    + [(kernel, label, phases)
       for kernel in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dq", "hstu_mha_relbias_bwd")
       for label, phases in [("wbwd: as shipped", ())] + [(name, (name,)) for name in _WIDE_BWD_EDITS
                                                          if kernel == "hstu_mha_relbias_bwd" or "table" not in name]]
    + [(kernel, label, phases)
       for kernel in ("hstu_mha_fwd", "hstu_mha_relbias_fwd")
       for label, phases in [("wfwd: as shipped", ()), (_WFWD_CHUNKS, ())]
       + [(name, (name,)) for name in _WIDE_FWD_EDITS]]
    + [("hstu_mha_fwd", "wfwd: tile, as shipped", ())]
    + [("hstu_mha_fwd", name, (name,)) for name in _WIDE_TILE_EDITS]
    + [(kernel, label, phases)
       for kernel in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dq", "hstu_mha_bwd_dkv", "hstu_mha_relbias_bwd")
       for label, phases in [("wcb: as shipped", ()), (_WCB_NO_SPLIT, ())]
       + [(name, (name,)) for name in _WIDE_CHUNKS_BWD_EDITS]]
    + [(kernel, label, phases)
       for kernel in ("hstu_mha_fwd", "hstu_mha_relbias_fwd")
       for label, phases in [("wcf: as shipped", ()), (_WCF_NO_SPLIT, ())]
       + [(name, (name,)) for name in _WIDE_CHUNKS_FWD_EDITS]]
)
_EDITS = {"hstu_mha_relbias_bwd": {**_K7, **_K7_DESIGNS, **_BF16_EDITS, **_R16_EDITS, **_W128_EDITS, **_WIDE_BWD_EDITS,
                                   **_WIDE_CHUNKS_BWD_EDITS},
          "delta_hstu_mha_fwd": _K5,
          "hstu_mha_fwd": {**_K16, **_BF16_EDITS, **_FWD16_EDITS, **_WIDE_FWD_EDITS, **_WIDE_TILE_EDITS,
                           **_WIDE_CHUNKS_FWD_EDITS},
          "hstu_mha_relbias_fwd": {**_K16, **_FWD16_EDITS, **_WIDE_FWD_EDITS, **_WIDE_CHUNKS_FWD_EDITS},
          "hstu_mha_bwd_fused": {**_K24, **_BF16_EDITS, **_BWD16_EDITS, **_WIDE_BWD_EDITS, **_WIDE_CHUNKS_BWD_EDITS},
          "hstu_mha_bwd_dkv": {**_K24, **_BF16_EDITS, **_BWD16_EDITS, **_WIDE_CHUNKS_BWD_EDITS},
          "hstu_mha_bwd_dq": {**_K3, **_BF16_EDITS, **_Q16_EDITS, **_WIDE_BWD_EDITS, **_WIDE_CHUNKS_BWD_EDITS}}


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
            [nvcc, *build.nvcc_flags(kernel), "-I", d, "-I", build.CSRC_DIR, "-o", os.path.join(d, f"lib{kernel}.so"),
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
            [nvcc, *build.nvcc_flags(kernel), "-I", csrc, "-o", os.path.join(d, f"lib{kernel}.so"),
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

    def k7det():
        return hstu_mha_relbias_bwd_cuda(q, k, v, lens, ts, pos_w, ts_w, do, alpha=1.0, max_seq_len=N,
                                         deterministic=True)

    # K7-det also at the long-history layer (B 2, N = Nm = 4096: the tables read)
    LB, LN = 2, 4096
    _, lv, lq, lk = torch.split(rand(LB, LN, 4 * H * D), [H * D] * 4, dim=-1)
    lq, lk, lv = (x.reshape(LB, LN, H, D) for x in (lq, lk, lv))
    l_lens = ints(3600, LN + 1, LB)
    l_ts = 1_500_000_000 + torch.cumsum(torch.randint(1, 86400, (LB, LN), device="cuda", generator=gen), 1)
    l_pos, l_do = rand(2 * LN - 1) * 0.1, rand(LN, LB, H, D).transpose(0, 1)

    def k7det_long():
        return hstu_mha_relbias_bwd_cuda(lq, lk, lv, l_lens, l_ts, l_pos, ts_w, l_do, alpha=1.0, max_seq_len=LN,
                                         deterministic=True)

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
    if args == ["--det"]:
        det_times(device_ms, rand, ints, gen)
        return
    if args == ["--bf16"]:
        bf16_times(device_ms, bf16_inputs(rand, gen), chunks=True)
        return
    if args == ["--wide"]:
        wide_times(device_ms, wide_inputs(rand, gen))
        k5_times(device_ms, rand, ints)
        return
    if args == ["--wide-bwd"]:
        wide_bwd_times(device_ms, wide_bwd_inputs(rand, gen))
        return
    if args == ["--wide-fwd"]:
        wide_fwd_times(device_ms, wide_fwd_inputs(rand, gen))
        return
    if args == ["--wide-chunks-bwd"]:
        wide_bwd_times(device_ms, wide_bwd_inputs(rand, gen, _WIDE_CHUNKS_BWD_SHAPES))
        return
    if args[:1] == ["--wide-chunks-bwd-variants"]:
        inputs = wide_bwd_inputs(rand, gen, _WIDE_CHUNKS_BWD_SHAPES)
        # naming kernels keeps their libraries' variants
        chosen = [i for i, (kernel, label, _) in enumerate(VARIANTS)
                  if label.startswith("wcb") and (len(args) == 1 or kernel in args[1:])]
        root = os.path.join(build.BUILD_DIR, "variants")
        try:
            _build_all(root, chosen)
            for i in chosen:
                kernel, label, _ = VARIANTS[i]
                build._libs.clear()
                _preload(kernel, os.path.join(root, f"v{i}"))
                relbias = kernel == "hstu_mha_relbias_bwd"
                only = {"hstu_mha_bwd_fused": ("K2", "K2-bf16"), "hstu_mha_bwd_dq": ("K3", "K3-bf16"),
                        "hstu_mha_bwd_dkv": ("K4", "K4-bf16")}.get(kernel)
                with _wcb_plan(label):
                    wide_bwd_times(device_ms, {k_: v_ for k_, v_ in inputs.items()
                                               if (v_["tables"] is not None) == relbias},
                                   label=f"{label} ({kernel})", plain=False, only=only)
        finally:
            build._libs.clear()
        return
    if args == ["--wide-chunks-fwd"]:
        wide_fwd_times(device_ms, wide_fwd_inputs(rand, gen, _WIDE_CHUNKS_FWD_SHAPES))
        return
    if args[:1] == ["--wide-chunks-fwd-variants"]:
        inputs = wide_fwd_inputs(rand, gen, _WIDE_CHUNKS_FWD_SHAPES)
        # naming kernels keeps their libraries' variants
        chosen = [i for i, (kernel, label, _) in enumerate(VARIANTS)
                  if label.startswith("wcf") and (len(args) == 1 or kernel in args[1:])]
        root = os.path.join(build.BUILD_DIR, "variants")
        try:
            _build_all(root, chosen)
            for i in chosen:
                kernel, label, _ = VARIANTS[i]
                build._libs.clear()
                _preload(kernel, os.path.join(root, f"v{i}"))
                relbias = kernel == "hstu_mha_relbias_fwd"
                with _wcb_plan(label):
                    wide_fwd_times(device_ms, {k_: v_ for k_, v_ in inputs.items()
                                               if (v_["tables"] is not None) == relbias},
                                   label=f"{label} ({kernel})", plain=False)
        finally:
            build._libs.clear()
        return
    if args == ["--wide-fwd-routes"]:
        wide_fwd_route_times(device_ms, rand, gen)
        return
    if args[:1] == ["--wide-fwd-variants"]:
        inputs = wide_fwd_inputs(rand, gen)
        # kernels' names keep those kernels' variants, other TEXTs those whose label holds one
        kernels = [a for a in args[1:] if a in build.KERNEL_SOURCES]
        texts = [a for a in args[1:] if a not in kernels]
        chosen = [i for i, (kernel, label, _) in enumerate(VARIANTS)
                  if label.startswith("wfwd") and (not kernels or kernel in kernels)
                  and (not texts or any(a in label for a in texts))]
        root = os.path.join(build.BUILD_DIR, "variants")
        try:
            _build_all(root, chosen)
            for i in chosen:
                kernel, label, _ = VARIANTS[i]
                build._libs.clear()
                _preload(kernel, os.path.join(root, f"v{i}"))
                relbias = kernel == "hstu_mha_relbias_fwd"
                with (_fwd_pairs_forced() if label == _WFWD_CHUNKS else contextlib.nullcontext()):
                    wide_fwd_times(device_ms, {k_: v_ for k_, v_ in inputs.items()
                                               if (v_["tables"] is not None) == relbias and "long" not in k_},
                                   label=f"{label} ({kernel})", plain=False)
        finally:
            build._libs.clear()
        return
    if args[:1] == ["--wide-bwd-variants"]:
        inputs = wide_bwd_inputs(rand, gen)
        # naming kernels keeps their libraries' variants
        chosen = [i for i, (kernel, label, _) in enumerate(VARIANTS)
                  if label.startswith("wbwd") and (len(args) == 1 or kernel in args[1:])]
        root = os.path.join(build.BUILD_DIR, "variants")
        try:
            _build_all(root, chosen)
            for i in chosen:
                kernel, label, _ = VARIANTS[i]
                build._libs.clear()
                _preload(kernel, os.path.join(root, f"v{i}"))
                relbias = kernel == "hstu_mha_relbias_bwd"
                only = {"hstu_mha_bwd_fused": ("K2", "K2-bf16"), "hstu_mha_bwd_dq": ("K3", "K3-bf16")}.get(kernel)
                wide_bwd_times(device_ms, {k_: v_ for k_, v_ in inputs.items() if (v_["tables"] is not None) == relbias
                                           and (kernel == "hstu_mha_bwd_dq" or "ranker" not in k_)},
                               label=f"{label} ({kernel})", plain=False, only=only)
        finally:
            build._libs.clear()
        return
    if args == ["--wide-variants"]:
        inputs = {k_: v_ for k_, v_ in wide_inputs(rand, gen).items() if k_.startswith("wide-head layer")}
        chosen = [i for i, (_, label, _) in enumerate(VARIANTS)
                  if label.startswith("w128") or label == "bf16: width 128, 1 head a block"]
        root = os.path.join(build.BUILD_DIR, "variants")
        try:
            _build_all(root, chosen)
            for i in chosen:
                kernel, label, _ = VARIANTS[i]
                build._libs.clear()
                _preload(kernel, os.path.join(root, f"v{i}"))
                with _plan_patch(label):
                    wide_times(device_ms, inputs, label=label, forced=False)
        finally:
            build._libs.clear()
        return
    if args[:1] == ["--bf16-variants"]:
        inputs = bf16_inputs(rand, gen)
        # kernels' names keep those kernels' variants, other TEXTs those whose label holds one
        kernels = [a for a in args[1:] if a in build.KERNEL_SOURCES]
        texts = [a for a in args[1:] if a not in kernels]
        chosen = [i for i, (kernel, label, _) in enumerate(VARIANTS)
                  if label.startswith("bf16") and (not kernels or kernel in kernels)
                  and (not texts or label == "bf16: as shipped" or any(a in label for a in texts))]
        root = os.path.join(build.BUILD_DIR, "variants")
        try:
            _build_all(root, chosen)
            for i in chosen:
                kernel, label, _ = VARIANTS[i]
                build._libs.clear()
                _preload(kernel, os.path.join(root, f"v{i}"))
                with _plan_patch(label):
                    bf16_times(device_ms, inputs, only=_BF16_KERNEL[kernel], label=label)
        finally:
            build._libs.clear()
        return
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
        # the shipped K7-det's outputs, which a design that sums in the same
        # order must give bit for bit
        shipped_det = [k7det(), k7det_long()] if any(VARIANTS[i][1] in _K7_DESIGNS for i in chosen) else None
        _build_all(root, chosen)
        for i in chosen:
            kernel, label, _ = VARIANTS[i]
            build._libs.clear()
            _preload(kernel, os.path.join(root, f"v{i}"))
            fn, reps = timed[kernel]
            det = ""
            if kernel == "hstu_mha_relbias_bwd":
                det = f", K7-det {device_ms(k7det, reps):.4f} ms, at N 4096 {device_ms(k7det_long, reps):.4f} ms"
                if label in _K7_DESIGNS:
                    same = all(torch.equal(a, b) for got, want in zip((k7det(), k7det_long()), shipped_det)
                               for a, b in zip(got, want))
                    det += f" (the shipped K7-det's bits: {same})"
            print(f"{kernel:22s} {label:45s} {device_ms(fn, reps):.4f} ms{det}")
    finally:
        build._libs.clear()


def det_times(device_ms, rand, ints, gen) -> None:
    """K7 and K7-det (float32, bfloat16) at ml-3b's layer 0 and the
    long-history layer, each on q/k/v views of one projection and a strided
    dO; the peak device memory of K7-det at the long-history layer."""
    import torch

    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import hstu_mha_relbias_bwd_cuda

    for name, B, N, lo in (("ml-3b layer 0", 96, 511, 1), ("long-history layer", 2, 4096, 3600)):
        H, D = 8, 32
        _, v, q, k = torch.split(rand(B, N, 4 * H * D), [H * D] * 4, dim=-1)
        lens = ints(lo, N + 1, B)
        steps = torch.randint(1, 86400, (B, N), device="cuda", generator=gen)
        ts = (1_500_000_000 + torch.cumsum(steps, 1)) * (torch.arange(N, device="cuda")[None] <= lens[:, None])
        pos_w, ts_w = rand(2 * N - 1) * 0.1, rand(129) * 0.1
        do = rand(N, B, H, D).transpose(0, 1)
        for dtype in (torch.float32, torch.bfloat16):
            q_, k_, v_, do_ = (x.reshape(B, N, H, D).to(dtype) if x is not do else x.to(dtype)
                               for x in (q, k, v, do))
            times = {}
            for det in (False, True, True, False):
                def fn():
                    hstu_mha_relbias_bwd_cuda(q_, k_, v_, lens, ts, pos_w, ts_w, do_, alpha=1.0, max_seq_len=N,
                                              deterministic=det)
                times.setdefault(det, []).append(device_ms(fn, 10))
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            hstu_mha_relbias_bwd_cuda(q_, k_, v_, lens, ts, pos_w, ts_w, do_, alpha=1.0, max_seq_len=N,
                                      deterministic=True)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            print(f"{name} (B {B}, N {N}, H {H}, D = V = {D}) {str(dtype)[6:]}: K7-det "
                  + " / ".join(f"{t:.4f}" for t in times[True]) + " ms, K7 "
                  + " / ".join(f"{t:.4f}" for t in times[False]) + f" ms; K7-det's call {peak:.1f} MiB above its inputs")


# the bfloat16 kernels each variant's library holds, as `bf16_times` names them
_BF16_KERNEL = {"hstu_mha_fwd": ("K1-bf16",), "hstu_mha_bwd_fused": ("K2-bf16",), "hstu_mha_bwd_dkv": ("K4-bf16",),
                "hstu_mha_relbias_fwd": ("K6-bf16",), "hstu_mha_relbias_bwd": ("K7-bf16", "K7-det-bf16"),
                "hstu_mha_bwd_dq": ("K3-bf16",)}


@contextlib.contextmanager
def _plan_patch(label: str):
    """The wrapper's plan matched to a variant that changes what the plan
    mirrors: K7's bfloat16 head group (K7-det sizes its buffers by it)."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    shipped = dict(hr._HEAD_GROUP_BF16)
    group = re.fullmatch(r"bf16: width (\d+), (\d+) heads? a block", label)
    if group:
        hr._HEAD_GROUP_BF16[int(group[1])] = int(group[2])
    try:
        yield
    finally:
        hr._HEAD_GROUP_BF16.update(shipped)


def bf16_inputs(rand, gen) -> Dict[str, tuple]:
    """The bfloat16 kernels' inputs by shape: bench.py's at N 2048 and 4096
    (q, k, v and dO from default_rng(0), after the lengths, as bench.py makes
    them) and ml-3b's block 0 (q, k, v views of one bfloat16 uvqk projection,
    a strided dO, lengths 1..511, timestamps and both tables for K6, a
    bfloat16 [B, N, N] bias for K1-bias); each (q, k, v, lengths, dO, the
    wrappers' keywords, extras)."""
    import numpy as np
    import torch

    bf = torch.bfloat16
    shapes = {}
    for N in (2048, 4096):
        B, H, D = 8, 4, 64
        rng = np.random.default_rng(0)
        lens = torch.as_tensor(np.clip(rng.integers(N // 8, N, size=(B,)), 1, N), dtype=torch.int32, device="cuda")
        q, k, v, do = (torch.as_tensor(rng.standard_normal((B, N, H, D), np.float32) * 0.1, device="cuda").to(bf)
                       for _ in range(4))
        shapes[f"bench.py's shape (B {B}, N {N}, H {H}, D {D})"] = (q, k, v, lens, do, dict(alpha=D**-0.5,
                                                                                             max_seq_len=N), {})
    B, N, H, D = 96, 511, 8, 32
    _, v, q, k = torch.split(rand(B, N, 4 * H * D).to(bf), [H * D] * 4, dim=-1)
    q, k, v = (x.reshape(B, N, H, D) for x in (q, k, v))
    lens = torch.randint(1, N + 1, (B,), device="cuda", generator=gen, dtype=torch.int32)
    steps = torch.randint(1, 86400, (B, N), device="cuda", generator=gen)
    ts = (1_500_000_000 + torch.cumsum(steps, 1)) * (torch.arange(N, device="cuda")[None] <= lens[:, None])
    extras = dict(ts=ts, pos_w=rand(2 * N - 1) * 0.1, ts_w=rand(129) * 0.1, bias=(rand(B, N, N) * 0.1).to(bf))
    shapes[f"ml-3b block 0 (B {B}, N {N}, H {H}, D {D})"] = (q, k, v, lens, rand(N, B, H, D).to(bf).transpose(0, 1),
                                                             dict(alpha=1.0, max_seq_len=N), extras)
    # the long-history layer: ml-3b's widths at N = Nm = 4096, K7 alone
    B, N = 2, 4096
    _, v, q, k = torch.split(rand(B, N, 4 * H * D).to(bf), [H * D] * 4, dim=-1)
    q, k, v = (x.reshape(B, N, H, D) for x in (q, k, v))
    lens = torch.randint(3600, N + 1, (B,), device="cuda", generator=gen, dtype=torch.int32)
    ts = 1_500_000_000 + torch.cumsum(torch.randint(1, 86400, (B, N), device="cuda", generator=gen), 1)
    extras = dict(ts=ts, pos_w=rand(2 * N - 1) * 0.1, ts_w=rand(129) * 0.1, kernels=("K7-bf16", "K7-det-bf16"))
    shapes[f"long-history layer (B {B}, N = Nm = {N}, H {H}, D {D})"] = (
        q, k, v, lens, rand(N, B, H, D).to(bf).transpose(0, 1), dict(alpha=1.0, max_seq_len=N), extras)
    return shapes


def bf16_times(device_ms, inputs: Dict[str, tuple], only: Optional[Tuple[str, ...]] = None, label: str = "",
               chunks: bool = False) -> None:
    """Prints the bfloat16 kernels' times (``only``: some of them) at each
    shape of ``inputs`` (`bf16_inputs`), each the mean of its launches
    through the wrapper (K3-bf16 through `_bwd_kernel`, K7-bf16 and
    K7-det-bf16 through `hstu_mha_relbias_bwd_cuda`: calls that every
    checkout since the relative-bias backward took ``deterministic`` has);
    the split K3-bf16 + K4-bf16 against K2-bf16; at bench.py's shape also
    the pair K1-bf16 + K2-bf16 in TFLOP/s under bench.py's FLOP model; with
    ``chunks``, K1-bf16 at bench.py's shapes with other chunks of its walks
    (no bound on their number) and with none, where the checkout cuts walks
    in chunks."""
    import torch

    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import (
        hstu_mha_dense_relbias_cuda,
        hstu_mha_relbias_bwd_cuda,
    )

    for shape, (q, k, v, lens, do, kw, ex) in inputs.items():
        one = dict(kw, causal=True, max_attn_len=0, contextual_seq_len=0, min_full_attn_seq_len=0)
        fns = {
            "K1-bf16": (lambda: ha.hstu_mha_dense_cuda(q, k, v, lens, **kw), 50),
            "K2-bf16": (lambda: ha.hstu_mha_bwd_cuda(q, k, v, lens, do, **kw), 20),
            "K3-bf16": (lambda: ha._bwd_kernel("hstu_mha_bwd_dq_bf16", q, k, v, lens, None, do, one), 20),
            "K4-bf16": (lambda: ha._bwd_kernel("hstu_mha_bwd_dkv_bf16", q, k, v, lens, None, do, one), 20),
        }
        if ex:
            fns["K6-bf16"] = (lambda: hstu_mha_dense_relbias_cuda(q, k, v, lens, ex["ts"], ex["pos_w"], ex["ts_w"],
                                                                  **kw), 50)
            if "bias" in ex:
                fns["K1-bias-bf16"] = (lambda: ha.hstu_mha_dense_cuda(q, k, v, lens, bias=ex["bias"], **kw), 20)
            for det in (False, True):
                fns["K7-det-bf16" if det else "K7-bf16"] = (
                    lambda det=det: hstu_mha_relbias_bwd_cuda(q, k, v, lens, ex["ts"], ex["pos_w"], ex["ts_w"], do,
                                                              deterministic=det, **kw), 10)
        wanted = ex.get("kernels", fns) if only is None else only
        times = {name: device_ms(fn, reps) for name, (fn, reps) in fns.items() if name in wanted}
        print(f"{label + ': ' if label else ''}{shape}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items()))
        if all(n in times for n in ("K2-bf16", "K3-bf16", "K4-bf16")):
            split = times["K3-bf16"] + times["K4-bf16"]
            print(f"  the split K3-bf16 + K4-bf16 {split:.4f} ms: {split / times['K2-bf16']:.2f}x K2-bf16")
        if not ex and only is None:
            B, N, H, D = q.shape
            fwd_flops = sum(2.0 * H * (D + D) * float(x) ** 2 / 2.0 for x in lens.tolist())
            pair = times["K1-bf16"] + times["K2-bf16"]
            print(f"  the pair K1-bf16 + K2-bf16 {pair:.4f} ms: {3.5 * fwd_flops / (pair * 1e-3) / 1e12:.2f} TFLOP/s "
                  "under bench.py's FLOP model")
            if chunks and hasattr(ha, "_FWD_CHUNK_BF16"):
                shipped = ha._FWD_CHUNK_BF16, ha._MAX_CHUNKS
                try:
                    ha._MAX_CHUNKS = 1 << 20
                    for c in (256, 512, 1024, 1 << 30):
                        ha._FWD_CHUNK_BF16 = c
                        t = device_ms(fns["K1-bf16"][0], 50)
                        print(f"  K1-bf16 with {'no chunks' if c == 1 << 30 else f'chunks of {c}'} {t:.4f} ms "
                              f"(shipped: {times['K1-bf16']:.4f})")
                finally:
                    ha._FWD_CHUNK_BF16, ha._MAX_CHUNKS = shipped


def wide_inputs(rand, gen) -> Dict[str, tuple]:
    """K7's inputs at the heads above 64, float32 and bfloat16: q, k, v views
    of one projection and a strided dO, full rows (as chip_smoke.py's
    every-shape phase times them), timestamps and both tables; by shape:
    (float32 args, bfloat16 args, float32 dO, bfloat16 dO, D)."""
    import torch

    shapes = {}
    for name, B, N, H, D, V in (("wide-head layer", 128, 211, 2, 128, 128), ("D = V = 96", 128, 211, 2, 96, 96),
                                ("D 128 / V 64", 128, 211, 2, 128, 64), ("D = V = 256", 4, 1024, 2, 256, 256)):
        proj = rand(B, N, H * (2 * D + V))
        v, q, k = torch.split(proj, [H * V, H * D, H * D], dim=-1)
        q, k, v = q.reshape(B, N, H, D), k.reshape(B, N, H, D), v.reshape(B, N, H, V)
        lens = torch.full((B,), N, dtype=torch.int32, device="cuda")
        steps = torch.randint(1, 86400, (B, N), device="cuda", generator=gen)
        ts = 1_500_000_000 + torch.cumsum(steps, 1)
        pos_w, ts_w = rand(2 * N - 1) * 0.1, rand(129) * 0.1
        do = rand(N, B, H, V).transpose(0, 1)
        b16 = [x.to(torch.bfloat16) for x in (q, k, v, do)]
        shapes[f"{name} (B {B}, N = Nm = {N}, H {H}, D {D}, V {V})"] = (
            (q, k, v, lens, ts, pos_w, ts_w), (*b16[:3], lens, ts, pos_w, ts_w), do, b16[3], D)
    return shapes


@contextlib.contextmanager
def _wide_forced():
    """K7's plans with the wide bodies' route at every width (in the checkout
    on ``PYTHONPATH``, whatever its narrow bound)."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    bwd, det = hr._relbias_bwd_plan, hr._relbias_det_plan
    wide = getattr(hr, "_NARROW_BWD_WIDTH", 64) + 1
    hr._relbias_bwd_plan = lambda D, V, H, Nm, NB, *a: bwd(max(D, wide), V, H, Nm, NB, *a)
    hr._relbias_det_plan = lambda D, V, H, B, N, Nm, NB, *a: det(max(D, wide), V, H, B, N, Nm, NB, *a)
    try:
        yield
    finally:
        hr._relbias_bwd_plan, hr._relbias_det_plan = bwd, det


def wide_times(device_ms, inputs: Dict[str, tuple], label: str = "", forced: bool = True) -> None:
    """Prints K7, K7-det, K7-bf16 and K7-det-bf16 at each shape of ``inputs``
    (`wide_inputs`), each the mean of 10 launches through
    `hstu_mha_relbias_bwd_cuda` (float32 at alpha D^-1/2, bfloat16 at 1), the
    route their plans took, and with ``forced`` the same with the wide
    bodies forced."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    c = hr.hstu_mha_relbias_bwd_cuda
    for shape, (a32, a16, do32, do16, D) in inputs.items():
        def one(tag):
            out = {}
            for name, args, do, det, alpha, counter in (
                    ("K7", a32, do32, False, D**-0.5, c.launches), ("K7-det", a32, do32, True, D**-0.5, c.launches_det),
                    ("K7-bf16", a16, do16, False, 1.0, c.launches_bf16),
                    ("K7-det-bf16", a16, do16, True, 1.0, c.launches_det_bf16)):
                counter.reset()
                out[name] = device_ms(lambda: c(*args, do, deterministic=det, alpha=alpha, max_seq_len=args[0].shape[1],
                                                num_buckets=128), 10)
                out[name] = f"{out[name]:.4f} ms ({'/'.join(counter.routes)})"
            print(f"{label + ': ' if label else ''}{shape}{tag}: " + ", ".join(f"{n} {t}" for n, t in out.items()))

        one("")
        if forced:
            with _wide_forced():
                one(", the wide bodies forced")


# the wide backward's shapes: name, B, N, H, D, V, the relative bias
_WIDE_BWD_SHAPES = (("D 512 / V 64", 4, 2048, 2, 512, 64, False),
                    ("D 64 / V 256", 4, 2048, 2, 64, 256, False),
                    ("the V-256 ranker's layer", 32, 268, 4, 128, 256, False),
                    ("D = V = 256", 4, 1024, 2, 256, 256, True))
# past the clusters (route ``wide_chunks``): the widest heads at chip_smoke's
# kernel phase (B 1, N 300, H 1), without and with the relative bias, and the
# widest-heads ranker's layer
_WIDE_CHUNKS_BWD_SHAPES = tuple((f"D {D} / V {V}{' with the bias' if rel else ''}", 1, 300, 1, D, V, rel)
                                for D, V in ((3968, 128), (2048, 2049), (4352, 64)) for rel in (False, True)) + (
    ("the widest-heads ranker's layer", 8, 268, 4, 3968, 128, False),)


# past the forward's clusters (route ``wide_chunks``): the widest-heads
# forward at chip_smoke's kernel phase (B 1, N 300, H 1), K1 and K1-bias and
# K6 (Nm = N), the wide-V shape, and K1 and K1-bias at the widest-heads
# ranker's forward layer
_WIDE_CHUNKS_FWD_SHAPES = tuple((f"D {D} / V {V}{' with the bias' if Nm else ''}", 1, 300, 1, D, V, Nm, False)
                                for D, V in ((4352, 64), (128, 4352)) for Nm in (0, 300)) + (
    ("the widest-heads ranker's forward layer", 8, 268, 4, 4352, 64, 0, False),)


@contextlib.contextmanager
def _wcb_plan(label: str):
    """The per-pair bodies' plans matched to a knock-out that changes what
    the plan decides: no split of the S / dP (or the forward's S) steps."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    shipped = ha._SPLIT_TARGET
    if label in (_WCB_NO_SPLIT, _WCF_NO_SPLIT):
        ha._SPLIT_TARGET = 1
    try:
        yield
    finally:
        ha._SPLIT_TARGET = shipped


def wide_bwd_inputs(rand, gen, table=_WIDE_BWD_SHAPES) -> Dict[str, dict]:
    """The wide backward's inputs by shape of ``table``, float32 and
    bfloat16: q, k, v views of one projection and a strided dO, lengths N / 2
    .. N with one full row; with the relative bias also its timestamps and
    tables (``tables``, else None)."""
    import torch

    shapes = {}
    for name, B, N, H, D, V, relbias in table:
        proj = rand(B, N, H * (2 * D + V))
        v, q, k = torch.split(proj, [H * V, H * D, H * D], dim=-1)
        q, k, v = q.reshape(B, N, H, D), k.reshape(B, N, H, D), v.reshape(B, N, H, V)
        do = rand(N, B, H, V).transpose(0, 1)
        lens = torch.cat([torch.full((1,), N, dtype=torch.int32, device="cuda"),
                          torch.randint(N // 2, N, (B - 1,), device="cuda", generator=gen, dtype=torch.int32)])
        tables = None
        if relbias:
            ts = 1_500_000_000 + torch.cumsum(torch.randint(1, 86400, (B, N), device="cuda", generator=gen), 1)
            tables = (ts, rand(2 * N - 1) * 0.1, rand(129) * 0.1)
        shapes[f"{name} (B {B}, N {N}, H {H}, D {D}, V {V})"] = dict(
            f32=(q, k, v, do), bf16=tuple(x.to(torch.bfloat16) for x in (q, k, v, do)), lens=lens, D=D, N=N,
            tables=tables)
    return shapes


def wide_bwd_times(device_ms, inputs: Dict[str, dict], label: str = "", plain: bool = True,
                   only: Optional[Tuple[str, ...]] = None) -> None:
    """Prints, per shape of ``inputs`` (`wide_bwd_inputs`), the wide backward's
    kernels through their wrappers, each the mean of 10 launches, with the
    route each plan took: K2, K3 and K4 (float32 at alpha D^-1/2; bfloat16 the
    same), or K7 and K7-det with the tables; with ``plain`` the plain backward
    of each type (the mean of 2). ``only``: the kernels to time."""
    import torch

    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    for shape, x in inputs.items():
        out = {}
        for sfx, (q, k, v, do) in (("", x["f32"]), ("-bf16", x["bf16"])):
            ent = sfx.replace("-", "_")
            kw = dict(alpha=x["D"] ** -0.5, max_seq_len=x["N"])
            lens = x["lens"]
            if x["tables"] is not None:
                ts, pos_w, ts_w = x["tables"]
                c = hr.hstu_mha_relbias_bwd_cuda
                args = (q, k, v, lens, ts, pos_w, ts_w, do)
                runs = {f"K7{sfx}": (lambda: c(*args, num_buckets=128, **kw), c.launches_bf16 if sfx else c.launches),
                        f"K7-det{sfx}": (lambda: c(*args, deterministic=True, num_buckets=128, **kw),
                                         c.launches_det_bf16 if sfx else c.launches_det)}
                plain_fn = lambda: hr.hstu_mha_relbias_bwd_plain(*args, num_buckets=128, **kw)  # noqa: E731
            else:
                do_c = do.contiguous()
                one = dict(kw, causal=True, max_attn_len=0, contextual_seq_len=0, min_full_attn_seq_len=0)
                lc = ha.hstu_mha_bwd_cuda.launches
                runs = {f"K2{sfx}": (lambda: ha.hstu_mha_bwd_cuda(q, k, v, lens, do, **kw), lc["hstu_mha_bwd_fused" + ent]),
                        f"K3{sfx}": (lambda: ha._bwd_kernel("hstu_mha_bwd_dq" + ent, q, k, v, lens, None, do_c, one),
                                     lc["hstu_mha_bwd_dq" + ent]),
                        f"K4{sfx}": (lambda: ha._bwd_kernel("hstu_mha_bwd_dkv" + ent, q, k, v, lens, None, do_c, one),
                                     lc["hstu_mha_bwd_dkv" + ent])}
                plain_fn = lambda: ha.hstu_mha_bwd_plain(q, k, v, lens, do, **kw)  # noqa: E731
            for name, (fn, counter) in runs.items():
                if only is not None and name not in only:
                    continue
                counter.reset()
                out[name] = f"{device_ms(fn, 10):.4f} ms ({'/'.join(counter.routes)})"
            if plain:
                out[f"plain{sfx}"] = f"{device_ms(plain_fn, 2):.4f} ms"
            torch.cuda.empty_cache()
        print(f"{label + ': ' if label else ''}{shape}: " + ", ".join(f"{n} {t}" for n, t in out.items()))


# the wide forward's shapes: name, B, N, H, D, V, Nm (K6's table length; 0:
# K1 and K1-bias), the wide bodies forced
_WIDE_FWD_SHAPES = (("the V-256 ranker's layer", 32, 268, 4, 128, 256, 0, False),
                    ("the --attn_dim 256 serving layer", 32, 674, 4, 256, 256, 0, False),
                    ("D 64 / V 256", 4, 2048, 2, 64, 256, 0, False),
                    ("D 512 / V 64", 4, 2048, 2, 512, 64, 0, False),
                    ("K6 at D = V = 256", 4, 1024, 2, 256, 256, 1024, False),
                    ("K6-long, N 4096 against Nm 16384", 2, 4096, 8, 64, 64, 16384, True))
# and the further widths `--wide-fwd-routes` times both routes at
_WIDE_FWD_ROUTE_SHAPES = (tuple((f"D {D} / V {V}", 4, 2048, 2, D, V, 0, False)
                                for D, V in ((128, 256), (192, 256), (256, 256), (320, 256), (128, 384), (256, 384)))
                          + tuple((f"D {D} / V 256", B, N, H, D, 256, 0, False)
                                  for B, N, H in ((8, 1024, 2), (4, 1536, 2), (32, 2048, 4)) for D in (128, 256)))


def wide_fwd_inputs(rand, gen, table=_WIDE_FWD_SHAPES) -> Dict[str, dict]:
    """The wide forward's inputs by shape of ``table``, float32 and bfloat16:
    q, k, v views of one projection, lengths N / 2 .. N with one full row, a
    float32 [B, N, N] bias (K1-bias); for K6 the relative bias's timestamps
    and tables (``tables``, else None); K6-long with full rows and the wide
    bodies forced (``forced``)."""
    import torch

    shapes = {}
    for name, B, N, H, D, V, Nm, forced in table:
        proj = rand(B, N, H * (2 * D + V))
        v, q, k = torch.split(proj, [H * V, H * D, H * D], dim=-1)
        q, k, v = q.reshape(B, N, H, D), k.reshape(B, N, H, D), v.reshape(B, N, H, V)
        if forced:
            lens = torch.full((B,), N, dtype=torch.int32, device="cuda")
        else:
            lens = torch.cat([torch.full((1,), N, dtype=torch.int32, device="cuda"),
                              torch.randint(N // 2, N, (B - 1,), device="cuda", generator=gen, dtype=torch.int32)])
        tables = bias = None
        if Nm:
            ts = 1_500_000_000 + torch.cumsum(torch.randint(1, 86400, (B, N), device="cuda", generator=gen), 1)
            tables = (ts, rand(2 * Nm - 1) * 0.1, rand(129) * 0.1)
        else:
            bias = rand(B, N, N) * 0.3
        shapes[f"{name} (B {B}, N {N}, H {H}, D {D}, V {V})"] = dict(
            f32=(q, k, v), bf16=tuple(x.to(torch.bfloat16) for x in (q, k, v)), lens=lens, D=D, N=N, bias=bias,
            tables=tables, forced=forced)
    return shapes


@contextlib.contextmanager
def _fwd_pairs_forced():
    """The wide forward's plans with the per-pair forward's route
    (``wide_chunks``) wherever they take another wide one."""
    import torch

    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    fwd = ha._fwd_plan

    def plan(D, V, H, Nm, NB, relbias, B=1, N=1, dtype=torch.float32):
        p = fwd(D, V, H, Nm, NB, relbias, B, N, dtype)
        if p["route"] not in ("wide", "wide_tile"):
            return p
        return ha._pairs_plan("the wide forward kernel", D, V, H, B, N, ha._chunks(V), False, dtype, forward=True)

    ha._fwd_plan = plan
    try:
        yield
    finally:
        ha._fwd_plan = fwd


@contextlib.contextmanager
def _fwd_clusters_forced():
    """The wide forward's plans on the clusters wherever one takes the widths
    (`hstu_attention._fwd_tile` off)."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    rule = ha._fwd_tile
    ha._fwd_tile = lambda *a: False
    try:
        yield
    finally:
        ha._fwd_tile = rule


@contextlib.contextmanager
def _fwd_tile_forced():
    """Float32 K1's and K1-bias's plans on the tile forward wherever it takes
    the widths (`hstu_attention._fwd_tile`), whatever the plan's rule."""
    import torch

    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    fwd = ha._fwd_plan

    def plan(D, V, H, Nm, NB, relbias, B=1, N=1, dtype=torch.float32):
        p = fwd(D, V, H, Nm, NB, relbias, B, N, dtype)
        return dict(p, route="wide_tile") if ha._fwd_tile(D, V, relbias, dtype) else p

    ha._fwd_plan = plan
    try:
        yield
    finally:
        ha._fwd_plan = fwd


def wide_fwd_route_times(device_ms, rand, gen) -> None:
    """Prints the wide forward at `--wide-fwd`'s shapes but K6-long and at
    `_WIDE_FWD_ROUTE_SHAPES`, on the clusters, on the per-pair forward and on
    the tile forward (float32 where it takes the widths), on the same inputs:
    the measurements the plan's routes follow."""
    import torch

    for shape in _WIDE_FWD_SHAPES[:-1] + _WIDE_FWD_ROUTE_SHAPES:
        inputs = wide_fwd_inputs(rand, gen, (shape,))
        for label, forced in (("clusters", _fwd_clusters_forced), ("per pair", _fwd_pairs_forced),
                              ("tile", _fwd_tile_forced)):
            with forced():
                wide_fwd_times(device_ms, inputs, label=label, plain=False)
        del inputs
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _fwd_wide_forced():
    """K6's plan with the wide route whatever the width (the wide bodies read
    the tables from device memory, as the narrow body's route ``read``)."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    fwd = hr.ha._fwd_plan
    hr.ha._fwd_plan = lambda D, V, H, Nm, NB, relbias, *a: fwd(max(D, 257), V, H, Nm, NB, relbias, *a)
    try:
        yield
    finally:
        hr.ha._fwd_plan = fwd


def wide_fwd_times(device_ms, inputs: Dict[str, dict], label: str = "", plain: bool = True) -> None:
    """Prints, per shape of ``inputs`` (`wide_fwd_inputs`), the wide forward
    through the public wrappers, each the mean of 10 launches, with the route
    each launch took: K1 and K1-bias, or K6; float32 at alpha D^-1/2, bfloat16
    the same (K6-bf16 at alpha 1); with ``plain`` the plain forward of each
    type (the mean of 2)."""
    import torch

    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    for shape, x in inputs.items():
        out = {}
        for sfx, (q, k, v) in (("", x["f32"]), ("-bf16", x["bf16"])):
            ent = sfx.replace("-", "_")
            kw = dict(alpha=x["D"] ** -0.5, max_seq_len=x["N"])
            lens = x["lens"]
            if x["tables"] is not None:
                ts, pos_w, ts_w = x["tables"]
                c = hr.hstu_mha_dense_relbias_cuda
                args = (q, k, v, lens, ts, pos_w, ts_w)
                rkw = dict(kw, alpha=1.0 if sfx else kw["alpha"], num_buckets=128)
                runs = {f"K6{sfx}": (lambda: c(*args, **rkw), c.launches_bf16 if sfx else c.launches)}
                plain_fn = lambda: hr.hstu_mha_dense_relbias_plain(*args, **rkw)  # noqa: E731
            else:
                lc = ha.hstu_mha_dense_cuda.launches
                bias = x["bias"]
                runs = {f"K1{sfx}": (lambda: ha.hstu_mha_dense_cuda(q, k, v, lens, **kw), lc["hstu_mha_fwd" + ent]),
                        f"K1-bias{sfx}": (lambda: ha.hstu_mha_dense_cuda(q, k, v, lens, bias=bias, **kw),
                                          lc["hstu_mha_fwd_bias" + ent])}
                plain_fn = lambda: ha.hstu_mha_dense_plain(q, k, v, lens, **kw)  # noqa: E731
            with (_fwd_wide_forced() if x["forced"] else contextlib.nullcontext()):
                for name, (fn, counter) in runs.items():
                    counter.reset()
                    out[name] = f"{device_ms(fn, 10):.4f} ms ({'/'.join(counter.routes)})"
            if plain:
                out[f"plain{sfx}"] = f"{device_ms(plain_fn, 2):.4f} ms"
            torch.cuda.empty_cache()
        print(f"{label + ': ' if label else ''}{shape}: " + ", ".join(f"{n} {t}" for n, t in out.items()))


def k5_times(device_ms, rand, ints) -> None:
    """K5 and K5-bf16 at the serving chunk (B 32, M 5, H 4, D = V = 128, N 523,
    lengths 100..329, q a strided view), each the mean of 300 launches."""
    import torch

    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import delta_hstu_mha_cuda

    dq = rand(32, 5, 4 * 512)[..., 1024:1536].reshape(32, 5, 4, 128)
    dk, dv, dlen = rand(32, 523, 4, 128), rand(32, 523, 4, 128), ints(100, 330, 32)
    m5 = torch.full((32,), 5, dtype=torch.int32, device="cuda")
    times = []
    for dtype in (torch.float32, torch.bfloat16):
        q_, k_, v_ = (x.to(dtype) for x in (dq, dk, dv))
        times.append(device_ms(lambda: delta_hstu_mha_cuda(q_, k_, v_, dlen, alpha=128**-0.5, num_targets=m5,
                                                           norm_len=678, contextual_seq_len=6), 300))
    print(f"the serving chunk (B 32, M 5, N 523, H 4, D = V = 128): K5 {times[0]:.4f} ms, K5-bf16 {times[1]:.4f} ms")


def _preload(kernel: str, directory: str) -> None:
    """Makes the wrappers launch the kernel's library in ``directory`` (a
    variant's, built here; `build.load` would rebuild the shipped source,
    whose hash its stamp does not hold)."""
    build._libs[kernel] = ctypes.CDLL(os.path.join(directory, f"lib{kernel}.so"))


if __name__ == "__main__":
    main()
