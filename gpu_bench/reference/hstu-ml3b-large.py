"""Plain PyTorch reference of the HSTU research model's training step
(sequential retrieval, sampled softmax over uniform negatives, AdamW), and
the counts of its operations and bytes. Float32 with TF32 off unless the
caller asks for TF32 (the control). It imports nothing of the program.

The model, as the HSTU paper and its public code define it:

  x0      = dropout(E[ids] sqrt(D) + P[:N]) * (ids != 0)
  layer   [u, v, q, k] = silu(LN(x) W_uvqk)
          A = (silu(q k^T + pos_w[j - i + Nm - 1] + ts_w[bucket]) / N) * mask(j <= i < len) @ v
          x = x + dropout(u * LN(A)) W_o + b_o
  output  y = x / ||x||, the positives and the negatives normalised alike
  loss    sampled softmax of y . e+ against y . e- over 128 negatives, temperature 0.05,
          negatives that equal the positive masked, mean over the supervised positions

bucket = floor(ln(max(|ts[min(i + 1, N - 1)] - ts[j]|, 1)) / 0.301), clipped to
[0, 128], with the timestamps in float32. The random draws follow the
trainer's documented streams: the dropout masks from a generator seeded with
seed + 1 (the input's mask, then each layer's, every step), the negatives'
offsets into the corpus' sorted unique ids from one seeded with seed + 2.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# comparison limits, each set from the program's readings and the control's
# (PERF.md gives the readings)
LIMITS = {"loss_gap": 6e-7, "grad_gap": 2e-5, "change_gap": 5e-4}
_EPS = 1e-6
NUM_TIME_BUCKETS = 128  # the relative bias' time buckets, as the HSTU code sets them


def _dims(cfg: dict) -> dict:
    m = cfg["model"]
    D, H = m["item_embedding_dim"], m["num_heads"]
    N = m["max_sequence_len"] + m["gr_output_length"] + 1
    return dict(D=D, H=H, dqk=m["dqk"], dv=m["dv"], N=N, L=m["num_blocks"], X=m["num_items"])


def leaf_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, standard deviation) of every trained tensor, in the
    program's parameter names."""
    d = _dims(cfg)
    D, H, dqk, dv, N = d["D"], d["H"], d["dqk"], d["dv"], d["N"]
    specs = [
        ("embedding_module.item_emb", (d["X"] + 1, D), 0.02),
        ("input_preproc.pos_emb", (N, D), math.sqrt(2.0 / (N + D))),
    ]
    for i in range(d["L"]):
        p = f"encoder.layer_{i}."
        specs += [
            (p + "uvqk", (D, 2 * H * dv + 2 * H * dqk), 0.02),
            (p + "o.kernel", (H * dv, D), math.sqrt(2.0 / (H * dv + D))),
            (p + "o.bias", (D,), 1.0 / math.sqrt(3.0 * H * dv)),
            (p + "rel_attn_bias.ts_w", (NUM_TIME_BUCKETS + 1,), 0.02),
            (p + "rel_attn_bias.pos_w", (2 * N - 1,), 0.02),
        ]
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight from one normal draw on ``device`` (a generator seeded
    from ``seed``), each leaf a scaled view of it."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(s) for _, s, _ in specs)
    gen = torch.Generator(device).manual_seed((seed * 8 + 5) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, std in specs:
        n = math.prod(shape)
        out[name] = flat[off : off + n].mul_(std).view(shape)
        off += n
    return out


# ----------------------------------------------------------------- the batch
def rows(corpus, idx: Sequence[int], cfg: dict) -> Dict[str, torch.Tensor]:
    """The training rows of users ``idx``: the last ``ignore_last_n`` events
    held out, the next one the target, the up to ``max_sequence_len`` before
    it the history (oldest first), padded; ids and timestamps widened by the
    output slots with the target scattered at the history's end."""
    m = cfg["model"]
    Nh, N = m["max_sequence_len"], _dims(cfg)["N"]
    hold = cfg["train"].get("ignore_last_n", 1)
    B = len(idx)
    ids = np.zeros((B, N), np.int64)
    ts = np.zeros((B, N), np.int64)
    lengths = np.zeros((B,), np.int64)
    for r, u in enumerate(idx):
        items, times = corpus.item_ids[u], corpus.timestamps[u]
        ign = min(hold, len(items) - 1)
        if ign > 0:
            items, times = items[:-ign], times[:-ign]
        n = min(len(items) - 1, Nh)
        ids[r, :n] = items[-1 - n : -1]
        ts[r, :n] = times[-1 - n : -1]
        ids[r, n], ts[r, n] = items[-1], times[-1]
        lengths[r] = n
    return {"ids": torch.from_numpy(ids), "ts": torch.from_numpy(ts), "lengths": torch.from_numpy(lengths)}


def corpus_ids(corpus) -> np.ndarray:
    """The corpus' sorted unique item ids, without 0: what negatives are
    drawn from."""
    ids = np.unique(np.concatenate(corpus.item_ids))
    return ids[ids > 0]


# ------------------------------------------------------------------ forward
def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(x.square().sum(-1, keepdim=True).clamp_min(_EPS * _EPS))


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=_EPS)


class _Gather1D(torch.autograd.Function):
    """table[idx] for a 1-D table, its gradient summed by a histogram
    (`torch.bincount`): indexing's own backward serialises on a table of a
    few hundred entries read millions of times."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.size = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g = torch.bincount(idx.reshape(-1), weights=grad.reshape(-1).float(), minlength=ctx.size)
        return g.to(grad.dtype), None


def _bias_index(ts: torch.Tensor, N: int, num_buckets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    cols = torch.arange(N, device=ts.device)
    rel = (cols[None, :] - cols[:, None] + N - 1).clamp(0, 2 * N - 2)
    t = ts.to(torch.float32)
    nxt = t[:, (cols + 1).clamp_max(N - 1)]
    dt = nxt[:, :, None] - t[:, None, :]
    bucket = torch.floor(torch.log(dt.abs().clamp_min(1.0)) / 0.301).clamp(0, num_buckets).long()
    return rel, bucket


def _block_loss(W, cfg, d, batch, masks, neg_ids, item_ids_all, lo, hi) -> torch.Tensor:
    """The summed loss of rows [lo, hi) (not yet divided by the batch's
    supervised count)."""
    D, H, dqk, dv, N = d["D"], d["H"], d["dqk"], d["dv"], d["N"]
    rate_in, rate_lin = cfg["model"]["dropout_rate"], cfg["model"]["linear_dropout_rate"]
    ids, ts, lengths = batch["ids"][lo:hi], batch["ts"][lo:hi], batch["lengths"][lo:hi]
    table = W["embedding_module.item_emb"]
    valid = (ids != 0)[..., None].float()
    emb = table[ids.clamp(0, d["X"])] * valid
    x = emb * D**0.5 + W["input_preproc.pos_emb"][None, :N]
    if rate_in > 0:
        x = torch.where(masks[0][lo:hi], x / (1.0 - rate_in), 0.0)
    x = x * valid
    b = hi - lo
    rel, bucket = _bias_index(ts, N, NUM_TIME_BUCKETS)
    i = torch.arange(N, device=ids.device)
    mask = (i[None, :] <= i[:, None])[None] & (i[None, :, None] < lengths[:, None, None])
    mask = mask[:, None].float() / N  # [b, 1, N, N]
    for layer in range(d["L"]):
        p = f"encoder.layer_{layer}."
        mixed = F.silu(_ln(x) @ W[p + "uvqk"])
        u, v, q, k = torch.split(mixed, [dv * H, dv * H, dqk * H, dqk * H], dim=-1)
        q, k, v = q.reshape(b, N, H, dqk), k.reshape(b, N, H, dqk), v.reshape(b, N, H, dv)
        bias = _Gather1D.apply(W[p + "rel_attn_bias.pos_w"], rel)[None] + _Gather1D.apply(W[p + "rel_attn_bias.ts_w"], bucket)
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) + bias[:, None]
        attn = torch.einsum("bhnm,bmhv->bnhv", F.silu(s) * mask, v).reshape(b, N, H * dv)
        o_in = u * _ln(attn)
        if rate_lin > 0:
            o_in = torch.where(masks[1 + layer][lo:hi], o_in / (1.0 - rate_lin), 0.0)
        x = o_in @ W[p + "o.kernel"] + W[p + "o.bias"] + x
    y = _l2(x)[:, :-1]
    sup_ids = ids[:, 1:]
    pos = _l2(emb[:, 1:])
    neg_id = item_ids_all[neg_ids[lo:hi]]
    neg = _l2(table[neg_id.clamp(0, d["X"])] * (neg_id != 0)[..., None].float())
    temp = cfg["train"]["temperature"]
    pos_logit = (y * pos).sum(-1) / temp
    neg_logit = torch.einsum("bnd,bnrd->bnr", y, neg) / temp
    neg_logit = torch.where(sup_ids[..., None] == neg_id, -5e4, neg_logit)
    logits = torch.cat([pos_logit[..., None], neg_logit], dim=-1)
    per = -torch.log_softmax(logits, dim=-1)[..., 0]
    return (per * (sup_ids != 0).float()).sum()


def _mask(shape, rate: float, gen: torch.Generator, device):
    """A dropout keep-mask, drawn as the trainer draws it; None at rate 0."""
    return None if rate <= 0 else torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def train_steps(
    cfg: dict,
    W0: Dict[str, torch.Tensor],
    batches: List[Dict[str, torch.Tensor]],
    corpus,
    seed: int,
    device,
    tf32: bool = False,
    block_rows: int = 16,
) -> dict:
    """The reference's first ``len(batches)`` steps from the weights ``W0``:
    each step's loss, the first step's gradient norm of every leaf, and every
    leaf's change after the last step. The batch's rows go through in blocks
    of ``block_rows``, the gradients summed."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _train_steps(cfg, W0, batches, corpus, seed, device, block_rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _train_steps(cfg, W0, batches, corpus, seed, device, block_rows) -> dict:
    d = _dims(cfg)
    m, opt = cfg["model"], cfg["optimizer"]
    names = [n for n, _, _ in leaf_specs(cfg)]
    W = {n: W0[n].detach().clone().requires_grad_(True) for n in names}
    state = {n: (torch.zeros_like(W[n]), torch.zeros_like(W[n])) for n in names}
    b1, b2 = opt["betas"]
    drop_gen = torch.Generator(device).manual_seed(seed + 1)
    neg_gen = torch.Generator(device).manual_seed(seed + 2)
    item_ids_all = torch.as_tensor(corpus_ids(corpus), device=device)
    R = cfg["train"]["num_negatives"]
    out = {"losses": [], "grad_norms": {}, "change_norms": {}}
    for step, raw in enumerate(batches, start=1):
        batch = {k: v.to(device) for k, v in raw.items()}
        B, N = batch["ids"].shape
        masks = [_mask((B, N, d["D"]), m["dropout_rate"], drop_gen, device)]
        masks += [_mask((B, N, d["H"] * d["dv"]), m["linear_dropout_rate"], drop_gen, device) for _ in range(d["L"])]
        neg = torch.randint(0, item_ids_all.shape[0], (B, N - 1, R), generator=neg_gen, device=device)
        count = (batch["ids"][:, 1:] != 0).sum().clamp_min(1).float()
        total = 0.0
        for lo in range(0, B, block_rows):
            loss = _block_loss(W, cfg, d, batch, masks, neg, item_ids_all, lo, min(B, lo + block_rows)) / count
            loss.backward()
            total += loss.item()
        out["losses"].append(total)
        with torch.no_grad():
            if step == 1:
                out["grad_norms"] = {n: W[n].grad.norm().item() for n in names}
            for n in names:
                g = W[n].grad
                mom, var = state[n]
                mom.mul_(b1).add_(g, alpha=1 - b1)
                var.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (var / (1 - b2**step)).sqrt_().add_(opt["eps"])
                W[n].mul_(1 - opt["lr"] * opt["weight_decay"])
                W[n].addcdiv_(mom, denom, value=-opt["lr"] / (1 - b1**step))
                W[n].grad = None
        del masks, neg
    with torch.no_grad():
        out["change_norms"] = {n: (W[n] - W0[n]).norm().item() for n in names}
    return out


# ------------------------------------------------------------------- counts
def live_counts(lengths: np.ndarray) -> Tuple[float, float]:
    """(live rows, live causal pairs j <= i < len) of a batch's attention."""
    n = lengths.astype(np.float64)
    return float(n.sum()), float((n * (n + 1) / 2).sum())


def step_flops(cfg: dict, lengths: np.ndarray) -> float:
    """The operations of one training step over the live tokens: the
    forward's products (the projections, attention, the sampled softmax's
    logits) times 3 for the backward; elementwise work not counted."""
    d = _dims(cfg)
    D, H, dqk, dv = d["D"], d["H"], d["dqk"], d["dv"]
    rows_, pairs = live_counts(lengths)
    tokens = rows_ + len(lengths)  # the history and the target
    per_layer = tokens * 2 * D * (2 * H * dv + 2 * H * dqk) + tokens * 2 * H * dv * D
    per_layer += pairs * H * 2 * (dqk + dv)
    loss = rows_ * 2 * D * (cfg["train"]["num_negatives"] + 1)
    return 3.0 * (d["L"] * per_layer + loss)


def attention_calls(cfg: dict, lengths: np.ndarray) -> List[Tuple[float, float]]:
    """(operations, bytes) of every attention call of one training step,
    forward (K6) and backward (K7) of each layer: each live row of q, k, v
    (and dO) read once, each output written once, float32; 2 (D + V)
    operations per live pair and head forward, 2 (3D + 2V) backward."""
    d = _dims(cfg)
    H, D, V = d["H"], d["dqk"], d["dv"]
    rows_, pairs = live_counts(lengths)
    fwd = (2.0 * (D + V) * pairs * H, 4.0 * rows_ * H * (2 * D + V + V))
    bwd = (2.0 * (3 * D + 2 * V) * pairs * H, 4.0 * rows_ * H * (2 * D + V + V + 2 * D + V))
    return [fwd, bwd] * d["L"]
