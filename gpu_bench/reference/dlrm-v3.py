"""Plain PyTorch reference of the DLRM-v3 HSTU ranker: its forward (the
served predictions) and its training step (per-task losses, row-wise
Adagrad on the tables and on the item MLP's 2-D kernels, Adam on the rest),
and the counts of its operations and bytes. Float32 with TF32 off unless the
caller asks for TF32 (the control). It imports nothing of the program.

The model, as the generative-recommenders code defines DLRM-v3:

  lookup    the four tables' rows of the features (serving: row-wise absmax
            int8, dequantized); candidates merged after each row's history
  item      SwishMLP(cat(post, owner)) -> [B, M, 512]
  input     SwishMLP(post emb) + SwishMLP(action bits x action table, the
            target's own row at candidates); two contextual tokens (viewer,
            dummy; zeroed below 128 events) by per-token linear maps in front;
            x * sqrt(512) + position[count-down index] + time[sqrt(minutes) bucket]
  STU x 3   normed = LN(x); [u, v, q, k] = normed W + b, u = silu(u)
            A = silu(alpha q k^T) / Nnorm * mask(causal, target-aware, contextual) @ v
            x = x + cat(u, A, u * GroupNorm_heads(A)) W_o
  head      candidates' rows -> cat(., cos / sin of hour and weekday) W + b -> LN;
            logits = MLP(user * item); prediction = sigmoid
  loss      binary cross entropy with logits over the valid candidates, x 0.2

Dropout (training) follows the trainer's documented streams: each step's
masks from a generator seeded by (seed, stream 0, step), the input's mask
first, then each layer's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# comparison limits, each set from the program's readings and the control's
# (PERF.md gives the readings)
LIMITS = {"pred_gap": 2e-5}
TABLES = (
    ("post_id", ("uih_post_id", "item_post_id")),
    ("owner_id", ("uih_owner_id", "item_owner_id")),
    ("viewer_id", ("viewer_id",)),
    ("dummy_contexual", ("dummy_contexual",)),
)
MERGE = (
    ("uih_post_id", "item_post_id"), ("uih_owner_id", "item_owner_id"),
    ("uih_action_time", "item_query_time"), ("uih_weight", "item_action_weight"),
    ("uih_watchtime", "item_target_watchtime"),
)
CONTEXT = (("viewer_id", 128), ("dummy_contexual", 128))  # (feature, the fewest events it needs)
ACTION_WEIGHTS = (1, 2, 4, 8)
ACTION_DIM = 8
TIME_FEATURES = ((3600.0, 24.0), (86400.0, 7.0))


def dims(cfg: dict, traffic: dict) -> dict:
    h = cfg["hstu"]
    Nu, M = traffic["max_uih_len"], traffic["max_num_candidates"]
    C = len(CONTEXT)
    return dict(
        D=h["hstu_transducer_embedding_dim"], E=h["hstu_embedding_table_dim"], H=h["hstu_num_heads"],
        a=h["hstu_attn_qk_dim"], hd=h["hstu_attn_linear_dim"], L=h["hstu_attn_num_layers"],
        rows=cfg["hash_size"], Nu=Nu, M=M, C=C, Nnorm=C + Nu + M,
        P=h["num_position_buckets"], NT=h["num_time_buckets"], T=1,
    )


def _xavier(fan_in, fan_out):
    return math.sqrt(2.0 / (fan_in + fan_out))


def leaf_specs(cfg: dict, traffic: dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, mean, standard deviation) of every trained tensor, in
    the program's parameter names."""
    d = dims(cfg, traffic)
    D, E, H, a, hd = d["D"], d["E"], d["H"], d["a"], d["hd"]
    specs = [(f"embedding_tables_{t}", (d["rows"], E), 0.0, 0.02) for t, _ in TABLES]

    def dense(p, i, o):
        return [(p + "kernel", (i, o), 0.0, _xavier(i, o)), (p + "bias", (o,), 0.0, 0.02)]

    def norm(p, n, w="weight", b="bias"):
        return [(p + w, (n,), 1.0, 0.02), (p + b, (n,), 0.0, 0.02)]

    def swish_mlp(p, i, hidden, o):
        return dense(p + "fc1.", i, hidden) + norm(p + "sln.", hidden) + dense(p + "fc2.", hidden, o) + norm(p + "ln.", o)

    W = (2 * hd + 2 * a) * H
    for i in range(d["L"]):
        p = f"hstu_transducer.stu_module.layer_{i}."
        specs += [
            (p + "uvqk_weight", (D, W), 0.0, _xavier(D, W)),
            (p + "uvqk_beta", (W,), 0.0, 0.02),
            *norm(p, D, "input_norm_weight", "input_norm_bias"),
            (p + "output_weight", (3 * hd * H, D), 0.0, _xavier(3 * hd * H, D)),
            *norm(p, H, "output_norm_weight", "output_norm_bias"),
        ]
    p = "hstu_transducer.input_preprocessor."
    A = len(ACTION_WEIGHTS)
    specs += [
        (p + "batched_contextual_linear_weights", (d["C"], E, D), 0.0, _xavier(E, D)),
        (p + "batched_contextual_linear_bias", (d["C"], D), 0.0, 0.02),
        *swish_mlp(p + "content_mlp.", E, 256, D),
        (p + "action_encoder.action_embedding_table", (A, ACTION_DIM), 0.0, 0.1),
        (p + "action_encoder.target_action_embedding_table", (1, A * ACTION_DIM), 0.0, 0.1),
        *swish_mlp(p + "action_mlp.", A * ACTION_DIM, 256, D),
    ]
    p = "hstu_transducer.output_postprocessor."
    specs += norm(p, D, "ln_weight", "ln_bias") + dense(p + "time_feature_combiner.", D + 2 * len(TIME_FEATURES), D)
    p = "hstu_transducer.positional_encoder."
    specs += [
        (p + "position_embeddings_weight", (d["P"], D), 0.0, math.sqrt(1.0 / d["P"] / 3.0)),
        (p + "timestamp_embeddings_weight", (d["NT"] + 1, D), 0.0, math.sqrt(1.0 / d["NT"] / 3.0)),
    ]
    specs += swish_mlp("item_embedding_mlp.", 2 * E, 512, D)
    specs += dense("multitask_module.pred_fc1.", D, 512) + norm("multitask_module.pred_sln.", 512)
    specs += dense("multitask_module.pred_fc2.", 512, d["T"])
    return specs


def _leaf_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed % (1 << 63), 7, i]).generate_state(1, np.uint64)[0] >> 1)


def make_leaf(spec, i: int, seed: int, device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leaf ``i`` of ``leaf_specs`` drawn on ``device`` from its own
    generator (one call a leaf), into ``out`` when given."""
    _, shape, mean, std = spec
    t = torch.empty(shape, device=device) if out is None else out
    with torch.no_grad():
        return t.normal_(mean, std, generator=torch.Generator(device).manual_seed(_leaf_seed(seed, i)))


def make_weights(cfg: dict, traffic: dict, seed: int, device, into: Optional[Dict[str, torch.Tensor]] = None,
                 tables: bool = True) -> Dict[str, torch.Tensor]:
    """Every leaf (the tables only with ``tables``), drawn into ``into``'s
    tensors when given."""
    out = {}
    for i, spec in enumerate(leaf_specs(cfg, traffic)):
        if tables or not spec[0].startswith("embedding_tables_"):
            out[spec[0]] = make_leaf(spec, i, seed, device, None if into is None else into[spec[0]])
    return out


def table_rows(cfg, traffic, seed: int, device, name: str, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of table ``name``, drawn again whole and then dropped."""
    for i, spec in enumerate(leaf_specs(cfg, traffic)):
        if spec[0] == f"embedding_tables_{name}":
            table = make_leaf(spec, i, seed, device)
            rows = table[ids.long()].clone()
            del table
            return rows
    raise KeyError(name)


def quantized(rows: torch.Tensor) -> torch.Tensor:
    """Row-wise absmax int8 with a float32 scale, dequantized."""
    scale = rows.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    q = torch.round(rows / scale * 127.0).clamp(-127, 127)
    return q * (scale / 127.0)


# ------------------------------------------------------------------ forward
def _ln(x, w=None, b=None, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def _dense(W, p, x):
    return x @ W[p + "kernel"] + W[p + "bias"]


def _swish_mlp(W, p, x):
    h = _dense(W, p + "fc1.", x)
    h = h * torch.sigmoid(_ln(h, W[p + "sln.weight"], W[p + "sln.bias"]))
    return _ln(_dense(W, p + "fc2.", h), W[p + "ln.weight"], W[p + "ln.bias"])


def _concat_tail(uih, ul, tail):
    B, M = tail.shape[:2]
    out = torch.cat([uih, uih.new_zeros((B, M) + tuple(uih.shape[2:]))], dim=1)
    rows = torch.arange(B, device=uih.device)[:, None]
    out[rows, ul.long()[:, None] + torch.arange(M, device=uih.device)[None]] = tail.to(out.dtype)
    return out


def _gather_tail(seq, start, M):
    B, N = seq.shape[:2]
    rows = torch.arange(B, device=seq.device)[:, None]
    return seq[rows, (start.long()[:, None] + torch.arange(M, device=seq.device)[None]).clamp(0, N - 1)]


def _mask(N, lengths, nt, C):
    """bool [B, N, N]: causal over the history, every candidate sees the
    history and itself only, the contextual tokens see all the history;
    rows and columns past each length masked."""
    B = lengths.shape[0]
    pos = torch.arange(N, device=lengths.device)
    ids = (pos - C + 1).clamp_min(0)[None]
    max_ids = (lengths - C + 1 - nt)[:, None]
    ids = torch.minimum(ids, max_ids)
    row, col = ids[:, :, None], ids[:, None, :]
    valid = torch.eye(N, dtype=torch.bool, device=lengths.device)[None] | (row - col > 0)
    valid = valid | ((row == 0) & (col < max_ids[:, :, None]))
    inside = pos[None] < lengths[:, None]
    return valid & inside[:, :, None] & inside[:, None, :]


def forward(cfg, traffic, W, lookup: Callable[[str, torch.Tensor], torch.Tensor], batch, masks=None,
            block: int = 0):
    """Logits [T, B, M] of a batch (a tuple of dicts and lengths as tensors);
    ``lookup(feature, ids)`` gives the feature's rows; ``masks`` the dropout
    keep-masks (training). With ``block`` the rows go through that many at a
    time (no gradient)."""
    if block:
        B = batch[1].shape[0]
        parts = [
            forward(cfg, traffic, W, lookup, _rows(batch, lo, min(B, lo + block)), None)
            for lo in range(0, B, block)
        ]
        return torch.cat(parts, dim=1)
    d = dims(cfg, traffic)
    D, H, a, hd, C, M = d["D"], d["H"], d["a"], d["hd"], d["C"], d["M"]
    h = cfg["hstu"]
    uih, ul, cands, nc = batch
    ul, nc = ul.long(), nc.long()
    feats = {**uih, **cands}
    emb = {f: lookup(f, feats[f]) for _, fs in TABLES for f in fs}
    pay = {f: v for f, v in feats.items() if f not in emb}
    for u_name, c_name in MERGE:
        src = emb if u_name in emb else pay
        src[u_name] = _concat_tail(src[u_name], ul, src[c_name])
    item = _swish_mlp(W, "item_embedding_mlp.", torch.cat([emb["item_post_id"], emb["item_owner_id"]], -1))
    seq = emb["uih_post_id"]
    B, N = seq.shape[:2]
    lengths = ul + nc
    p = "hstu_transducer.input_preprocessor."
    out = _swish_mlp(W, p + "content_mlp.", seq)
    bits = (pay["uih_weight"].long()[..., None] & torch.tensor(ACTION_WEIGHTS, device=seq.device)) > 0
    act = (bits[..., None].float() * W[p + "action_encoder.action_embedding_table"]).reshape(B, N, -1)
    is_uih = (torch.arange(N, device=seq.device)[None] < ul[:, None])[..., None]
    act = torch.where(is_uih, act, W[p + "action_encoder.target_action_embedding_table"].reshape(1, 1, -1))
    out = out + _swish_mlp(W, p + "action_mlp.", act)
    ctx_in = torch.cat([
        emb[f].reshape(B, 1, -1) * (lengths[:, None, None] >= n).float() for f, n in CONTEXT
    ], dim=1)
    ctx = torch.einsum("bcd,cde->bce", ctx_in, W[p + "batched_contextual_linear_weights"])
    ctx = ctx + W[p + "batched_contextual_linear_bias"][None]
    x = torch.cat([ctx, out], dim=1)
    ts = torch.cat([pay["uih_action_time"].new_zeros((B, C)), pay["uih_action_time"]], dim=1)
    L, U, N2 = lengths + C, ul + C, N + C
    # positions count down from the last history event; candidates share it
    col = torch.arange(N2, device=seq.device)[None]
    high = (L - nc)[:, None]
    pos_idx = ((high - torch.minimum(col, high)) + C).clamp(max=d["P"] - 1)
    pos_idx = torch.where(col < C, col, pos_idx).clamp(0, d["P"] - 1)
    tsf = ts.float()
    query = torch.gather(tsf, 1, (L - 1).clamp(0, N2 - 1)[:, None])
    bucket = torch.sqrt((query - tsf).clamp_min(1e-6) / 60.0).to(torch.int32).clamp(0, d["NT"]).long()
    pe = "hstu_transducer.positional_encoder."
    x = x * D**0.5 + W[pe + "position_embeddings_weight"][pos_idx] + W[pe + "timestamp_embeddings_weight"][bucket]
    if masks is not None:
        x = torch.where(masks[0], x / (1.0 - h["hstu_input_dropout_ratio"]), 0.0)
    allowed = _mask(N2, L, nc, C)[:, None].float() / d["Nnorm"]
    alpha = 1.0 / math.sqrt(a)
    for i in range(d["L"]):
        p = f"hstu_transducer.stu_module.layer_{i}."
        normed = _ln(x, W[p + "input_norm_weight"], W[p + "input_norm_bias"], 1e-6)
        uvqk = normed @ W[p + "uvqk_weight"] + W[p + "uvqk_beta"]
        u, v, q, k = torch.split(uvqk, [hd * H, hd * H, a * H, a * H], dim=-1)
        u = F.silu(u)
        q, k, v = q.reshape(B, N2, H, a), k.reshape(B, N2, H, a), v.reshape(B, N2, H, hd)
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) * alpha
        attn = torch.einsum("bhnm,bmhv->bnhv", F.silu(s) * allowed, v)
        mean = attn.mean(-1, keepdim=True)
        var = (attn - mean).square().mean(-1, keepdim=True)
        g = (attn - mean) * torch.rsqrt(var + 1e-6)
        g = g * W[p + "output_norm_weight"].reshape(1, 1, H, 1) + W[p + "output_norm_bias"].reshape(1, 1, H, 1)
        attn = attn.reshape(B, N2, H * hd)
        y = torch.cat([u, attn, u * g.reshape(B, N2, H * hd)], dim=-1)
        if masks is not None:
            y = torch.where(masks[1 + i], y / (1.0 - h["hstu_linear_dropout_rate"]), 0.0)
        x = x + y @ W[p + "output_weight"]
    cand = _gather_tail(x, U, M)
    cand_ts = _gather_tail(ts, U, M).float()[..., None]
    period = torch.tensor([f[0] for f in TIME_FEATURES], device=x.device)
    per = torch.tensor([f[1] for f in TIME_FEATURES], device=x.device)
    phase = torch.remainder(torch.floor(cand_ts / period), per) / per * 2.0 * 3.14
    polar = torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1).flatten(-2)
    pp = "hstu_transducer.output_postprocessor."
    user = _ln(_dense(W, pp + "time_feature_combiner.", torch.cat([cand, polar], -1)), W[pp + "ln_weight"], W[pp + "ln_bias"])
    mt = "multitask_module."
    hid = _dense(W, mt + "pred_fc1.", user * item)
    hid = hid * torch.sigmoid(_ln(hid, W[mt + "pred_sln.weight"], W[mt + "pred_sln.bias"]))
    return _dense(W, mt + "pred_fc2.", hid).movedim(-1, 0)


def _rows(batch, lo, hi):
    uih, ul, cands, nc = batch
    return ({k: v[lo:hi] for k, v in uih.items()}, ul[lo:hi], {k: v[lo:hi] for k, v in cands.items()}, nc[lo:hi])


def to_device(batch, device):
    uih, ul, cands, nc = batch
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return {k: t(v) for k, v in uih.items()}, t(ul), {k: t(v) for k, v in cands.items()}, t(nc)


def _table_of(feature: str) -> str:
    return next(t for t, fs in TABLES if feature in fs)


def _gather_tables(cfg, traffic, seed, device, batches, quantize: bool):
    """For each table, the sorted unique ids the batches read and their rows
    (dequantized int8 when ``quantize``)."""
    out = {}
    for t, fs in TABLES:
        ids = torch.cat([b[0 if f in b[0] else 2][f].reshape(-1).long() for b in batches for f in fs])
        uniq = torch.unique(ids)
        rows = table_rows(cfg, traffic, seed, device, t, uniq)
        out[t] = (uniq, quantized(rows) if quantize else rows)
    return out


def _lookup_fn(tables):
    def lookup(feature, ids):
        uniq, rows = tables[_table_of(feature)]
        return rows[torch.searchsorted(uniq, ids.long())]
    return lookup


def serve_predictions(cfg, traffic, seed: int, device, batches: Sequence, tf32: bool = False,
                      block: int = 32) -> List[torch.Tensor]:
    """The served predictions [T, B, M] of each batch (host numpy batches),
    from the int8 tables the serving path quantizes."""
    with _precision(tf32), torch.no_grad():
        dev_batches = [to_device(b, device) for b in batches]
        W = make_weights(cfg, traffic, seed, device, tables=False)
        lookup = _lookup_fn(_gather_tables(cfg, traffic, seed, device, dev_batches, quantize=True))
        return [torch.sigmoid(forward(cfg, traffic, W, lookup, b, block=block)) for b in dev_batches]


class _precision:
    def __init__(self, tf32: bool) -> None:
        self.tf32 = tf32

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old


# ----------------------------------------------------------------- training
def step_seed(seed: int, stream: int, step: int) -> int:
    """The trainer's documented seed of one random stream of one step."""
    return int(np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0] >> 1)


def loss_of(cfg, traffic, logits, cands, nc):
    """The weighted binary cross entropy of the one task over the valid
    candidates, x the multitask weight."""
    M = logits.shape[-1]
    labels = ((cands["item_action_weight"].long() & 1) > 0).float()[None]
    w = (torch.arange(M, device=logits.device)[None] < nc.long()[:, None]).float()[None]
    per = (logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))) * w
    return (per.reshape(1, -1).sum(-1) / w.reshape(1, -1).sum(-1).clamp_min(1.0) * cfg["hstu"]["causal_multitask_weights"]).sum()


def train_steps(cfg, traffic, seed: int, device, batches: Sequence, tf32: bool = False) -> dict:
    """The reference's first ``len(batches)`` training steps from the seed's
    weights: each step's loss and predictions, every leaf's first gradient
    norm and its change after the last step. A table is held as the rows the
    batches read (the others get no gradient and do not move)."""
    with _precision(tf32):
        return _train_steps(cfg, traffic, seed, device, batches)


def _train_steps(cfg, traffic, seed, device, batches) -> dict:
    d = dims(cfg, traffic)
    h, opt = cfg["hstu"], cfg["optimizer"]
    dev_batches = [to_device(b, device) for b in batches]
    dense = make_weights(cfg, traffic, seed, device, tables=False)
    tables = _gather_tables(cfg, traffic, seed, device, dev_batches, quantize=False)
    W = {n: t.clone().requires_grad_(True) for n, t in dense.items()}
    T = {t: rows.clone().requires_grad_(True) for t, (_, rows) in tables.items()}
    W0 = {**dense, **{f"embedding_tables_{t}": rows for t, (_, rows) in tables.items()}}
    params = {**W, **{f"embedding_tables_{t}": r for t, r in T.items()}}
    sparse = {n for n, p in params.items() if p.dim() == 2 and any(k in n for k in ("embedding_tables", "item_embedding"))}
    state = {n: None for n in params}
    lookup_tables = {t: (tables[t][0], T[t]) for t in T}
    lookup = _lookup_fn(lookup_tables)
    b1, b2 = opt["adam_betas"]
    out = {"losses": [], "preds": [], "grad_norms": {}, "change_norms": {}}
    for step, batch in enumerate(dev_batches):
        B = batch[1].shape[0]
        N2 = d["C"] + d["Nu"] + d["M"]
        gen = torch.Generator(device).manual_seed(step_seed(seed, 0, step))
        masks = [torch.rand((B, N2, d["D"]), generator=gen, device=device) < 1.0 - h["hstu_input_dropout_ratio"]]
        masks += [
            torch.rand((B, N2, 3 * d["hd"] * d["H"]), generator=gen, device=device) < 1.0 - h["hstu_linear_dropout_rate"]
            for _ in range(d["L"])
        ]
        logits = forward(cfg, traffic, W, lookup, batch, masks)
        loss = loss_of(cfg, traffic, logits, batch[2], batch[3])
        loss.backward()
        out["losses"].append(loss.item())
        out["preds"].append(torch.sigmoid(logits.detach()))
        with torch.no_grad():
            if step == 0:
                out["grad_norms"] = {n: p.grad.norm().item() for n, p in params.items()}
            for n, p in params.items():
                g = p.grad
                if n in sparse:
                    acc = state[n] if state[n] is not None else torch.zeros(p.shape[0], device=device)
                    acc += g.square().mean(dim=1)
                    p -= (opt["sparse_lr"] / (acc.sqrt() + opt["adagrad_eps"]))[:, None] * g
                    state[n] = acc
                else:
                    if state[n] is None:
                        state[n] = (torch.zeros_like(p), torch.zeros_like(p))
                    m, v = state[n]
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    t = step + 1
                    denom = (v / (1 - b2**t)).sqrt_().add_(opt["adam_eps"])
                    p.addcdiv_(m, denom, value=-opt["dense_lr"] / (1 - b1**t))
                p.grad = None
        del masks
    with torch.no_grad():
        out["change_norms"] = {n: (p - W0[n]).norm().item() for n, p in params.items()}
    return out


# ------------------------------------------------------------------- counts
def _lengths(batch):
    _, ul, _, nc = batch
    ul, nc = np.asarray(ul, np.float64), np.asarray(nc, np.float64)
    return ul + nc + len(CONTEXT), nc


def _pairs(L: np.ndarray, nc: np.ndarray) -> float:
    """Live (query, key) pairs of the mask: each of the C contextual rows
    sees the whole history, a history row at position p sees p + 1 keys, a
    candidate the history and itself."""
    C = len(CONTEXT)
    hist = L - nc
    return float((C * hist + hist * (hist + 1) / 2 - C * (C + 1) / 2 + nc * (hist + 1)).sum())


def forward_flops(cfg: dict, traffic: dict, batch) -> float:
    """The forward's products over the live tokens (the layers' projections
    and attention, the input and item MLPs, the head); elementwise work not
    counted."""
    d = dims(cfg, traffic)
    D, E, H, a, hd = d["D"], d["E"], d["H"], d["a"], d["hd"]
    L, nc = _lengths(batch)
    tokens, cands = float(L.sum()), float(nc.sum())
    per_token = 2 * D * (2 * hd + 2 * a) * H + 2 * 3 * hd * H * D
    flops = d["L"] * (tokens * per_token + _pairs(L, nc) * H * 2 * (a + hd))
    flops += tokens * 2 * (E * 256 + 256 * D + 32 * 256 + 256 * D)  # the input MLPs
    flops += cands * 2 * (2 * E * 512 + 512 * D + (D + 4) * D + D * 512 + 512)  # item MLP, head
    return flops


def attention_calls(cfg: dict, traffic: dict, batch, backward: bool = False) -> List[Tuple[float, float]]:
    """(operations, bytes) of each layer's attention call (K1, and K2 in
    training): each live row of q, k, v (and dO) read once, each output
    written once, float32; 2 (D + V) operations per live pair and head
    forward, 2 (3D + 2V) backward."""
    d = dims(cfg, traffic)
    H, Dq, V = d["H"], d["a"], d["hd"]
    L, nc = _lengths(batch)
    rows, pairs = float(L.sum()), _pairs(L, nc)
    calls = [(2.0 * (Dq + V) * pairs * H, 4.0 * rows * H * (2 * Dq + 2 * V))]
    if backward:
        calls.append((2.0 * (3 * Dq + 2 * V) * pairs * H, 4.0 * rows * H * (2 * Dq + 2 * V + 2 * Dq + V)))
    return calls * d["L"]
