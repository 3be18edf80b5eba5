"""The counts of operations and bytes against a count by hand at a small
shape."""

import os

import numpy as np
import torch

from harness.registry import load_module

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
hstu = load_module(os.path.join(HARNESS_DIR, "reference", "hstu-ml3b-large.py"))
dlrm = load_module(os.path.join(HARNESS_DIR, "reference", "dlrm-v3.py"))


def _hstu_cfg():
    return {
        "model": dict(item_embedding_dim=4, num_heads=2, dqk=3, dv=5, max_sequence_len=6, gr_output_length=1,
                      num_blocks=2, num_items=10),
        "train": dict(num_negatives=7),
    }


def test_hstu_live_counts_by_hand():
    # lengths 2 and 3: rows 2 + 3, pairs j <= i < len: 3 + 6
    assert hstu.live_counts(np.array([2, 3])) == (5.0, 9.0)


def test_hstu_attention_calls_by_hand():
    calls = hstu.attention_calls(_hstu_cfg(), np.array([2, 3]))
    assert len(calls) == 4  # forward and backward of 2 layers
    H, D, V, rows, pairs = 2, 3, 5, 5, 9
    assert calls[0] == (2 * (D + V) * pairs * H, 4 * rows * H * (D + D + V + V))
    assert calls[1] == (2 * (3 * D + 2 * V) * pairs * H, 4 * rows * H * (D + D + V + V + D + D + V))


def test_hstu_step_flops_by_hand():
    cfg = _hstu_cfg()
    lengths = np.array([2, 3])
    D, H, dqk, dv, R, L = 4, 2, 3, 5, 7, 2
    tokens = 5 + 2  # the histories and the targets
    per_layer = tokens * 2 * D * (2 * H * dv + 2 * H * dqk) + tokens * 2 * H * dv * D + 9 * H * 2 * (dqk + dv)
    loss = 5 * 2 * D * (R + 1)
    assert hstu.step_flops(cfg, lengths) == 3 * (L * per_layer + loss)


def test_dlrm_live_pairs_match_the_mask():
    """The pairs the counts use are the True entries of the reference's mask."""
    ul = np.array([5, 9, 1])
    nc = np.array([3, 1, 2])
    C = len(dlrm.CONTEXT)
    L = ul + nc + C
    N = int(L.max()) + 2
    mask = dlrm._mask(N, torch.as_tensor(L), torch.as_tensor(nc), C)
    assert int(mask.sum()) == dlrm._pairs(L.astype(np.float64), nc.astype(np.float64))


def test_dlrm_attention_calls_by_hand():
    cfg = {"hstu": dict(hstu_transducer_embedding_dim=8, hstu_embedding_table_dim=4, hstu_num_heads=2,
                        hstu_attn_qk_dim=3, hstu_attn_linear_dim=5, hstu_attn_num_layers=1,
                        num_position_buckets=16, num_time_buckets=8),
           "hash_size": 10}
    traffic = dict(max_uih_len=8, max_num_candidates=4)
    batch = (None, np.array([4]), None, np.array([2]))
    L = 4 + 2 + 2
    hist = L - 2
    # two contextual rows see the 6 history keys, history rows 2..5 see 3..6, two candidates 7 each
    pairs = 2 * 6 + (3 + 4 + 5 + 6) + 2 * 7
    fwd, bwd = dlrm.attention_calls(cfg, traffic, batch, backward=True)
    assert fwd == (2 * (3 + 5) * pairs * 2, 4 * L * 2 * (2 * 3 + 2 * 5))
    assert bwd == (2 * (3 * 3 + 2 * 5) * pairs * 2, 4 * L * 2 * (2 * 3 + 2 * 5 + 2 * 3 + 5))
