"""The inputs made from the seed: the same seed gives the same inputs,
another seed others."""

import numpy as np

from harness import synth
from harness.registry import load_module
import os

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_corpus(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.item_ids + a.timestamps, b.item_ids + b.timestamps))


def test_research_corpus_is_deterministic_in_the_seed():
    a = synth.research_corpus(32, 500, 41, 5, 8, 2**31 + 5)
    b = synth.research_corpus(32, 500, 41, 5, 8, 2**31 + 5)
    c = synth.research_corpus(32, 500, 41, 5, 8, 2**31 + 6)
    assert _same_corpus(a, b)
    assert not _same_corpus(a, c)
    lengths = [len(x) for x in a.item_ids]
    assert min(lengths) >= 5 and max(lengths) <= 41
    assert all(x.min() >= 1 and x.max() <= 500 for x in a.item_ids)
    assert all(np.all(np.diff(t) > 0) for t in a.timestamps)


def test_ranker_batches_are_deterministic_in_the_seed():
    t = dict(batch=16, max_uih_len=64, max_num_candidates=10, zipf_a=1.05)

    def draw(seed):
        return synth.ranker_batches(np.random.default_rng(seed), t, 1000, 2)[0]

    a, b, c = draw(2**32 + 1), draw(2**32 + 1), draw(2**32 + 2)
    for x, y in zip(a[0].values(), b[0].values()):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0]["uih_post_id"], c[0]["uih_post_id"])
    uih, ul, cands, nc = a
    assert ul.min() >= 1 and ul.max() <= 64 and nc.min() >= 1 and nc.max() <= 10
    # ids past a row's length are 0; every id is a row of the table
    assert np.all(uih["uih_post_id"][np.arange(64)[None] >= ul[:, None]] == 0)
    assert uih["uih_post_id"].max() < 1000 and cands["item_post_id"].max() < 1000


def test_every_seed_gets_the_same_sizes():
    t = dict(batch=16, max_uih_len=64, max_num_candidates=10, zipf_a=1.05)
    a = synth.ranker_batches(np.random.default_rng(1), t, 1000, 4)
    b = synth.ranker_batches(np.random.default_rng(2), t, 1000, 4)
    for k in (1, 3):
        x, y = np.concatenate([q[k] for q in a]), np.concatenate([q[k] for q in b])
        assert np.array_equal(np.sort(x), np.sort(y)) and not np.array_equal(x, y)
    c1 = synth.research_corpus(32, 500, 41, 5, 8, 1)
    c2 = synth.research_corpus(32, 500, 41, 5, 8, 2)
    assert sorted(map(len, c1.item_ids)) == sorted(map(len, c2.item_ids))


def test_zipf_ids_are_skewed():
    ids = synth._zipf_rows(np.random.default_rng(3), (200000,), 10_000_000, 1.05)
    _, counts = np.unique(ids, return_counts=True)
    top = np.sort(counts)[::-1]
    # the hottest row takes a few percent, far above a uniform draw's share
    assert top[0] > 1000 and top[0] / ids.size < 0.2


def test_poisson_arrivals_are_deterministic_and_at_the_rate():
    server = load_module(os.path.join(HARNESS_DIR, "drivers", "serve_server.py"))
    a = server.arrivals(40.0, 100.0, 2**31 + 3)
    b = server.arrivals(40.0, 100.0, 2**31 + 3)
    c = server.arrivals(40.0, 100.0, 2**31 + 4)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a[0] == 0.0 and np.all(np.diff(a) >= 0) and a[-1] < 100.0
    assert abs(len(a) / 100.0 - 40.0) < 4.0
