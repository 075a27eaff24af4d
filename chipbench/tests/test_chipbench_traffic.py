"""The traffic and the inputs: the same seed gives the same load and the
same inputs; another seed gives others; seeds past 32 bits work."""

import numpy as np
import pytest
import torch

from chipbench import inputs, load
from chipbench import run as harness

BIG = 2 ** 31 + 12_345_678_901


def _traffic(name):
    return harness.load_json(harness.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("mix", ["sessions", "cold", "one_session"])
def test_conversation_plan_repeats_for_a_seed(mix):
    tr = _traffic(mix)
    tr.setdefault("conversations_per_s", 64.0)
    a = load.conversation_plan(tr, 1024, 12.0, BIG, 8.0)
    b = load.conversation_plan(tr, 1024, 12.0, BIG, 8.0)
    c = load.conversation_plan(tr, 1024, 12.0, BIG + 1, 8.0)
    assert np.array_equal(a.scripts, b.scripts)
    assert np.array_equal(a.think, b.think)
    assert not np.array_equal(a.scripts, c.scripts)
    if a.arrivals is not None:
        assert np.array_equal(a.arrivals, b.arrivals)
        # the ramp and the window hold the rate's count: seeds change the
        # order and the timing of the load, not its amount
        rate = tr["conversations_per_s"]
        for p in (a, c):
            assert (p.arrivals < 8.0).sum() == round(8.0 * rate)
            assert p.arrivals.max() < 12.0
        assert not np.array_equal(a.arrivals, c.arrivals)
        # ... and keep a Poisson process's bursts: seconds hold different
        # counts
        per_s = np.bincount(a.arrivals[a.arrivals < 8.0].astype(int))
        assert per_s.min() < per_s.max()


def test_open_loop_gaps_are_poisson():
    """Pooled over seeds, the gaps between arrivals are exponential at
    the mix's rate (mean and spread 1/rate), the count a second has the
    Poisson variance of the rate, and the tail after the counted seconds
    carries on at the same rate."""
    tr = dict(_traffic("sessions"), conversations_per_s=64.0)
    gaps, counts, tails = [], [], []
    for seed in range(40):
        p = load.conversation_plan(tr, 1024, 40.0, BIG + seed, 30.0)
        head = p.arrivals[p.arrivals < 30.0]
        gaps.append(np.diff(head))
        counts.append(np.bincount(head.astype(int), minlength=30))
        tails.append(((p.arrivals >= 30.0) & (p.arrivals < 40.0)).sum())
    gaps, counts = np.concatenate(gaps), np.concatenate(counts)
    assert abs(gaps.mean() * 64.0 - 1.0) < 0.02
    assert abs(gaps.std() * 64.0 - 1.0) < 0.05
    assert abs(counts.var() / 64.0 - 1.0) < 0.15
    assert abs(np.mean(tails) / 640.0 - 1.0) < 0.03


def test_token_scripts_repeat_for_a_seed():
    sc = harness.load_json(harness.ROOT / "chipbench/configs/cast19-star.json")
    sc = dict(sc["scripts"], n_scripts=32)
    a = inputs.token_scripts(sc, 30522, BIG)
    b = inputs.token_scripts(sc, 30522, BIG)
    c = inputs.token_scripts(sc, 30522, 7)
    assert np.array_equal(a.rows, b.rows)
    assert not np.array_equal(a.rows, c.rows)
    # repeated turns repeat; lengths as the mix says; pads are -1
    for t, src in sc["repeats"].items():
        assert np.array_equal(a.rows[:, int(t)], a.rows[:, src])
    real = (a.rows >= 0).sum(-1)
    assert np.array_equal(real, a.lengths)
    assert real.min() >= sc["prefix"] + sc["suffix"][0]
    assert real.max() <= sc["prefix"] + sc["suffix"][1]
    assert a.unique_rows.shape[0] == 32 * (sc["turns"] - len(sc["repeats"]))


def test_histories_repeat_for_a_seed_and_follow_the_mix():
    tr = _traffic("serve")
    tr = dict(tr, pool=4, batch=256)
    a = inputs.histories(tr, 1 << 20, 50, BIG)
    b = inputs.histories(tr, 1 << 20, 50, BIG)
    assert np.array_equal(a, b)
    n = (a >= 0).sum(-1)
    assert n.min() >= 1 and n.max() <= 50
    # right-padded
    assert ((a[..., 1:] >= 0) <= (a[..., :-1] >= 0)).all()
    # heavy-tailed: most histories short, some long
    assert np.median(n) < 10 and n.max() > 30


def test_corpus_blocks_repeat_and_keep_planted_rows_near_their_centre():
    g = torch.Generator().manual_seed(0)
    centres = torch.nn.functional.normalize(torch.randn(6, 16, generator=g),
                                            dim=1)
    cfg = {"corpus": {"n_docs": 300, "dim": 16, "planted_per_centre": 20,
                      "planted_sigma": 0.2, "subspace_dim": 4,
                      "norm_jitter": 0.15}}
    own = np.repeat(np.arange(3), 2)
    rec = inputs.corpus_recipe(cfg, centres, own, 3, BIG)
    a = [x for _, _, x in rec.blocks(block_rows=128)]
    b = [x for _, _, x in rec.blocks(block_rows=128)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rows = torch.cat(a)
    assert rows.shape == (300, 16)
    norms = torch.linalg.vector_norm(rows, dim=1)
    assert (norms - 1).abs().max() <= 0.15 + 1e-5
    unit = rows / norms[:, None]
    cos = (unit[:120].view(6, 20, 16) * centres[:, None]).sum(-1)
    assert cos.min() > 0.9                   # planted around the centre
    assert (unit[120:] @ centres.T).abs().max() < 0.95
