"""A run with the timed path broken underneath comes out as not correct.

Each test drives the whole harness on the CPU at a smoke size (set-up,
load, window, check; only the look for a card is skipped) with one fault
planted in the program where it does its work:

  * a step that returns its state unchanged: the cache's fill inserts
    nothing (the batched engine's fused insert, or the one-session
    cache's insert);
  * half of the batch left out: the encoder computes the first half of
    its rows and gives the rest their mean;
  * an answer altered where it is produced: the index scan's best id of
    each row replaced by the next document's.

The exchange between chips is not a fault these cells can have: every
cell runs on one card.
"""

import pytest
import torch

from chipbench.tests.smoke import smoke_root, smoke_run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("smoke"))


def _unchanged_state(monkeypatch):
    from repro_torch.core import cache as core_cache
    from repro_torch.core.cache_ops import query_batched
    from repro_torch.serve import session

    def fill_nothing(state, cfg, psi, radius, new_emb, new_ids, k, do=None,
                     record=None, rows=None):
        out, state = query_batched(state, psi, k, rows=rows)
        return out, state, torch.zeros(psi.shape[0], dtype=torch.int32)

    monkeypatch.setattr(session, "insert_query_batched", fill_nothing)
    monkeypatch.setattr(core_cache.MetricCache, "insert",
                        lambda self, *a, **kw: None)


def _half_batch(monkeypatch):
    from repro_torch.models import recsys, transformer

    def halved(fn):
        def call(params, x, cfg, *a, **kw):
            half = max(x.shape[0] // 2, 1)
            out = fn(params, x[:half], cfg, *a, **kw)
            rest = out.mean(0, keepdim=True).expand(
                (x.shape[0] - half,) + tuple(out.shape[1:]))
            return torch.cat([out, rest])
        return call

    monkeypatch.setattr(transformer, "hidden_states",
                        halved(transformer.hidden_states))
    monkeypatch.setattr(recsys, "_encode", halved(recsys._encode))


def _altered_answer(monkeypatch):
    from repro_torch.core import metric_index
    from repro_torch.dist import retrieval

    def altered(fn):
        def call(docs, doc_ids, queries, k, **kw):
            scores, ids = fn(docs, doc_ids, queries, k, **kw)
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + 1) % docs.shape[0]
            return scores, ids
        return call

    monkeypatch.setattr(retrieval, "scan_topk",
                        altered(retrieval.scan_topk))
    monkeypatch.setattr(metric_index, "scan_topk",
                        altered(metric_index.scan_topk))


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}
# at this size the CPU's scheduler forms one-turn waves from the sessions
# mix's spread-out arrivals, so the half batch is the cold cell's to show
# (the same front door and wave path, with waves of four)
CASES = [("cast19-star.sessions", "unchanged_state"),
         ("cast19-star.sessions", "altered_answer")] + \
    [("cast19-star.cold", f) for f in FAULTS] + \
    [("cast19-star.one_session", "unchanged_state"),
     ("cast19-star.one_session", "altered_answer"),
     ("sasrec.serve", "half_batch"), ("sasrec.serve", "altered_answer")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_makes_the_run_not_correct(root, monkeypatch, cell,
                                                    fault):
    FAULTS[fault](monkeypatch)
    out = smoke_run(root, cell)
    assert not out["correct"], (fault, out["checks"])
    failing = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failing or out["failed"], out
