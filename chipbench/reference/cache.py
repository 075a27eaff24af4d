"""The paper's metric cache for one conversation, replayed plainly
(Algorithm 1 with Eq. 3/4).

A turn is answered from the cache when some recorded back-end query
(psi_a, r_a) covers it: r_a - ||psi - psi_a|| >= epsilon, where r_a is the
distance from psi_a to the k_c-th document of its exact answer.  Otherwise
the exact top-k_c of the corpus is inserted (each document once) and
(psi, r_a) recorded.  Either way the turn's answer is the top k of the
cached documents.  Capacity and the record ring are never reached by the
configuration's conversations (turns x k_c <= capacity, turns <= ring),
and the replay refuses one that would reach them.

Where the program decides otherwise than the replay and the replay's own
margin |max r_hat - epsilon| lies within ``band`` (rounding of psi can tip
such a turn either way), the replay follows the program's decision and
counts it as borderline; every other disagreement is a flip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chipbench.reference import eq1


@dataclasses.dataclass
class TurnCheck:
    hit: bool             # the replay's decision (after following)
    flip: bool            # the program decided otherwise, outside the band
    borderline: bool      # ... inside the band
    answer_gap: float     # widest score gap of the program's answer


def answer_gap(ref_scores: np.ndarray, doc_score: dict,
               prog_ids: np.ndarray, k: int) -> float:
    """The widest gap by which a document of the program's answer scores
    below the reference's document of the same rank: ``ref_scores`` (k,)
    the reference's best scores, ``doc_score`` the reference's score of
    every document it holds as a candidate.  A document that is not a
    candidate, a repeated one, or a short answer reads +inf."""
    ids = [int(i) for i in prog_ids]
    if len(ids) != min(k, len(doc_score)) or len(set(ids)) != len(ids):
        return float("inf")
    gap = 0.0
    for j, d in enumerate(ids):
        if d not in doc_score:
            return float("inf")
        gap = max(gap, float(ref_scores[j]) - doc_score[d])
    return gap


def replay(psi: torch.Tensor, prog_hit: np.ndarray, prog_ids: list,
           topk_scores: torch.Tensor, topk_ids: torch.Tensor,
           docs: torch.Tensor, row_of: dict, cfg: dict,
           band: float) -> list:
    """Check one conversation's turns.

    ``psi`` (T, D+1) the reference's queries; ``prog_hit`` (T,) and
    ``prog_ids`` (T lists) the program's decisions and answers;
    ``topk_scores`` / ``topk_ids`` (T, k_c) each turn's exact corpus
    answer; ``docs`` (U, D+1) the transformed rows of every document
    those answers name, ``row_of`` id -> row of ``docs``."""
    kc, k, eps = cfg["k_c"], cfg["k"], cfg["epsilon"]
    if psi.shape[0] * kc > cfg["capacity"] or psi.shape[0] > cfg["max_queries"]:
        raise ValueError("a conversation would fill the cache or its ring")
    rec_psi, rec_r = [], []
    cached: list[int] = []
    seen: set = set()
    out = []
    for t in range(psi.shape[0]):
        if rec_psi:
            d = eq1.distance(torch.stack(rec_psi) @ psi[t])
            r_hat = torch.stack(rec_r) - d
            best = float(r_hat.max())
            ref_hit = best >= eps
        else:
            best, ref_hit = float("-inf"), False
        hit, flip, border = ref_hit, False, False
        if bool(prog_hit[t]) != ref_hit:
            if abs(best - eps) <= band:
                hit, border = bool(prog_hit[t]), True
            else:
                flip = True
        if not hit:
            ids = topk_ids[t].tolist()
            for i in ids:
                if i not in seen:
                    seen.add(i)
                    cached.append(i)
            rec_psi.append(psi[t])
            rec_r.append(eq1.distance(topk_scores[t, kc - 1]))
        rows = torch.as_tensor([row_of[i] for i in cached],
                               device=docs.device)
        s = docs[rows] @ psi[t]
        top_s, top_j = torch.topk(s, min(k, len(cached)))
        score_of = dict(zip(cached, s.tolist()))
        gap = answer_gap(top_s.cpu().numpy(), score_of,
                         np.asarray(prog_ids[t]), k)
        out.append(TurnCheck(hit=hit, flip=flip, borderline=border,
                             answer_gap=gap))
    return out


def serve(psi: torch.Tensor, topk_scores: torch.Tensor,
          topk_ids: torch.Tensor, docs: torch.Tensor, row_of: dict,
          cfg: dict, precision: str = "f32") -> list:
    """One conversation answered by the plain cache itself: [(hit, answer
    ids)] by turn.  With ``precision`` "tf32" it is the control: the
    reference in the program's place, one step below the stated
    precision."""
    from chipbench.reference import mm
    kc, k, eps = cfg["k_c"], cfg["k"], cfg["epsilon"]
    rec_psi, rec_r, cached, seen, out = [], [], [], set(), []
    for t in range(psi.shape[0]):
        hit = False
        if rec_psi:
            s = mm(torch.stack(rec_psi), psi[t][:, None], precision)[:, 0]
            hit = float((torch.stack(rec_r) - eq1.distance(s)).max()) >= eps
        if not hit:
            for i in topk_ids[t].tolist():
                if i not in seen:
                    seen.add(i)
                    cached.append(i)
            rec_psi.append(psi[t])
            rec_r.append(eq1.distance(topk_scores[t, kc - 1]))
        rows = torch.as_tensor([row_of[i] for i in cached],
                               device=docs.device)
        s = mm(docs[rows], psi[t][:, None], precision)[:, 0]
        _, top_j = torch.topk(s, min(k, len(cached)))
        out.append((hit, np.asarray([cached[j] for j in top_j.tolist()])))
    return out
