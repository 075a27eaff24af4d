#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--phases kernels,recsys,...]

Run from the repository root.  Phases, each fatal on failure:

  1. device  — needs a CUDA card; prints its name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them.
  2. build   — ``nvcc`` builds every kernel source of ``src/repro_torch/csrc``
     (one process per source, all started together).
  3. kernels — every kernel against its plain PyTorch version on the card,
     on the same inputs, at its path's shapes: the batched probe's decision
     (S=64, Qmax=64, dim 769; one launch: ring validity, the first maximal
     r_hat, the hit test, nearest = -1 for an empty ring) against the plain
     decision on the card and on the CPU, and its r_hat entry; the
     single-session probe (Qmax=64, rings of 0, 1, 64 and 73 records, an int
     and a device record count), the wave in its three modes and three
     store dtypes (S=64, capacity 16000, k_c=1000, k=10; and the query at
     k=200) and at one session on Table 1's cache with every slot live
     (capacity 12000, the query at k=200, a k_c=1000 insert), the kNN search (B=64, k=1000 and k=2048; fp32 at N=8,841,823,
     bf16 / int8 / int8-dot at N=1,000,000; and B=1 at k=1000 and 200, the
     single-query score path), the score paths around their threshold
     beside ``torch.mm`` (B = 1, 8, 9, 16, 32, 64: the crossover; the plain
     score at B = 16), ``MetricIndex.search`` of 2,048 queries over the
     whole corpus (chunked under ``kernels/knn/ops.SCRATCH_BUDGET``: ids
     equal the 64-query searches, its time and its peak memory above the
     corpus), the radix select on synthetic (2, N) rows (all scores
     equal, a tie run across rank k, -inf runs and a row with 10 finite
     scores, k = 2048 and 20,000) against the plain stable top-k bit for
     bit, and the two-stage scan (k=1000 at N=1,000,000, B=64: fp32 and
     int8-dot with the tuned tile, a cluster of 2 and of 4 blocks; fp32
     with tile_n=256 and 100, whole tiles a block; bf16 at 4096, a cluster
     of 16; fp32 at 8192, the kept pair; and B=4 at 512, a query tile
     mostly empty).  Each is timed
     with CUDA events beside its plain version, its bound and, where one
     PyTorch call computes the same function, that call.
     probe   — (also part of kernels) the probe's times through the entries
     that this package and its parent share: ``cache_probe_batched`` at
     S=64 and ``cache_probe`` at S=1 (Qmax=64, every record live), on the
     device alone and back to back, and the r_hat entries' device time.
  4. recsys  — the recsys serving path at full published widths, before the
     corpus so its 9 GB of tables never meet the 28 GB corpus: first the
     smoke configs on the CPU path and, moved to the card, through the
     kernel (logits within 1e-5); then ``DLRM(dlrm_rm2.full_config())`` (26
     x 1,048,576 x 64 f32) with the embedding-bag kernel held against its
     plain version (bit for bit for bags of one item) and timed beside it,
     ``F.embedding_bag`` and its bound at every shape: the flattened table
     at ``serve_bulk`` and ``serve_p99``, f16 / bf16 copies at
     ``serve_bulk``, and 65,536 multi-hot bags of 8 (weights, pads, an
     empty bag) in sum / mean / max; serving
     ``CTRStream`` batches at ``serve_p99`` (512 rows, 51 calls: latency
     p50 / p99) and ``serve_bulk`` (262,144 rows: rows/s), 1 launch per
     forward; then ``XDeepFM(xdeepfm.full_config())`` (39 x 1,048,576 x 10
     plus the x 1 linear term; the kernel at D = 10 over the bulk batch and
     one 16,384-row chunk, and at D = 1)
     at ``serve_p99`` and at ``serve_bulk`` in 16 chunks of 16,384 rows
     (CIN's (B, H*m, D) product is 81.8 GB at 262,144 rows), 2 launches per
     forward.  Logits are finite and equal the interaction fed the plain
     pooled rows (rtol 1e-4, atol 1e-5); the pool reads the (F*V, D) view of
     the tables, and the peak memory shows no copy of them.  Then
     ``retrieval_cand`` for each: 51 one-row requests through the user
     tower and the top 1,000 of ``candidate_index(tables[0], n_valid=
     1,000,000)`` (the kNN kernels; DLRM's table taken as is, xDeepFM's
     padded 10 -> 32 once), latency p50 / p99, the last answer's ids equal
     the plain search's on the card, none >= 1,000,000; the kNN pair and
     the embedding bag at that shape timed beside their plain versions
     and library calls.
  5. lm      — the LM family with MLA, MoE and MTP and the decode path,
     before the corpus so its weights never meet the 28 GB corpus (plain
     PyTorch, as the JAX package computes them in plain ``jnp``; bf16
     products accumulate in f32, asserted).  The deepseek-v3-671b and
     llama4-scout-17b-16e smoke configs with the same parameters on the
     card and on the CPU path (f32: a padded prefill's logits and aux
     loss, MTP logits, three decode steps, within 1e-5); then both at full
     width cut to 4 layers (deepseek: its 3 dense layers and 1 MoE layer,
     MTP; 31.60 / 21.76 GB of seeded random bf16 weights): ``moe_ffn`` over
     8 x 512 tokens against a plain f32 loop with the routing computed
     apart (equal ids, positions and kept mask; the RMS of the error
     within 2e-2 of the output's), 8 tokens prefilled against the same 8
     through ``decode_step`` (logits within 0.25, argmax equal where the
     top two lie further apart), a prefill of 8 x 512 into caches of 544
     positions and 32 greedy decode steps, twice, bit for bit (prefill
     and decode step timed on the device and back to back beside their
     bounds, a profiler split, peak memory); deepseek's MTP logits, and
     its ``make_lm_query_encoder`` with a (7168, 768) ``proj`` in front
     of ``ConversationalEngine`` for 2 conversations x 10 token turns
     over ``make_world``'s 60,000 documents (every miss the exact top-k of
     its psi).
  5b. seqrec — SASRec and BERT4Rec (plain PyTorch encode, as the JAX
     package's ``jnp``), before the corpus.  The smoke configs with the same
     parameters on the card and on the CPU path over ``SessionStream`` rows
     (most with pads, one all pads): encode, session repr, BCE and the
     top-25 scores within 1e-5, ids equal.  Then each at full width
     (1,048,576 items; seeded random weights) through ``SeqRec.retrieve``:
     the encode in row chunks (``models/recsys.encode_rows``), then
     ``MetricIndex.search`` over the item table (BERT4Rec's taken as is,
     SASRec's padded 50 -> 64 once): ``serve_p99`` (51 requests of 512
     sessions, top 100: latency p50 / p99, every row of the last against
     the plain search, encode and scan timed apart), ``serve_bulk``
     (262,144 sessions, served twice: rows/s, the encode's and the kNN
     search's chunks, 1,024 sampled rows against the plain search, peak
     memory) and ``retrieval_cand`` (51 one-session requests over the
     first 1,000,000 items, top 1,000).  The kNN pair at ``serve_p99``'s
     shape timed beside its plain versions and library calls.
  5c. egnn  — the equivariant GNN (plain PyTorch, as the JAX package's
     ``jnp``; no kernel).  The smoke config card against CPU (node and
     graph readout, within 1e-4) and, on the card, a rotation and
     translation (logits equal, coordinates rotated, within 2e-4).  Then
     the four shapes of ``configs/egnn.SHAPES`` at full width (4 layers,
     d 64): ``molecule`` (128 graphs x 30 nodes x 64 edges, graph
     readout), ``full_graph_sm`` (2,708 nodes, 10,556 edges, d_feat
     1,433), ``minibatch_lg`` (a 1,024-seed block of fanout (15, 10) from
     ``NeighborSampler`` over a 232,965-node, 114,615,892-edge host graph,
     d_feat 602) and ``ogb_products`` (2,449,029 nodes, 61,859,140 edges,
     d_feat 100), each made on the host from the seed: the forward timed
     on the device and back to back beside its bound, its edge chunks
     (``models/egnn.EDGE_CHUNK``), two forwards equal bit for bit, its
     peak memory, and the host seconds apart.
  6. corpus  — ``make_world`` (60,000 docs, 64 conversations of 10 turns,
     dim 768) plus background distractors drawn on the card from a seeded
     generator fill the corpus to N = 8,841,823 (the MS MARCO passage
     collection of TREC CAsT 2019); one Eq. 1 M over the whole corpus.
  7. encoder — the paper's query encoder (``make_lm_query_encoder`` over
     the dense transformer, plain PyTorch: the JAX package has no
     attention kernel).  The four smoke configs (star-encoder,
     chatglm3-6b, gemma2-9b, mistral-large-123b) with the same parameters
     on the card and on the CPU path (hidden states within 1e-5); then
     ``star_encoder.full_config()`` (12 layers, d 768, 12 heads, d_ff
     3072, vocab 30,522, f32) with seeded random weights (no STAR weights
     offline) and a (768, 768) ``proj``: psi of 8 rows (lengths 8-64, -1
     pads) card against CPU within 1e-4, unit norm within 1e-5; encode
     timed at B = 1 and B = 64 rows of 64 tokens (device and back to
     back) beside its bound (2 x 113.26 M x tokens + attention
     operations; the 453 MB of layer weights), one ``torch.profiler``
     forward at each (device activities, and device ms by part: products,
     attention, norms, RoPE, the rest).  Then token turns (a 16-token
     prefix from ``data.lm.TokenStream`` + an 8-48-token suffix; turns 4
     and 8 repeat turns 1 and 5): ``ConversationalEngine(encoder=lambda
     t: encode(t[None])[0])`` over 8 conversations x 10 turns ([engine]'s
     launches per turn; hits and misses; turn p50 of each and the
     encoder's share), and ``SessionManager`` -> ``BatchedEngine(64
     sessions, ..., encoder=encode)`` over 64 conversations x 10 turns
     (rows padded to 64 tokens; one encoder call a wave, [main]'s
     launches per wave; probe and fill span p50, peak memory above the
     corpus).  Every miss turn of both equals the exact top-k of the psi
     it probed with.
  8. ab      — the two-stage A/B baseline over that corpus:
     ``knn_search(two_stage=True)`` for the 64 first turns at k = k_c =
     1000 (one launch of the fused tile kernel, one of the merge's
     select), against the fused search and the plain two-stage version;
     its peak memory above the corpus; timed apart: the fused tile kernel,
     the merge (beside its plain sort and ``torch.topk``), the kept pair
     (``knn_score`` + ``knn_tile_select``) on the same queries, and the
     whole two-stage search beside the fused one.
  9. main    — the batched serving path: ``SessionManager`` ->
     ``BatchedEngine(64 sessions, k=10, k_c=1000, epsilon=0.04, capacity=
     16000)`` -> ``ShardedRouter([DeviceShard(fp32)])`` serves the 10 turns
     of every conversation, then one round that re-asks each last turn.  3
     launches per wave with a miss (the kNN search counted as one) and 2
     per wave without; every miss turn matches an exact plain search over
     the whole corpus, and the same engine on a small input answers as the
     CPU path does.  Prints each wave's bucket, the p50 of the probe and
     fill spans, and the serve's own peak device memory.
  10. tiered  — the tiered wave on the same corpus.  First, on the 60,000
     world docs (one 16-cluster index built on the card), the tiered
     engine on the card and on the CPU path answers alike: tiers, ids and
     counters (promotions, memo serves, prefetch accounting).  Then the
     ``ClusterIndex`` over the whole corpus (64 clusters, at most 10
     Lloyd iterations, neighbour tables 256 wide), built twice,
     bit-identical, with no second copy of the corpus; then
     ``BatchedEngine(64 sessions, k=10, k_c=1000, epsilon=0.04, capacity
     16000, shared=SharedTier(n_shards=4, capacity=8000, memo_sim=0.995,
     cluster=...), cluster=..., prefetch_width=128)`` behind one
     ``DeviceShard`` serves ``serve_bench.bench_zipf``'s traffic (3
     generations of 64 sessions, each drawing a conversation with Zipf
     alpha 1.1 and a 0.005 jitter on its raw queries, 10 turns) in fixed
     rounds: every wave's launches as the tiered contract says (L1 probe,
     the L2 probe when a row is left after the memo, the kNN pair, the
     fused insert+query or the query, the L2 query when a row hits L2,
     one insert per admission sub-wave), turns well formed, L2 serving
     some, every miss turn the exact top-k, peak memory above the corpus
     under 10 GB.  ``[chaos]``: ``serve_bench.bench_chaos`` at 8 sessions
     x 10 rounds over 4 ``DeviceShard``s on row views of the corpus under
     ``chaos_plan(4)``, with ``SharedTier(ttl_waves=3)`` and
     ``validate_every=4``: no corrupt answer served, warm availability >=
     0.99, a breaker opened and closed.  The kernels at the new shapes
     (the assignment, the neighbour tables, the L2 probe and query, the
     admission insert, the widened fill) against their plain versions,
     timed beside ``torch.max(q @ C.T, 1)`` / ``torch.topk(q @ D.T,
     256)`` where one call computes the same function.
  11. paper  — Algorithm 1 for one session: ``ConversationalSearcher(
     MetricIndex(corpus), k=200, k_c=1000, epsilon=0.04, capacity=12000)``
     under the ``none``, ``static`` and ``dynamic`` policies over the 64
     conversations, with Table 1's columns (hit rate over turns 2-10,
     MAP@200, MRR@200, nDCG@3, P@1, P@3, cov@10), the largest cache and the
     per-turn latency (and the p50 of hit turns); every ``none`` turn
     equals the exact top-200; per
     turn one probe and one cache query, per miss one kNN search and one
     insert.  First, on 8 conversations x 4 turns over the 60,000 world
     docs (k_c=100), the card answers as the CPU path does.
  12. engine — ``ConversationalEngine`` behind ``ShardedRouter([DeviceShard
     (corpus)])`` serves 8 conversations x 10 turns (k=10, k_c=1000) and
     agrees turn for turn with the dynamic searcher.
  13. dist   — the distributed layer (``repro_torch.dist``) in a world of
     one rank: an NCCL group on the card (a rendezvous file, no port) and
     ``DeviceMesh``es of shape (1,) and (1, 1).  ``MetricIndex(corpus,
     sharded=True)`` lays the corpus out with ``shard_corpus`` without a
     copy; its ``sharded_nn`` at B = 64 and B = 1 (k = 1000) equals
     ``MetricIndex.search`` on the same corpus bit for bit, through the
     kNN kernels, timed on the device and back to back beside it (the
     difference is the gather and the merge at a world of one).
     ``make_batched_scorer`` at SASRec's ``retrieval_cand`` shape
     (1,048,576 x 64 items, 1,000,000 valid, B = 1, k = 1000) against
     ``candidate_index``'s search.  STAR at full width under
     ``lm_activation_rules`` with its parameters placed by
     ``param_specs`` as DTensors, B = 1 and 64 rows of 64 tokens, within
     1e-6 of the plain forward, both timed.  After the corpus is
     released: ``moe_ffn_sharded`` on one deepseek-v3 MoE layer at full
     width (256 experts, top 8, bf16, 8 x 512 tokens, ``moe_ffn``'s
     capacity) against ``moe_ffn``: the sharded form routes in bf16 (the
     JAX version's rule) and ``moe_ffn`` in f32, so the tokens routed
     alike by both are held to [lm]'s MoE bar (RMS error within 2e-2 of
     the output's RMS); the share routed differently and the whole RMS
     error are printed; both timed.
  14. cells  — the 40 cells of ``registry.all_cells()``, each built by
     ``launch.cells.build_cell`` on a (1, 1) mesh over a world of one NCCL
     rank of its own and run at full width with seeded random weights and
     inputs (the cuts: the comment above ``CELL_LM_CUTS``): a train cell's
     first loss equals ``train.step.make_train_step``'s from the same
     parameters and batch (rtol 1e-5); a serve, prefill, decode or
     retrieval output equals the direct model path's within 0 (top-k by
     ``assert_topk_agree``, scores equal).  Each cell prints its time a
     call (CUDA events and the host clock), its peak memory above what the
     card held beside its arguments, its kernel launches (the kNN pair
     behind every retrieval and seqrec serve, the embedding bag behind the
     CTR models' serving; none elsewhere), its model flops over the time
     against the roofline bound of ``launch.dryrun``'s counts, and the
     dry-run's peak estimate on a (1, 1) fake mesh (traced in host
     processes while the card works), which must reach half the measured
     peak.

``--phases`` runs a subset (``probe,recsys,paper`` also drives the
parent package, whose entries these phases share, for a comparison in one
call).  Every path (recsys, lm's encoder session, the encoder's two
engines, ab, main, the
cluster build, tiered, chaos, the three paper runs, engine, each cell) runs
with the kernel
counters zeroed just before it and read just after; each checks its own
launch accounting, and the ``launches`` of the kernels line are their sums.
The line also holds ``knn_score_b1`` and ``knn_select_b1``: the same two
kernels timed at the single-query shape, with the launches of [paper] and
[engine] (and of [encoder]'s one session), where every kNN search is a
single query; and
``wave_query_topk_s1`` and ``wave_insert_scatter_s1``: the wave kernel at
one session (every cache query and insert of [paper] and [engine]), timed
with the stream's queue filled ahead so that the wrapper's host time
between launches is not counted (the back-to-back time is printed
beside it).  The two probe rows (``cache_probe``, ``probe_rhat``) are the
decision ops, one launch each, timed the same way.  The ``*_assign``,
``*_tables``, ``*_l2`` and ``wave_insert_query_wide`` rows are the kernels
at the tiered path's shapes, with the launches of the cluster build and of
``[tiered]`` made at those shapes.  The ``*_seqrec`` rows are the kNN pair
at seqrec's ``serve_p99`` shape (launches of ``serve_p99`` and
``serve_bulk``), the ``*_cand`` rows the kNN pair and the embedding bag at
``retrieval_cand``'s (launches of all four archs there, and of the two
user towers), each timed with the queue filled ahead.

Tolerances (the kernels and the plain versions sum f32 dot products in
different orders): scores and r_hat within 1e-5 and 1e-4 (r_hat takes a
square root of 2 - 2s, which widens the score's error); pooled rows within
1e-5 for f32 tables and 1e-3 for f16 / bf16 ones (bags of one item: equal
bit for bit); ranks compared by
``repro_torch.kernels.parity.assert_topk_agree`` (ids equal where the score
gap to the neighbouring ranks exceeds the tolerance, as sets inside tied
runs).  Wave states must be equal bit for bit: the scatter copies rows.

Output: progress lines, then the ``{"kernels": [...]}`` line, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # the H100 data sheet's rates and the paths' cost counts
    from repro_torch.launch.roofline import (BF16_OPS, F32_OPS, HBM_BPS,
                                             I8_OPS, bound, egnn_costs,
                                             lm_bound, lm_costs, lm_train_ops,
                                             recsys_train_ops)
except ImportError:     # no package beside the script, or no PyTorch:
    pass                # main() says which and exits 2
N_CORPUS = 8_841_823          # MS MARCO passages (TREC CAsT 2019 collection)
N_SMALL = 1_000_000           # corpus of the bf16 / int8 kNN checks
S, QMAX, DIM_RAW = 64, 64, 768
CAPACITY, KC, K, EPS = 16000, 1000, 10, 0.04
PAPER_K = 200                 # Table 1's evaluation depth (MAP@200)
PAPER_CAP = 12000             # (turns + 2) * k_c, as evaluate_policy sets it
SCORE_TOL, RHAT_TOL = 1e-5, 1e-4
DEV = "cuda"

SRC = "src/repro_torch/csrc/"
TPU = "src/repro/kernels/"
KERNELS = {
    "cache_probe": ("cache_probe.cu", "cache_probe/cache_probe.py:81"),
    "knn_score": ("knn.cu", "knn/knn.py:197"),
    "knn_select": ("knn.cu", "knn/knn.py:197"),
    "wave_insert_query": ("cache_wave.cu", "cache_wave/ops.py:255"),
    "wave_query_topk": ("cache_wave.cu", "cache_wave/ops.py:163"),
    "wave_insert_scatter": ("cache_wave.cu", "cache_wave/ops.py:234"),
    "probe_rhat": ("cache_probe.cu", "cache_probe/cache_probe.py:49"),
    "knn_tile_topk": ("knn.cu", "knn/knn.py:285"),
    "embedding_bag": ("embedding_bag.cu", "embedding_bag/embedding_bag.py:50"),
}
# the score and select kernels again at the single-query shape (B = 1, the
# miss of Algorithm 1 for one session); their launches are those of [paper]
# and [engine], where every kNN search is a single query
B1_ROWS = {"knn_score_b1": "knn_score", "knn_select_b1": "knn_select"}
# the wave kernel again at one session (Algorithm 1's cache, capacity 12000,
# every slot live): the query of every [paper] / [engine] turn and the
# insert of every miss; their launches are those of [paper] and [engine]
S1_ROWS = {"wave_query_topk_s1": "wave_query_topk",
           "wave_insert_scatter_s1": "wave_insert_scatter"}
BAG_TOL, HALF_TOL = 1e-5, 1e-3     # pooled rows: f32 tables, f16 / bf16
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
P99_CALLS = 51                     # the first is a warm-up, not in the stats
SPREAD_READINGS = 5                # readings of the B = 1 select's time
# what --phases may select; the default runs them all (the kernels phase is
# every kernel against its plain version, the knn checks included)
PHASES = ("kernels", "probe", "recsys", "lm", "seqrec", "egnn", "train",
          "encoder", "ab", "main", "tiered", "paper", "engine", "dist",
          "cells")
XDEEPFM_CHUNK = 16_384
# [tiered]: the L2 tier, the cluster index and the traffic of
# serve_bench.bench_zipf; [chaos]: bench_chaos at 8 sessions x 10 rounds
TIER_SHARDS, TIER_CAP, MEMO_SIM, PREFETCH_WIDTH = 4, 8000, 0.995, 128
N_CLUSTERS, CLUSTER_ITERS, MAX_WIDTH = 64, 10, 256
ASSIGN_CHUNK = 16_384         # corpus rows a k-means assignment scan
GENERATIONS, ZIPF_ALPHA, ZIPF_JITTER = 3, 1.1, 0.005
CHAOS_SESSIONS, CHAOS_ROUNDS, CHAOS_SEED = 8, 10, 23
SEED = 0                      # --seed
# [encoder]: token turns of ENC_PREFIX + ENC_SUFFIX tokens (at most ENC_SEQ)
# through the STAR encoder at full width; the ENC_REPEATS turns repeat an
# earlier turn verbatim.  Hidden states of the smoke configs, card against
# CPU, within ENC_SMOKE_TOL; psi at full width within ENC_PSI_TOL (unit
# norm, 12 layers of f32 sums in other orders)
ENC_SEQ, ENC_PREFIX, ENC_SUFFIX, ENC_TURNS = 64, 16, (8, 48), 10
ENC_REPEATS = {4: 1, 8: 5}
ENC_SMOKE_TOL, ENC_PSI_TOL = 1e-5, 1e-4
# [lm]: the MoE / MLA models at full width, cut to LM_LAYERS layers
# (deepseek: its 3 dense layers and 1 MoE layer); a served prefill of LM_B
# x LM_S tokens into caches of LM_KV positions, then LM_STEPS greedy decode
# steps; LM_CONVS conversations through the encoder (deepseek).  The smoke
# configs' logits card against CPU within LM_SMOKE_TOL (f32, as
# ENC_SMOKE_TOL); moe_ffn (bf16) against a plain f32 loop: the RMS of
# the error within LM_MOE_TOL of the output's RMS (bf16 rounding gives
# about 5e-3; a product accumulated in bf16 about 0.1); prefill against
# decode (bf16 logits of RMS about 1) within LM_PD_TOL
LM_ARCHS = ("deepseek-v3-671b", "llama4-scout-17b-16e")
LM_LAYERS, LM_B, LM_S, LM_KV, LM_STEPS, LM_CONVS = 4, 8, 512, 544, 32, 2
LM_SMOKE_TOL, LM_MOE_TOL, LM_PD_TOL = 1e-5, 2e-2, 0.25
# [recsys] retrieval_cand and [seqrec]: the paper's index scan over an item
# table (cells.py: the top SERVE_K at serve_p99 / serve_bulk, the top CAND_K
# of retrieval_cand's candidates); BULK_SAMPLE serve_bulk rows checked
# against the plain search; the smoke configs card against CPU within
# SEQREC_TOL.  [egnn]: the smoke config card against CPU within
# EGNN_SMOKE_TOL, a rotation and translation within EGNN_EQUI_TOL (the JAX
# package's test bound); EGNN_SHAPES in order, with EGNN_REPS timed
# forwards each
SEQREC_ARCHS = ("sasrec", "bert4rec")
SERVE_K, CAND_K, BULK_SAMPLE, SEQREC_TOL = 100, 1000, 1024, 1e-5
EGNN_SMOKE_TOL, EGNN_EQUI_TOL = 1e-4, 2e-4
EGNN_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg", "ogb_products")
EGNN_REPS = {"molecule": 10, "full_graph_sm": 10, "minibatch_lg": 5,
             "ogb_products": 2}
# [train]: the smoke configs card against CPU (train.parity's rule); STAR
# at full width through train.encoder (TRAIN_STAR_STEPS steps of
# TRAIN_STAR_B x TRAIN_STAR_S tokens in its config's TRAIN_ACCUM_STEPS
# microbatches, remat "full"), then killed after TRAIN_RESUME steps and
# resumed (losses within TRAIN_RESUME_RTOL, test_system.py's bar);
# llama4-scout at full width cut to TRAIN_LM_LAYERS layer(s) (TRAIN_LM_B x
# TRAIN_LM_S tokens, Adafactor with bf16 stochastic rounding); the four
# recsys archs at train_batch for TRAIN_RECSYS_STEPS steps (xDeepFM in
# XDEEPFM_TRAIN_ACCUM row microbatches: its CIN product is 20.4 GB a layer
# at 65,536 rows); EGNN at TRAIN_EGNN_SHAPES, TRAIN_EGNN_STEPS steps each
# (the first a warm-up).  EGNN_GRAPHS keeps those shapes' host graphs from
# [egnn] for [train].
TRAIN_STAR_STEPS, TRAIN_STAR_B, TRAIN_STAR_S, TRAIN_RESUME = 20, 64, 512, 3
TRAIN_RESUME_RTOL = 1e-5
TRAIN_LM_ARCH, TRAIN_LM_LAYERS, TRAIN_LM_B, TRAIN_LM_S, TRAIN_LM_STEPS = (
    "llama4-scout-17b-16e", 1, 8, 512, 3)
TRAIN_RECSYS = ("dlrm-rm2", "xdeepfm", "sasrec", "bert4rec")
TRAIN_RECSYS_STEPS, XDEEPFM_TRAIN_ACCUM = 5, 4
TRAIN_EGNN_SHAPES, TRAIN_EGNN_STEPS = (
    ("molecule", "full_graph_sm", "minibatch_lg"), 3)
EGNN_GRAPHS: dict = {}
# the kernels again at this slice's shapes: the kNN pair at seqrec's
# serve_p99 (B = 512 over the 1,048,576-item table, k = SERVE_K; launches
# of serve_p99 and serve_bulk) and at retrieval_cand (B = 1, k = CAND_K;
# launches of all four archs), the embedding bag at the DLRM user tower's
# retrieval_cand request (launches of both towers)
SLICE_ROWS = {"knn_score_seqrec": "knn_score",
              "knn_select_seqrec": "knn_select",
              "knn_score_cand": "knn_score", "knn_select_cand": "knn_select",
              "embedding_bag_cand": "embedding_bag"}
# the kernels again at the tiered path's shapes; their launches are those
# of [tiered] (the assignment's and tables' those of the cluster build)
TIER_ROWS = {"knn_score_assign": "knn_score", "knn_select_assign":
             "knn_select", "knn_score_tables": "knn_score",
             "knn_select_tables": "knn_select",
             "cache_probe_l2": "cache_probe",
             "wave_query_topk_l2": "wave_query_topk",
             "wave_insert_scatter_l2": "wave_insert_scatter",
             "wave_insert_query_wide": "wave_insert_query"}


# [dist]: a world of one rank.  The sharded index at DIST_B queries (k =
# KC); STAR under the activation rules at DIST_ENC_B rows of ENC_SEQ
# tokens, within DIST_FWD_TOL of the plain forward; SASRec's
# retrieval_cand table (CAND_ROWS x CAND_WIDTH, CAND_VALID valid)
DIST_B, DIST_ENC_B, DIST_FWD_TOL = (64, 1), (1, 64), 1e-6
CAND_ROWS, CAND_WIDTH, CAND_VALID = 1 << 20, 64, 1_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls (after a warm-up),
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def timed_device(torch, fn, reps: int, strict: bool = True):
    """Mean device ms of ``fn`` over ``reps`` calls enqueued while the
    stream sleeps, so the host's enqueue time between calls is not in the
    interval (a short kernel otherwise waits on its wrapper).  The sleep
    outlasts the enqueue (sized from a host-timed trial).  An ``fn`` that
    waits for the device (a copy from pageable memory) outruns any sleep:
    then the reading is refused, or None when not ``strict``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    host_s = (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    s.record()
    # cycles of a clock at up to 2 GHz: at least twice the enqueue + 5 ms
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 0.005)))
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    if enqueue_ms >= s.elapsed_time(a):
        if not strict:
            return None
        raise AssertionError(f"timed_device: the enqueue ({enqueue_ms:.2f} "
                             f"ms) outran the sleep "
                             f"({s.elapsed_time(a):.2f} ms)")
    return a.elapsed_time(b) / reps


class Report:
    def __init__(self):
        self.rows = {}

    def add(self, name, *, err, ms, plain_ms, nbytes, ops, rate,
            library_ms=None):
        bms, by = bound(nbytes, ops, rate)
        self.rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bms, "bound_by": by,
                           "library_ms": library_ms}
        log(f"[kernels] {name}: max_abs_err={err:.3g} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
            f"library_ms={library_ms}")

    def line(self, launches):
        out = []
        again = {**B1_ROWS, **S1_ROWS, **TIER_ROWS, **SLICE_ROWS}
        for name in (*KERNELS, *again):
            src, tpu = KERNELS[again.get(name, name)]
            out.append({"name": name, "route": "cuda", "source": SRC + src,
                        "replaces": TPU + tpu, "launches": launches[name],
                        **self.rows[name]})
        return json.dumps({"kernels": out})


def counted(torch, fn):
    """Run one path with every kernel counter zeroed just before it; return
    (its result, {kernel: launches} read just after)."""
    from repro_torch.kernels import dispatch
    dispatch.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    # a CPU rehearsal launches nothing: it counts wrapper calls instead
    field = "launches" if DEV == "cuda" else "calls"
    return out, {n: getattr(c, field)
                 for n, c in dispatch.counters().items()}


def pad_to(torch, q, width: int):
    """Queries (..., 769) zero-padded to the corpus width, on the card."""
    q = torch.as_tensor(q, dtype=torch.float32, device=DEV)
    return torch.nn.functional.pad(q, (0, width - q.shape[-1]))


# ------------------------------------------------------------------ probe
def probe_records(torch, gen, s, n_queries):
    """``s`` sessions' fp32 record rings (Qmax = 64, Dp = 800) scattered
    around each session's psi at growing distances, radii in [0.3, 1.1)
    and the record counts ``n_queries`` (an (s,) int32 tensor): (q_emb,
    q_scale, psi (s, 769), radius, n_queries)."""
    from repro_torch.core import cache_ops as tc

    cfg = tc.CacheConfig(capacity=CAPACITY, dim=DIM_RAW + 1,
                         max_queries=QMAX)
    dp, qp = cfg.phys_dim, cfg.phys_max_queries
    psi = torch.nn.functional.normalize(
        torch.randn(s, cfg.dim, generator=gen, device=DEV), dim=1)
    noise = torch.randn(s, qp, cfg.dim, generator=gen, device=DEV)
    spread = torch.linspace(0.3, 1.5, qp, device=DEV)[None, :, None]
    recs = torch.nn.functional.normalize(
        psi[:, None, :] + spread * noise / cfg.dim ** 0.5, dim=2)
    radius = 0.3 + 0.8 * torch.rand(s, qp, generator=gen, device=DEV)
    q_emb, q_scale = tc.store_rows(tc.pad_features(recs, dp), "fp32")
    return q_emb, q_scale, psi, radius, n_queries


def probe_timing(torch, seed):
    """The probe at S = 64 (record counts drawn in [0, 128), the edges 0, 1,
    64 and 73 first) and at S = 1 (Qmax = 64, every record live), through
    the public entries that both this package and its parent have: the
    device time (the stream's queue filled ahead) and the back-to-back time
    of ``cache_probe_batched`` / ``cache_probe`` as whole ops, and the
    device time of the r_hat entry.  Returns {S: (inputs, times)}."""
    from repro_torch.kernels.cache_probe import ops as probe_ops

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 3)
    n_q = torch.randint(0, 2 * QMAX, (S,), generator=gen, device=DEV,
                        dtype=torch.int32)
    n_q[:4] = torch.tensor([0, 1, QMAX, QMAX + 9], dtype=torch.int32)
    wave = probe_records(torch, gen, S, n_q)
    one = probe_records(torch, gen, 1, torch.full((1,), QMAX,
                                                  dtype=torch.int32,
                                                  device=DEV))
    out = {}
    for s, (q_emb, q_scale, psi, radius, n_queries) in ((S, wave), (1, one)):
        psi_p = pad_to(torch, psi, q_emb.shape[-1])
        if s == 1:
            args = (q_emb[0], psi[0], radius[0], n_queries[0], EPS)
            kw = dict(q_scale=q_scale[0], max_queries=QMAX)
            op = lambda: probe_ops.cache_probe(*args, **kw)  # noqa: E731
            rhat = lambda: probe_ops.probe_rhat(  # noqa: E731
                q_emb[0], psi_p[0], radius[0], q_scale[0])
        else:
            args = (q_emb, psi, radius, n_queries, EPS)
            kw = dict(q_scale=q_scale, max_queries=QMAX)
            op = lambda: probe_ops.cache_probe_batched(*args,  # noqa: E731
                                                       **kw)
            rhat = lambda: probe_ops.probe_rhat_batched(  # noqa: E731
                q_emb, psi_p, radius, q_scale)
        t = {"op_device": timed_device(torch, op, 200, strict=False),
             "op_b2b": timed(torch, op, 200),
             "rhat_device": timed_device(torch, rhat, 200)}
        dev = "not measurable (the op waits on the host)" \
            if t["op_device"] is None else f"{t['op_device']:.4f} ms"
        log(f"[kernels] probe S={s} Qmax={QMAX} Dp={q_emb.shape[-1]} "
            f"(records live: {int(torch.clamp(n_queries, max=QMAX).sum())}"
            f"): {'cache_probe' if s == 1 else 'cache_probe_batched'} "
            f"device {dev}, back to back {t['op_b2b']:.4f} ms; r_hat entry "
            f"device {t['rhat_device']:.4f} ms")
        out[s] = ((q_emb, q_scale, psi, radius, n_queries), t)
    return out


def probe_checks(torch, gen):
    """The fused decision against the plain path at S = 64, for every store
    dtype: hit and nearest equal, best_r within RHAT_TOL, on the card
    (``ref.lowquality`` over the plain r_hat) and on the CPU; the r_hat
    entry against ``ref.probe_rhat_batched``."""
    from repro_torch.core import cache_ops as tc
    from repro_torch.kernels.cache_probe import ops as probe_ops
    from repro_torch.kernels.cache_probe import ref as probe_ref
    from repro_torch.kernels.parity import assert_close

    n_q = torch.randint(0, 2 * QMAX, (S,), generator=gen, device=DEV,
                        dtype=torch.int32)
    n_q[:4] = torch.tensor([0, 1, QMAX, QMAX + 9], dtype=torch.int32)
    recs, _, psi, radius, _ = probe_records(torch, gen, S, n_q)
    dp = recs.shape[-1]
    errs = {}
    for dtype in ("fp32", "bf16", "int8"):
        q_emb, q_scale = tc.store_rows(recs, dtype)
        got = probe_ops.cache_probe_batched(q_emb, psi, radius, n_q, 0.25,
                                            q_scale=q_scale, max_queries=QMAX)
        plain = probe_ref.lowquality(q_emb, psi, radius, n_q, 0.25, q_scale,
                                     QMAX)
        cpu = probe_ops.cache_probe_batched(
            *(t.cpu() for t in (q_emb, psi, radius, n_q)), 0.25,
            q_scale=q_scale.cpu(), max_queries=QMAX)
        for want, where in ((plain, "card"), (cpu, "CPU")):
            if not (torch.equal(got[0].cpu(), want[0].cpu())
                    and torch.equal(got[2].cpu(), want[2].cpu())):
                raise AssertionError(f"probe {dtype}: hit / nearest_q differ "
                                     f"from the plain path on the {where}")
        if not (cpu[0].any() and not cpu[0].all()):
            raise AssertionError("probe inputs must mix hits and misses")
        live = torch.isfinite(plain[1])
        errs[dtype] = assert_close(
            torch.where(live, got[1], 0.0), torch.where(live, plain[1], 0.0),
            RHAT_TOL, f"probe {dtype} best_r")
        psi_p = pad_to(torch, psi, dp)
        assert_close(probe_ops.probe_rhat_batched(q_emb, psi_p, radius,
                                                  q_scale),
                     probe_ref.probe_rhat_batched(q_emb, psi_p, radius,
                                                  q_scale),
                     RHAT_TOL, f"probe {dtype} r_hat")
        log(f"[kernels] cache_probe {dtype}: the fused decision equals the "
            f"plain path (best_r max_abs_err {errs[dtype]:.3g})")
    return errs["fp32"]


def probe_bytes(q_emb, n_queries, s):
    """Bytes the decision must move: the live records with their radius
    and scale, psi at 769, the counts and the three outputs."""
    live = int(n_queries.clamp(min=0, max=QMAX).sum())
    return (live * (q_emb.shape[-1] * q_emb.element_size() + 8)
            + s * ((DIM_RAW + 1) * 4 + 4 + 9)), live


def probe_phase(torch, rep: Report, gen, timing):
    """The wave's probe (``cache_probe`` row): checks, then its times."""
    from repro_torch.kernels.cache_probe import ref as probe_ref

    err = probe_checks(torch, gen)
    (q_emb, q_scale, psi, radius, n_q), t = timing[S]
    if t["op_device"] is None:
        raise AssertionError("cache_probe_batched waits on the host")
    nbytes, live = probe_bytes(q_emb, n_q, S)
    rep.add("cache_probe", err=err, ms=t["op_device"],
            plain_ms=timed(torch, lambda: probe_ref.lowquality(
                q_emb, psi, radius, n_q, EPS, q_scale, QMAX), 50),
            nbytes=nbytes, ops=2 * live * q_emb.shape[-1], rate=F32_OPS)


def probe_single_phase(torch, rep: Report, gen, timing):
    """The single-session probe of Algorithm 1 at the searcher's ring: the
    r_hat entry against its plain version, the decision against the CPU
    path (rings of 0, 1, 64 and 73 records, an int and a device count),
    then the ``probe_rhat`` row's times at a full ring."""
    from repro_torch.core import cache_ops as tc
    from repro_torch.kernels.cache_probe import ops as probe_ops
    from repro_torch.kernels.cache_probe import ref as probe_ref
    from repro_torch.kernels.parity import assert_close

    recs, _, psi, radius, _ = probe_records(
        torch, gen, 1, torch.zeros(1, dtype=torch.int32, device=DEV))
    recs, psi, radius = recs[0], psi[0], radius[0]
    dp = recs.shape[-1]
    hits, err = set(), 0.0
    for dtype in ("fp32", "bf16", "int8"):
        q_emb, q_scale = tc.store_rows(recs, dtype)
        psi_p = pad_to(torch, psi, dp)
        e = assert_close(probe_ops.probe_rhat(q_emb, psi_p, radius, q_scale),
                         probe_ref.probe_rhat(q_emb, psi_p, radius, q_scale),
                         RHAT_TOL, f"probe_rhat {dtype}")
        for n_q in (0, 1, QMAX, QMAX + 9):
            for count in (n_q, torch.tensor(n_q, dtype=torch.int32,
                                            device=DEV)):
                got = probe_ops.cache_probe(q_emb, psi, radius, count, 0.25,
                                            q_scale=q_scale, max_queries=QMAX)
                want = probe_ops.cache_probe(
                    q_emb.cpu(), psi.cpu(), radius.cpu(), n_q, 0.25,
                    q_scale=q_scale.cpu(), max_queries=QMAX)
                if bool(got[0]) != bool(want[0]) \
                        or int(got[2]) != int(want[2]):
                    raise AssertionError(f"cache_probe {dtype} n_queries="
                                         f"{n_q}: hit / nearest differ from "
                                         f"the CPU")
                if n_q:
                    e = max(e, assert_close(got[1].cpu(), want[1], RHAT_TOL,
                                            f"cache_probe {dtype} best"))
                hits.add(bool(got[0]))
        log(f"[kernels] probe_rhat / cache_probe {dtype}: ok (max_abs_err "
            f"{e:.3g})")
        if dtype == "fp32":
            err = e
    if hits != {True, False}:
        raise AssertionError("single-probe inputs must mix hits and misses")
    (q_emb, q_scale, psi, radius, n_q), t = timing[1]
    if t["op_device"] is None:
        raise AssertionError("cache_probe waits on the host")
    nbytes, live = probe_bytes(q_emb, n_q, 1)
    rep.add("probe_rhat", err=err, ms=t["op_device"],
            plain_ms=timed(torch, lambda: probe_ref.lowquality(
                q_emb, psi, radius, n_q, EPS, q_scale, QMAX), 50),
            nbytes=nbytes, ops=2 * live * q_emb.shape[-1], rate=F32_OPS)


# ------------------------------------------------------------------- wave
def wave_inputs(torch, tc, cfg, gen, kc=KC):
    """A half-full stacked cache and one insert wave of ``kc`` rows a
    session at serving shapes."""
    cp, dp = cfg.phys_capacity, cfg.phys_dim
    st = tc.init_batched_cache(cfg, S, DEV)
    n_docs = torch.randint(CAPACITY // 8, CAPACITY * 3 // 4, (S,),
                           generator=gen, device=DEV)
    rows = torch.nn.functional.normalize(torch.randn(
        S, cp, cfg.dim, generator=gen, device=DEV), dim=2)
    data, scale = tc.store_rows(rows, cfg.store_dtype)
    del rows
    live = torch.arange(cp, device=DEV)[None, :] < n_docs[:, None]
    st.doc_emb[..., :cfg.dim] = data * live[..., None].to(data.dtype)
    del data
    st.doc_scale.copy_(torch.where(live, scale, torch.ones_like(scale)))
    ids = torch.arange(S * cp, device=DEV, dtype=torch.int32).view(S, cp)
    st.doc_ids.copy_(torch.where(live, ids, torch.full_like(ids, -1)))
    st.doc_stamp.copy_(live.to(torch.int32))
    st.n_docs.copy_(n_docs.to(torch.int32))
    st.n_queries.copy_(torch.randint(0, 100, (S,), generator=gen,
                                     device=DEV, dtype=torch.int32))
    st.step.fill_(5)
    new = torch.nn.functional.normalize(torch.randn(
        S, kc, cfg.dim, generator=gen, device=DEV), dim=2)
    emb_q, emb_scale = tc.store_rows(new, cfg.store_dtype)
    keep = torch.rand(S, kc, generator=gen, device=DEV) < 0.7
    pos = n_docs[:, None] + torch.cumsum(keep.long(), 1) - 1
    pos = torch.where(keep & (pos < CAPACITY), pos,
                      torch.full_like(pos, cp)).to(torch.int32)
    new_ids = (10 ** 7 + torch.arange(S * kc, device=DEV)).view(S, kc) \
        .to(torch.int32)
    psi = torch.nn.functional.normalize(torch.randn(
        S, cfg.dim, generator=gen, device=DEV), dim=1)
    psi_q, psi_scale = tc.store_rows(psi, cfg.store_dtype)
    ins = (tc.pad_features(emb_q, dp), emb_scale, new_ids, pos,
           tc.pad_features(psi_q, dp), psi_scale,
           torch.rand(S, generator=gen, device=DEV),
           torch.rand(S, generator=gen, device=DEV) < 0.8,
           torch.remainder(st.n_queries, QMAX), st.step.clone())
    return st, ins, tc.pad_features(psi, dp), int((pos < cp).sum())


def wave_phase(torch, rep: Report, gen):
    from repro_torch.core import cache_ops as tc
    from repro_torch.kernels.cache_wave import ops as wave_ops
    from repro_torch.kernels.cache_wave import ref as wave_ref
    from repro_torch.kernels.parity import assert_topk_agree

    def clone(st):
        return tc.CacheState(*(x.clone() for x in st))

    def leaves(st):
        return (st.doc_emb, st.doc_ids, st.doc_stamp, st.doc_scale,
                st.q_emb, st.q_radius, st.q_scale)

    def same(a, b, what):
        for f, x, y in zip(tc.CacheState._fields, a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: state leaf {f} differs")

    for dtype in ("fp32", "bf16", "int8"):
        cfg = tc.CacheConfig(capacity=CAPACITY, dim=DIM_RAW + 1,
                             max_queries=QMAX, store_dtype=dtype)
        st, ins, psi, n_kept = wave_inputs(torch, tc, cfg, gen)
        errs = {}
        # insert + query
        sk, sp = clone(st), clone(st)
        vk, ik, slk = wave_ops.wave_insert_query(*leaves(sk), *ins, psi, K)
        wave_ref.insert_scatter(*leaves(sp), *ins)
        vp, ip, _ = wave_ref.query_topk(sp.doc_emb, sp.doc_ids, sp.doc_scale,
                                        psi, K)
        same(sk, sp, f"wave_insert_query {dtype}")
        errs["wave_insert_query"] = assert_topk_agree(
            vk, ik, vp, ip, SCORE_TOL, f"wave_insert_query {dtype}")
        if not torch.equal(torch.gather(sk.doc_ids, 1, slk.long()), ik):
            raise AssertionError("wave slots do not point at the ids")
        # query only, on the post-insert state
        vk, ik, _ = wave_ops.wave_query_topk(sk.doc_emb, sk.doc_ids,
                                             sk.doc_scale, psi, K)
        errs["wave_query_topk"] = assert_topk_agree(
            vk, ik, vp, ip, SCORE_TOL, f"wave_query_topk {dtype}")
        del sk, sp
        # insert only
        sk, sp = clone(st), clone(st)
        wave_ops.wave_insert_scatter(*leaves(sk), *ins)
        wave_ref.insert_scatter(*leaves(sp), *ins)
        same(sk, sp, f"wave_insert_scatter {dtype}")
        errs["wave_insert_scatter"] = 0.0
        del sp
        # the repaired limit: the query at k = 200 (Table 1's depth)
        vk, ik, _ = wave_ops.wave_query_topk(sk.doc_emb, sk.doc_ids,
                                             sk.doc_scale, psi, PAPER_K)
        vr, ir, _ = wave_ref.query_topk(sk.doc_emb, sk.doc_ids, sk.doc_scale,
                                        psi, PAPER_K)
        e200 = assert_topk_agree(vk, ik, vr, ir, SCORE_TOL,
                                 f"wave_query_topk {dtype} k={PAPER_K}")
        del vk, ik, vr, ir
        log(f"[kernels] cache_wave {dtype}: ok "
            f"({n_kept} rows written, max_abs_err {errs}; query at "
            f"k={PAPER_K}: {e200:.3g})")
        if dtype == "fp32":
            isz, dp, cp = 4, cfg.phys_dim, cfg.phys_capacity
            scan = S * cp * (dp * isz + 8)
            write = n_kept * (2 * dp * isz + 12) + S * KC * 4 + S * 24
            out = S * K * 12 + S * dp * 4
            ops = 2 * S * cp * dp
            lv = leaves(sk)
            rep.add("wave_insert_query", err=errs["wave_insert_query"],
                    ms=timed(torch, lambda: wave_ops.wave_insert_query(
                        *lv, *ins, psi, K), 10),
                    plain_ms=timed(torch, lambda: (
                        wave_ref.insert_scatter(*lv, *ins),
                        wave_ref.query_topk(lv[0], lv[1], lv[3], psi, K)), 3),
                    nbytes=scan + write + out, ops=ops, rate=F32_OPS)
            rep.add("wave_query_topk", err=errs["wave_query_topk"],
                    ms=timed(torch, lambda: wave_ops.wave_query_topk(
                        lv[0], lv[1], lv[3], psi, K), 10),
                    plain_ms=timed(torch, lambda: wave_ref.query_topk(
                        lv[0], lv[1], lv[3], psi, K), 3),
                    nbytes=scan + out, ops=ops, rate=F32_OPS)
            rep.add("wave_insert_scatter", err=0.0,
                    ms=timed(torch, lambda: wave_ops.wave_insert_scatter(
                        *lv, *ins), 10),
                    plain_ms=timed(torch, lambda: wave_ref.insert_scatter(
                        *lv, *ins), 3),
                    nbytes=write, ops=0, rate=F32_OPS)
        del st, sk, ins
        torch.cuda.empty_cache()


def wave_single_phase(torch, rep: Report, gen):
    """The wave kernel at one session on Table 1's cache (capacity 12000,
    12288 physical slots) with every slot live: the query at k = 200, and a
    k_c = 1000 insert over live slots with its record, each against its
    plain version (states bit for bit).  Timed on the device alone (the
    queue filled ahead) and back to back (what a caller's loop sees)."""
    from repro_torch.core import cache_ops as tc
    from repro_torch.kernels.cache_wave import ops as wave_ops
    from repro_torch.kernels.cache_wave import ref as wave_ref
    from repro_torch.kernels.parity import assert_topk_agree

    cfg = tc.CacheConfig(capacity=PAPER_CAP, dim=DIM_RAW + 1,
                         max_queries=QMAX)
    cp, dp, dim = cfg.phys_capacity, cfg.phys_dim, cfg.dim
    st = tc.init_batched_cache(cfg, 1, DEV)
    st.doc_emb[0, :PAPER_CAP, :dim] = torch.nn.functional.normalize(
        torch.randn(PAPER_CAP, dim, generator=gen, device=DEV), dim=1)
    st.doc_ids[0, :PAPER_CAP] = torch.arange(PAPER_CAP, dtype=torch.int32,
                                             device=DEV)
    st.doc_stamp[0, :PAPER_CAP] = 1
    st.n_docs.fill_(PAPER_CAP)
    st.n_queries.fill_(7)
    st.step.fill_(2)
    psi = tc.pad_features(torch.nn.functional.normalize(torch.randn(
        1, dim, generator=gen, device=DEV), dim=1), dp)
    lv = (st.doc_emb, st.doc_ids, st.doc_stamp, st.doc_scale, st.q_emb,
          st.q_radius, st.q_scale)
    vk, ik, _ = wave_ops.wave_query_topk(lv[0], lv[1], lv[3], psi, PAPER_K)
    vr, ir, _ = wave_ref.query_topk(lv[0], lv[1], lv[3], psi, PAPER_K)
    err_q = assert_topk_agree(vk, ik, vr, ir, SCORE_TOL,
                              "wave_query_topk S=1")
    new = tc.pad_features(torch.nn.functional.normalize(torch.randn(
        1, KC, dim, generator=gen, device=DEV), dim=2), dp)
    pos = torch.randperm(PAPER_CAP, generator=gen, device=DEV)[:KC] \
        .to(torch.int32)[None]
    ins = (new, torch.ones(1, KC, device=DEV),
           (10 ** 7 + torch.arange(KC, device=DEV, dtype=torch.int32))[None],
           pos, psi, torch.ones(1, device=DEV), torch.full((1,), 0.3,
                                                           device=DEV),
           torch.ones(1, dtype=torch.bool, device=DEV),
           torch.remainder(st.n_queries, QMAX), st.step.clone())
    sk = tc.CacheState(*(x.clone() for x in st))
    sp = tc.CacheState(*(x.clone() for x in st))

    def leaves(x):
        return (x.doc_emb, x.doc_ids, x.doc_stamp, x.doc_scale, x.q_emb,
                x.q_radius, x.q_scale)
    wave_ops.wave_insert_scatter(*leaves(sk), *ins)
    wave_ref.insert_scatter(*leaves(sp), *ins)
    for f, x, y in zip(tc.CacheState._fields, sk, sp):
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            raise AssertionError(f"wave_insert_scatter S=1: leaf {f} differs")
    del sk, sp

    q_dev = timed_device(torch, lambda: wave_ops.wave_query_topk(
        lv[0], lv[1], lv[3], psi, PAPER_K), 50)
    q_b2b = timed(torch, lambda: wave_ops.wave_query_topk(
        lv[0], lv[1], lv[3], psi, PAPER_K), 50)
    q_plain = timed(torch, lambda: wave_ref.query_topk(
        lv[0], lv[1], lv[3], psi, PAPER_K), 10)
    i_dev = timed_device(torch, lambda: wave_ops.wave_insert_scatter(
        *lv, *ins), 50)
    i_b2b = timed(torch, lambda: wave_ops.wave_insert_scatter(*lv, *ins), 50)
    i_plain = timed(torch, lambda: wave_ref.insert_scatter(*lv, *ins), 10)
    rep.add("wave_query_topk_s1", err=err_q, ms=q_dev, plain_ms=q_plain,
            nbytes=cp * (dp * 4 + 8) + dp * 4 + PAPER_K * 12,
            ops=2 * cp * dp, rate=F32_OPS)
    rep.add("wave_insert_scatter_s1", err=0.0, ms=i_dev, plain_ms=i_plain,
            nbytes=KC * (2 * dp * 4 + 12) + KC * 4 + 2 * dp * 4 + 8,
            ops=0, rate=F32_OPS)
    chunk, chunks = wave_ops.wave_grid(
        1, cp, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"[kernels] cache_wave S=1 Cp={cp} (every slot live, grid of "
        f"{chunks} blocks of {chunk} slots): query k={PAPER_K} device "
        f"{q_dev:.4f} ms, back to back {q_b2b:.4f} ms; insert of {KC} rows "
        f"device {i_dev:.4f} ms, back to back {i_b2b:.4f} ms")
    del st, lv, ins
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- recsys
def close_logits(torch, got, want, what) -> float:
    """Finite logits of the same shape within LOGIT_RTOL / LOGIT_ATOL;
    returns the largest |diff| / max(|want|, LOGIT_ATOL / LOGIT_RTOL)."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: logits {tuple(got.shape)} not finite "
                             f"or not {tuple(want.shape)}")
    diff = (got - want).abs()
    if not bool((diff <= LOGIT_ATOL + LOGIT_RTOL * want.abs()).all()):
        raise AssertionError(f"{what}: max |diff| {float(diff.max()):.3g}")
    return float((diff / want.abs().clamp(min=LOGIT_ATOL / LOGIT_RTOL))
                 .max())


def plain_pool(torch, tables, idx):
    """``field_pool`` through the plain version, on the same device."""
    from repro_torch.kernels.embedding_bag import ref as bag_ref
    from repro_torch.models import recsys as rs
    return bag_ref.embedding_bag(*rs.flatten_fields(tables, idx)).view(
        idx.shape[0], tables.shape[0], tables.shape[2])


def serve_calls(torch, model, batches, per_call, what):
    """Serve ``batches`` one call each, counted; returns (the last logits,
    per-call seconds from the host clock around call + synchronize,
    launches).  Every call must launch ``per_call`` embedding bags."""
    def run():
        lat, outs = [], []
        for args in batches:
            t0 = time.perf_counter()
            outs.append(model(*args))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        return outs, lat

    (outs, lat), launches = counted(torch, run)
    want = {name: 0 for name in launches}
    want["embedding_bag"] = per_call * len(batches)
    if launches != want:
        raise AssertionError(f"[recsys] {what}: launches {launches} != "
                             f"{want}")
    for out, args in zip(outs, batches):
        if out.shape != (args[-1].shape[0],) or not torch.isfinite(out).all():
            raise AssertionError(f"[recsys] {what}: logits of shape "
                                 f"{tuple(out.shape)} or not finite")
    return outs[-1], lat, launches["embedding_bag"]


def bag_row(torch, what, table, idx, w=None, mode="sum", reps=20):
    """``embedding_bag`` at one shape: held against its plain version (bit
    for bit for bags of one item, else within BAG_TOL / HALF_TOL), then
    timed beside the plain version and ``F.embedding_bag`` over the same
    items (the valid ids in a flat list with per-bag offsets; items of
    weight <= 0 left out in max mode, as the kernel does; none for a
    weighted mean, which no one call computes), with its bound: the output,
    the ids, the weights and every distinct row once.  Logs one line and
    returns the row's numbers."""
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag import ref as bag_ref
    from repro_torch.kernels.parity import assert_close

    kernel = lambda: bag_ops.embedding_bag(table, idx, w, mode)  # noqa: E731
    plain = lambda: bag_ref.embedding_bag(table, idx, w, mode)  # noqa: E731
    got, want = kernel(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite pooled rows")
    if idx.shape[1] == 1:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: bags of one item differ from the "
                                 f"plain version")
        err = 0.0
    else:
        err = assert_close(got, want, BAG_TOL if table.dtype == torch.float32
                           else HALF_TOL, what)
    del got, want
    keep = idx >= 0
    if mode == "max" and w is not None:
        keep &= w > 0
    counts = keep.sum(dim=1)
    offsets = torch.cumsum(counts, 0) - counts
    flat = idx[keep].long()
    psw = w[keep] if (w is not None and mode == "sum") else None
    b, d = idx.shape[0], table.shape[1]
    items = int(counts.sum())
    uq = int(torch.unique(flat).numel())
    row = {"bags": b, "items": items, "D": d, "dtype": str(table.dtype),
           "mode": mode, "weighted": w is not None,
           "ms": timed(torch, kernel, reps),
           "device_ms": timed_device(torch, kernel, reps),
           "plain_ms": timed(torch, plain, max(2, reps // 4)),
           "library_ms": None if (mode == "mean" and w is not None)
           else timed(torch, lambda: torch.nn.functional.embedding_bag(
               flat, table, offsets, mode=mode, per_sample_weights=psw),
               reps),
           "unique_rows": uq, "err": err,
           "nbytes": b * d * 4 + idx.numel() * 4 * (1 if w is None else 2)
           + uq * d * table.element_size(), "ops": 2 * items * d}
    del keep, counts, offsets, flat, psw
    row["bound_ms"], row["bound_by"] = bound(row["nbytes"], row["ops"],
                                             F32_OPS)
    lib = row["library_ms"]
    log(f"[kernels] embedding_bag {what}: {b} bags, D={d} {table.dtype}, "
        f"{mode}{' weighted' if w is not None else ''}: ok (max_abs_err "
        f"{err:.3g}) ms={row['ms']:.4f} (device {row['device_ms']:.4f}) "
        f"plain_ms={row['plain_ms']:.4f} "
        f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; {uq} unique "
        f"rows)")
    return row


def plain_search(torch, index, q, k):
    """The plain search (``knn/ref.search``) over an index's payload, on
    the card."""
    from repro_torch.kernels.knn import ref as knn_ref
    dp = index.doc_emb.shape[1]
    return knn_ref.search(index.doc_emb, index.doc_ids,
                          torch.nn.functional.pad(q, (0, dp - q.shape[1])), k)


def check_answers(torch, what, index, q, scores, ids, k, n_valid) -> float:
    """Served (scores, ids) of queries ``q`` against the plain search on the
    card (``assert_topk_agree``, scores within SCORE_TOL of the largest
    score's magnitude, at least 1), every id a row in [0, n_valid)."""
    from repro_torch.kernels.parity import assert_topk_agree
    rv, ri = plain_search(torch, index, q, k)
    tol = SCORE_TOL * max(1.0, float(rv[:, 0].abs().max()))
    err = assert_topk_agree(scores, ids, rv, ri, tol, what)
    if int(ids.min()) < 0 or int(ids.max()) >= n_valid:
        raise AssertionError(f"{what}: ids outside [0, {n_valid}): "
                             f"{int(ids.min())}..{int(ids.max())}")
    return err


def p50_p99(lat):
    """(p50, p99) in ms of per-call seconds, the first call a warm-up."""
    import numpy as np
    lat = np.array(lat[1:]) * 1e3
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def serve_retrieval(torch, what, call, requests, per_call):
    """Serve ``requests`` one ``call(*args) -> (scores, ids)`` each, counted,
    the host clock around call + synchronize.  Every call must launch
    ``per_call`` (kernel: launches).  Returns (launches, per-call seconds,
    the last answer)."""
    def run():
        lat, out = [], None
        for args in requests:
            t0 = time.perf_counter()
            out = call(*args)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        return lat, out

    (lat, out), launches = counted(torch, run)
    want = {name: 0 for name in launches}
    want.update({n: c * len(requests) for n, c in per_call.items()})
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} != {want}")
    return {n: c for n, c in launches.items() if c}, lat, out


def knn_rows(torch, what, index, q, k):
    """``knn_score`` and ``knn_select`` on an index's payload at one shape,
    each held against its plain version on the card and timed beside it
    and its library call (``torch.mm``, ``torch.topk``), on the device
    (the queue filled ahead) and back to back; and the whole op
    (``MetricIndex.search``) beside ``topk(q @ T.T)``, back to back.  Logs
    the lines and returns the two rows' numbers."""
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_close, assert_topk_agree

    docs, ids = index.doc_emb, index.doc_ids
    n, dp = docs.shape
    b = q.shape[0]
    qp = torch.nn.functional.pad(q, (0, dp - q.shape[1])).contiguous()
    def both(fn, reps):
        """(device ms, back-to-back ms): the device reading where the
        stream's sleep outlasts the enqueue, else the back-to-back one."""
        b2b = timed(torch, fn, reps)
        dev = timed_device(torch, fn, reps, strict=False)
        return (b2b if dev is None else dev), b2b

    sk = knn_ops.knn_score(docs, ids, qp)
    tol = SCORE_TOL * max(1.0, float(sk.abs().max()))
    score = {"err": assert_close(sk, knn_ref.score(docs, ids, qp), tol,
                                 f"{what} knn_score"),
             "nbytes": n * (dp * 4 + 4) + b * dp * 4 + b * n * 4,
             "ops": 2 * b * n * dp}
    score["ms"], score["b2b_ms"] = both(
        lambda: knn_ops.knn_score(docs, ids, qp), 10)
    score["plain_ms"] = both(lambda: knn_ref.score(docs, ids, qp), 5)[0]
    score["library_ms"] = both(lambda: torch.mm(qp, docs.T), 10)[0]
    vk, ik = knn_ops.knn_select(sk, ids, k)
    vr, ir = knn_ref.select(sk, ids, k)
    select = {"err": assert_topk_agree(vk, ik, vr, ir, 0.0,
                                       f"{what} knn_select"),
              "nbytes": b * n * 4 + b * k * 8, "ops": 0}
    select["ms"], select["b2b_ms"] = both(
        lambda: knn_ops.knn_select(sk, ids, k), 10)
    select["plain_ms"] = both(lambda: knn_ref.select(sk, ids, k), 3)[0]
    select["library_ms"] = both(lambda: torch.topk(sk, k, dim=1), 10)[0]
    del sk, vk, ik, vr, ir
    op_ms = timed(torch, lambda: index.search(q, k), 10)
    op_lib = timed(torch, lambda: torch.topk(qp @ docs.T, k, dim=1), 10)
    op_bound = bound(n * (dp * 4 + 4) + b * dp * 4 + b * k * 8,
                     2 * b * n * dp, F32_OPS)
    for name, row in (("knn_score", score), ("knn_select", select)):
        row["bound_ms"], row["bound_by"] = bound(row["nbytes"], row["ops"],
                                                 F32_OPS)
        log(f"[kernels] {name} {what} (B={b}, N={n}, Dp={dp}, k={k}): "
            f"max_abs_err={row['err']:.3g} ms={row['ms']:.4f} (back to back "
            f"{row['b2b_ms']:.4f}) plain_ms={row['plain_ms']:.4f} library_ms="
            f"{row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']})")
    log(f"[kernels] MetricIndex.search {what}: op ms={op_ms:.4f} "
        f"(knn_score + knn_select) library_ms={op_lib:.4f} (topk(q @ T.T)) "
        f"bound_ms={op_bound[0]:.4f} ({op_bound[1]})")
    torch.cuda.empty_cache()
    return {"knn_score": score, "knn_select": select}


def add_rows(rep, rows: dict, suffix: str) -> None:
    for name, r in rows.items():
        rep.add(f"{name}_{suffix}", err=r["err"], ms=r["ms"],
                plain_ms=r["plain_ms"], nbytes=r["nbytes"], ops=r["ops"],
                rate=F32_OPS, library_ms=r["library_ms"])


def recsys_cand(torch, rep, model, requests, what):
    """retrieval_cand for a DLRM / xDeepFM model: its user tower, then the
    top CAND_K of the candidate index over ``tables[0]`` (rows past
    n_candidates masked), one request at a time.  Returns the path's
    launches."""
    from repro_torch.configs import registry
    from repro_torch.models import recsys as rs

    n_valid = registry.RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    table = model.tables[0]
    before = torch.cuda.memory_allocated()
    index = rs.candidate_index(table, n_valid, device=DEV)
    copied = torch.cuda.memory_allocated() - before
    aligned = table.shape[1] % 32 == 0
    if aligned != (index.doc_emb.data_ptr() == table.data_ptr()):
        raise AssertionError(f"[recsys] {what}: the index's payload is "
                             f"not what the table's width asks for")

    def call(*args):
        res = index.search(model.user_tower(*args), CAND_K)
        return res.scores, res.ids

    launches, lat, (scores, ids) = serve_retrieval(
        torch, f"[recsys] {what} retrieval_cand", call, requests,
        {"embedding_bag": 1, "knn_score": 1, "knn_select": 1})
    err = check_answers(torch, f"[recsys] {what} retrieval_cand", index,
                        model.user_tower(*requests[-1]), scores, ids, CAND_K,
                        n_valid)
    p50, p99 = p50_p99(lat)
    payload = ("takes tables[0] as is" if aligned else
               f"pads tables[0] to width {index.doc_emb.shape[1]} "
               f"({copied / 1e6:.1f} MB copied once)")
    log(f"[recsys] {what} retrieval_cand (1 request x {table.shape[0]} "
        f"candidates, {n_valid} valid, top {CAND_K}): {len(lat) - 1} calls "
        f"after a warm-up, latency p50 {p50:.4f} ms, p99 {p99:.4f} ms; ids "
        f"equal the plain search's (max err {err:.3g}), none >= {n_valid}; "
        f"the index {payload}")
    rows = knn_rows(torch, f"{what} retrieval_cand", index,
                    model.user_tower(*requests[-1]), CAND_K)
    if what == "dlrm-rm2":          # the kernels line's rows at this shape
        add_rows(rep, rows, "cand")
        r = bag_row(torch, "dlrm retrieval_cand",
                    *rs.flatten_fields(model.tables, requests[-1][1]),
                    reps=200)
        rep.add("embedding_bag_cand", err=r["err"], ms=r["device_ms"],
                plain_ms=r["plain_ms"], nbytes=r["nbytes"], ops=r["ops"],
                rate=F32_OPS, library_ms=r["library_ms"])
    del index
    torch.cuda.empty_cache()
    return launches


def recsys_cpu_check(torch, seed):
    """The smoke configs on the CPU path, then moved to the card: logits
    within 1e-5, 1 / 2 launches per forward."""
    import numpy as np

    from repro_torch.configs import dlrm_rm2, xdeepfm
    from repro_torch.kernels.parity import assert_close
    from repro_torch.models import recsys as rs

    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    dc, xc = dlrm_rm2.smoke_config(), xdeepfm.smoke_config()
    for model, args, per_call in (
            (rs.DLRM(dc, device="cpu", generator=gen),
             (rng.standard_normal((256, dc.n_dense)).astype(np.float32),
              rng.integers(-1, dc.vocab, (256, dc.n_sparse, dc.multi_hot))
              .astype(np.int32)), 1),
            (rs.XDeepFM(xc, device="cpu", generator=gen),
             (rng.integers(-1, xc.vocab, (256, xc.n_sparse, 1))
              .astype(np.int32),), 2)):
        want = model(*args)
        model.to(DEV)
        got, _, _ = serve_calls(torch, model, [args], per_call,
                                f"{model.cfg.name} card")
        err = assert_close(got, want, 1e-5, f"[recsys] {model.cfg.name}")
        log(f"[recsys] {model.cfg.name}: card == CPU path on the same "
            f"parameters (256 rows, max_abs_err {err:.3g}, {per_call} "
            f"launch{'es' if per_call > 1 else ''} per forward)")


def recsys_phase(torch, rep: Report, gen, seed):
    """DLRM-RM2 and xDeepFM at full width: the embedding-bag kernel against
    its plain version and ``F.embedding_bag``, then the served forwards,
    then retrieval_cand through each user tower.  Returns {path:
    launches} of the served runs."""
    import numpy as np

    from repro_torch.configs import dlrm_rm2, registry, xdeepfm
    from repro_torch.data.recsys import CTRSpec, CTRStream
    from repro_torch.models import recsys as rs

    recsys_cpu_check(torch, seed)
    b_p99 = registry.RECSYS_SHAPES["serve_p99"]["batch"]
    b_bulk = registry.RECSYS_SHAPES["serve_bulk"]["batch"]
    launches = 0

    def batches(cfg, steps, size, dense=True):
        stream = CTRStream(CTRSpec(n_dense=13, n_sparse=cfg.n_sparse,
                                   vocab=cfg.vocab, multi_hot=1, seed=seed))
        out = []
        for step in steps:
            b = stream.batch(step, size)
            sp = torch.as_tensor(b["sparse"], device=DEV)
            out.append((torch.as_tensor(b["dense"], device=DEV), sp)
                       if dense else (sp,))
        return out

    def p99_line(name, lat, err):
        lat = np.array(lat[1:])
        log(f"[recsys] {name} serve_p99 ({b_p99} rows): {len(lat)} calls "
            f"after a warm-up, latency p50 {np.percentile(lat, 50) * 1e3:.4f}"
            f" ms, p99 {np.percentile(lat, 99) * 1e3:.4f} ms; logits finite, "
            f"equal the plain pool's (max rel err {err:.3g}); peak device "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    # ------------------------------------------------------- DLRM-RM2
    t0 = time.perf_counter()
    cfg = dlrm_rm2.full_config()
    model = rs.DLRM(cfg, device=DEV, generator=gen)
    params, tables = model.params, model.tables
    f, v, d = tables.shape
    tab_bytes = tables.numel() * tables.element_size()
    torch.cuda.synchronize()
    log(f"[recsys] {cfg.name}: tables ({f}, {v}, {d}) f32 "
        f"({tab_bytes / 1e9:.3f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    (dense_b, sparse_b), = batches(cfg, [0], b_bulk)
    flat, flat_idx = rs.flatten_fields(tables, sparse_b)
    if flat.data_ptr() != tables.data_ptr():
        raise AssertionError("[recsys] the flat table is not a view")
    # (a) the kernel at every shape of the served path and beside it: the
    # flattened table at serve_bulk (the kernels line's row) and serve_p99,
    # f16 / bf16 copies of it, multi-hot bags in the three modes
    n_bags = flat_idx.shape[0]
    rows = {}
    rows["dlrm serve_bulk"] = r = bag_row(torch, "dlrm serve_bulk", flat,
                                          flat_idx)
    rep.add("embedding_bag", err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], nbytes=r["nbytes"], ops=r["ops"],
            rate=F32_OPS, library_ms=r["library_ms"])
    all_ms = bound(n_bags * d * 8 + n_bags * 4, 2 * n_bags * d, F32_OPS)[0]
    log(f"[kernels] embedding_bag serve_bulk: {r['unique_rows']} unique rows "
        f"({r['unique_rows'] / n_bags:.4f} of the gathered); bound_ms if "
        f"every gathered row came from HBM {all_ms:.4f}")
    rows["dlrm serve_p99"] = bag_row(torch, "dlrm serve_p99", flat,
                                     flat_idx[:b_p99 * f], reps=200)
    for dt in (torch.float16, torch.bfloat16):
        half = flat.to(dt)
        rows[f"dlrm serve_bulk {dt}"] = bag_row(
            torch, f"dlrm serve_bulk {dt}", half, flat_idx)
        del half
        torch.cuda.empty_cache()
    # multi-hot bags: weights (some <= 0), 20% pads, an empty bag, a bag of
    # zero weights, in the three modes
    mh = torch.randint(0, f * v, (65_536, 8), generator=gen, device=DEV,
                       dtype=torch.int32)
    mh = torch.where(torch.rand(mh.shape, generator=gen, device=DEV) < 0.2,
                     -1, mh)
    mh[0] = -1
    w = torch.rand(mh.shape, generator=gen, device=DEV) * 2 - 0.5
    w[1] = 0.0
    for mode in ("sum", "mean", "max"):
        rows[f"multi-hot {mode}"] = bag_row(torch, f"multi-hot {mode}", flat,
                                            mh, w, mode, reps=50)
    del mh, w, flat, flat_idx
    torch.cuda.empty_cache()
    # serve_p99: 51 calls, 1 launch each
    torch.cuda.reset_peak_memory_stats()
    p99 = batches(cfg, range(1, P99_CALLS + 1), b_p99)
    out, lat, n = serve_calls(torch, model, p99, 1, "dlrm serve_p99")
    launches += n
    want = rs.dlrm_interact(params, p99[-1][0],
                            plain_pool(torch, tables, p99[-1][1]), cfg)
    err = close_logits(torch, out, want, "dlrm serve_p99")
    peak = torch.cuda.max_memory_allocated()
    if peak > tab_bytes + 3e9:
        raise AssertionError(f"[recsys] dlrm serve_p99 peak {peak} B")
    p99_line(cfg.name, lat, err)
    # serve_bulk: 3 calls of 262,144 rows, 1 launch each
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, lat, n = serve_calls(torch, model, [(dense_b, sparse_b)] * 3, 1,
                              "dlrm serve_bulk")
    launches += n
    peak = torch.cuda.max_memory_allocated()
    emb = plain_pool(torch, tables, sparse_b)
    err = close_logits(torch, out,
                       rs.dlrm_interact(params, dense_b, emb, cfg),
                       "dlrm serve_bulk")
    pool_ms = timed(torch, lambda: rs.field_pool(tables, sparse_b), 10)
    inter_ms = timed(torch, lambda: rs.dlrm_interact(params, dense_b, emb,
                                                     cfg), 5)
    log(f"[recsys] {cfg.name} serve_bulk device time (CUDA events): "
        f"field_pool {pool_ms:.4f} ms (flat ids + 1 launch), dlrm_interact "
        f"{inter_ms:.4f} ms")
    del emb
    # a copy of the tables, padded or not, would add >= tab_bytes
    if peak - before >= tab_bytes:
        raise AssertionError(f"[recsys] dlrm serve_bulk: the forward "
                             f"allocated {peak - before} B")
    log(f"[recsys] {cfg.name} serve_bulk ({b_bulk} rows): "
        f"{b_bulk / np.median(lat):.1f} rows/s (median of {len(lat)} calls, "
        f"{np.median(lat) * 1e3:.3f} ms each); logits finite, equal the "
        f"plain pool's (max rel err {err:.3g}); peak device memory "
        f"{peak / 1e9:.3f} GB = tables {tab_bytes / 1e9:.3f} GB + "
        f"{(peak - tab_bytes) / 1e9:.3f} GB (forward "
        f"{(peak - before) / 1e9:.3f} GB: no copy of the tables)")
    cand = {"dlrm-rm2": recsys_cand(
        torch, rep, model, batches(cfg, range(100, 100 + P99_CALLS), 1),
        cfg.name)}
    del model, params, tables, dense_b, sparse_b, p99, out
    torch.cuda.empty_cache()

    # ------------------------------------------------------- xDeepFM
    t0 = time.perf_counter()
    cfg = xdeepfm.full_config()
    model = rs.XDeepFM(cfg, device=DEV, generator=gen)
    params = model.params
    tab_bytes = sum(t.numel() * 4 for t in (model.tables, model.linear))
    torch.cuda.synchronize()
    log(f"[recsys] {cfg.name}: tables {tuple(model.tables.shape)} + linear "
        f"{tuple(model.linear.shape)} f32 ({tab_bytes / 1e9:.3f} GB) drawn "
        f"in {time.perf_counter() - t0:.2f} s")
    (sparse_b,), = batches(cfg, [0], b_bulk, dense=False)
    # (b) D = 10 and D = 1 at xDeepFM's widths: serve_bulk ids, and the
    # fields of one 16,384-row chunk (what a chunked serve_bulk call pools)
    for name, ids in (("tables", sparse_b), ("linear", sparse_b),
                      ("tables chunk", sparse_b[:XDEEPFM_CHUNK])):
        tab, idx = rs.flatten_fields(params[name.split()[0]], ids)
        rows[f"xdeepfm {name}"] = bag_row(torch, f"xdeepfm {name}", tab, idx)
        del tab, idx
    log("[recsys] embedding_bag rows " + json.dumps(rows))
    # serve_p99: 51 calls, 2 launches each
    torch.cuda.reset_peak_memory_stats()
    p99 = batches(cfg, range(1, P99_CALLS + 1), b_p99, dense=False)
    out, lat, n = serve_calls(torch, model, p99, 2, "xdeepfm serve_p99")
    launches += n
    sp = p99[-1][0]
    want = rs.xdeepfm_interact(params, plain_pool(torch, model.tables, sp),
                               plain_pool(torch, model.linear, sp), cfg)
    err = close_logits(torch, out, want, "xdeepfm serve_p99")
    peak = torch.cuda.max_memory_allocated()
    if peak > tab_bytes + 3e9:
        raise AssertionError(f"[recsys] xdeepfm serve_p99 peak {peak} B")
    p99_line(cfg.name, lat, err)
    # serve_bulk in chunks: CIN's (B, H*m, D) product is 81.8 GB at 262,144
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    chunks = [(sparse_b[lo:lo + XDEEPFM_CHUNK],)
              for lo in range(0, b_bulk, XDEEPFM_CHUNK)]
    out, lat, n = serve_calls(torch, model, chunks, 2, "xdeepfm serve_bulk")
    launches += n
    sp = chunks[-1][0]
    x0, lin = (plain_pool(torch, t, sp) for t in (model.tables, model.linear))
    err = close_logits(torch, out, rs.xdeepfm_interact(params, x0, lin, cfg),
                       "xdeepfm serve_bulk")
    pool_ms = timed(torch, lambda: (rs.field_pool(model.tables, sp),
                                    rs.field_pool(model.linear, sp)), 10)
    inter_ms = timed(torch, lambda: rs.xdeepfm_interact(params, x0, lin, cfg),
                     3)
    log(f"[recsys] {cfg.name} serve_bulk device time per {XDEEPFM_CHUNK}-row "
        f"chunk (CUDA events): two field_pools {pool_ms:.4f} ms, "
        f"xdeepfm_interact {inter_ms:.4f} ms")
    del x0, lin
    log(f"[recsys] {cfg.name} serve_bulk ({b_bulk} rows in {len(chunks)} "
        f"chunks of {XDEEPFM_CHUNK}, a stated cut): "
        f"{b_bulk / sum(lat):.1f} rows/s ({sum(lat) * 1e3:.3f} ms in all); "
        f"logits finite, the last chunk equals the plain pool's (max rel err "
        f"{err:.3g}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    cand[cfg.name] = recsys_cand(
        torch, rep, model,
        batches(cfg, range(100, 100 + P99_CALLS), 1, dense=False), cfg.name)
    del model, params, sparse_b, p99, chunks, out
    torch.cuda.empty_cache()
    log(f"[recsys] served with {launches} embedding_bag launches; "
        f"retrieval_cand with {json.dumps(cand)}")
    return {"recsys": {"embedding_bag": launches},
            "recsys_cand": {n: sum(c.get(n, 0) for c in cand.values())
                            for n in ("embedding_bag", "knn_score",
                                      "knn_select")}}


# ---------------------------------------------------------------- seqrec
def seqrec_encode_ops(cfg) -> float:
    """Operations of one row's encode (``launch/cells.py``'s
    ``_recsys_flops`` for the sequential models)."""
    d, s = cfg.embed_dim, cfg.max_len
    per_tok = 4 * d * d + 2 * cfg.d_ff_mult * d * d + 2 * s * d
    return 2.0 * s * cfg.n_blocks * per_tok


def session_batches(torch, cfg, steps, size):
    """``SessionStream`` item rows (S/2..S items, -1 pads) on the card."""
    from repro_torch.data.recsys import SessionStream
    stream = SessionStream(cfg.vocab, cfg.max_len, seed=SEED)
    return [(torch.as_tensor(stream.batch(step, size)["items"],
                             device=DEV),) for step in steps]


def seqrec_smoke(torch):
    """The smoke configs with the same parameters on the CPU path and on
    the card, over ``SessionStream`` rows (most with pads) and an all-pad
    row: encode, session repr, BCE within SEQREC_TOL, retrieval ids equal
    (one knn_score and one knn_select launch)."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.data.recsys import SessionStream
    from repro_torch.kernels.parity import assert_close
    from repro_torch.models import recsys as rs

    for arch in SEQREC_ARCHS:
        cfg = registry.get(arch).smoke_config()
        m = rs.SeqRec(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(SEED))
        b = SessionStream(cfg.vocab, cfg.max_len, seed=SEED).batch(0, 64)
        b["items"][0] = -1
        pads = int((b["items"] < 0).any(axis=1).sum())
        args = (b["items"], b["pos"], b["neg"])
        n_valid, k = cfg.vocab - 20, 25

        def run():
            return (m.encode(args[0]), m.session_repr(args[0]),
                    m.bce_loss(*args), m.retrieve(args[0], k, n_valid))

        want = run()
        m.to(DEV)
        got, launches = counted(torch, run)
        if launches["knn_score"] != 1 or launches["knn_select"] != 1:
            raise AssertionError(f"[seqrec] {arch} smoke: {launches}")
        errs = [assert_close(g, w, SEQREC_TOL, f"[seqrec] {arch} {n}")
                for g, w, n in zip(got[:3], want[:3],
                                   ("encode", "repr", "bce"))]
        (gs, gi), (ws, wi) = got[3], want[3]
        errs.append(assert_close(gs, ws, SEQREC_TOL, f"[seqrec] {arch} "
                                 f"retrieve scores"))
        if not np.array_equal(gi.cpu().numpy(), wi.numpy()):
            raise AssertionError(f"[seqrec] {arch} smoke: retrieved ids "
                                 f"differ from the CPU path's")
        log(f"[seqrec] {cfg.name}: card == CPU path on the same parameters "
            f"(64 rows, {pads} with pads, one all pads; encode / repr / bce "
            f"/ top-{k} scores max_abs_err "
            f"{' / '.join(f'{e:.3g}' for e in errs)}, ids equal)")


def seqrec_arch(torch, rep, arch, gen):
    """One arch at full width: serve_p99, serve_bulk and retrieval_cand,
    each through ``SeqRec.retrieve`` (the encode in row chunks, then the
    index scan of the kNN kernels).  Returns {path: launches}."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.models import recsys as rs

    cfg = registry.get(arch).full_config()
    t0 = time.perf_counter()
    m = rs.SeqRec(cfg, device=DEV, generator=gen)
    torch.cuda.synchronize()
    table = m.item_emb
    before = torch.cuda.memory_allocated()
    index = m.index()
    copied = torch.cuda.memory_allocated() - before
    aligned = cfg.embed_dim % 32 == 0
    if aligned != (index.doc_emb.data_ptr() == table.data_ptr()):
        raise AssertionError(f"[seqrec] {arch}: the index's payload is not "
                             f"what the table's width asks for")
    n, dp = index.doc_emb.shape
    rows = rs.encode_rows(cfg)
    log(f"[seqrec] {arch} (vocab {cfg.vocab}, d {cfg.embed_dim}, "
        f"{cfg.n_blocks} blocks, {cfg.n_heads} head(s), S {cfg.max_len}, "
        f"{'causal' if cfg.causal else 'bidirectional'}): item table "
        f"{table.numel() * 4 / 1e6:.1f} MB drawn in "
        f"{time.perf_counter() - t0:.2f} s; the index "
        + ("takes it as is" if aligned else
           f"pads it to width {dp} ({copied / 1e6:.1f} MB copied once)")
        + f"; encode chunks of {rows} rows")
    paths = {}
    ops_row = seqrec_encode_ops(cfg)
    # serve_p99: 51 requests of 512 sessions
    b_p99 = registry.RECSYS_SHAPES["serve_p99"]["batch"]
    p99 = session_batches(torch, cfg, range(1, P99_CALLS + 1), b_p99)
    launches, lat, (scores, ids) = serve_retrieval(
        torch, f"[seqrec] {arch} serve_p99",
        lambda it: m.retrieve(it, SERVE_K), p99,
        {"knn_score": 1, "knn_select": 1})
    p50, p99ms = p50_p99(lat)
    q = m.session_repr(p99[-1][0])
    err = check_answers(torch, f"[seqrec] {arch} serve_p99", index, q,
                        scores, ids, SERVE_K, n)
    del scores, ids
    enc_ms = timed(torch, lambda: m.session_repr(p99[-1][0]), 10)
    scan_ms = timed(torch, lambda: index.search(q, SERVE_K), 10)
    enc_bound = bound(0, ops_row * b_p99, F32_OPS)[0]
    log(f"[seqrec] {arch} serve_p99 ({b_p99} sessions, top {SERVE_K}): "
        f"{len(lat) - 1} calls after a warm-up, latency p50 {p50:.4f} ms, "
        f"p99 {p99ms:.4f} ms; all {b_p99} rows equal the plain search "
        f"(max err {err:.3g}); device time apart (CUDA events): encode "
        f"{enc_ms:.4f} ms (bound {enc_bound:.4f}), scan {scan_ms:.4f} ms")
    if arch == "bert4rec":          # the kernels line's rows at this shape
        add_rows(rep, knn_rows(torch, f"{arch} serve_p99", index, q,
                               SERVE_K), "seqrec")
    paths["seqrec"] = launches
    del p99, q
    torch.cuda.empty_cache()
    # serve_bulk: one batch of 262,144 sessions, served twice
    b_bulk = registry.RECSYS_SHAPES["serve_bulk"]["batch"]
    (items,), = session_batches(torch, cfg, [0], b_bulk)
    knn_chunk = knn_ops.chunk_rows(n, 4 * knn_ops._select_words(
        n, SERVE_K)[2])
    chunks = -(-b_bulk // knn_chunk)
    per_call = chunks if DEV == "cuda" else 1   # a rehearsal counts calls
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches, lat, (scores, ids) = serve_retrieval(
        torch, f"[seqrec] {arch} serve_bulk",
        lambda it: m.retrieve(it, SERVE_K), [(items,)] * 2,
        {"knn_score": per_call, "knn_select": per_call})
    peak = torch.cuda.max_memory_allocated() - base
    sample = torch.linspace(0, b_bulk - 1, BULK_SAMPLE, device=DEV).long()
    err = check_answers(torch, f"[seqrec] {arch} serve_bulk sample", index,
                        m.session_repr(items[sample]), scores[sample],
                        ids[sample], SERVE_K, n)
    del scores, ids
    t_enc = time.perf_counter()
    q = m.session_repr(items)
    torch.cuda.synchronize()
    t_scan = time.perf_counter()
    index.search(q, SERVE_K)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    log(f"[seqrec] {arch} serve_bulk ({b_bulk} sessions, top {SERVE_K}): "
        f"{b_bulk / lat[-1]:.1f} rows/s ({lat[-1] * 1e3:.3f} ms a call, "
        f"the second of 2); encode {(t_scan - t_enc) * 1e3:.3f} ms in "
        f"{-(-b_bulk // rows)} chunks of {rows} rows (bound "
        f"{bound(0, ops_row * b_bulk, F32_OPS)[0]:.3f} ms), scan "
        f"{(t_end - t_scan) * 1e3:.3f} ms in {chunks} kNN chunks of "
        f"{knn_chunk} queries (score bound "
        f"{bound(0, 2 * b_bulk * n * dp, F32_OPS)[0]:.3f} ms); "
        f"{BULK_SAMPLE} sampled rows equal the plain search (max err "
        f"{err:.3g}); peak device memory above the item table and index "
        f"{peak / 1e9:.3f} GB")
    paths["seqrec"] = {k: paths["seqrec"][k] + launches[k]
                       for k in paths["seqrec"]}
    del items, q
    torch.cuda.empty_cache()
    # retrieval_cand: one session against the first 1,000,000 items
    n_valid = registry.RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    cand = m.index(n_valid)
    if cand.doc_emb.data_ptr() != index.doc_emb.data_ptr():
        raise AssertionError(f"[seqrec] {arch}: retrieval_cand's index "
                             f"copied the payload again")
    requests = session_batches(torch, cfg, range(100, 100 + P99_CALLS), 1)
    launches, lat, (scores, ids) = serve_retrieval(
        torch, f"[seqrec] {arch} retrieval_cand",
        lambda it: m.retrieve(it, CAND_K, n_valid), requests,
        {"knn_score": 1, "knn_select": 1})
    err = check_answers(torch, f"[seqrec] {arch} retrieval_cand", cand,
                        m.session_repr(requests[-1][0]), scores, ids, CAND_K,
                        n_valid)
    p50, p99ms = p50_p99(lat)
    log(f"[seqrec] {arch} retrieval_cand (1 session x {n} candidates, "
        f"{n_valid} valid, top {CAND_K}): {len(lat) - 1} calls after a "
        f"warm-up, latency p50 {p50:.4f} ms, p99 {p99ms:.4f} ms; ids equal "
        f"the plain search's (max err {err:.3g}), none >= {n_valid}")
    paths["seqrec_cand"] = launches
    del m, index, cand
    torch.cuda.empty_cache()
    return paths


def seqrec_phase(torch, rep: Report):
    """[seqrec]: the smoke configs card against CPU, then SASRec and
    BERT4Rec at full width through the index scan.  Returns {path:
    launches}."""
    t_phase = time.perf_counter()
    seqrec_smoke(torch)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 5)
    paths = {}
    for arch in SEQREC_ARCHS:
        for name, counts in seqrec_arch(torch, rep, arch, gen).items():
            mine = paths.setdefault(name, {})
            for k, v in counts.items():
                mine[k] = mine.get(k, 0) + v
    log(f"[seqrec] phase in {time.perf_counter() - t_phase:.1f} s")
    return paths


# ------------------------------------------------------------------ egnn
def egnn_graph(shape, seed):
    """One shape's input on the host: (node_feat, coords, edge_index,
    graph_ids or None, n_graphs or None, host seconds, sampler seconds or
    None, labels), from the port's copies of the JAX package's generators.
    The labels are per graph (molecule), per node (full graphs) or per seed
    node (minibatch; -1 elsewhere).  A shape of TRAIN_EGNN_SHAPES is made
    once and kept for [train] until it ends."""
    import numpy as np

    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.data import graph

    geom, key = egnn_cfg.SHAPES[shape], (shape, seed)
    if key in EGNN_GRAPHS:
        return EGNN_GRAPHS[key]
    t0 = time.perf_counter()
    if geom["kind"] == "batched":
        feat, coords, edges, gids, labels = graph.batched_molecules(
            seed, geom["batch"], geom["n_nodes"], geom["n_edges"],
            geom["d_feat"])
        out = (feat, coords, edges, gids, geom["batch"],
               time.perf_counter() - t0, None, labels)
    else:
        g = graph.random_graph(seed, geom["n_nodes"], geom["n_edges"],
                               geom["d_feat"])
        made = time.perf_counter() - t0
        if geom["kind"] == "full":
            out = (g.node_feat, g.coords, g.edge_index, None, None, made,
                   None, g.labels)
        else:
            t0 = time.perf_counter()
            rng = np.random.default_rng(seed)
            sampler = graph.NeighborSampler(g.edge_index, geom["n_nodes"])
            seeds = rng.choice(geom["n_nodes"], geom["batch_nodes"],
                               replace=False)
            block = sampler.sample(seeds, geom["fanout"], rng)
            labels = np.full_like(g.labels, -1)
            labels[seeds] = g.labels[seeds]
            out = (g.node_feat, g.coords, block, None, None, made,
                   time.perf_counter() - t0, labels)
    if shape in TRAIN_EGNN_SHAPES:
        EGNN_GRAPHS[key] = out
    return out


def egnn_smoke(torch):
    """The smoke config card against CPU (node readout on a random graph,
    graph readout on molecules; logits and coordinates within
    EGNN_SMOKE_TOL), and equivariance on the card: a rotation and
    translation leave the logits and move the coordinates alike within
    EGNN_EQUI_TOL."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.data import graph
    from repro_torch.kernels.parity import assert_close
    from repro_torch.models import egnn

    base = egnn_cfg.smoke_config()
    g = graph.random_graph(SEED, 500, 6000, base.d_feat_in)
    mol = graph.batched_molecules(SEED, 8, 30, 64, base.d_feat_in)
    cases = {"node": ((g.node_feat, g.coords, g.edge_index), {}),
             "graph": (mol[:3], dict(graph_ids=mol[3], n_graphs=8))}
    errs = []
    for readout, (args, kw) in cases.items():
        cfg = dataclasses.replace(base, readout=readout)
        params = egnn.init_params(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(
                                      SEED))
        want = egnn.forward(params, *args, cfg, **kw)
        card = tree_to(params, DEV)
        kw_card = {k: (torch.as_tensor(v, device=DEV)
                       if k == "graph_ids" else v) for k, v in kw.items()}
        got = egnn.forward(card, *args, cfg, **kw_card)
        errs += [assert_close(a, b, EGNN_SMOKE_TOL,
                              f"[egnn] smoke {readout} {what}")
                 for a, b, what in zip(got, want, ("logits", "coords"))]
    rng = np.random.default_rng(SEED)
    rot, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    shift = rng.standard_normal(3)
    moved = (args[1] @ rot.T + shift).astype(np.float32)
    l2, x2 = egnn.forward(card, args[0], moved, args[2], cfg, **kw_card)
    rot_t = torch.as_tensor(rot, dtype=torch.float32, device=DEV)
    e_l = assert_close(l2, got[0], EGNN_EQUI_TOL, "[egnn] invariant logits")
    e_x = assert_close(x2, got[1] @ rot_t.T + torch.as_tensor(
        shift, dtype=torch.float32, device=DEV), EGNN_EQUI_TOL,
        "[egnn] equivariant coords")
    log(f"[egnn] smoke config: card == CPU path (node readout on 500 nodes "
        f"x 6000 edges, graph readout on 8 molecules; logits / coords "
        f"max_abs_err {' / '.join(f'{e:.3g}' for e in errs)}); rotated and "
        f"translated on the card: logits within {e_l:.3g}, coords within "
        f"{e_x:.3g} (bound {EGNN_EQUI_TOL})")


def egnn_shape(torch, shape, gen):
    """One of the JAX package's four shapes at full width: the graph made
    on the host, moved to the card, its plan built once, the forward timed
    on the device and back to back beside its bound, two forwards (the
    second building its own plan) equal bit for bit, the peak memory."""
    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.models import egnn

    geom = egnn_cfg.SHAPES[shape]
    feat, coords, edges, gids, n_graphs, made, sampled, _ = egnn_graph(
        shape, SEED)
    readout = "graph" if gids is not None else "node"
    cfg = egnn_cfg.full_config(d_feat=geom["d_feat"], readout=readout)
    params = egnn.init_params(cfg, device=DEV, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feat, coords, edges = (torch.as_tensor(a, device=DEV)
                           for a in (feat, coords, edges))
    if gids is not None:
        gids = torch.as_tensor(gids, device=DEV)
    torch.cuda.synchronize()
    moved = time.perf_counter() - t0
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = egnn.prepare(edges, feat.shape[0], gids, n_graphs)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3

    def fwd(p=plan):
        return egnn.forward(params, feat, coords, edges, cfg,
                            graph_ids=gids, n_graphs=n_graphs, plan=p)

    (logits, x), launches = counted(torch, fwd)
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        raise AssertionError(f"[egnn] {shape}: a forward launched {launches}")
    n_out = n_graphs or feat.shape[0]
    if logits.shape != (n_out, cfg.n_classes) or x.shape != coords.shape \
            or not (torch.isfinite(logits).all() and torch.isfinite(x).all()):
        raise AssertionError(f"[egnn] {shape}: outputs malformed")
    again = fwd(None)                       # a plan of its own
    if not (torch.equal(again[0], logits) and torch.equal(again[1], x)):
        raise AssertionError(f"[egnn] {shape}: two forwards differ")
    del again
    # one forward a device reading: a forward over many edge chunks
    # launches more kernels than the launch queue holds behind a sleep,
    # and then only the profiler's sum over its kernels reads the device
    reps = EGNN_REPS[shape]
    readings = [timed_device(torch, fwd, 1, strict=False)
                for _ in range(reps)]
    dev_ms = None if None in readings else sum(readings) / reps
    b2b_ms = timed(torch, fwd, reps)
    prof = profile_split(torch, lambda _: fwd(), None, parts={
        "mlp": (egnn, "_mlp"), "segment_sum": (egnn.SegmentPlan, "add")})
    split = None if prof is None else {k: round(v, 4)
                                       for k, v in prof[1].items()}
    n_edges = int(plan.edges.counts.sum())
    nbytes, ops = egnn_costs(cfg, feat.shape[0], n_edges, n_out,
                             geom["d_feat"])
    bms, by = bound(nbytes, ops, F32_OPS)
    log(f"[egnn] {shape} ({feat.shape[0]} nodes, {edges.shape[1]} edge "
        f"slots, {n_edges} valid, d_feat {geom['d_feat']}, {readout} "
        f"readout, 4 layers, d 64): forward "
        + (f"{dev_ms:.4f} ms on the device" if dev_ms is not None else
           "device time not measurable behind a sleep (the enqueue "
           "outran it)")
        + f", {b2b_ms:.4f} ms back to back (mean of {reps}); profiler, "
        + ("no device activity" if prof is None else
           f"one forward: {prof[0]} device activities, kernels "
           f"{sum(prof[1].values()):.4f} ms by part {json.dumps(split)}")
        + f"; bound {bms:.4f} ms "
        f"({by}: {ops:.4g} operations, {nbytes / 1e9:.4g} GB); plan "
        f"{plan_ms:.2f} ms (host clock, once a graph); "
        f"{len(plan.edges.chunks)} edge chunk(s) of at most "
        f"{egnn.EDGE_CHUNK}; two forwards equal bit for bit; peak device "
        f"memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} above the "
        f"inputs and weights); host: graph made in {made:.2f} s"
        + (f", sampler {sampled:.2f} s" if sampled is not None else "")
        + f", moved to the card in {moved:.2f} s")
    if peak > 80e9:
        raise AssertionError(f"[egnn] {shape}: peak {peak} B")
    return {"ms": dev_ms, "b2b_ms": b2b_ms, "bound_ms": bms, "bound_by": by,
            "profiled_ms": None if prof is None else sum(prof[1].values()),
            "peak_gb": peak / 1e9, "chunks": len(plan.edges.chunks)}


def egnn_phase(torch):
    """[egnn]: the smoke config card against CPU and equivariance, then
    the four shapes at full width."""
    t_phase = time.perf_counter()
    egnn_smoke(torch)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 7)
    out = {}
    for shape in EGNN_SHAPES:
        out[shape] = egnn_shape(torch, shape, gen)
        torch.cuda.empty_cache()
    log("[egnn] shapes " + json.dumps(out))
    log(f"[egnn] phase in {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- train
def labelled(opt):
    """``opt`` with its update under the profiler label ``part.update``."""
    from torch.profiler import record_function

    from repro_torch.train.optimizer import Optimizer

    def update(*args):
        with record_function("part.update"):
            return opt.update(*args)
    return Optimizer(opt.init, update)


def train_timing(torch, step_once):
    """One more step under ``torch.profiler``: (device activities, kernel
    ms by part, the largest operators of ``other``) or None when the
    profiler saw no device activity.  The forward's parts (and the remat
    recompute's) carry their labels; the backward's kernels, launched from
    autograd's thread, count as matmul or other."""
    prof = profile_split(torch, lambda _: step_once(), None)
    if prof is None:
        return None
    return (prof[0], {k: round(v, 4) for k, v in prof[1].items() if v},
            {k: round(v, 4) for k, v in prof[2].items()})


def train_log(what, *, dev, b2b_ms, reps, items, unit, peak, base, bms,
              by, ops, nbytes, losses, launches, extra=""):
    """The line every full-width train path prints."""
    n_dev, split, top = dev if dev is not None else (0, {}, {})
    dev_ms = sum(split.values()) if dev is not None else None
    log(f"[train] {what}: step "
        + (f"{dev_ms:.4f} ms on the device (profiler, one step: {n_dev} "
           f"device activities, kernels by part {json.dumps(split)}; the "
           f"largest of other {json.dumps(top)})"
           if dev_ms is not None else "device time not measured (the "
           "profiler saw no device activity)")
        + f", {b2b_ms:.4f} ms back to back (mean of {reps}); "
        f"{items / b2b_ms * 1e3:.6g} {unit}/s; bound {bms:.4f} ms ({by}: "
        f"{ops:.4g} operations, {nbytes / 1e9:.4g} GB); peak device memory "
        f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} above the "
        f"allocation before the first step); loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} "
        f"over {len(losses)} steps; kernel launches {launches}" + extra)
    return {"ms": dev_ms, "b2b_ms": b2b_ms, "bound_ms": bms, "bound_by": by,
            "peak_gb": peak / 1e9, "first_loss": losses[0],
            "last_loss": losses[-1]}


def no_launches(launches, what):
    if any(launches.values()):
        raise AssertionError(f"[train] {what}: kernel launches {launches} "
                             f"on a train path")
    return sum(launches.values())


def train_drive(torch, step, state, batches):
    """``step`` over ``batches`` (the first a warm-up, synchronised; the
    rest enqueued back to back), with the kernel counters zeroed before
    and read after.  Returns (state, losses, back-to-back ms, launches,
    peak bytes, bytes allocated before the first step)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = []

    def run():
        nonlocal state
        for i, b in enumerate(batches):
            state, m = step(state, b)
            out.append(m["loss"])
            if i == 0:
                torch.cuda.synchronize()
                out.append(time.perf_counter())
        return None

    _, launches = counted(torch, run)
    t_end = time.perf_counter()
    t1 = out.pop(1)
    losses = [float(x) for x in out]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"[train] losses {losses}")
    b2b = (t_end - t1) * 1e3 / max(len(batches) - 1, 1)
    return (state, losses, b2b, launches, torch.cuda.max_memory_allocated(),
            base)


def train_smoke(torch):
    """The smoke configs: one step from the same parameters and batch on
    the CPU path and on the card, held by ``train.parity``."""
    from repro_torch.train import parity

    errs = {}
    for arch in parity.SMOKE_ARCHS:
        ref = parity.smoke_step(arch, "cpu")
        got, launches = counted(torch, lambda: parity.smoke_step(arch, DEV))
        no_launches(launches, f"{arch} smoke")
        errs[arch] = {k: float(f"{v:.3g}") for k, v in
                      parity.assert_steps_agree(ref, got, arch).items()}
    log(f"[train] smoke configs, card == CPU path (one step, lr "
        f"{parity.LR}: loss / grad_norm within rtol {parity.LOSS_RTOL}, "
        f"gradients within {parity.G_ATOL} + {parity.G_RTOL} x the leaf's "
        f"largest, parameters within {parity.P_ATOL}; 0 kernel launches): "
        f"largest errors {json.dumps(errs)}")


def train_star(torch):
    """STAR at full width through ``train.encoder.train``: TRAIN_STAR_STEPS
    steps (loss falling), then a run killed after TRAIN_RESUME steps and
    resumed from its checkpoints, whose losses equal the first run's."""
    import shutil

    from repro_torch.configs import star_encoder
    from repro_torch.data.lm import LMBatchSpec, TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.train import encoder
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_lm_train_step

    cfg = star_encoder.full_config()
    accum = star_encoder.TRAIN_ACCUM_STEPS
    root = ROOT / "artifacts" / "train_star"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(device=DEV, batch=TRAIN_STAR_B, seq=TRAIN_STAR_S, accum=accum,
              remat="full", seed=SEED)
    marks = []

    def mark(step, _metrics):
        if step == 0:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (state, _, hist), launches = counted(torch, lambda: encoder.train(
        cfg, TRAIN_STAR_STEPS, str(root / "run"), interval=10 ** 9,
        on_step=mark, **kw))
    b2b = (time.perf_counter() - marks[0]) * 1e3 / (TRAIN_STAR_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in hist]
    if not all(map(math.isfinite, losses)) or \
            sum(losses[-5:]) >= sum(losses[:5]):
        raise AssertionError(f"[train] star-encoder: losses {losses}")
    params = state["params"]
    n = tf.param_count(params)
    layer = tf.param_count(params["group0_dense"])
    tokens = TRAIN_STAR_B * TRAIN_STAR_S
    ops = lm_train_ops(cfg, layer, tokens, TRAIN_STAR_B, TRAIN_STAR_S)
    # f32 AdamW: per microbatch a gradient written and read and the
    # accumulator read and written (16 B a parameter); the update reads
    # the parameter, accumulator, m and v and writes three (28 B)
    nbytes = n * (16 * accum + 28)
    bms, by = bound(nbytes, ops, F32_OPS)
    opt = labelled(adamw(lr=encoder.LR, warmup=encoder.WARMUP))
    step = make_lm_train_step(cfg, opt, accum_steps=accum, remat="full")
    stream = TokenStream(LMBatchSpec(TRAIN_STAR_B, TRAIN_STAR_S,
                                     cfg.vocab_size), device=DEV)
    batch = stream.batch(TRAIN_STAR_STEPS)
    dev = train_timing(torch, lambda: step(state, batch))
    out = {"star": train_log(
        f"star-encoder (12 layers, d 768, {n} parameters, f32, AdamW lr "
        f"{encoder.LR} warmup {encoder.WARMUP}, remat full) at "
        f"{TRAIN_STAR_B} x {TRAIN_STAR_S} tokens in {accum} microbatches",
        dev=dev, b2b_ms=b2b, reps=TRAIN_STAR_STEPS - 1, items=tokens,
        unit="tokens", peak=peak, base=base, bms=bms, by=by, ops=ops,
        nbytes=nbytes, losses=losses, launches=no_launches(launches, "star"),
        extra=f" (the state is made inside the run); losses "
        f"{[round(x, 4) for x in losses]}")}
    del state, params, step, batch
    torch.cuda.empty_cache()
    ck = str(root / "resume")
    (_, _, first), l1 = counted(torch, lambda: encoder.train(
        cfg, TRAIN_RESUME, ck, interval=1, **kw))
    # the run is killed here: its state is gone, its checkpoints stay
    (_, start, rest), l2 = counted(torch, lambda: encoder.train(
        cfg, 2 * TRAIN_RESUME, ck, interval=1, **kw))
    no_launches({k: l1[k] + l2[k] for k in l1}, "star resume")
    again = [float(m["loss"]) for m in first + rest]
    want = losses[:2 * TRAIN_RESUME]
    err = max(abs(a - b) / abs(b) for a, b in zip(again, want))
    if start != TRAIN_RESUME or err > TRAIN_RESUME_RTOL:
        raise AssertionError(f"[train] resumed at {start}: losses {again} "
                             f"against {want}")
    log(f"[train] star-encoder killed after {TRAIN_RESUME} steps "
        f"(CheckpointManager interval 1, async saves) and resumed from "
        f"step {start}: losses of steps 0-{2 * TRAIN_RESUME - 1} "
        f"{[round(x, 6) for x in again]} against the uninterrupted run's "
        f"within rtol {err:.3g} (bound {TRAIN_RESUME_RTOL})")
    shutil.rmtree(root, ignore_errors=True)
    return out


def train_llama4(torch):
    """llama4-scout at full width cut to TRAIN_LM_LAYERS layer(s): bf16,
    Adafactor with stochastic rounding, TRAIN_ACCUM_STEPS microbatches in
    an f32 accumulator, remat "full"."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.data.lm import LMBatchSpec, TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import OPTIMIZERS
    from repro_torch.train.step import make_lm_train_step

    mod = registry.get(TRAIN_LM_ARCH)
    cfg = dataclasses.replace(mod.full_config(), n_layers=TRAIN_LM_LAYERS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 11)
    params = tf.init_params(cfg, device=DEV, generator=gen)
    opt = labelled(OPTIMIZERS[mod.OPTIMIZER]())      # stochastic rounding on
    accum = mod.TRAIN_ACCUM_STEPS
    step = make_lm_train_step(cfg, opt, accum_steps=accum, remat="full",
                              accum_dtype=mod.ACCUM_DTYPE)
    stream = TokenStream(LMBatchSpec(TRAIN_LM_B, TRAIN_LM_S,
                                     cfg.vocab_size), device=DEV)
    batches = [stream.batch(i) for i in range(TRAIN_LM_STEPS)]
    probe = params["group0_moe"]["ffn"]["wi"][0, 0, :4, :4].clone()
    state = {"params": params, "opt": opt.init(params)}
    state, losses, b2b, launches, peak, base = train_drive(
        torch, step, state, batches)
    wi = state["params"]["group0_moe"]["ffn"]["wi"]
    if wi.dtype != torch.bfloat16 or torch.equal(wi[0, 0, :4, :4], probe):
        raise AssertionError("[train] llama4: bf16 weights not updated")
    n = tf.param_count(params)
    active = tf.active_param_count(cfg, params)
    layer = active - 2 * cfg.d_model * cfg.vocab_size     # embed and head
    tokens = TRAIN_LM_B * TRAIN_LM_S
    ops = lm_train_ops(cfg, layer, tokens, TRAIN_LM_B, TRAIN_LM_S)
    # per microbatch a bf16 gradient written and read and the f32
    # accumulator read and written (12 B a parameter); the update reads
    # the parameter and accumulator and writes the parameter (8 B; the
    # factored state is small)
    nbytes = n * (12 * accum + 8)
    bms, by = bound(nbytes, ops, BF16_OPS)
    if by == "bytes":
        by = "the optimizer's bytes"
    dev = train_timing(torch, lambda: step(state, batches[0]))
    out = train_log(
        f"{TRAIN_LM_ARCH} at full width, {TRAIN_LM_LAYERS} of "
        f"{mod.full_config().n_layers} layers ({n} parameters, "
        f"{n * 2 / 1e9:.2f} GB bf16; Adafactor with stochastic rounding, "
        f"remat full, f32 accumulator) at {TRAIN_LM_B} x {TRAIN_LM_S} "
        f"tokens in {accum} microbatches", dev=dev, b2b_ms=b2b,
        reps=TRAIN_LM_STEPS - 1, items=tokens, unit="tokens", peak=peak,
        base=base, bms=bms, by=by, ops=ops, nbytes=nbytes, losses=losses,
        launches=no_launches(launches, TRAIN_LM_ARCH))
    del state, params, step, batches, wi
    torch.cuda.empty_cache()
    return out


def train_recsys(torch, arch):
    """One recsys arch at full width and ``train_batch``: TRAIN_RECSYS_STEPS
    AdamW steps through the gather branch (no embedding-bag launch)."""
    import functools

    from repro_torch.configs import registry
    from repro_torch.data.recsys import CTRSpec, CTRStream, SessionStream
    from repro_torch.models import recsys as rs
    from repro_torch.train import step as st
    from repro_torch.train import tree
    from repro_torch.train.optimizer import OPTIMIZERS

    mod = registry.get(arch)
    cfg = mod.full_config()
    rows = registry.RECSYS_SHAPES["train_batch"]["batch"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 13)
    t0 = time.perf_counter()
    if arch in ("dlrm-rm2", "xdeepfm"):
        dlrm = arch == "dlrm-rm2"
        params = (rs.dlrm_init if dlrm else rs.xdeepfm_init)(
            cfg, device=DEV, generator=gen)
        stream = CTRStream(CTRSpec(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                   multi_hot=cfg.multi_hot if dlrm else 1,
                                   seed=SEED))
        loss = functools.partial(st.ctr_loss_fn, cfg=cfg)

        def batch(i):
            b = stream.batch(i, rows)
            if not dlrm:
                del b["dense"]
            return b
    else:
        params = rs.seqrec_init(cfg, device=DEV, generator=gen)
        stream = SessionStream(cfg.vocab, cfg.max_len, seed=SEED)
        loss = functools.partial(st.seqrec_loss_fn, cfg=cfg)

        def batch(i):
            return stream.batch(i, rows)
    accum = XDEEPFM_TRAIN_ACCUM if arch == "xdeepfm" else \
        mod.TRAIN_ACCUM_STEPS
    opt = labelled(OPTIMIZERS[mod.OPTIMIZER]())
    step = st.make_train_step(loss, opt, accum_steps=accum,
                              accum_dtype=mod.ACCUM_DTYPE)
    batches = [{k: torch.as_tensor(v, device=DEV)
                for k, v in batch(i).items()}
               for i in range(TRAIN_RECSYS_STEPS)]
    made = time.perf_counter() - t0
    state = {"params": params, "opt": opt.init(params)}
    state, losses, b2b, launches, peak, base = train_drive(
        torch, step, state, batches)
    n = sum(t.numel() for t in tree.leaves(params))
    ops = recsys_train_ops(arch, cfg, rows)
    # f32 AdamW: the dense gradient written and read, the parameter, m and
    # v read and written (32 B a parameter); with microbatches the
    # accumulator's read and write per microbatch besides (16 B)
    nbytes = n * (32 + (16 * accum if accum > 1 else 0))
    bms, by = bound(nbytes, ops, F32_OPS)
    dev = train_timing(torch, lambda: step(state, batches[0]))
    out = train_log(
        f"{arch} at train_batch ({rows} rows"
        + (f" in {accum} microbatches" if accum > 1 else "")
        + f"; {n} parameters, {n * 4 / 1e9:.2f} GB f32; AdamW; the gather "
        f"branch)", dev=dev, b2b_ms=b2b, reps=TRAIN_RECSYS_STEPS - 1,
        items=rows, unit="rows", peak=peak, base=base, bms=bms, by=by,
        ops=ops, nbytes=nbytes, losses=losses,
        launches=no_launches(launches, arch),
        extra=f"; host: parameters and batches made in {made:.2f} s")
    del state, params, step, batches
    torch.cuda.empty_cache()
    return out


def train_egnn(torch, shape):
    """EGNN at full width on one of TRAIN_EGNN_SHAPES: TRAIN_EGNN_STEPS
    AdamW steps through ``egnn_loss_fn`` (each layer checkpointed)."""
    import functools

    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.models import egnn
    from repro_torch.train import step as st
    from repro_torch.train import tree
    from repro_torch.train.optimizer import OPTIMIZERS

    geom = egnn_cfg.SHAPES[shape]
    feat, coords, edges, gids, n_graphs, _, _, labels = egnn_graph(shape,
                                                                   SEED)
    readout = "graph" if gids is not None else "node"
    cfg = egnn_cfg.full_config(d_feat=geom["d_feat"], readout=readout)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 17)
    params = egnn.init_params(cfg, device=DEV, generator=gen)
    b = {"feat": feat, "coords": coords, "edge_index": edges,
         "labels": labels}
    if gids is not None:
        b["graph_ids"] = gids
    b = {k: torch.as_tensor(v, device=DEV) for k, v in b.items()}
    plan = egnn.prepare(b["edge_index"], feat.shape[0], b.get("graph_ids"),
                        n_graphs)
    loss = functools.partial(st.egnn_loss_fn, cfg=cfg, n_graphs=n_graphs,
                             plan=plan)
    opt = labelled(OPTIMIZERS[egnn_cfg.OPTIMIZER]())
    step = st.make_train_step(loss, opt)
    state = {"params": params, "opt": opt.init(params)}
    state, losses, b2b, launches, peak, base = train_drive(
        torch, step, state, [b] * TRAIN_EGNN_STEPS)
    n_out = n_graphs or feat.shape[0]
    n_edges = int(plan.edges.counts.sum())
    nbytes, ops = egnn_costs(cfg, feat.shape[0], n_edges, n_out,
                             geom["d_feat"])
    n = sum(t.numel() for t in tree.leaves(params))
    ops, nbytes = 4 * ops, nbytes + 32 * n       # remat: 4 x the forward
    bms, by = bound(nbytes, ops, F32_OPS)
    dev = train_timing(torch, lambda: step(state, b))
    out = train_log(
        f"egnn {shape} ({feat.shape[0]} nodes, {n_edges} valid edges, "
        f"d_feat {geom['d_feat']}, {readout} readout, "
        f"{int((b['labels'] >= 0).sum())} labels; AdamW, remat per layer)",
        dev=dev, b2b_ms=b2b, reps=TRAIN_EGNN_STEPS - 1, items=n_out,
        unit=("graphs" if readout == "graph" else "nodes"), peak=peak,
        base=base, bms=bms, by=by, ops=ops, nbytes=nbytes, losses=losses,
        launches=no_launches(launches, f"egnn {shape}"))
    del state, params, step, b, plan
    torch.cuda.empty_cache()
    return out


def train_phase(torch):
    """[train]: the smoke configs card against CPU, then every full-width
    train path (STAR with kill and resume, llama4-scout cut to 1 layer,
    the recsys archs at train_batch, EGNN at three shapes), each freed
    before the next and each checked to launch no kernel."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError("[train] products must accumulate in f32")
    t_phase = time.perf_counter()
    train_smoke(torch)
    out = train_star(torch)
    out[TRAIN_LM_ARCH] = train_llama4(torch)
    for arch in TRAIN_RECSYS:
        out[arch] = train_recsys(torch, arch)
    for shape in TRAIN_EGNN_SHAPES:
        out[f"egnn {shape}"] = train_egnn(torch, shape)
    EGNN_GRAPHS.clear()
    log("[train] paths " + json.dumps(out))
    log(f"[train] phase in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- corpus
def build_corpus(torch, seed: int):
    """World docs + on-card distractors, Eq. 1-transformed with one M,
    stored at the port's padded width (N, 800) f32."""
    from repro_torch.core import embedding as temb
    from repro_torch.core import layout
    from repro_torch.data.conversations import WorldConfig, make_world

    t0 = time.perf_counter()
    world = make_world(WorldConfig(n_conversations=S, seed=seed))
    n_world = world.n_docs
    n_bg = N_CORPUS - n_world
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
    jitter = world.cfg.norm_jitter
    bg_norms = 1.0 + jitter * (torch.rand(n_bg, generator=gen,
                                          device=DEV) * 2 - 1)
    world_emb = torch.as_tensor(world.doc_emb, dtype=torch.float32,
                                device=DEV)
    m = max(float(torch.linalg.vector_norm(world_emb, dim=1).max()),
            float(bg_norms.max()))
    dim = DIM_RAW + 1
    corpus = torch.zeros((N_CORPUS, layout.phys_dim(dim)), dtype=torch.float32,
                         device=DEV)
    corpus[:n_world, :dim] = temb.transform_documents(world_emb, m)[0]
    del world_emb
    chunk = 1 << 20
    for lo in range(0, n_bg, chunk):
        hi = min(lo + chunk, n_bg)
        z = torch.nn.functional.normalize(torch.randn(
            hi - lo, DIM_RAW, generator=gen, device=DEV), dim=1)
        corpus[n_world + lo:n_world + hi, :dim] = temb.transform_documents(
            z * bg_norms[lo:hi, None], m)[0]
    del bg_norms
    streams = [temb.transform_queries(torch.as_tensor(
        c.queries, dtype=torch.float32)).numpy() for c in world.conversations]
    torch.cuda.synchronize()
    log(f"[main] corpus {tuple(corpus.shape)} f32 "
        f"({corpus.numel() * 4 / 1e9:.2f} GB), M={m:.6f}, world "
        f"{n_world} docs, built in {time.perf_counter() - t0:.1f} s")
    return world, corpus, streams


# ------------------------------------------------------------ two-stage
def tiles_agree(torch, vk, pk, vr, pr, what) -> float:
    """Per (tile, row) candidate lists, on the card: the same -inf pattern,
    values within SCORE_TOL, and equal positions wherever a finite value
    lies more than SCORE_TOL from both neighbours (a tied run, or the last
    rank, may hold other positions; a -inf entry any masked or padded one).
    Returns the largest value difference."""
    if not torch.equal(torch.isneginf(vk), torch.isneginf(vr)):
        raise AssertionError(f"{what}: -inf patterns differ")
    fin = torch.isfinite(vr)
    err = float(torch.where(fin, (vk - vr).abs(), 0.0).max())
    if err > SCORE_TOL:
        raise AssertionError(f"{what}: max |diff| {err:.3g} > {SCORE_TOL}")
    gap = vr[..., :-1] - vr[..., 1:]
    iso = fin.clone()
    iso[..., 1:] &= gap > SCORE_TOL
    iso[..., :-1] &= gap > SCORE_TOL
    iso[..., -1] = False
    if not torch.equal(pk[iso], pr[iso]):
        raise AssertionError(f"{what}: tile positions differ")
    return err


def two_stage_check(torch, docs, ids, q, k, *, scale=None, i8=False,
                    tile_n=None):
    """``knn_search(two_stage=True)`` and its tile stage against the plain
    versions.  Returns (max error, tile_n, k_eff, the queries as the tile
    stage takes them)."""
    from repro_torch.core import quant
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_topk_agree

    n, dp = docs.shape
    what = f"two-stage {docs.dtype} int8-dot={i8} tile_n={tile_n}"
    qq, qs = torch.nn.functional.pad(q, (0, dp - q.shape[1])), None
    if i8:
        qqc = quant.quantize(qq, "int8")
        qq, qs = qqc.data, qqc.scale
    t_n, k_eff = (knn_ops.autotune_knn(n, dp, q.shape[0], k,
                                       docs.element_size())
                  if tile_n is None else (tile_n, min(k, tile_n)))
    vk, pk = knn_ops.knn_tile_topk(docs, ids, qq, k_eff, t_n, scale, qs)
    vr, pr = knn_ref.tile_topk(docs, ids, qq, k_eff, t_n, scale, qs)
    err = tiles_agree(torch, vk, pk, vr, pr, what)
    del vk, pk
    rv, ri = knn_ref.merge_tiles(vr, pr, ids, k)
    del vr, pr
    torch.cuda.empty_cache()
    v, i = knn_ops.knn_search(docs, ids, q, k, scale=scale, int8_dot=i8,
                              tile_n=tile_n, two_stage=True)
    assert_topk_agree(v, i, rv, ri, SCORE_TOL, what)
    del v, i, rv, ri
    torch.cuda.empty_cache()
    return err, t_n, k_eff, qq


# -------------------------------------------------------------------- knn
def knn_phase(torch, rep: Report, corpus, streams):
    import numpy as np

    from repro_torch.core import quant
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_close, assert_topk_agree

    dp = corpus.shape[1]
    q = torch.nn.functional.pad(torch.as_tensor(
        np.stack([s[0] for s in streams]), device=DEV), (0, dp - DIM_RAW - 1))
    ids = torch.arange(N_CORPUS, dtype=torch.int32, device=DEV)
    # fp32 at full N: kernel against plain, then timing
    vk, ik = knn_ops.knn_search(corpus, ids, q, KC)
    vp, ip = knn_ref.search(corpus, ids, q, KC)
    err = assert_topk_agree(vk, ik, vp, ip, SCORE_TOL, "knn fp32")
    del vp, ip
    sk = knn_ops.knn_score(corpus, ids, q)
    sp = knn_ref.score(corpus, ids, q)
    err_s = assert_close(sk, sp, SCORE_TOL, "knn_score fp32")
    del sp
    sel_v, sel_i = knn_ops.knn_select(sk, ids, KC)
    ref_v, ref_i = knn_ref.select(sk, ids, KC)
    err_sel = assert_topk_agree(sel_v, sel_i, ref_v, ref_i, 0.0,
                                "knn_select fp32")
    del ref_v, ref_i
    log(f"[kernels] knn fp32 N={N_CORPUS}: ok (max_abs_err {err:.3g})")
    b = q.shape[0]
    del sel_v, sel_i
    score_ms = timed(torch, lambda: knn_ops.knn_score(corpus, ids, q), 3)
    score_plain = timed(torch, lambda: knn_ref.score(corpus, ids, q), 2)
    score_lib = timed(torch, lambda: torch.mm(q, corpus.T), 2)
    rep.add("knn_score", err=err_s, ms=score_ms, plain_ms=score_plain,
            nbytes=N_CORPUS * (dp * 4 + 4) + b * dp * 4 + b * N_CORPUS * 4,
            ops=2 * b * N_CORPUS * dp, rate=F32_OPS, library_ms=score_lib)
    sel_ms = timed(torch, lambda: knn_ops.knn_select(sk, ids, KC), 3)
    sel_plain = timed(torch, lambda: knn_ref.select(sk, ids, KC), 2)
    sel_lib = timed(torch, lambda: torch.topk(sk, KC, dim=1), 2)
    rep.add("knn_select", err=err_sel, ms=sel_ms, plain_ms=sel_plain,
            nbytes=b * N_CORPUS * 4 + b * KC * 8, ops=0, rate=F32_OPS,
            library_ms=sel_lib)
    del sk
    torch.cuda.empty_cache()
    op_ms = timed(torch, lambda: knn_ops.knn_search(corpus, ids, q, KC), 3)
    op_plain = timed(torch, lambda: knn_ref.search(corpus, ids, q, KC), 1)
    op_lib = timed(torch, lambda: torch.topk(q @ corpus.T, KC, dim=1), 2)
    op_bound = bound(N_CORPUS * (dp * 4 + 8) + b * dp * 4 + b * KC * 8,
                     2 * b * N_CORPUS * dp, F32_OPS)
    log(f"[kernels] knn_search fp32 (one op, two launches): ms={op_ms:.4f} "
        f"plain_ms={op_plain:.4f} library_ms={op_lib:.4f} "
        f"bound_ms={op_bound[0]:.4f} ({op_bound[1]})")
    torch.cuda.empty_cache()
    # the repaired limit: k = 2048 > the old 1024
    vk, ik = knn_ops.knn_search(corpus, ids, q, 2048)
    vp, ip = knn_ref.search(corpus, ids, q, 2048)
    e2048 = assert_topk_agree(vk, ik, vp, ip, SCORE_TOL, "knn fp32 k=2048")
    del vk, ik, vp, ip
    torch.cuda.empty_cache()
    ms2048 = timed(torch, lambda: knn_ops.knn_search(corpus, ids, q, 2048), 2)
    log(f"[kernels] knn_search fp32 k=2048 N={N_CORPUS}: ok (max_abs_err "
        f"{e2048:.3g}) ms={ms2048:.4f}")
    # a single query, every miss of Algorithm 1 for one session
    q1 = q[:1].contiguous()
    s1 = knn_ops.knn_score(corpus, ids, q1)
    e1 = assert_close(s1, knn_ref.score(corpus, ids, q1), SCORE_TOL,
                      "knn_score B=1")
    ms = timed(torch, lambda: knn_ops.knn_score(corpus, ids, q1), 5)
    rep.add("knn_score_b1", err=e1, ms=ms,
            plain_ms=timed(torch, lambda: knn_ref.score(corpus, ids, q1), 3),
            nbytes=N_CORPUS * (dp * 4 + 4) + dp * 4 + N_CORPUS * 4,
            ops=2 * N_CORPUS * dp, rate=F32_OPS,
            library_ms=timed(torch, lambda: torch.mm(q1, corpus.T), 5))
    for k in (KC, PAPER_K):
        v1, i1 = knn_ops.knn_search(corpus, ids, q1, k)
        vp, ip = knn_ref.search(corpus, ids, q1, k)
        assert_topk_agree(v1, i1, vp, ip, SCORE_TOL, f"knn B=1 k={k}")
        sv, si = knn_ops.knn_select(s1, ids, k)
        rv, ri = knn_ref.select(s1, ids, k)
        if not (torch.equal(sv, rv) and torch.equal(si, ri)):
            raise AssertionError(f"knn_select B=1 k={k} != plain")
        # five readings of the select: its spread between calls
        spread = sorted(timed(torch, lambda: knn_ops.knn_select(s1, ids, k),
                              5) for _ in range(SPREAD_READINGS))
        select_ms = spread[len(spread) // 2]
        sel_plain = timed(torch, lambda: knn_ref.select(s1, ids, k), 3)
        sel_lib = timed(torch, lambda: torch.topk(s1, k, dim=1), 5)
        plain = timed(torch, lambda: knn_ref.search(corpus, ids, q1, k), 3)
        op_ms = timed(torch, lambda: knn_ops.knn_search(corpus, ids, q1, k),
                      5)
        op_lib = timed(torch, lambda: torch.topk(q1 @ corpus.T, k, dim=1), 5)
        if k == KC:
            rep.add("knn_select_b1", err=0.0, ms=select_ms,
                    plain_ms=sel_plain, nbytes=N_CORPUS * 4 + k * 8, ops=0,
                    rate=F32_OPS, library_ms=sel_lib)
        else:
            bms, by = bound(N_CORPUS * 4 + k * 8, 0, F32_OPS)
            log(f"[kernels] knn_select B=1 k={k}: ms={select_ms:.4f} "
                f"plain_ms={sel_plain:.4f} bound_ms={bms:.4f} ({by}) "
                f"library_ms={sel_lib:.4f}")
        log(f"[kernels] knn_search fp32 B=1 k={k} N={N_CORPUS}: ok; op "
            f"ms={op_ms:.4f} (knn_score {ms:.4f} + knn_select "
            f"{select_ms:.4f}, the median of {SPREAD_READINGS} readings "
            f"{[round(x, 4) for x in spread]}) plain_ms={plain:.4f} "
            f"library_ms={op_lib:.4f} (topk(q[:1] @ D.T))")
    del s1
    torch.cuda.empty_cache()
    # the score paths around the threshold beside one torch.mm and the
    # bound: the crossover, and what a wave of 9..63 misses pays
    thr = knn_ops.SCORE_GEMV_MAX_B
    cross = {}
    for bb in (1, thr, thr + 1, 16, 32, b):
        qb = q[:bb].contiguous()
        row = {}
        for gemv in ((True, False) if bb <= thr else (False,)):
            row["gemv" if gemv else "gemm"] = round(timed(
                torch, lambda: knn_ops._score(corpus, ids, qb, None, None,
                                              gemv=gemv), 3), 4)
        row["mm"] = round(timed(torch, lambda: torch.mm(qb, corpus.T), 3), 4)
        if bb == 16:
            row["plain"] = round(timed(torch, lambda: knn_ref.score(
                corpus, ids, qb), 2), 4)
        row["bound"] = round(bound(
            N_CORPUS * (dp * 4 + 4) + bb * dp * 4 + bb * N_CORPUS * 4,
            2 * bb * N_CORPUS * dp, F32_OPS)[0], 4)
        cross[f"B={bb}"] = row
        del qb
    log(f"[kernels] knn_score crossover (ms; the wrapper takes the GEMV up "
        f"to B={thr}): {json.dumps(cross)}")
    torch.cuda.empty_cache()
    bulk_search_check(torch, corpus)
    select_cases(torch)
    # quantized corpora at N_SMALL
    sub = corpus[:N_SMALL]
    for dtype, i8 in (("bf16", False), ("int8", False), ("int8", True)):
        qc = quant.quantize(sub, dtype)
        vk, ik = knn_ops.knn_search(qc.data, ids[:N_SMALL], q, KC,
                                    scale=qc.scale, int8_dot=i8)
        qq, qs = q, None
        if i8:
            qqc = quant.quantize(q, "int8")
            qq, qs = qqc.data, qqc.scale
        vp, ip = knn_ref.search(qc.data, ids[:N_SMALL], qq, KC, qc.scale, qs)
        e = assert_topk_agree(vk, ik, vp, ip, SCORE_TOL, f"knn {dtype}")
        ms = timed(torch, lambda: knn_ops.knn_search(
            qc.data, ids[:N_SMALL], q, KC, scale=qc.scale, int8_dot=i8), 3)
        rate = I8_OPS if i8 else F32_OPS
        isz = qc.data.element_size()
        bms, by = bound(N_SMALL * (dp * isz + 8) + b * dp * (1 if i8 else 4)
                        + b * KC * 8, 2 * b * N_SMALL * dp, rate)
        log(f"[kernels] knn {dtype}{' int8-dot' if i8 else ''} N={N_SMALL}: "
            f"ok (max_abs_err {e:.3g}) ms={ms:.4f} bound_ms={bms:.4f} ({by})")
        del qc, vp, ip
        torch.cuda.empty_cache()
    # the two-stage scan at N_SMALL: the tuned tile (fp32 512: a cluster
    # of 2, k_eff < k; int8-dot 1024: 4), narrow tiles (256 and 100: whole
    # tiles a block), a cluster of 16 (4096), the kept pair (8192) and 4
    # queries (a query tile mostly empty)
    for dtype, i8, tile_n, nq in (("fp32", False, None, 64),
                                  ("int8", True, None, 64),
                                  ("fp32", False, 256, 64),
                                  ("fp32", False, 100, 64),
                                  ("bf16", False, 4096, 64),
                                  ("fp32", False, 8192, 64),
                                  ("fp32", False, 512, 4)):
        qc = quant.quantize(sub, dtype)
        err, t_n, k_eff, _ = two_stage_check(
            torch, qc.data, ids[:N_SMALL], q[:nq], KC, scale=qc.scale, i8=i8,
            tile_n=tile_n)
        ms = timed(torch, lambda: knn_ops.knn_search(
            qc.data, ids[:N_SMALL], q[:nq], KC, scale=qc.scale, int8_dot=i8,
            tile_n=tile_n, two_stage=True), 3)
        log(f"[kernels] knn two-stage {dtype}{' int8-dot' if i8 else ''} "
            f"N={N_SMALL} B={nq} tile_n={t_n} k_eff={k_eff}: ok (max_abs_err "
            f"{err:.3g}) ms={ms:.4f}")
        del qc
        torch.cuda.empty_cache()


def bulk_search_check(torch, corpus):
    """``MetricIndex.search`` with 2,048 queries over the whole corpus, more
    than the ~1,450 whose (B, N) f32 scores would fit beside it unchunked:
    ids equal those of the same queries searched 64 at a time, scores
    within SCORE_TOL; its time, and its peak memory above what was
    allocated before it (the corpus), which must stay under the scratch
    budget plus the outputs and the padded queries."""
    from repro_torch.core.metric_index import MetricIndex
    from repro_torch.kernels.knn import ops as knn_ops

    index = MetricIndex(corpus, transformed=True, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(11)
    b, dp = 2048, corpus.shape[1]
    q = torch.zeros(b, dp, device=DEV)
    q[:, :DIM_RAW] = torch.nn.functional.normalize(
        torch.randn(b, DIM_RAW, generator=gen, device=DEV), dim=1)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = index.search(q, KC)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    outs = sum(t.numel() * t.element_size() for t in res)
    limit = knn_ops.SCRATCH_BUDGET + outs + q.numel() * 4
    if peak > limit:
        raise AssertionError(f"2048-query search: {peak} B above the corpus "
                             f"> {limit}")
    err = 0.0
    for lo in range(0, b, 64):
        part = index.search(q[lo:lo + 64], KC)
        if not torch.equal(part.ids, res.ids[lo:lo + 64]):
            raise AssertionError(f"2048-query search: ids of queries "
                                 f"{lo}..{lo + 63} differ from a 64-query "
                                 f"search")
        err = max(err, float((part.scores - res.scores[lo:lo + 64])
                             .abs().max()))
    if err > SCORE_TOL:
        raise AssertionError(f"2048-query search: scores differ by {err}")
    rows = knn_ops.chunk_rows(corpus.shape[0], 4 * knn_ops._select_words(
        corpus.shape[0], KC)[2])
    n = corpus.shape[0]
    bms, by = bound(n * (dp * 4 + 8) + b * dp * 4 + b * KC * 8,
                    2 * b * n * dp, F32_OPS)
    log(f"[kernels] MetricIndex.search of {b} queries over {corpus.shape[0]} "
        f"docs, k={KC}: {secs:.3f} s (bound {bms:.4f} ms, {by}) in chunks "
        f"of {rows} queries; ids equal "
        f"the 64-query searches (scores max diff {err:.3g}); peak device "
        f"memory above the corpus {peak / 1e9:.3f} GB (limit "
        f"{limit / 1e9:.3f} GB: scratch budget "
        f"{knn_ops.SCRATCH_BUDGET / 1e9:.3f} + outputs + queries)")
    del index, res, q
    torch.cuda.empty_cache()


def select_cases(torch):
    """The radix select against the plain stable top-k on synthetic (2, N)
    rows at the corpus size: equal answers, bit for bit."""
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref

    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    ids = torch.arange(N_CORPUS, dtype=torch.int32, device=DEV)
    base = torch.randn(2, N_CORPUS, generator=gen, device=DEV)
    out = {}
    for case, k in (("all_equal", KC), ("tie_across_k", KC),
                    ("half_neginf", KC), ("k2048", 2048), ("k20000", 20000)):
        s = base.clone()
        if case == "all_equal":
            s.fill_(0.25)
        elif case == "tie_across_k":         # a run of 500 at ranks 900+
            v = torch.sort(s, dim=1, descending=True).values[:, 900:901]
            s[:, torch.randperm(N_CORPUS, generator=gen,
                                device=DEV)[:500]] = v
        elif case == "half_neginf":          # -inf on half the row, and
            s[:, ::2] = float("-inf")        # a row with 10 finite scores
            s[1, 20:] = float("-inf")
        v, i = knn_ops.knn_select(s, ids, k)
        rv, ri = knn_ref.select(s, ids, k)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise AssertionError(f"knn_select {case} k={k} != plain")
        out[case] = round(timed(torch, lambda: knn_ops.knn_select(s, ids, k),
                                2), 4)
        del s, v, i, rv, ri
    log(f"[kernels] knn_select synthetic (2, {N_CORPUS}) rows equal the "
        f"plain stable top-k; ms {json.dumps(out)}")
    del base
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ A/B
def ab_phase(torch, rep: Report, corpus, streams):
    """The two-stage A/B baseline over the main path's corpus: the 64 first
    turns at k = k_c through ``knn_search(two_stage=True)`` (counted: the
    fused tile kernel and the merge's select), its peak memory above the
    corpus, against the fused search and the plain two-stage version; then
    the ``knn_tile_topk`` row at this shape, and apart: the fused tile
    kernel, the merge, the kept pair (``knn_score`` + ``knn_tile_select``)
    on the same queries, the fused tile kernel at B = 1, and the whole
    two-stage search beside the fused one."""
    import numpy as np

    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_topk_agree

    n, dp = corpus.shape
    ids = torch.arange(n, dtype=torch.int32, device=DEV)
    q = pad_to(torch, np.stack([s[0] for s in streams]), dp)
    b = q.shape[0]
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (v2, i2), launches = counted(torch, lambda: knn_ops.knn_search(
        corpus, ids, q, KC, two_stage=True))
    peak = torch.cuda.max_memory_allocated() - before
    want = {name: 0 for name in launches}
    want.update(knn_tile_topk=1, knn_select=1)
    if launches != want:
        raise AssertionError(f"[ab] launches {launches} != {want}")
    vf, i_f = knn_ops.knn_search(corpus, ids, q, KC)
    assert_topk_agree(v2, i2, vf, i_f, SCORE_TOL, "two-stage vs fused")
    del v2, i2, vf, i_f
    torch.cuda.empty_cache()
    err, tile_n, k_eff, qq = two_stage_check(torch, corpus, ids, q, KC)
    tiles = -(-n // tile_n)
    ms = timed(torch, lambda: knn_ops.knn_tile_topk(corpus, ids, qq, k_eff,
                                                    tile_n), 3)
    plain = timed(torch, lambda: knn_ref.tile_topk(corpus, ids, qq, k_eff,
                                                   tile_n), 1)
    # one query through the same kernel (every B takes its 64-query tile),
    # beside the single-query score path alone
    ms1 = timed(torch, lambda: knn_ops.knn_tile_topk(corpus, ids, qq[:1],
                                                     k_eff, tile_n), 3)
    gemv1 = timed(torch, lambda: knn_ops.knn_score(corpus, ids, qq[:1]), 3)
    plain1 = timed(torch, lambda: knn_ref.tile_topk(corpus, ids, qq[:1],
                                                    k_eff, tile_n), 2)
    torch.cuda.empty_cache()

    def library(x):
        s = torch.nn.functional.pad(torch.mm(x, corpus.T),
                                    (0, tiles * tile_n - n),
                                    value=float("-inf"))
        return torch.topk(s.view(x.shape[0], tiles, tile_n), k_eff, dim=2)

    lib = timed(torch, lambda: library(qq), 2)
    lib1 = timed(torch, lambda: library(qq[:1]), 3)
    torch.cuda.empty_cache()
    # apart: the merge of the fused kernel's candidates through the select,
    # its plain version (a stable sort of every candidate) and torch.topk
    # over the same candidate values
    tv, tp = knn_ops.knn_tile_topk(corpus, ids, qq, k_eff, tile_n)
    merge_ms = timed(torch, lambda: knn_ops.merge_tiles(tv, tp, ids, KC), 3)
    merge_plain = timed(torch, lambda: knn_ref.merge_tiles(tv, tp, ids, KC),
                        1)
    flat = tv.permute(1, 0, 2).reshape(b, tiles * k_eff)
    merge_lib = timed(torch, lambda: torch.topk(flat, KC, dim=1), 3)
    merge_bound = bound(flat.numel() * 4, 0, F32_OPS)[0]
    del tv, tp, flat
    torch.cuda.empty_cache()
    # the kept pair on the same queries: the score into the (B, N) scratch,
    # then the tile select on it
    scores = knn_ops.knn_score(corpus, ids, qq)
    score_ms = timed(torch, lambda: knn_ops.knn_score(corpus, ids, qq), 3)
    pair_ms = timed(torch, lambda: knn_ops.knn_tile_select(
        scores, k_eff, tile_n), 3)
    del scores
    torch.cuda.empty_cache()
    search_ms = timed(torch, lambda: knn_ops.knn_search(
        corpus, ids, q, KC, two_stage=True), 3)
    fused_ms = timed(torch, lambda: knn_ops.knn_search(corpus, ids, q, KC),
                     3)
    torch.cuda.empty_cache()
    log(f"[ab] knn_tile_topk apart: the fused tile kernel {ms:.3f} ms; the "
        f"merge through knn_select {merge_ms:.3f} ms (bound "
        f"{merge_bound:.3f}, bytes; its plain stable sort {merge_plain:.3f}, "
        f"torch.topk over the same candidates {merge_lib:.3f}); the kept "
        f"pair knn_score {score_ms:.3f} + knn_tile_select {pair_ms:.3f} = "
        f"{score_ms + pair_ms:.3f} ms (the same function as the fused "
        f"kernel: plain {plain:.3f}, library {lib:.3f}); the fused tile "
        f"kernel at B=1 {ms1:.3f} ms (the B=1 score alone {gemv1:.3f}; "
        f"plain {plain1:.3f}, library topk(mm.view(1, tiles, {tile_n})) "
        f"{lib1:.3f})")
    log(f"[ab] two-stage knn_search {search_ms:.3f} ms, the fused search "
        f"{fused_ms:.3f} ms on the same queries; peak device memory of the "
        f"two-stage search above the corpus {peak / 1e9:.3f} GB (its "
        f"candidates {8 * b * tiles * k_eff / 1e9:.3f} GB)")
    rep.add("knn_tile_topk", err=err, ms=ms, plain_ms=plain,
            nbytes=n * (dp * 4 + 8) + b * dp * 4 + tiles * b * k_eff * 8,
            ops=2 * b * n * dp, rate=F32_OPS, library_ms=lib)
    log(f"[ab] two-stage knn_search (tile_n={tile_n}, k_eff={k_eff}, "
        f"{tiles} tiles) over {n} docs at B={b}, k={KC}: equals the fused "
        f"search and the plain two-stage version; launches {launches}")
    return launches


# ------------------------------------------------------------ main path
def serve(torch, corpus, streams, *, n_sessions, k_c, capacity, device,
          waves_seen=None, encoder=None, reask=True):
    """Serve every session's turns through SessionManager, round by round,
    then (``reask``) one round re-asking each last turn.  Returns the
    engine.  Each wave appends (misses, bucket, probe span s, fill span s)
    to ``waves_seen`` when given.  With an ``encoder`` the turns are token
    rows of one width."""
    import numpy as np

    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.serve.router import ShardedRouter
    from repro_torch.serve.session import BatchedEngine, SessionManager

    ids = torch.arange(corpus.shape[0], dtype=torch.int32, device=device)
    with ShardedRouter([DeviceShard(corpus, ids, device=device,
                                    dtype="fp32")], deadline_s=300) as router:
        engine = BatchedEngine(router, corpus, dim=DIM_RAW + 1,
                               n_sessions=n_sessions, k=K, k_c=k_c,
                               epsilon=EPS, capacity=capacity, dtype="fp32",
                               device=device, encoder=encoder)
        if waves_seen is not None:
            fill_wave = engine.fill_wave

            def logged(ws):     # the wave's misses are the kNN search's B
                out = fill_wave(ws)
                spans = [t.spans for t in out if hasattr(t, "spans")]
                waves_seen.append((int(np.asarray(ws.need).sum()), ws.bucket,
                                   ws.probe_s, spans[0].insert_s if spans
                                   else float("nan")))
                return out
            engine.fill_wave = logged
        rounds = [[s[t] for s in streams[:n_sessions]]
                  for t in range(streams[0].shape[0])]
        if reask:
            rounds.append([s[-1] for s in streams[:n_sessions]])
        with SessionManager(engine) as mgr:
            for key in range(n_sessions):
                mgr.open(key)
            for wave in rounds:
                futs = [mgr.submit(key, q) for key, q in enumerate(wave)]
                for f in futs:
                    f.result(timeout=600)
    return engine


def check_turns(sessions, n_turns):
    """Every session's turns (lists of ``EngineTurn``) are well formed."""
    import numpy as np
    for s, turns in enumerate(sessions):
        if len(turns) != n_turns:
            raise AssertionError(f"session {s}: {len(turns)} turns")
        for t in turns:
            if t.ids.shape != (K,) or not np.isfinite(t.scores).all() \
                    or (np.diff(t.scores) > 0).any():
                raise AssertionError(f"session {s}: malformed turn {t}")


def main_phase(torch, corpus, streams):
    import numpy as np

    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_topk_agree

    n_turns = streams[0].shape[0] + 1
    # small input first: the same engine on the card and on the CPU path
    small = [s[:4] for s in streams[:8]]
    world_docs = corpus[:60_000]
    kw = dict(n_sessions=8, k_c=100, capacity=1600)
    gpu = serve(torch, world_docs, small, device=DEV, **kw)
    cpu = serve(torch, world_docs.cpu(), small, device="cpu", **kw)
    for s in range(8):
        for a, b in zip(gpu.turns[s], cpu.turns[s]):
            if a.tier != b.tier:
                raise AssertionError(f"small input: session {s} tier "
                                     f"{a.tier} != {b.tier} on the CPU")
            assert_topk_agree(a.scores[None], a.ids[None], b.scores[None],
                              b.ids[None], SCORE_TOL, f"small session {s}")
    log(f"[main] small input (8 sessions x 5 turns, 60000 docs): card == "
        f"CPU path, hit rate {gpu.hit_rate():.4f}")
    del gpu, cpu
    torch.cuda.empty_cache()

    waves: list = []
    before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, launches = counted(torch, lambda: serve(
        torch, corpus, streams, n_sessions=S, k_c=KC, capacity=CAPACITY,
        device=DEV, waves_seen=waves))
    wall = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    sizes = sorted(w[0] for w in waves if w[0])
    miss, clean = len(sizes), len(waves) - len(sizes)
    got = {n: launches.get(n, 0) for n in KERNELS}
    want = {"cache_probe": len(waves), "knn_score": miss, "knn_select": miss,
            "wave_insert_query": miss, "wave_query_topk": clean,
            "wave_insert_scatter": 0, "probe_rhat": 0, "knn_tile_topk": 0,
            "embedding_bag": 0}
    if got != want or miss == 0 or clean == 0:
        raise AssertionError(f"launches {got} != {want} for {miss} waves "
                             f"with misses and {clean} without")
    ops = got["cache_probe"] + got["knn_score"] + got["wave_insert_query"] \
        + got["wave_query_topk"]
    if ops != 3 * miss + 2 * clean:
        raise AssertionError(f"{ops} launches for {miss} + {clean} waves")
    log(f"[main] {len(waves)} waves: {miss} with misses (3 launches each), "
        f"{clean} without (2 each); launches {got}")
    thr = knn_ops.SCORE_GEMV_MAX_B
    log(f"[main] miss-wave sizes (the kNN search's B, sum {sum(sizes)}): "
        f"{sizes}; GEMV (B <= {thr}): "
        f"{sum(w <= thr for w in sizes)} waves, GEMM at B {thr + 1}..63: "
        f"{sum(thr < w < 64 for w in sizes)}, at B >= 64: "
        f"{sum(w >= 64 for w in sizes)}")
    probe = np.array([w[2] for w in waves]) * 1e3
    fill = np.array([w[3] for w in waves]) * 1e3
    missed = np.array([w[0] > 0 for w in waves])
    log(f"[main] wave buckets (sessions after padding, in order): "
        f"{[w[1] for w in waves]}; probe span p50 "
        f"{np.percentile(probe, 50):.3f} ms; fill span p50 "
        f"{np.percentile(fill, 50):.3f} ms (waves with misses "
        f"{np.percentile(fill[missed], 50):.3f}, without "
        f"{np.percentile(fill[~missed], 50):.3f})")
    check_turns(engine.turns, n_turns)
    # every miss turn answers the exact top-k of the whole corpus
    miss_q, miss_t = [], []
    for s, turns in enumerate(engine.turns):
        for t, turn in enumerate(turns):
            if turn.tier == "backend":
                miss_q.append(streams[s][min(t, n_turns - 2)])
                miss_t.append(turn)
    dp = corpus.shape[1]
    ids = torch.arange(corpus.shape[0], dtype=torch.int32, device=DEV)
    for lo in range(0, len(miss_q), 64):
        q = torch.nn.functional.pad(torch.as_tensor(
            np.stack(miss_q[lo:lo + 64]), device=DEV),
            (0, dp - DIM_RAW - 1))
        v, i = knn_ref.search(corpus, ids, q, K)
        got_v = np.stack([t.scores for t in miss_t[lo:lo + 64]])
        got_i = np.stack([t.ids for t in miss_t[lo:lo + 64]])
        assert_topk_agree(got_v, got_i, v, i, SCORE_TOL, "miss turns")
        torch.cuda.empty_cache()
    summ = engine.telemetry.summary()
    conv = [t.hit for turns in engine.turns for t in turns[1:-1]]
    log(f"[main] {S} sessions x {n_turns} turns over {corpus.shape[0]} docs "
        f"in {wall:.2f} s; {len(miss_t)} miss turns match the exact search; "
        f"hit rate {engine.hit_rate():.4f} (turns 2-10 of the conversations "
        f"alone: {np.mean(conv):.4f}); tiers {engine.tier_counts()}")
    log("[main] telemetry (s) " + json.dumps(
        {"turn": summ["spans"]["total_s"], "tiers": summ["tiers"],
         "wave_size": summ["wave_size"],
         "wave_service": summ["wave_service_s"]}))
    log(f"[main] peak device memory over the serve {serve_peak / 1e9:.2f} "
        f"GB (the run's peak before it: {before / 1e9:.2f} GB; after it, "
        f"with the exact check of the miss turns: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    return launches


# ------------------------------------------------------------ tiered wave
def zipf_generation(torch, world, rng, n_sessions, jitter=ZIPF_JITTER):
    """One generation of ``serve_bench.bench_zipf``'s traffic: each session
    draws a conversation from Zipf(ZIPF_ALPHA) popularity and asks its
    turns with a Gaussian jitter on the raw queries (numpy, from ``rng``);
    returns each session's transformed stream (host f32)."""
    import numpy as np

    from repro_torch.core.embedding import transform_queries

    convs = world.conversations
    pop = np.arange(1, len(convs) + 1, dtype=np.float64) ** -ZIPF_ALPHA
    pop /= pop.sum()
    pick = rng.choice(len(convs), size=n_sessions, p=pop)
    return [transform_queries(torch.as_tensor(
        convs[c].queries + jitter * rng.standard_normal(
            convs[c].queries.shape), dtype=torch.float32)).numpy()
        for c in pick]


def wave_kinds(torch, before, after, tiers, promoted):
    """The launches of one tiered wave by kind, checked against the
    contract: L1 probe, then the L2 probe when some row is left after the
    memo, the kNN pair when some row needs the back end, the fused
    insert+query when some row inserts (else the query), the L2 query when
    some row hits L2, and one insert per admission sub-wave."""
    got = {n: after.get(n, 0) - before.get(n, 0) for n in KERNELS}
    residual = bool(tiers & {"l2", "backend"})
    miss = "backend" in tiers
    want = {n: 0 for n in KERNELS}
    want.update(cache_probe=1 + residual, knn_score=int(miss),
                knn_select=int(miss),
                wave_insert_query=int(tiers != {"l1"}),
                wave_query_topk=int(tiers == {"l1"}) + int("l2" in tiers))
    flush = got["wave_insert_scatter"]
    if (flush > 0) != (promoted > 0) or flush > promoted:
        raise AssertionError(f"{flush} admission inserts for {promoted} "
                             f"promotions")
    want["wave_insert_scatter"] = flush
    if got != want:
        raise AssertionError(f"tiered wave (tiers {sorted(tiers)}): "
                             f"launches {got} != {want}")
    kinds = tuple(n for n in ("cache_probe", "knn_score",
                              "wave_insert_query", "wave_query_topk",
                              "wave_insert_scatter")
                  for _ in range(got[n]))
    return kinds, {"cache_probe_l2": int(residual),
                   "wave_query_topk_l2": int("l2" in tiers),
                   "wave_insert_scatter_l2": flush}


def counts_now(torch):
    from repro_torch.kernels import dispatch
    field = "launches" if DEV == "cuda" else "calls"
    return {n: getattr(c, field) for n, c in dispatch.counters().items()}


def tiered_serve(torch, docs, ci, world, *, device, n_sessions, k_c,
                 capacity, tier_cap, width, generations, turns, seed):
    """The tiered engine (``SharedTier`` with the cluster index, cluster
    prefetch) over one ``DeviceShard`` of ``docs``, serving
    ``generations`` of Zipf traffic in fixed rounds (``answer_batch`` over
    every session, as ``serve_bench`` drives it).  Returns (engine, every
    wave's turns over all generations, the miss turns' queries and turns,
    every wave's launch kinds, the L2 launches by row)."""
    import numpy as np

    from repro_torch.core.shared import SharedTier
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.serve.router import ShardedRouter
    from repro_torch.serve.session import BatchedEngine

    rng = np.random.default_rng(seed)
    ids = torch.arange(docs.shape[0], dtype=torch.int32, device=device)
    sids = list(range(n_sessions))
    waves, misses, kinds = [], [], []
    l2 = {"cache_probe_l2": 0, "wave_query_topk_l2": 0,
          "wave_insert_scatter_l2": 0}
    with ShardedRouter([DeviceShard(docs, ids, device=device,
                                    dtype="fp32")], deadline_s=300) as router:
        tier = SharedTier(dim=DIM_RAW + 1, n_shards=TIER_SHARDS,
                          capacity=tier_cap, memo_sim=MEMO_SIM, cluster=ci,
                          device=device)
        engine = BatchedEngine(router, docs, dim=DIM_RAW + 1,
                               n_sessions=n_sessions, k=K, k_c=k_c,
                               epsilon=EPS, capacity=capacity, dtype="fp32",
                               shared=tier, cluster=ci, prefetch_width=width,
                               device=device)
        for _g in range(generations):
            streams = zipf_generation(torch, world, rng, n_sessions)
            for s in sids:
                engine.start_session(s)
            for t in range(turns):
                qs = [streams[s][t] for s in sids]
                before, promoted = counts_now(torch), tier.n_promoted
                out = engine.answer_batch(sids, qs)
                if device == "cuda":
                    torch.cuda.synchronize()
                    kind, extra = wave_kinds(
                        torch, before, counts_now(torch),
                        {x.tier for x in out}, tier.n_promoted - promoted)
                    kinds.append(kind)
                    for name, v in extra.items():
                        l2[name] += v
                waves.append(out)
                misses += [(q, x) for q, x in zip(qs, out)
                           if x.tier == "backend"]
    return engine, waves, misses, kinds, l2


def tier_stats(engine, waves):
    """The tier of every turn of every generation (``engine.tier_counts``
    sees only the last one: ``start_session`` clears a session's turns)
    and the shared tier's and prefetch's counters."""
    t = engine.shared
    tiers = {"l1": 0, "l2": 0, "l2_reuse": 0, "backend": 0}
    for out in waves:
        for x in out:
            tiers[x.tier] += 1
    return {"tiers": tiers,
            "n_promoted": t.n_promoted, "n_memo_served": t.n_memo_served,
            "n_offered": t.n_offered, "prefetch": engine.prefetch_stats()}


def build_twice(torch, index, **kw):
    """Two cluster builds over ``index`` (the first one counted as a path);
    both must be bit-identical.  Returns (index, seconds each, launches)."""
    from repro_torch.core.cluster import build_cluster_index

    secs = []
    t0 = time.perf_counter()
    ci, launches = counted(torch, lambda: build_cluster_index(index, **kw))
    secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    again = build_cluster_index(index, **kw)
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
    for f in ("centroids", "assign", "member_offsets", "member_ids",
              "near_ids", "near_d"):
        a, b = getattr(ci, f), getattr(again, f)
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"two cluster builds differ in {f}")
    if ci.n_iters != again.n_iters:
        raise AssertionError("two cluster builds took different iterations")
    return ci, secs, launches


def tiered_phase(torch, corpus, world):
    """The tiered wave: small input card == CPU, then the full corpus (two
    bit-identical cluster builds, the Zipf serve, the exact check of every
    miss turn), then the chaos replay.  Returns ({path: launches}, the
    launches of the tiered kernel rows, what their timing needs)."""
    import numpy as np

    from repro_torch.core.metric_index import MetricIndex
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_topk_agree

    import gc

    t_phase = time.perf_counter()
    gc.collect()        # an earlier phase's engine may sit in a ref cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dim = DIM_RAW + 1
    # small input first: one cluster index, the engine on the card and on
    # the CPU path over the 60,000 world documents
    world_docs = corpus[:60_000]
    small_ci = MetricIndex(world_docs, transformed=True, dim=dim,
                           device=DEV).cluster(16, iters=10, max_width=64)
    kw = dict(ci=small_ci, world=world, n_sessions=8, k_c=100,
              capacity=1600, tier_cap=800, width=32, generations=2, turns=4,
              seed=SEED + 7)
    gpu, rec_gpu, *_ = tiered_serve(torch, world_docs, device=DEV, **kw)
    cpu, rec_cpu, *_ = tiered_serve(torch, world_docs.cpu(), device="cpu",
                                    **kw)
    for w, (wa, wb) in enumerate(zip(rec_gpu, rec_cpu)):
        for s, (a, b) in enumerate(zip(wa, wb)):
            if a.tier != b.tier:
                raise AssertionError(f"[tiered] small wave {w} session {s}: "
                                     f"tier {a.tier} != {b.tier} on the CPU")
            assert_topk_agree(a.scores[None], a.ids[None], b.scores[None],
                              b.ids[None], SCORE_TOL,
                              f"[tiered] small wave {w} session {s}")
    small = tier_stats(gpu, rec_gpu)
    if small != tier_stats(cpu, rec_cpu):
        raise AssertionError(f"[tiered] small input counters {small} != "
                             f"{tier_stats(cpu, rec_cpu)}")
    log(f"[tiered] small input (8 sessions x 2 generations x 4 turns, 60000 "
        f"docs, 16 clusters): card == CPU path; {json.dumps(small)}")
    del gpu, cpu, small_ci
    torch.cuda.empty_cache()

    # full size: the cluster index over the whole corpus, twice
    index = MetricIndex(corpus, transformed=True, dim=dim, device=DEV)
    if index.doc_emb.data_ptr() != corpus.data_ptr():
        raise AssertionError("the MetricIndex copied the corpus")
    ci, secs, build_launches = build_twice(
        torch, index, n_clusters=N_CLUSTERS, iters=CLUSTER_ITERS,
        max_width=MAX_WIDTH, query_chunk=ASSIGN_CHUNK)
    log(f"[tiered] ClusterIndex over {index.n_docs} docs: {ci.n_clusters} "
        f"clusters, {ci.n_iters} iterations (at most {CLUSTER_ITERS}), "
        f"max_width {ci.max_width}, query_chunk {ASSIGN_CHUNK}; built in "
        f"{secs[0]:.2f} s and again in {secs[1]:.2f} s, bit-identical; "
        f"sizes min {int(ci.sizes.min())} max {int(ci.sizes.max())}; "
        f"launches {build_launches}")

    t0 = time.perf_counter()
    turns = streams_turns(world)
    before_serve = torch.cuda.memory_allocated()
    (engine, waves, misses, kinds, l2), launches = counted(torch, lambda: tiered_serve(
        torch, corpus, ci, world, device=DEV, n_sessions=S, k_c=KC,
        capacity=CAPACITY, tier_cap=TIER_CAP, width=PREFETCH_WIDTH,
        generations=GENERATIONS, turns=turns, seed=SEED))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    turns_all = [t for out in waves for t in out]
    for w, out in enumerate(waves):
        for s, t in enumerate(out):
            if t.ids.shape != (K,) or not np.isfinite(t.scores).all() \
                    or (np.diff(t.scores) > 0).any():
                raise AssertionError(f"[tiered] wave {w} session {s}: "
                                     f"malformed turn")
    stats = tier_stats(engine, waves)
    if stats["tiers"]["l2"] + stats["tiers"]["l2_reuse"] == 0:
        raise AssertionError("[tiered] no turn was served by the L2 tier")
    hist: dict = {}
    for k in kinds:
        key = " + ".join(f"{n} x{k.count(n)}" if k.count(n) > 1 else n
                         for n in dict.fromkeys(k))
        hist[key] = hist.get(key, 0) + 1
    log(f"[tiered] {S} sessions x {GENERATIONS} generations x {turns} turns "
        f"= {len(turns_all)} turns (Zipf alpha {ZIPF_ALPHA}, jitter "
        f"{ZIPF_JITTER}) over {corpus.shape[0]} docs in {wall:.2f} s: "
        f"{json.dumps(stats)}")
    log(f"[tiered] launches per wave by kind, as the contract says "
        f"({len(kinds)} waves; wave_insert_scatter once per admission "
        f"sub-wave): {json.dumps(hist)}; path total {launches}")
    lat = np.array([t.latency_s for t in turns_all])
    log(f"[tiered] turn p50 {np.percentile(lat, 50):.5f} s, p99 "
        f"{np.percentile(lat, 99):.5f} s (all {len(turns_all)} turns); peak "
        f"device memory above the corpus {(peak - corpus.numel() * 4) / 1e9:.3f} GB "
        f"(held before the phase, corpus included: {held / 1e9:.3f} GB; "
        f"before the serve {before_serve / 1e9:.3f} GB)")
    if peak - corpus.numel() * 4 > 10e9:
        raise AssertionError("[tiered] peak memory above the corpus over "
                             "10 GB")
    # every miss turn answers the exact top-k of the whole corpus
    dp = corpus.shape[1]
    ids = torch.arange(corpus.shape[0], dtype=torch.int32, device=DEV)
    for lo in range(0, len(misses), 64):
        part = misses[lo:lo + 64]
        v, i = knn_ref.search(corpus, ids, pad_to(
            torch, np.stack([q for q, _ in part]), dp), K)
        assert_topk_agree(np.stack([t.scores for _, t in part]),
                          np.stack([t.ids for _, t in part]), v, i,
                          SCORE_TOL, "[tiered] miss turns")
        del v, i
        torch.cuda.empty_cache()
    log(f"[tiered] {len(misses)} miss turns match the exact search")
    rows = {**l2, "wave_insert_query_wide": launches["wave_insert_query"],
            "knn_score_tables": 1, "knn_select_tables": 1,
            "knn_score_assign": build_launches["knn_score"] - 1,
            "knn_select_assign": build_launches["knn_select"] - 1}
    chaos = chaos_run(torch, corpus, world)
    log(f"[tiered] phase in {time.perf_counter() - t_phase:.1f} s (both "
        f"cluster builds included)")
    return {"cluster": build_launches, "tiered": launches,
            "chaos": chaos}, rows, (ci, engine)


def streams_turns(world) -> int:
    return int(world.conversations[0].queries.shape[0])


def chaos_run(torch, corpus, world):
    """``serve_bench.bench_chaos`` on the card: 4 ``DeviceShard``s over row
    views of the corpus under ``chaos_plan(4)`` behind a router with
    breakers, the tiered engine (``SharedTier(ttl_waves=3)``,
    ``validate_every=4``), 8 sessions x 10 rounds.  Returns its launches."""
    import numpy as np

    from repro_torch.core.embedding import transform_queries
    from repro_torch.core.shared import SharedTier
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.serve.faults import chaos_plan
    from repro_torch.serve.router import ShardedRouter
    from repro_torch.serve.session import BatchedEngine
    from repro_torch.serve.telemetry import ServeTelemetry

    n, n_s, k_c, spike = corpus.shape[0], CHAOS_SESSIONS, 50, 0.02
    rng = np.random.default_rng(SEED + CHAOS_SEED)
    bounds = np.linspace(0, n, TIER_SHARDS + 1).astype(int)
    shards = [DeviceShard(corpus[lo:hi], torch.arange(
        lo, hi, dtype=torch.int32, device=DEV), device=DEV, dtype="fp32")
        for lo, hi in zip(bounds[:-1], bounds[1:])]
    if any(s.docs.data_ptr() != corpus[lo].data_ptr()
           for s, lo in zip(shards, bounds)):
        raise AssertionError("[chaos] a shard copied its rows")
    plan = chaos_plan(TIER_SHARDS, seed=SEED + CHAOS_SEED, spike_s=spike)
    telemetry = ServeTelemetry()
    total = answered = warm_total = warm_answered = corrupt = degraded = 0
    t0 = time.perf_counter()

    def run():
        nonlocal total, answered, warm_total, warm_answered, corrupt
        nonlocal degraded
        with ShardedRouter(plan.wrap(shards), deadline_s=2.0,
                           hedge_after_s=spike / 2, n_docs=n,
                           max_retries=1, backoff_base_s=0.002,
                           breaker_window=8, breaker_fail_rate=0.5,
                           breaker_min_calls=2, breaker_cooldown_s=0.25,
                           telemetry=telemetry) as router:
            tier = SharedTier(dim=DIM_RAW + 1, n_shards=TIER_SHARDS,
                              capacity=max(8 * k_c, 1024), memo_sim=MEMO_SIM,
                              ttl_waves=3, device=DEV)
            engine = BatchedEngine(router, corpus, dim=DIM_RAW + 1,
                                   n_sessions=n_s, k=K, k_c=k_c,
                                   epsilon=EPS, capacity=4 * k_c,
                                   dtype="fp32", shared=tier,
                                   telemetry=telemetry, validate_every=4,
                                   device=DEV)
            convs = world.conversations
            for _r in range(CHAOS_ROUNDS):
                streams = [transform_queries(torch.as_tensor(
                    convs[s].queries + 0.1 * rng.standard_normal(
                        convs[s].queries.shape), dtype=torch.float32)).numpy()
                    for s in range(n_s)]
                for s in range(n_s):
                    engine.start_session(s)
                for t in range(streams[0].shape[0]):
                    try:
                        out = engine.answer_batch(
                            list(range(n_s)), [x[t] for x in streams])
                    except TimeoutError:
                        out = [None] * n_s
                    for turn in out:
                        total += 1
                        warm_total += t > 0
                        if turn is None or isinstance(turn, Exception):
                            continue
                        answered += 1
                        warm_answered += t > 0
                        if turn.ids.size and (
                                (turn.ids < 0).any() or (turn.ids >= n).any()
                                or not np.isfinite(turn.scores).all()):
                            corrupt += 1
                        degraded += turn.degraded
            return router.stats, tier, engine

    (stats, tier, engine), launches = counted(torch, run)
    rec = {"turns": total, "availability": answered / max(total, 1),
           "warm_availability": warm_answered / max(warm_total, 1),
           "corrupt_served": corrupt, "degraded_turns": degraded,
           "breaker_opens": stats.breaker_opens,
           "breaker_closes": stats.breaker_closes,
           "rejected_answers": stats.rejected, "shed": stats.shed,
           "stale_served": tier.n_stale_served,
           "quarantined": engine.quarantined,
           "injected_faults": [w.faults for w in plan.wrapped],
           "seconds": time.perf_counter() - t0}
    log(f"[chaos] {n_s} sessions x {CHAOS_ROUNDS} rounds over 4 shards of "
        f"the corpus under chaos_plan(4): {json.dumps(rec)}; launches "
        f"{launches}")
    if corrupt or rec["warm_availability"] < 0.99 \
            or stats.breaker_opens < 1 or stats.breaker_closes < 1:
        raise AssertionError(f"[chaos] gate failed: {rec}")
    return launches


def tiered_kernels(torch, rep: Report, corpus, ci, engine, world):
    """The kernels at the tiered path's new shapes against their plain
    versions, timed: the k-means assignment (``ASSIGN_CHUNK`` corpus rows
    against the 64 centroids, k = 1), the neighbour tables (the centroids
    over the corpus, k = ``MAX_WIDTH``), the L2 probe and query over the
    served tier's gathered shard rows (S = 64), the admission insert (S =
    4 shard rows of k_c + width rows) and the widened fill (S = 64, k_c +
    width rows)."""
    import numpy as np

    from repro_torch.core import cache_ops as tc
    from repro_torch.kernels.cache_probe import ops as probe_ops
    from repro_torch.kernels.cache_probe import ref as probe_ref
    from repro_torch.kernels.cache_wave import ops as wave_ops
    from repro_torch.kernels.cache_wave import ref as wave_ref
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_close, assert_topk_agree

    n, dp = corpus.shape
    kc = ci.n_clusters
    cents = tc.pad_features(torch.as_tensor(ci.centroids, device=DEV), dp)
    cids = torch.arange(kc, dtype=torch.int32, device=DEV)
    ids = torch.arange(n, dtype=torch.int32, device=DEV)
    # the assignment: the corpus's first chunk of rows as queries
    q = corpus[:ASSIGN_CHUNK]
    b = q.shape[0]
    sk = knn_ops.knn_score(cents, cids, q)
    err = assert_close(sk, knn_ref.score(cents, cids, q), SCORE_TOL,
                       "knn_score assignment")
    vk, ik = knn_ops.knn_select(sk, cids, 1)
    vr, ir = knn_ref.select(sk, cids, 1)
    if not (torch.equal(vk, vr) and torch.equal(ik, ir)):
        raise AssertionError("knn_select k=1 != plain")
    if not np.array_equal(ik[:, 0].cpu().numpy(), ci.assign[:b]):
        raise AssertionError("the assignment differs from the index's")
    rep.add("knn_score_assign", err=err,
            ms=timed(torch, lambda: knn_ops.knn_score(cents, cids, q), 20),
            plain_ms=timed(torch, lambda: knn_ref.score(cents, cids, q), 20),
            nbytes=b * dp * 4 + kc * (dp * 4 + 4) + b * kc * 4,
            ops=2 * b * kc * dp, rate=F32_OPS,
            library_ms=timed(torch, lambda: torch.mm(q, cents.T), 20))
    rep.add("knn_select_assign", err=0.0,
            ms=timed(torch, lambda: knn_ops.knn_select(sk, cids, 1), 20),
            plain_ms=timed(torch, lambda: knn_ref.select(sk, cids, 1), 20),
            nbytes=b * kc * 4 + b * 8, ops=0, rate=F32_OPS,
            library_ms=timed(torch, lambda: torch.max(sk, 1), 20))
    op = timed(torch, lambda: knn_ops.knn_search(cents, cids, q, 1), 20)
    lib = timed(torch, lambda: torch.max(q @ cents.T, 1), 20)
    log(f"[kernels] assignment B={b} N={kc} k=1 (one op, two launches): "
        f"ms={op:.4f} library_ms={lib:.4f} (torch.max(q @ C.T, 1)); "
        f"{int(np.ceil(n / ASSIGN_CHUNK))} such ops an iteration")
    del sk
    # the neighbour tables: the centroids over the whole corpus
    sk = knn_ops.knn_score(corpus, ids, cents)
    err = assert_close(sk, knn_ref.score(corpus, ids, cents), SCORE_TOL,
                       "knn_score tables")
    vk, ik = knn_ops.knn_select(sk, ids, MAX_WIDTH)
    vr, ir = knn_ref.select(sk, ids, MAX_WIDTH)
    if not (torch.equal(vk, vr) and torch.equal(ik, ir)):
        raise AssertionError(f"knn_select k={MAX_WIDTH} != plain")
    if not np.array_equal(ik.cpu().numpy(), ci.near_ids):
        raise AssertionError("the neighbour tables differ from the index's")
    rep.add("knn_score_tables", err=err,
            ms=timed(torch, lambda: knn_ops.knn_score(corpus, ids, cents), 3),
            plain_ms=timed(torch, lambda: knn_ref.score(corpus, ids, cents),
                           2),
            nbytes=n * (dp * 4 + 4) + kc * dp * 4 + kc * n * 4,
            ops=2 * kc * n * dp, rate=F32_OPS,
            library_ms=timed(torch, lambda: torch.mm(cents, corpus.T), 2))
    rep.add("knn_select_tables", err=0.0,
            ms=timed(torch, lambda: knn_ops.knn_select(sk, ids, MAX_WIDTH),
                     3),
            plain_ms=timed(torch, lambda: knn_ref.select(sk, ids, MAX_WIDTH),
                           2),
            nbytes=kc * n * 4 + kc * MAX_WIDTH * 8, ops=0, rate=F32_OPS,
            library_ms=timed(torch, lambda: torch.topk(sk, MAX_WIDTH, 1), 2))
    del sk, vr, ir
    torch.cuda.empty_cache()
    op = timed(torch, lambda: knn_ops.knn_search(corpus, ids, cents,
                                                 MAX_WIDTH), 3)
    lib = timed(torch, lambda: torch.topk(cents @ corpus.T, MAX_WIDTH, 1), 2)
    log(f"[kernels] neighbour tables B={kc} N={n} k={MAX_WIDTH} (one op): "
        f"ms={op:.4f} library_ms={lib:.4f} (torch.topk(q @ D.T, "
        f"{MAX_WIDTH}))")
    torch.cuda.empty_cache()

    # the L2 probe and query over the served tier's gathered shard rows
    tier = engine.shared
    psi = torch.as_tensor(np.stack([s[0] for s in zipf_generation(
        torch, world, np.random.default_rng(SEED + 11), S)]), device=DEV)
    shards = tier.route(psi.cpu().numpy())
    sub = tier.shards.gather(shards, payload=False)
    qmax = tier.cfg.max_queries
    args = (sub.q_emb, psi, sub.q_radius, sub.n_queries, EPS)
    got = probe_ops.cache_probe_batched(*args, q_scale=sub.q_scale,
                                        max_queries=qmax)
    want = probe_ref.lowquality(sub.q_emb, psi, sub.q_radius, sub.n_queries,
                                EPS, sub.q_scale, qmax)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
        raise AssertionError("L2 probe: hit / nearest differ from plain")
    live_m = torch.isfinite(want[1])
    err = assert_close(torch.where(live_m, got[1], 0.0),
                       torch.where(live_m, want[1], 0.0), RHAT_TOL,
                       "L2 probe best_r")
    live = int(sub.n_queries.clamp(0, qmax).sum())
    rep.add("cache_probe_l2", err=err,
            ms=timed_device(torch, lambda: probe_ops.cache_probe_batched(
                *args, q_scale=sub.q_scale, max_queries=qmax), 200),
            plain_ms=timed(torch, lambda: probe_ref.lowquality(
                sub.q_emb, psi, sub.q_radius, sub.n_queries, EPS,
                sub.q_scale, qmax), 50),
            nbytes=live * (dp * 4 + 8) + S * ((DIM_RAW + 1) * 4 + 4 + 9),
            ops=2 * live * dp, rate=F32_OPS)
    rows = tier.shards.wave_rows(shards)
    psi_p = tc.pad_features(psi, dp)
    payload = tier.state.doc_emb
    vk, ik, _ = wave_ops.wave_query_topk(payload, sub.doc_ids,
                                         sub.doc_scale, psi_p, K, rows)
    vr, ir, _ = wave_ref.query_topk(payload, sub.doc_ids, sub.doc_scale,
                                    psi_p, K, rows)
    err = assert_topk_agree(vk, ik, vr, ir, SCORE_TOL, "L2 query")
    cp = tier.cfg.phys_capacity
    distinct = len(set(shards.tolist()))
    rep.add("wave_query_topk_l2", err=err,
            ms=timed_device(torch, lambda: wave_ops.wave_query_topk(
                payload, sub.doc_ids, sub.doc_scale, psi_p, K, rows), 50),
            plain_ms=timed(torch, lambda: wave_ref.query_topk(
                payload, sub.doc_ids, sub.doc_scale, psi_p, K, rows), 10),
            nbytes=distinct * cp * (dp * 4 + 8) + S * dp * 4 + S * K * 12,
            ops=2 * S * cp * dp, rate=F32_OPS)
    log(f"[kernels] L2 rows: {S} wave rows over {distinct} distinct shards "
        f"(capacity {tier.cfg.capacity}, {live} live records of at most "
        f"{qmax} a row, n_docs {tier.n_docs.tolist()})")
    del sub
    # the admission insert: the 4 shard rows, k_c + width rows each
    width = KC + PREFETCH_WIDTH
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 13)
    st = tc.CacheState(*(x.clone() for x in tier.state))
    srows = torch.arange(TIER_SHARDS, dtype=torch.int32, device=DEV)
    new = torch.nn.functional.normalize(torch.randn(
        TIER_SHARDS, width, DIM_RAW + 1, generator=gen, device=DEV), dim=2)
    new_ids = (10 ** 7 + torch.arange(TIER_SHARDS * width, device=DEV)) \
        .view(TIER_SHARDS, width).to(torch.int32)
    old = st.doc_ids[:, :width:4]            # some already cached: dedup
    new_ids[:, ::4] = torch.where(old >= 0, old, new_ids[:, ::4])
    ipsi = torch.nn.functional.normalize(torch.randn(
        TIER_SHARDS, DIM_RAW + 1, generator=gen, device=DEV), dim=1)
    _keep, pos, _d, _n = tc.insert_positions(st, tier.cfg, ipsi, new_ids)
    ins = (tc.pad_features(new, dp), torch.ones(TIER_SHARDS, width,
                                                device=DEV),
           new_ids, pos, tc.pad_features(ipsi, dp),
           torch.ones(TIER_SHARDS, device=DEV),
           torch.full((TIER_SHARDS,), 0.3, device=DEV),
           torch.ones(TIER_SHARDS, dtype=torch.bool, device=DEV),
           torch.remainder(st.n_queries, qmax), st.step.clone())

    def lv(x):
        return (x.doc_emb, x.doc_ids, x.doc_stamp, x.doc_scale, x.q_emb,
                x.q_radius, x.q_scale)
    sk = tc.CacheState(*(x.clone() for x in st))
    wave_ops.wave_insert_scatter(*lv(sk), *ins, rows=srows)
    wave_ref.insert_scatter(*lv(st), *ins, rows=srows)
    for f, x, y in zip(tc.CacheState._fields, sk, st):
        if not torch.equal(x, y):
            raise AssertionError(f"admission insert: leaf {f} differs")
    kept = int((pos < cp).sum())
    rep.add("wave_insert_scatter_l2", err=0.0,
            ms=timed_device(torch, lambda: wave_ops.wave_insert_scatter(
                *lv(sk), *ins, rows=srows), 50),
            plain_ms=timed(torch, lambda: wave_ref.insert_scatter(
                *lv(st), *ins, rows=srows), 10),
            nbytes=kept * (2 * dp * 4 + 12) + TIER_SHARDS * width * 4
            + TIER_SHARDS * 24, ops=0, rate=F32_OPS)
    del st, sk, ins
    torch.cuda.empty_cache()
    # the widened fill: 64 sessions, k_c + width rows an insert
    cfg = tc.CacheConfig(capacity=CAPACITY, dim=DIM_RAW + 1,
                         max_queries=QMAX)
    st, ins, psi, kept = wave_inputs(torch, tc, cfg, gen, kc=width)
    sk = tc.CacheState(*(x.clone() for x in st))
    vk, ik, _ = wave_ops.wave_insert_query(*lv(sk), *ins, psi, K)
    wave_ref.insert_scatter(*lv(st), *ins)
    vr, ir, _ = wave_ref.query_topk(st.doc_emb, st.doc_ids, st.doc_scale,
                                    psi, K)
    for f, x, y in zip(tc.CacheState._fields, sk, st):
        if not torch.equal(x, y):
            raise AssertionError(f"widened fill: leaf {f} differs")
    err = assert_topk_agree(vk, ik, vr, ir, SCORE_TOL, "widened fill")
    cp = cfg.phys_capacity
    rep.add("wave_insert_query_wide", err=err,
            ms=timed(torch, lambda: wave_ops.wave_insert_query(
                *lv(sk), *ins, psi, K), 10),
            plain_ms=timed(torch, lambda: (
                wave_ref.insert_scatter(*lv(st), *ins),
                wave_ref.query_topk(st.doc_emb, st.doc_ids, st.doc_scale,
                                    psi, K)), 3),
            nbytes=S * cp * (dp * 4 + 8) + kept * (2 * dp * 4 + 12)
            + S * width * 4 + S * 24 + S * K * 12 + S * dp * 4,
            ops=2 * S * cp * dp, rate=F32_OPS)
    del st, sk, ins
    torch.cuda.empty_cache()

# ------------------------------------------------------------ Algorithm 1
def converse(torch, index, streams, policy, *, k_c, capacity):
    """Every conversation through one ``ConversationalSearcher``; returns
    (turn records per conversation, the largest cache)."""
    from repro_torch.core.conversation import ConversationalSearcher

    s = ConversationalSearcher(index, k=PAPER_K, k_c=k_c, epsilon=EPS,
                               policy=policy, cache_capacity=capacity)
    recs, max_docs = [], 0
    for stream in streams:
        s.start_conversation()
        qs = pad_to(torch, stream, index.dim)
        recs.append([s.answer(q) for q in qs])
        max_docs = max(max_docs, s.cache.n_docs)
    return recs, max_docs


def rec_scores(recs):
    """(rows, k) scores back from the records' f32 distances (unit vectors:
    s = 1 - d^2 / 2, exact to about 1e-7), -inf past the cached docs."""
    import numpy as np
    d = np.stack([r.distances for r in recs]).astype(np.float64)
    return np.where(np.isfinite(d), 1.0 - d * d / 2.0, -np.inf)


def agree_to_k(vals, ids, ref_vals, ref_ids, tol, what):
    """``assert_topk_agree`` for two answers cut at the same k, neither of
    which shows rank k + 1: the reference's last entry is appended to both,
    so a last rank tied with an unseen neighbour may hold either doc."""
    import numpy as np

    from repro_torch.kernels.parity import assert_topk_agree
    return assert_topk_agree(np.concatenate([vals, ref_vals[:, -1:]], 1),
                             np.concatenate([ids, ref_ids[:, -1:]], 1),
                             np.concatenate([ref_vals, ref_vals[:, -1:]], 1),
                             np.concatenate([ref_ids, ref_ids[:, -1:]], 1),
                             tol, what)


def paper_phase(torch, corpus, world, streams):
    import numpy as np

    from repro_torch.core.metric_index import MetricIndex
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_topk_agree
    from repro_torch.metrics import ir

    # small input first: the card answers as the CPU path does
    small = [s[:4] for s in streams[:8]]
    world_docs = corpus[:60_000]
    gpu_index = MetricIndex(world_docs, transformed=True, device=DEV)
    cpu_index = MetricIndex(world_docs.cpu(), transformed=True, device="cpu")
    for policy in ("dynamic", "static", "none"):
        kw = dict(k_c=100, capacity=(4 + 2) * 100)
        gpu, _ = converse(torch, gpu_index, small, policy, **kw)
        cpu, _ = converse(torch, cpu_index, small, policy, **kw)
        for c, (ga, ca) in enumerate(zip(gpu, cpu)):
            for t, (a, b) in enumerate(zip(ga, ca)):
                what = f"[paper] small {policy} conversation {c} turn {t}"
                if a.hit != b.hit or not (a.r_hat == b.r_hat or abs(
                        a.r_hat - b.r_hat) <= RHAT_TOL):
                    raise AssertionError(f"{what}: hit / r_hat {a.hit} "
                                         f"{a.r_hat} != {b.hit} {b.r_hat}")
                agree_to_k(rec_scores([a]), a.ids[None], rec_scores([b]),
                           b.ids[None], RHAT_TOL, what)
    log("[paper] small input (8 conversations x 4 turns, 60000 docs, "
        "k_c=100): card == CPU path under none / static / dynamic")
    del gpu_index, cpu_index
    torch.cuda.empty_cache()

    n, dp = corpus.shape
    index = MetricIndex(corpus, transformed=True, device=DEV)
    if index.doc_emb.data_ptr() != corpus.data_ptr():
        raise AssertionError("the MetricIndex copied the corpus")
    log(f"[paper] MetricIndex over the ({n}, {dp}) corpus tensor itself: "
        f"dim {index.dim} (the {dp - DIM_RAW - 1} zero columns after Eq. 1 "
        f"change no score), no copy; queries padded to {dp}")
    # exact top-201 of every turn, in batches of 64, by the plain search
    # (the 201st shows a tie across the k = 200 boundary)
    ids = torch.arange(n, dtype=torch.int32, device=DEV)
    flat = np.concatenate(streams)
    ex_v, ex_i = [], []
    for lo in range(0, len(flat), 64):
        v, i = knn_ref.search(corpus, ids, pad_to(torch, flat[lo:lo + 64],
                                                  dp), PAPER_K + 1)
        ex_v.append(v.cpu().numpy())
        ex_i.append(i.cpu().numpy())
        del v, i
        torch.cuda.empty_cache()
    ex_v, ex_i = np.concatenate(ex_v), np.concatenate(ex_i)
    n_turns = flat.shape[0]
    torch.cuda.reset_peak_memory_stats()
    runs, totals = {}, {}
    for policy in ("none", "static", "dynamic"):
        t0 = time.perf_counter()
        (recs, max_docs), launches = counted(torch, lambda: converse(
            torch, index, streams, policy, k_c=KC, capacity=PAPER_CAP))
        wall = time.perf_counter() - t0
        flat_recs = [r for conv in recs for r in conv]
        misses = sum(not r.hit for r in flat_recs)
        want = {name: 0 for name in launches}
        if policy == "none":
            want.update(knn_score=n_turns, knn_select=n_turns)
        else:
            want.update(probe_rhat=n_turns, wave_query_topk=n_turns,
                        knn_score=misses, knn_select=misses,
                        wave_insert_scatter=misses)
        if launches != want:
            raise AssertionError(f"[paper] {policy}: launches {launches} "
                                 f"!= {want}")
        for name, v in launches.items():
            totals[name] = totals.get(name, 0) + v
        if policy == "none":
            # each turn's 200 with the exact 201st appended: a 200th doc
            # tied with the 201st may be either of them
            assert_topk_agree(
                np.concatenate([rec_scores(flat_recs), ex_v[:, -1:]], 1),
                np.concatenate([np.stack([r.ids for r in flat_recs]),
                                ex_i[:, -1:]], 1),
                ex_v, ex_i, SCORE_TOL, "[paper] none vs exact")
        per = {m: [] for m in ("map", "mrr", "ndcg", "p1", "p3", "cov10")}
        hits = []
        for c, conv in enumerate(recs):
            for t, r in enumerate(conv):
                ranked = r.ids.tolist()
                qr = world.conversations[c].qrels[t]
                per["map"].append(ir.average_precision(ranked, qr, 200))
                per["mrr"].append(ir.mrr(ranked, qr, 200))
                per["ndcg"].append(ir.ndcg_at_k(ranked, qr, 3))
                per["p1"].append(ir.precision_at_k(ranked, qr, 1))
                per["p3"].append(ir.precision_at_k(ranked, qr, 3))
                row = c * len(conv) + t
                per["cov10"].append(ir.coverage(
                    ranked, ex_i[row, :10].tolist(), 10))
                if t > 0:
                    hits.append(r.hit)
        lat = np.array([r.latency_s for r in flat_recs])
        row = {"policy": policy, "turns": n_turns, "misses": misses,
               "hit_rate_2_10": float(np.mean(hits)),
               **{m: float(np.mean(v)) for m, v in per.items()},
               "max_cache_docs": max_docs,
               "turn_p50_s": float(np.percentile(lat, 50)),
               "turn_p99_s": float(np.percentile(lat, 99)),
               "hit_turn_p50_s": float(np.percentile(
                   [r.latency_s for r in flat_recs if r.hit], 50))
               if policy != "none" else None,
               "wall_s": wall}
        log("[paper] " + json.dumps(row))
        runs[policy] = recs
    log(f"[paper] launches over the three runs {totals}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (corpus "
        f"{corpus.numel() * 4 / 1e9:.2f} GB); a turn's cache query and a "
        f"miss's insert are the kernels line's wave_*_s1 rows")
    return runs["dynamic"], totals


def engine_phase(torch, corpus, streams, dynamic):
    """``ConversationalEngine`` behind the router, turn for turn against
    the dynamic searcher's turns."""
    import numpy as np

    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.serve import ConversationalEngine, ShardedRouter

    n, dp = corpus.shape
    n_conv = 8
    ids = torch.arange(n, dtype=torch.int32, device=DEV)

    def serve_all():
        with ShardedRouter([DeviceShard(corpus, ids, device=DEV,
                                        dtype="fp32")],
                           deadline_s=300) as router:
            eng = ConversationalEngine(router, corpus, dim=dp, k=K, k_c=KC,
                                       epsilon=EPS, capacity=PAPER_CAP,
                                       dtype="fp32", device=DEV)
            out = []
            for stream in streams[:n_conv]:
                eng.start_session()
                out.append([eng.answer(q) for q in pad_to(torch, stream, dp)])
            return out

    convs, launches = counted(torch, serve_all)
    turns = sum(len(c) for c in convs)
    misses = sum(not t.hit for c in convs for t in c)
    want = {name: 0 for name in launches}
    want.update(probe_rhat=turns, wave_query_topk=turns, knn_score=misses,
                knn_select=misses, wave_insert_scatter=misses)
    if launches != want:
        raise AssertionError(f"[engine] launches {launches} != {want}")
    compared = ties = 0
    for c, (turns_e, turns_s) in enumerate(zip(convs, dynamic)):
        for t, (e, s) in enumerate(zip(turns_e, turns_s)):
            if abs(s.r_hat - EPS) <= RHAT_TOL:
                ties += 1          # a tie at epsilon: the caches may part
                break
            if e.hit != s.hit or not np.array_equal(e.ids, s.ids[:K]):
                raise AssertionError(f"[engine] conversation {c} turn {t}: "
                                     f"hit {e.hit} ids {e.ids} != the "
                                     f"searcher's {s.hit} {s.ids[:K]}")
            compared += 1
    log(f"[engine] {n_conv} conversations x {len(convs[0])} turns: "
        f"{compared} turns equal the dynamic searcher's ({ties} ties at "
        f"epsilon), {misses} misses; launches {launches}")
    return launches


# ------------------------------------------------------------ query encoder
def token_conversations(n_conv, vocab, seed):
    """``n_conv`` token conversations of ENC_TURNS turns: an ENC_PREFIX-token
    topic prefix drawn from ``data.lm.TokenStream`` plus a per-turn suffix
    of ENC_SUFFIX tokens; the ENC_REPEATS turns repeat an earlier turn of
    the conversation verbatim.  Lists of int32 numpy rows."""
    import numpy as np

    from repro_torch.data.lm import LMBatchSpec, TokenStream

    stream = TokenStream(LMBatchSpec(n_conv, ENC_SEQ, vocab, seed=seed),
                         device="cpu")
    steps = [stream.batch_numpy(t)["tokens"] for t in range(ENC_TURNS + 1)]
    rng = np.random.default_rng(seed)
    convs = []
    for c in range(n_conv):
        turns = []
        for t in range(ENC_TURNS):
            if t in ENC_REPEATS:
                turns.append(turns[ENC_REPEATS[t]].copy())
                continue
            n = int(rng.integers(ENC_SUFFIX[0], ENC_SUFFIX[1] + 1))
            turns.append(np.concatenate([steps[0][c, :ENC_PREFIX],
                                         steps[1 + t][c, :n]]))
        convs.append(turns)
    return convs


def pad_rows(rows, width):
    """Token rows right-padded with -1 to ``width`` (an int32 array)."""
    import numpy as np
    out = np.full((len(rows), width), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.detach().to(dev)


class Recorder:
    """An encoder wrapper: counts calls, keeps each row's psi by its tokens
    (the exact check reads the psi the engine probed with) and, with
    ``sync``, the host seconds of each call up to the device's finish."""

    def __init__(self, torch, encode, sync=False):
        self.torch, self.encode, self.sync = torch, encode, sync
        self.calls, self.seconds, self.psi = 0, [], {}

    def __call__(self, tokens):
        t0 = time.perf_counter()
        psi = self.encode(tokens)
        if self.sync:
            self.torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
        self.calls += 1
        tok = self.torch.as_tensor(tokens).cpu().numpy()
        for row, p in zip(tok.reshape(-1, tok.shape[-1]),
                          psi.reshape(-1, psi.shape[-1])):
            self.psi[row[row >= 0].tobytes()] = p
        return psi


def encoder_ops(cfg, b, s):
    """(operations, weight bytes) of one ``hidden_states`` + pool at (b, s):
    2 x layer parameters x tokens for the products, plus QK^T and PV over
    the whole (s, s) block as the blockwise attention computes it."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import init_params
    layers = tf.param_count(init_params(cfg, device="meta")["group0_dense"])
    attn = 4 * b * s * s * cfg.n_heads * cfg.head_dim * cfg.n_layers
    return 2 * layers * b * s + attn, 4 * layers


def profile_split(torch, encode, tokens, parts=None):
    """One call ``encode(tokens)`` under ``torch.profiler``: the device
    activities launched (kernels, copies, fills), device ms by part, and
    the operators of ``other`` that took the most (at most 6, by ms).  The
    parts are {label: (module, function name)}, each function wrapped for
    the call (the innermost wrapped caller names a kernel's part); by
    default the encoder's attention, RMSNorms and RoPE; products outside
    every part count as ``matmul``, the rest as ``other``.  None when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import common as cm

    parts = parts or {"attention": (cm, "blockwise_attention"),
                      "norm": (cm, "rms_norm"), "rope": (cm, "rotate")}
    saved = {label: getattr(mod, name) for label, (mod, name) in
             parts.items()}

    def annotated(label, fn):
        def call(*a, **kw):
            with record_function("part." + label):
                return fn(*a, **kw)
        return call

    encode(tokens)
    torch.cuda.synchronize()
    try:
        for label, (mod, name) in parts.items():
            setattr(mod, name, annotated(label, saved[label]))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            encode(tokens)
            torch.cuda.synchronize()
    finally:
        for label, (mod, name) in parts.items():
            setattr(mod, name, saved[label])
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        return None
    # kernels are charged to the aten operator that launched them; the
    # profiler's own markers (a full command buffer, when the launch queue
    # blocks the host) list the same kernels again
    split = dict.fromkeys(["matmul", *parts, "other"], 0.0)
    others: dict = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels \
                or not e.name.startswith("aten::"):
            continue
        part, p = None, e
        while p is not None and part is None:
            if p.name.startswith("part."):
                part = p.name.removeprefix("part.")
            p = p.cpu_parent
        if part is None:
            part = "matmul" if e.name in ("aten::mm", "aten::addmm",
                                          "aten::bmm") else "other"
        ms = sum(k.duration for k in e.kernels) / 1e3
        split[part] = split.get(part, 0.0) + ms
        if part == "other":
            others[e.name] = others.get(e.name, 0.0) + ms
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:6])
    return len(device), split, top


def encoder_phase(torch, corpus):
    """The paper's query encoder at the STAR encoder's full width, then
    both engines driven by token turns through it.  Returns {path:
    launches}."""
    import gc

    import numpy as np

    from repro_torch.configs import registry, star_encoder
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_close, assert_topk_agree
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ConversationalEngine, ShardedRouter
    from repro_torch.serve.engine import make_lm_query_encoder

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("[encoder] f32 products must run in full f32")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)

    def rows(b, s, vocab, lengths):
        tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
        tok[np.arange(s)[None, :] >= np.asarray(lengths)[:, None]] = -1
        return torch.as_tensor(tok)

    # 1. card against CPU, the four smoke configs, the same parameters
    errs = {}
    for arch in ("star-encoder", "chatglm3-6b", "gemma2-9b",
                 "mistral-large-123b"):
        small = registry.get(arch).smoke_config()
        params = tf.init_params(small, device="cpu", generator=torch
                                .Generator().manual_seed(SEED))
        tok = rows(4, 32, small.vocab_size, [32, 25, 16, 3])
        errs[arch] = assert_close(
            tf.hidden_states(tree_to(params, DEV), tok.to(DEV), small),
            tf.hidden_states(params, tok, small), ENC_SMOKE_TOL,
            f"[encoder] {arch} smoke hidden states")
    log(f"[encoder] smoke configs, card == CPU path (hidden states within "
        f"{ENC_SMOKE_TOL}): " + json.dumps({a: float(f"{e:.3g}")
                                            for a, e in errs.items()}))

    # 2. full width: seeded random weights (no STAR weights offline)
    cfg = star_encoder.full_config()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    model = tf.Transformer(cfg, device=DEV, generator=gen)
    d = cfg.d_model
    proj = torch.randn(d, d, generator=gen, device=DEV) * d ** -0.5
    encode = make_lm_query_encoder(model.params, cfg, proj, device=DEV)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    cpu_encode = make_lm_query_encoder(tree_to(model.params, "cpu"), cfg,
                                       proj.cpu(), device="cpu")
    tok8 = rows(8, ENC_SEQ, cfg.vocab_size,
                np.linspace(8, ENC_SEQ, 8).astype(int))
    psi8 = encode(tok8.to(DEV))
    err = assert_close(psi8, cpu_encode(tok8), ENC_PSI_TOL,
                       "[encoder] full-width psi, card against CPU")
    norms = torch.linalg.vector_norm(psi8[:, :d], dim=1)
    if not torch.isfinite(psi8).all() or psi8.shape != (8, d + 1) or \
            float((norms - 1).abs().max()) > 1e-5 or (psi8[:, d] != 0).any():
        raise AssertionError(f"[encoder] malformed psi: norms {norms}")
    del cpu_encode
    gc.collect()
    log(f"[encoder] {cfg.name} ({cfg.n_layers} layers, d {d}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): "
        f"{tf.param_count(model.params)} parameters ({weights / 1e9:.3f} "
        f"GB); psi of 8 rows (lengths 8..{ENC_SEQ}, -1 pads) card == CPU "
        f"path, max_abs_err={err:.3g} (tolerance {ENC_PSI_TOL}); norms 1 "
        f"within {float((norms - 1).abs().max()):.2g}")

    # 3. time one turn (B = 1) and one wave (B = 64) of 64-token rows
    for b, reps in ((1, 20), (S, 10)):
        tok = rows(b, ENC_SEQ, cfg.vocab_size, [ENC_SEQ] * b).to(DEV)
        ops, nbytes = encoder_ops(cfg, b, ENC_SEQ)
        bms, by = bound(nbytes, ops, F32_OPS)
        # one forward a reading: its ~700 launches fit the launch queue
        # behind the sleep, where 50 fill it and the enqueue blocks
        got = [timed_device(torch, lambda: encode(tok), 1, strict=False)
               for _ in range(reps)]
        got = [ms for ms in got if ms is not None]
        dev_ms = sum(got) / len(got) if got else float("nan")
        b2b_ms = timed(torch, lambda: encode(tok), reps)
        log(f"[encoder] encode B={b} x S={ENC_SEQ}: {dev_ms:.4f} ms on the "
            f"device (queue filled ahead; {len(got)} of {reps} readings "
            f"kept), {b2b_ms:.4f} ms back to back; "
            f"bound {bms:.4f} ms ({by}: {ops / 1e9:.2f} GFLOP at "
            f"{F32_OPS / 1e12:.0f} TFLOP/s f32, {nbytes / 1e6:.0f} MB of "
            f"layer weights at {HBM_BPS / 1e12:.2f} TB/s)")
    split = profile_split(torch, encode, tok)
    if split is None:
        log("[encoder] profiler split: the profiler saw no device activity "
            "(not measured)")
    else:
        log(f"[encoder] profiler, one B={S} forward: {split[0]} "
            f"device activities (kernels, copies, fills); device ms by part "
            + json.dumps({k: round(v, 4) for k, v in split[1].items()}))
        b1 = profile_split(torch, encode, tok[:1])
        log(f"[encoder] profiler, one B=1 forward: "
            f"{b1[0] if b1 else 'not measured'} device activities; device "
            f"ms by part " + (json.dumps({k: round(v, 4) for k, v in
                                          b1[1].items()}) if b1 else "—"))
    del tok
    torch.cuda.empty_cache()

    convs = token_conversations(S, cfg.vocab_size, SEED)
    n, dp = corpus.shape
    ids = torch.arange(n, dtype=torch.int32, device=DEV)
    paths = {}

    def exact(turns, rec, what):
        """Every miss turn's ids are the exact top-k of the psi it probed
        with (a plain search over the whole corpus)."""
        miss = [(t, rec.psi[tok[tok >= 0].tobytes()]) for t, tok in turns
                if t.tier == "backend"]
        for lo in range(0, len(miss), 64):
            q = torch.nn.functional.pad(torch.stack(
                [p for _, p in miss[lo:lo + 64]]).to(DEV),
                (0, dp - d - 1))
            v, i = knn_ref.search(corpus, ids, q, K)
            assert_topk_agree(np.stack([t.scores for t, _ in miss[lo:lo + 64]]),
                              np.stack([t.ids for t, _ in miss[lo:lo + 64]]),
                              v, i, SCORE_TOL, what)
            torch.cuda.empty_cache()
        return len(miss)

    # 4. one session: ConversationalEngine, B = 1 encodes of each turn
    n_conv = 8
    rec1 = Recorder(torch, lambda t: encode(t[None])[0], sync=True)

    def one_session():
        with ShardedRouter([DeviceShard(corpus, ids, device=DEV,
                                        dtype="fp32")],
                           deadline_s=300) as router:
            eng = ConversationalEngine(router, corpus, dim=d + 1, k=K,
                                       k_c=KC, epsilon=EPS,
                                       capacity=PAPER_CAP, dtype="fp32",
                                       device=DEV, encoder=rec1)
            out_ = []
            for conv in convs[:n_conv]:
                eng.start_session()
                out_.append([eng.answer(tok) for tok in conv])
            return out_

    sessions, launches = counted(torch, one_session)
    turns = [t for c in sessions for t in c]
    misses = sum(not t.hit for t in turns)
    want = {name: 0 for name in launches}
    want.update(probe_rhat=len(turns), wave_query_topk=len(turns),
                knn_score=misses, knn_select=misses,
                wave_insert_scatter=misses)
    if launches != want or misses in (0, len(turns)):
        raise AssertionError(f"[encoder] one session: launches {launches} "
                             f"!= {want} for {misses} misses of "
                             f"{len(turns)} turns")
    if rec1.calls != len(turns):
        raise AssertionError(f"[encoder] {rec1.calls} encoder calls for "
                             f"{len(turns)} turns")
    check_turns(sessions, ENC_TURNS)
    checked = exact([(t, tok) for c, conv in enumerate(sessions)
                     for t, tok in zip(conv, convs[c])], rec1,
                    "[encoder] one-session miss turns")
    lat = np.array([t.latency_s for t in turns]) * 1e3
    enc = np.array(rec1.seconds) * 1e3
    hit = np.array([t.hit for t in turns])
    log(f"[encoder] one session: {n_conv} conversations x {ENC_TURNS} "
        f"token turns ({ENC_PREFIX}-token prefix + {ENC_SUFFIX[0]}-"
        f"{ENC_SUFFIX[1]}-token suffix; turns {sorted(ENC_REPEATS)} repeat "
        f"turns {[ENC_REPEATS[t] for t in sorted(ENC_REPEATS)]}): "
        f"{int(hit.sum())} hits, {misses} misses, {checked} miss turns "
        f"equal the exact top-{K} over {n} docs; launches {launches}")
    p50 = {kind: (np.percentile(lat[m], 50), np.percentile(enc[m], 50))
           for kind, m in (("hit", hit), ("miss", ~hit))}
    log("[encoder] one session: turn p50 " + ", ".join(
        f"{kind} {t:.3f} ms (encoder {e:.3f} ms of it, {e / t:.0%})"
        for kind, (t, e) in p50.items())
        + "; host clock, the encoder timed to the device's finish")
    paths["encoder_session"] = launches
    del sessions, turns
    gc.collect()

    # 5. the wave engine: every turn a row padded to ENC_SEQ tokens, so
    # that every wave the scheduler forms has one width
    streams = [pad_rows(conv, ENC_SEQ) for conv in convs]
    recb = Recorder(torch, encode)
    waves: list = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine, launches = counted(torch, lambda: serve(
        torch, corpus, streams, n_sessions=S, k_c=KC,
        capacity=CAPACITY, device=DEV, waves_seen=waves, encoder=recb,
        reask=False))
    peak = torch.cuda.max_memory_allocated()
    miss = sum(1 for w in waves if w[0])
    clean = len(waves) - miss
    got = {name: launches.get(name, 0) for name in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want.update(cache_probe=len(waves), knn_score=miss, knn_select=miss,
                wave_insert_query=miss, wave_query_topk=clean)
    if got != want or miss == 0 or clean == 0:
        raise AssertionError(f"[encoder] waves: launches {got} != {want} "
                             f"({miss} waves with misses, {clean} without)")
    if recb.calls != len(waves):
        raise AssertionError(f"[encoder] {recb.calls} encoder calls for "
                             f"{len(waves)} waves")
    check_turns(engine.turns, ENC_TURNS)
    checked = exact([(t, tok) for s_, ts in enumerate(engine.turns)
                     for t, tok in zip(ts, convs[s_])], recb,
                    "[encoder] wave miss turns")
    probe = np.array([w[2] for w in waves]) * 1e3
    fill = np.array([w[3] for w in waves]) * 1e3
    state = sum(x.numel() * x.element_size() for x in engine.cache.state)
    log(f"[encoder] waves: {S} sessions x {ENC_TURNS} token turns in "
        f"{len(waves)} waves ({miss} with misses at 3 launches, {clean} "
        f"without at 2), one encoder call a wave; {checked} miss turns "
        f"equal the exact top-{K}; hit rate {engine.hit_rate():.4f}; "
        f"buckets {[w[1] for w in waves]}; launches {got}")
    log(f"[encoder] waves: probe span (encoder + L1 probe) p50 "
        f"{np.percentile(probe, 50):.3f} ms, fill span p50 "
        f"{np.percentile(fill, 50):.3f} ms; peak device memory above the "
        f"corpus {(peak - corpus.numel() * 4) / 1e9:.3f} GB (encoder weights "
        f"{weights / 1e9:.3f}, L1 state {state / 1e9:.3f}; allocated before "
        f"the serve {(base - corpus.numel() * 4) / 1e9:.3f} GB above the "
        f"corpus)")
    paths["encoder_wave"] = launches
    del engine, model, encode, recb, rec1
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[encoder] phase in {time.perf_counter() - t_phase:.1f} s")
    return paths


# ------------------------------------------------------------- LM serving
def plain_moe(torch, params, x, cfg, capacity):
    """The MoE rule computed apart, for ``moe_ffn``'s check: routing from the
    router's f32 probabilities by a stable numpy argsort and a queue
    counter walked over the (token, choice) pairs in token-major order;
    then a plain loop over the experts that runs each kept pair through
    its expert in f32 (the bf16 weights widened), gated in f32, plus the
    shared expert.  Returns (expert ids, positions, kept mask, y f32)."""
    import numpy as np

    from repro_torch.models.moe import _swiglu

    t, k = x.shape[0], cfg.top_k
    probs = torch.softmax(x.float() @ params["router"], dim=-1).cpu().numpy()
    ids = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, ids, axis=1)
    if cfg.norm_topk:
        gates = gates / np.maximum(gates.sum(1, keepdims=True), 1e-9)
    ids, gates = ids.reshape(-1), gates.reshape(-1)
    count = np.zeros(cfg.n_experts, np.int64)
    pos = np.empty(t * k, np.int64)
    for i, e in enumerate(ids.tolist()):
        pos[i] = count[e]
        count[e] += 1
    keep = pos < capacity
    tok = np.repeat(np.arange(t), k)
    y = _swiglu(x.float(), params["shared_wi"].float(),
                params["shared_wo"].float())
    for e in np.unique(ids[keep]).tolist():
        sel = np.flatnonzero((ids == e) & keep)
        rows = torch.as_tensor(tok[sel], device=x.device)
        out = _swiglu(x[rows].float(), params["wi"][e].float(),
                      params["wo"][e].float())
        g = torch.as_tensor(gates[sel], device=x.device)
        y[rows] += out * g[:, None]      # rows distinct: a token, one expert
    return ids, pos, keep, y


def route_recorder(torch):
    """Wrap ``models.moe.route`` (``moe_ffn`` calls it through the module)
    to record each call's expert ids; returns (record list, restore)."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def recording(*a, **kw):
        r = route(*a, **kw)
        seen.append((r.expert_ids.view(a[1].shape[0], -1).cpu(),
                     int(r.keep.sum())))
        return r

    moe.route = recording
    return seen, lambda: setattr(moe, "route", route)


def lm_smoke(torch):
    """The MoE / MLA smoke configs, the same parameters on the card and on
    the CPU path: a padded prefill's logits and aux loss, MTP logits and
    three decode steps (the CPU's argmax fed to both)."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels.parity import assert_close
    from repro_torch.models import transformer as tf

    errs = {}
    rng = np.random.default_rng(SEED)
    for arch in LM_ARCHS:
        small = registry.get(arch).smoke_config()
        params = tf.init_params(small, device="cpu", generator=torch
                                .Generator().manual_seed(SEED))
        gpu = tree_to(params, DEV)
        tok = rng.integers(0, small.vocab_size, (4, 32)).astype(np.int32)
        tok[np.arange(32)[None] >= np.array([32, 25, 16, 3])[:, None]] = -1
        tok = torch.as_tensor(tok)
        want = tf.forward(params, tok, small, return_kv=True, kv_len=36)
        got = tf.forward(gpu, tok.to(DEV), small, return_kv=True, kv_len=36)
        e = {"logits": assert_close(got[0], want[0], LM_SMOKE_TOL,
                                    f"[lm] {arch} smoke logits"),
             "aux": abs(float(got[1]) - float(want[1]))}
        if e["aux"] > 1e-6:
            raise AssertionError(f"[lm] {arch} smoke aux {e['aux']}")
        if small.mtp:
            e["mtp"] = assert_close(
                tf.mtp_logits(gpu, tok.to(DEV), got[2], small),
                tf.mtp_logits(params, tok, want[2], small), LM_SMOKE_TOL,
                f"[lm] {arch} smoke mtp")
        kc, kg = want[3], got[3]
        nxt = want[0][:, -1].argmax(-1)
        for t in range(3):
            lc, kc = tf.decode_step(params, nxt, kc, 33 + t, small)
            lg, kg = tf.decode_step(gpu, nxt.to(DEV), kg, 33 + t, small)
            e[f"decode{t}"] = assert_close(lg, lc, LM_SMOKE_TOL,
                                           f"[lm] {arch} decode {t}")
            nxt = lc.argmax(-1)
        errs[arch] = {k: float(f"{v:.3g}") for k, v in e.items()}
    log(f"[lm] smoke configs, card == CPU path (f32, within {LM_SMOKE_TOL};"
        f" aux within 1e-6): " + json.dumps(errs))


def lm_moe_check(torch, params, cfg, gen):
    """``moe_ffn`` of the model's MoE layer over LM_B x LM_S tokens against
    ``plain_moe``."""
    import numpy as np

    from repro_torch.models import moe
    from repro_torch.models.transformer import _layer

    layer = _layer(params[[k for k in params if k.endswith("_moe")][0]],
                   0)["ffn"]
    # the layer's input is an RMSNorm's output (unit scale): rows of RMS 1
    x = torch.randn(LM_B * LM_S, cfg.d_model, generator=gen,
                    device=DEV).to(cfg.dtype)
    y = moe.moe_ffn(layer, x, cfg.moe).y
    r = moe.route(layer, x, cfg.moe)
    ids, pos, keep, want = plain_moe(torch, layer, x, cfg.moe, r.capacity)
    for name, a, b in (("expert ids", r.expert_ids, ids),
                       ("positions", r.pos, pos), ("kept", r.keep, keep)):
        if not np.array_equal(a.cpu().numpy(), b):
            raise AssertionError(f"[lm] {cfg.name} MoE {name} differ from "
                                 f"the plain rule")
    rms = float(want.pow(2).mean().sqrt())
    diff = (y.float() - want)
    err, rms_err = float(diff.abs().max()) / rms, \
        float(diff.pow(2).mean().sqrt()) / rms
    dropped = int((~keep).sum())
    tokens = int((~keep).reshape(-1, cfg.moe.top_k).any(1).sum())
    if not torch.isfinite(y).all() or rms_err > LM_MOE_TOL:
        raise AssertionError(f"[lm] {cfg.name} MoE RMS error {rms_err:.3g} "
                             f"of the output's RMS > {LM_MOE_TOL}")
    log(f"[lm] {cfg.name} moe_ffn over {LM_B} x {LM_S} tokens "
        f"({cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, capacity "
        f"{r.capacity}): "
        f"routing, positions and kept mask equal the plain rule's; "
        f"{dropped} (token, choice) pairs dropped ({tokens} tokens lost a "
        f"choice); against the plain f32 loop the RMS of the error is "
        f"{rms_err:.3g} of the output's RMS {rms:.4g} (bound {LM_MOE_TOL}); "
        f"max |diff| {err:.3g} of it (bf16 rounds each of {cfg.moe.top_k} "
        f"+ 1 sums and products at up to 2^-9 of values several times the "
        f"RMS)")


def lm_prefill_decode(torch, params, cfg, gen):
    """8 tokens prefilled against the same 8 through ``decode_step``: the
    logits within LM_PD_TOL, equal argmax where the top two logits lie
    further apart; the router's choices of both paths compared."""
    from repro_torch.models import transformer as tf

    tok = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen,
                        device=DEV)
    seen, restore = route_recorder(torch)
    try:
        pre = tf.forward(params, tok, cfg)[0][0].float()
        n_pre = len(seen)
        caches = tf.init_kv_caches(cfg, 1, 8, device=DEV)
        steps = []
        for t in range(8):
            lg, caches = tf.decode_step(params, tok[:, t], caches, t + 1, cfg)
            steps.append(lg[0].float())
    finally:
        restore()
    dec = torch.stack(steps)
    # the router's choices as sets (their order only orders the combine's
    # sum): prefill layer l against decode step t, layer l
    layers = n_pre
    same = sum(int(torch.equal(
        seen[l][0][t].sort().values,
        seen[n_pre + t * layers + l][0][0].sort().values))
        for l in range(layers) for t in range(8))
    err = float((pre - dec).abs().max())
    top2 = pre.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > LM_PD_TOL
    agree = (pre.argmax(-1) == dec.argmax(-1))
    ok = err <= LM_PD_TOL and bool(agree[clear].all())
    log(f"[lm] {cfg.name} prefill against decode, 8 tokens (bf16 logits of "
        f"RMS {float(pre.pow(2).mean().sqrt()):.3f}): max |diff| {err:.4g} "
        f"(tolerance {LM_PD_TOL}); argmax equal at {int(agree.sum())} of 8 "
        f"positions ({int(clear.sum())} with the top two further apart "
        f"than the tolerance); the router's chosen experts equal at {same} "
        f"of {8 * layers} (token, MoE layer)")
    if not ok:
        raise AssertionError(f"[lm] {cfg.name} prefill and decode differ")


def lm_serve(torch, params, cfg, gen):
    """Prefill LM_B x LM_S with ``return_kv``, then LM_STEPS greedy decode
    steps, twice (the same tokens bit for bit); times, bounds, a profiler
    split and peak memory.  Returns the prefill's (tokens, hidden)."""
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf

    tok = torch.randint(0, cfg.vocab_size, (LM_B, LM_S), generator=gen,
                        device=DEV)
    n_moe = sum(c for kind, c in cfg.layer_groups() if kind == "moe")

    def run():
        logits, _aux, hidden, caches = tf.forward(
            params, tok, cfg, return_kv=True, kv_len=LM_KV)
        nxt, out = logits[:, -1].argmax(-1), []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for t in range(LM_STEPS):
            lg, caches = tf.decode_step(params, nxt, caches, LM_S + 1 + t,
                                        cfg)
            nxt = lg.argmax(-1)
            out.append(nxt)
        b.record()
        b.synchronize()
        return (torch.stack(out, 1), lg, hidden, caches,
                a.elapsed_time(b) / LM_STEPS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    seen, restore = route_recorder(torch)
    try:
        toks1, last1, hidden, caches, _ = run()
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    kept = sum(n for _ids, n in seen[:n_moe])       # the prefill's layers
    # the second run unrecorded: the recorder waits for the card each call
    toks2, last2, _, _, step_b2b = run()
    if not (torch.equal(toks1, toks2) and torch.equal(last1, last2)):
        raise AssertionError(f"[lm] {cfg.name}: two runs decoded apart")
    if not torch.isfinite(last1).all():
        raise AssertionError(f"[lm] {cfg.name}: non-finite decode logits")

    def prefill():
        return tf.forward(params, tok, cfg, return_kv=True, kv_len=LM_KV)

    def step():
        return tf.decode_step(params, toks1[:, -1], caches, LM_KV, cfg)

    pre_dev = [timed_device(torch, prefill, 1, strict=False)
               for _ in range(3)]
    pre_b2b = timed(torch, prefill, 3)
    dec_dev = [timed_device(torch, step, 1, strict=False) for _ in range(5)]
    for what, dev, b2b, s, ctx, k in (
            ("prefill", pre_dev, pre_b2b, LM_S, LM_S, kept),
            ("decode step", dec_dev, step_b2b, 1, LM_KV,
             n_moe * LM_B * cfg.moe.top_k)):
        dev = [ms for ms in dev if ms is not None]
        dev_ms = sum(dev) / len(dev) if dev else float("nan")
        bf, f32, nbytes = lm_costs(cfg, params, LM_B, s, ctx, k)
        bms, by = lm_bound(bf, f32, nbytes)
        log(f"[lm] {cfg.name} {what} (B={LM_B}, "
            + (f"S={LM_S}, kv_len {LM_KV}" if s > 1 else
               f"over {ctx} cache positions") + f"): {dev_ms:.3f} ms on the "
            f"device ({len(dev)} readings kept), {b2b:.3f} ms back to back; "
            f"bound {bms:.3f} ms ({by}: {bf / 1e12:.3f} TFLOP bf16 at "
            f"{BF16_OPS / 1e12:.0f} TFLOP/s + {f32 / 1e9:.1f} GFLOP f32 at "
            f"{F32_OPS / 1e12:.0f}, attention in f32 as in the reference; "
            f"{nbytes / 1e9:.2f} GB at {HBM_BPS / 1e12:.2f} TB/s)")
    parts = {"attention": (tf, "_attn_mla" if cfg.attention == "mla"
                           else "_attn_gqa"),
             "moe": (tf, "moe_ffn"), "dense_ffn": (tf, "_dense_ffn"),
             "head": (tf, "_head"), "norm": (cm, "rms_norm")}
    for what, fn in (("prefill", prefill), ("decode step", step)):
        split = profile_split(torch, lambda _: fn(), None, parts)
        log(f"[lm] {cfg.name} profiler, one {what}: " + (
            "the profiler saw no device activity (not measured)" if split
            is None else f"{split[0]} device activities; device ms by "
            f"part " + json.dumps({k: round(v, 3)
                                   for k, v in split[1].items()})))
    log(f"[lm] {cfg.name} serve: {LM_STEPS} greedy steps after the prefill, "
        f"twice, the same tokens and last logits bit for bit; peak device "
        f"memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} above the "
        f"{base / 1e9:.2f} GB held before)")
    return tok, hidden


def lm_encoder(torch, params, cfg, gen):
    """``make_lm_query_encoder`` over the model in front of
    ``ConversationalEngine`` for LM_CONVS conversations x ENC_TURNS token
    turns over ``make_world``'s documents; every miss turn is the exact
    top-k of its psi.  Returns the path's launches."""
    import numpy as np

    from repro_torch.core import embedding as temb
    from repro_torch.core import layout
    from repro_torch.data.conversations import WorldConfig, make_world
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_topk_agree
    from repro_torch.serve import ConversationalEngine, ShardedRouter
    from repro_torch.serve.engine import make_lm_query_encoder

    world = make_world(WorldConfig(n_conversations=S, seed=SEED))
    emb = torch.as_tensor(world.doc_emb, dtype=torch.float32, device=DEV)
    dim = DIM_RAW + 1
    docs = torch.zeros((world.n_docs, layout.phys_dim(dim)),
                       dtype=torch.float32, device=DEV)
    docs[:, :dim] = temb.transform_documents(emb)[0]
    ids = torch.arange(world.n_docs, dtype=torch.int32, device=DEV)
    proj = torch.randn(cfg.d_model, DIM_RAW, generator=gen, device=DEV) \
        * cfg.d_model ** -0.5
    encode = make_lm_query_encoder(params, cfg, proj, device=DEV)
    convs = token_conversations(LM_CONVS, cfg.vocab_size, SEED)
    rec = Recorder(torch, lambda t: encode(t[None])[0], sync=True)

    def one_session():
        with ShardedRouter([DeviceShard(docs, ids, device=DEV,
                                        dtype="fp32")],
                           deadline_s=300) as router:
            eng = ConversationalEngine(router, docs, dim=dim, k=K, k_c=KC,
                                       epsilon=EPS, capacity=PAPER_CAP,
                                       dtype="fp32", device=DEV,
                                       encoder=rec)
            out = []
            for conv in convs:
                eng.start_session()
                out.append([eng.answer(t) for t in conv])
            return out

    sessions, launches = counted(torch, one_session)
    turns = [t for c in sessions for t in c]
    misses = sum(not t.hit for t in turns)
    want = {name: 0 for name in launches}
    want.update(probe_rhat=len(turns), wave_query_topk=len(turns),
                knn_score=misses, knn_select=misses,
                wave_insert_scatter=misses)
    if launches != want or rec.calls != len(turns):
        raise AssertionError(f"[lm] encoder session: launches {launches} != "
                             f"{want}, {rec.calls} encoder calls")
    check_turns(sessions, ENC_TURNS)
    psi = torch.stack(list(rec.psi.values()))
    if not torch.isfinite(psi).all() or psi.shape[1] != dim:
        raise AssertionError("[lm] encoder: malformed psi")
    miss = [(t, rec.psi[tok[tok >= 0].tobytes()]) for c, conv in
            enumerate(sessions) for t, tok in zip(conv, convs[c])
            if t.tier == "backend"]
    q = torch.nn.functional.pad(torch.stack([p for _, p in miss]),
                                (0, docs.shape[1] - dim))
    v, i = knn_ref.search(docs, ids, q, K)
    assert_topk_agree(np.stack([t.scores for t, _ in miss]),
                      np.stack([t.ids for t, _ in miss]), v, i, SCORE_TOL,
                      "[lm] encoder miss turns")
    row = torch.as_tensor(pad_rows([convs[0][0]], len(convs[0][0])),
                          device=DEV)
    enc_ms = timed(torch, lambda: encode(row), 5)
    lat = np.array([t.latency_s for t in turns]) * 1e3
    log(f"[lm] {cfg.name} encoder: {LM_CONVS} conversations x {ENC_TURNS} "
        f"token turns through ConversationalEngine over {world.n_docs} "
        f"docs: {len(turns) - misses} hits, {misses} misses, every miss the "
        f"exact top-{K} of its psi (finite); turn p50 "
        f"{np.percentile(lat, 50):.2f} ms (host clock; encoder p50 "
        f"{np.percentile(np.array(rec.seconds) * 1e3, 50):.2f} ms); encode "
        f"B=1 x S={row.shape[1]} {enc_ms:.2f} ms back to back; launches "
        f"{launches}")
    return launches


def lm_phase(torch):
    """[lm]: the MoE / MLA smoke configs card against CPU, then
    deepseek-v3-671b and llama4-scout-17b-16e at full width cut to
    LM_LAYERS layers, with seeded random weights: the MoE layer against a
    plain f32 loop, prefill against decode, a served prefill + greedy
    decode, MTP (deepseek) and the query encoder in front of the one-
    session engine (deepseek).  Returns {path: launches}."""
    import dataclasses
    import gc

    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError("[lm] products must accumulate in f32")
    t_phase = time.perf_counter()
    lm_smoke(torch)
    paths = {}
    for arch in LM_ARCHS:
        cfg = dataclasses.replace(registry.get(arch).full_config(),
                                  n_layers=LM_LAYERS)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED + 3)
        t0 = time.perf_counter()
        params = tf.init_params(cfg, device=DEV, generator=gen)
        torch.cuda.synchronize()
        weights = sum(v.numel() * v.element_size()
                      for v in tf._leaves(params))
        m = cfg.moe
        log(f"[lm] {arch} at full width, {LM_LAYERS} of "
            f"{registry.get(arch).full_config().n_layers} layers "
            f"({cfg.layer_groups()}; d {cfg.d_model}, {cfg.n_heads} heads"
            + (" MLA" if cfg.attention == "mla" else
               f", {cfg.n_kv_heads} KV") + f", {m.n_experts} experts top-"
            f"{m.top_k} + {m.n_shared} shared, vocab {cfg.vocab_size}, "
            f"{'MTP, ' if cfg.mtp else ''}bf16): {tf.param_count(params)} "
            f"parameters ({weights / 1e9:.2f} GB), seeded random weights "
            f"in {time.perf_counter() - t0:.1f} s")
        lm_moe_check(torch, params, cfg, gen)
        lm_prefill_decode(torch, params, cfg, gen)
        tok, hidden = lm_serve(torch, params, cfg, gen)
        if cfg.mtp:
            out = tf.mtp_logits(params, tok.roll(-1, 1), hidden, cfg)
            if out.shape != (LM_B, LM_S, cfg.vocab_size) or \
                    not torch.isfinite(out).all():
                raise AssertionError(f"[lm] {arch} MTP logits malformed")
            log(f"[lm] {arch} MTP logits {tuple(out.shape)} on the "
                f"prefill's hidden states, finite")
            del out
            paths["lm"] = lm_encoder(torch, params, cfg, gen)
        del params, tok, hidden
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[lm] phase in {time.perf_counter() - t_phase:.1f} s")
    return paths


# ----------------------------------------------------------------- dist
def dist_group(torch, tmp):
    """A one-rank NCCL group on cuda:0 that meets through a file in
    ``tmp``, and the (1,) and (1, 1) meshes over it."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "rendezvous"), rank=0, world_size=1)
    return (init_device_mesh("cuda", (1,), mesh_dim_names=("shard",)),
            init_device_mesh("cuda", (1, 1), mesh_dim_names=("data",
                                                             "model")))


def both_times(torch, fn, reps):
    """(device ms or None when the enqueue outruns the sleep, back-to-back
    ms) of ``fn``."""
    return (timed_device(torch, fn, reps, strict=False),
            timed(torch, fn, reps))


def fmt_ms(ms) -> str:
    return "not measurable" if ms is None else f"{ms:.4f} ms"


def dist_index(torch, corpus, streams, flat):
    """[dist] the sharded index over the [kernels] corpus against the
    single-device search.  Returns {path: launches}."""
    import numpy as np

    from repro_torch.core.metric_index import MetricIndex

    dim = DIM_RAW + 1
    local = MetricIndex(corpus, transformed=True, dim=dim, device=DEV)
    shard = MetricIndex(corpus, transformed=True, dim=dim, device=DEV,
                        sharded=True, mesh=flat)
    if shard.doc_emb.to_local().data_ptr() != corpus.data_ptr() or \
            local.doc_emb.data_ptr() != corpus.data_ptr():
        raise AssertionError("[dist] the sharded index copied the corpus")
    q64 = torch.as_tensor(np.stack([c[0] for c in streams]), device=DEV)
    paths = {}
    for b in DIST_B:
        q = q64[:b]
        got, launches = counted(torch, lambda: shard.search(q, KC))
        want = local.search(q, KC)
        if not (torch.equal(got.ids, want.ids)
                and torch.equal(got.scores, want.scores)):
            raise AssertionError(f"[dist] sharded_nn at B={b} differs from "
                                 f"MetricIndex.search")
        n = launches.get("knn_score", 0), launches.get("knn_select", 0)
        if n[0] < 1 or n[1] < 1:
            raise AssertionError(f"[dist] sharded_nn at B={b} launched "
                                 f"no kNN kernel: {launches}")
        paths["dist" if b == S else "dist_b1"] = launches
        reps = 5 if b == S else 10
        s_dev, s_b2b = both_times(torch, lambda: shard.search(q, KC), reps)
        l_dev, l_b2b = both_times(torch, lambda: local.search(q, KC), reps)
        log(f"[dist] sharded_nn over {tuple(corpus.shape)} f32 laid out by "
            f"shard_corpus on a (1,) mesh, no copy; B={b}, k={KC}: ids and "
            f"scores equal MetricIndex.search bit for bit; launches "
            f"knn_score {n[0]}, knn_select {n[1]}; {fmt_ms(s_dev)} on the "
            f"device, {s_b2b:.4f} ms back to back, against the local "
            f"search's {fmt_ms(l_dev)} / {l_b2b:.4f} ms (the gather and the "
            f"merge at a world of one)")
    del shard, local, q64
    return paths


def dist_scorer(torch, mesh):
    """[dist] ``make_batched_scorer`` at SASRec's retrieval_cand shape
    against ``candidate_index``.  Returns {path: launches}."""
    from repro_torch.dist.retrieval import make_batched_scorer
    from repro_torch.kernels.parity import assert_topk_agree
    from repro_torch.models.recsys import candidate_index

    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 7)
    table = torch.randn(CAND_ROWS, CAND_WIDTH, generator=gen, device=DEV)
    q = torch.randn(1, CAND_WIDTH, generator=gen, device=DEV)
    scorer = make_batched_scorer(mesh, k=CAND_K, table_axes=("model",),
                                 batch_axes=("data",))
    (vals, ids), launches = counted(
        torch, lambda: scorer(q, table, n_valid=CAND_VALID))
    index = candidate_index(table, n_valid=CAND_VALID, device=DEV)
    if index.doc_emb.data_ptr() != table.data_ptr():
        raise AssertionError("[dist] candidate_index copied the table")
    want = index.search(q, CAND_K)
    err = assert_topk_agree(vals, ids, want.scores, want.ids, SCORE_TOL,
                            "[dist] batched scorer")
    if int(ids.max()) >= CAND_VALID or launches.get("knn_score", 0) < 1:
        raise AssertionError(f"[dist] batched scorer: an id >= "
                             f"{CAND_VALID} or no kNN launch {launches}")
    s_dev, s_b2b = both_times(
        torch, lambda: scorer(q, table, n_valid=CAND_VALID), 20)
    c_dev, c_b2b = both_times(torch, lambda: index.search(q, CAND_K), 20)
    log(f"[dist] make_batched_scorer at retrieval_cand ({CAND_ROWS} x "
        f"{CAND_WIDTH} items, {CAND_VALID} valid, B=1, k={CAND_K}) on a "
        f"(1, 1) mesh: ids equal candidate_index's search (scores within "
        f"{err:.3g}), none >= {CAND_VALID}; launches knn_score "
        f"{launches.get('knn_score', 0)}, knn_select "
        f"{launches.get('knn_select', 0)}; {fmt_ms(s_dev)} on the device, "
        f"{s_b2b:.4f} ms back to back, against candidate_index's "
        f"{fmt_ms(c_dev)} / {c_b2b:.4f} ms")
    return {"dist_cand": launches}


def dist_forward(torch, mesh):
    """[dist] STAR at full width under ``lm_activation_rules``, its
    parameters DTensors placed by ``param_specs``, against the plain
    forward."""
    import numpy as np

    from repro_torch.configs import star_encoder
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.api import sharding_rules
    from repro_torch.models import transformer as tf

    cfg = star_encoder.full_config()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    params = tf.init_params(cfg, device=DEV, generator=gen)
    specs = shd.param_specs(params, mesh)
    placed = shd.place_tree(params, mesh, specs)
    rules = shd.lm_activation_rules(mesh, cfg, "train")
    rng = np.random.default_rng(SEED)
    for b in DIST_ENC_B:
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, ENC_SEQ))
                              .astype(np.int32), device=DEV)

        def sharded():
            with sharding_rules(mesh, rules):
                return tf.forward(placed, tok, cfg)[0]

        with torch.no_grad():
            got = sharded()
            want = tf.forward(params, tok, cfg)[0]
            full = got.full_tensor()
            err = float((full - want).abs().max())
            if full.shape != want.shape or not torch.isfinite(full).all() \
                    or err > DIST_FWD_TOL:
                raise AssertionError(f"[dist] STAR under the rules at B={b} "
                                     f"differs from the plain forward by "
                                     f"{err:.3g}")
            reps = 10 if b == 1 else 5
            s_dev, s_b2b = both_times(torch, sharded, reps)
            p_dev, p_b2b = both_times(
                torch, lambda: tf.forward(params, tok, cfg)[0], reps)
        log(f"[dist] {cfg.name} at full width under lm_activation_rules on "
            f"a (1, 1) mesh, parameters placed by param_specs as DTensors "
            f"(logits {[str(p) for p in got.placements]}); B={b} x "
            f"S={ENC_SEQ}: logits within {err:.3g} of the plain forward "
            f"(bound {DIST_FWD_TOL}); {fmt_ms(s_dev)} on the device, "
            f"{s_b2b:.4f} ms back to back, against the plain forward's "
            f"{fmt_ms(p_dev)} / {p_b2b:.4f} ms")
    del params, placed


def dist_moe(torch, mesh):
    """[dist] ``moe_ffn_sharded`` on one deepseek-v3 MoE layer at full
    width against ``moe_ffn`` at the same capacity."""
    from repro_torch.configs import deepseek_v3_671b
    from repro_torch.models import moe

    cfg = deepseek_v3_671b.full_config()
    m = cfg.moe
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    layer = moe.init_moe(m, cfg.d_model, cfg.dtype, device=DEV,
                         generator=gen)
    weights = sum(v.numel() * v.element_size() for v in layer.values())
    x = torch.randn(LM_B * LM_S, cfg.d_model, generator=gen,
                    device=DEV).to(cfg.dtype)
    with torch.no_grad():
        r = moe.route(layer, x, m)
        want = moe.moe_ffn(layer, x, m).y.float()
        got = moe.moe_ffn_sharded(layer, x, m, mesh,
                                  capacity=r.capacity).y.float()
        # the sharded rule's routing: router logits in the activation dtype
        probs = torch.softmax((x @ layer["router"].to(x.dtype)).float(), -1)
        _g, ids = moe._top_k(probs, m)
        _aux, pos = moe._aux_and_positions(probs, ids.reshape(-1), m)
        alike = ((ids.reshape(-1) == r.expert_ids)
                 & ((pos < r.capacity) == r.keep)).view(-1, m.top_k).all(1)
        rms = float(want.pow(2).mean().sqrt())
        diff = got - want
        err = float(diff[alike].pow(2).mean().sqrt()) / rms
        whole = float(diff.pow(2).mean().sqrt()) / rms
        share = float(alike.float().mean())
        if not torch.isfinite(got).all() or err > LM_MOE_TOL:
            raise AssertionError(f"[dist] moe_ffn_sharded: RMS error "
                                 f"{err:.3g} of the output's RMS on the "
                                 f"tokens routed alike > {LM_MOE_TOL}")
        s_dev, s_b2b = both_times(torch, lambda: moe.moe_ffn_sharded(
            layer, x, m, mesh, capacity=r.capacity), 5)
        p_dev, p_b2b = both_times(torch, lambda: moe.moe_ffn(
            layer, x, m, capacity=r.capacity), 5)
    log(f"[dist] moe_ffn_sharded, one {cfg.name} MoE layer at full width "
        f"({m.n_experts} experts, top-{m.top_k} + {m.n_shared} shared, d "
        f"{cfg.d_model}, bf16, {weights / 1e9:.2f} GB) over {LM_B} x {LM_S} "
        f"tokens on a (1, 1) mesh, capacity {r.capacity} as moe_ffn's: "
        f"{share:.4f} of the tokens routed alike by both rules (bf16 "
        f"router logits against f32), their RMS error {err:.3g} of the "
        f"output's RMS {rms:.4g} (bound {LM_MOE_TOL}); over every token "
        f"{whole:.3g}; {fmt_ms(s_dev)} on the device, {s_b2b:.4f} ms back "
        f"to back, against moe_ffn's {fmt_ms(p_dev)} / {p_b2b:.4f} ms")
    del layer, x, want, got


# ----------------------------------------------------------------- cells
# [cells]: the 40 cells of launch.cells, built by build_cell on a world of
# one NCCL rank over a (1, 1) ("data", "model") mesh and run at full width.
# An LM keeps one layer of each group kind (deepseek: 1 dense + 1 MoE) and
# runs at CELL_LM_CUTS' (batch, sequence) (a train batch at least its
# microbatch count); deepseek's train cell keeps CELL_TRAIN_EXPERTS of its
# 256 experts (Adafactor's f32 update of one layer's 256 would be 30 GB).
# CELL_ROWS: cells one card cannot hold whole run their fn over row chunks.
# Every other cell runs at its full shape.  Calls a cell: CELL_CALLS (a
# GNN cell trains CELL_CALLS["gnn"] AdamW steps; a recsys cell calls once).
# Each cell's memory is estimated by launch.dryrun on a (1, 1) fake mesh in
# CELL_WORKERS host processes, beside the card's work.
CELL_LM_CUTS = {"train_4k": (8, 512), "prefill_32k": (1, 4096),
                "decode_32k": (32, 32768), "long_500k": (1, 524288)}
CELL_TRAIN_EXPERTS = {"deepseek-v3-671b": 32}
CELL_ROWS = {("xdeepfm", "serve_bulk"): 16_384,      # CIN: 81.8 GB whole
             ("xdeepfm", "train_batch"): 16_384}     # CIN: 20.4 GB a layer
CELL_CALLS = {"lm": 2, "gnn": 3, "recsys": 1}
CELL_LOSS_RTOL, CELL_WORKERS = 1e-5, 6


def cell_specs() -> list:
    """One dict a cell: arch, shape, family, and its cuts (None: whole)."""
    from repro_torch.configs import registry

    out = []
    for arch, shape in registry.all_cells():
        mod = registry.get(arch)
        spec = {"arch": arch, "shape": shape, "family": mod.FAMILY,
                "batch": None, "seq": None, "layers": None, "experts": None,
                "rows": CELL_ROWS.get((arch, shape))}
        if mod.FAMILY == "lm":
            b, s = CELL_LM_CUTS[shape]
            if shape == "train_4k":
                b = max(b, mod.TRAIN_ACCUM_STEPS)
                spec["experts"] = CELL_TRAIN_EXPERTS.get(arch)
            spec.update(batch=b, seq=s,
                        layers=len(mod.full_config().layer_groups()))
        elif spec["rows"] is not None:
            spec["batch"] = spec["rows"]
        out.append(spec)
    return out


def cell_config(spec):
    """The config a cut LM cell runs: one layer of each group kind, and
    its expert cut."""
    import dataclasses

    from repro_torch.configs import registry

    cfg = registry.get(spec["arch"]).full_config()
    kw = {"n_layers": spec["layers"],
          "n_dense_layers": min(cfg.n_dense_layers, 1)}
    if spec["experts"]:
        kw["moe"] = cfg.moe._replace(n_experts=spec["experts"])
    return dataclasses.replace(cfg, **kw)


def cell_reduced(spec) -> str:
    """The cell's cuts, as printed."""
    from repro_torch.configs import registry
    from repro_torch.launch import cells

    mod = registry.get(spec["arch"])
    cuts = []
    if spec["family"] == "lm":
        full = mod.full_config()
        d = cells.LM_SHAPE_DEFS[spec["shape"]]
        cuts.append(f"layers {full.n_layers} -> {spec['layers']}")
        if spec["experts"]:
            cuts.append(f"experts {full.moe.n_experts} -> "
                        f"{spec['experts']}")
        if spec["batch"] != d["batch"]:
            cuts.append(f"batch {d['batch']} -> {spec['batch']}")
        if spec["seq"] != d["seq"]:
            cuts.append(f"sequence {d['seq']} -> {spec['seq']}")
    elif spec["rows"]:
        total = cells.RECSYS_SHAPE_DEFS[spec["shape"]]["batch"]
        cuts.append(f"{total} rows in {total // spec['rows']} chunks of "
                    f"{spec['rows']}" if spec["shape"] != "train_batch"
                    else f"rows {total} -> {spec['rows']}")
    return "; ".join(cuts) or "none"


def build_spec_cell(spec, mesh):
    """``launch.cells``' cell with the spec's cuts: its shape table's
    batch and sequence replaced while it builds."""
    from repro_torch.launch import cells

    lm = spec["family"] == "lm"
    if spec["batch"] is None:
        return cells.build_cell(spec["arch"], spec["shape"], mesh)
    table = cells.LM_SHAPE_DEFS if lm else cells.RECSYS_SHAPE_DEFS
    old = table[spec["shape"]]
    new = dict(old)
    if spec["batch"] is not None:
        new["batch"] = spec["batch"]
    if spec["seq"] is not None:
        new["seq"] = spec["seq"]
    table[spec["shape"]] = new
    try:
        if lm:
            return cells.build_lm_cell(spec["arch"], spec["shape"], mesh,
                                       cfg_override=cell_config(spec))
        return cells.build_cell(spec["arch"], spec["shape"], mesh)
    finally:
        table[spec["shape"]] = old


def cell_estimate(spec) -> dict:
    """The dry-run of one cut cell on a (1, 1) fake CPU mesh (a host
    process of its own): rank 0's peak live bytes and costs."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import collective_bytes

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        c = dryrun.trace_cell(build_spec_cell(spec,
                                              make_host_mesh("cpu")))
    return {"peak": c.peak_bytes, "flops": c.flops, "bytes": c.bytes,
            "coll": collective_bytes(c.collectives)["total"],
            "trace_s": time.perf_counter() - t0}


def cell_gen(torch, spec, salt=0):
    """The cell's generator on the card (the same numbers on a rerun)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED * 1_000_003 + zlib.crc32(
        f"{spec['arch']}@{spec['shape']}@{salt}".encode()))
    return gen


def check_tree(torch, got, want, what):
    """``got`` (the card's tensors) has ``want``'s (the cell's meta
    arguments) leaves, shapes and dtypes."""
    from repro_torch.train import tree

    g, w = tree.leaves_with_path(got), tree.leaves_with_path(want)
    bad = [(pg, tuple(a.shape), tuple(b.shape)) for (pg, a), (pw, b)
           in zip(g, w) if pg != pw or a.shape != b.shape
           or a.dtype != b.dtype]
    if len(g) != len(w) or bad:
        raise AssertionError(f"[cells] {what}: arguments differ from the "
                             f"cell's: {bad[:3]} ({len(g)} vs {len(w)})")


def cell_params(torch, spec, cfg, gen):
    from repro_torch.models import egnn
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as tf

    if spec["family"] == "lm":
        return tf.init_params(cfg, device=DEV, generator=gen)
    if spec["family"] == "gnn":
        return egnn.init_params(cfg, device=DEV, generator=gen)
    init = {"dlrm-rm2": rs.dlrm_init, "xdeepfm": rs.xdeepfm_init}.get(
        spec["arch"], rs.seqrec_init)
    return init(cfg, device=DEV, generator=gen)


def cell_batch(torch, spec, cfg, shapes, gen):
    """Seeded inputs on the card for the batch leaves ``shapes`` (the
    cell's meta tensors, by name)."""
    out = {}
    for k, m in shapes.items():
        if k == "tokens":
            out[k] = torch.randint(0, cfg.vocab_size, tuple(m.shape),
                                   generator=gen, device=DEV,
                                   dtype=torch.int32)
        elif k == "labels" and spec["family"] == "lm":
            out[k] = torch.roll(out["tokens"], -1, 1)
        elif k == "labels":
            out[k] = torch.randint(0, cfg.n_classes, tuple(m.shape),
                                   generator=gen, device=DEV,
                                   dtype=torch.int32)
        elif k == "edge_index":
            out[k] = torch.randint(0, shapes["feat"].shape[0],
                                   tuple(m.shape), generator=gen,
                                   device=DEV, dtype=torch.int32)
        elif k == "graph_ids":
            n = m.shape[0]
            per = n // registry_shape(spec)["batch"]
            out[k] = (torch.arange(n, device=DEV) // per).to(torch.int32)
        elif k == "label":
            out[k] = torch.randint(0, 2, tuple(m.shape), generator=gen,
                                   device=DEV).to(torch.float32)
        elif k in ("sparse",):
            out[k] = torch.randint(0, cfg.vocab, tuple(m.shape),
                                   generator=gen, device=DEV,
                                   dtype=torch.int32)
        elif k in ("items", "pos", "neg"):
            t = torch.randint(0, cfg.vocab, tuple(m.shape), generator=gen,
                              device=DEV, dtype=torch.int32)
            # sessions of 1..max_len items, left-padded with -1
            n = torch.randint(1, m.shape[1] + 1, (m.shape[0], 1),
                              generator=gen, device=DEV)
            pos = torch.arange(m.shape[1], device=DEV)[None]
            out[k] = torch.where(pos >= m.shape[1] - n, t, -1)
        else:
            out[k] = torch.randn(tuple(m.shape), generator=gen, device=DEV,
                                 dtype=m.dtype)
    return out


def registry_shape(spec) -> dict:
    from repro_torch.configs import registry
    return registry.get(spec["arch"]).SHAPES[spec["shape"]]


def storage_bytes(torch, *trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees`` (a
    graph plan's index tensors too)."""
    from repro_torch.train import tree

    seen = {}
    for t in trees:
        for leaf in tree.leaves(t):
            # a SegmentPlan holds its index tensors as attributes
            for x in (vars(leaf).values() if hasattr(leaf, "__dict__")
                      and not isinstance(leaf, torch.Tensor) else [leaf]):
                if isinstance(x, torch.Tensor):
                    st = x.untyped_storage()
                    seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def cell_times(torch, call, calls: int, args):
    """Run ``call(i)`` for i < calls: the first alone (its peak memory),
    the rest back to back.  Returns (first result, stream ms and host ms
    of a call, the mean over calls 2.. (or of the one call), the cell's
    peak bytes, the bytes held apart from it, launches over every call).
    The cell's peak is the card's peak less what it held at the start
    beside the cell's arguments ``args`` (library workspaces, the
    checks' reference copies), which no dry-run of the cell sees."""
    from repro_torch.kernels import dispatch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    apart = max(torch.cuda.memory_allocated() - storage_bytes(torch, args),
                0)
    dispatch.reset_counters()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    first = call(0)
    b.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    stream = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated()
    if calls > 1:
        t0 = time.perf_counter()
        a.record()
        for i in range(1, calls):
            call(i)
        b.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / (calls - 1)
        stream = a.elapsed_time(b) / (calls - 1)
        peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in dispatch.counters().items()
                if c.launches}
    return first, stream, host, peak - apart, apart, launches


def all_finite(torch, out, what):
    from repro_torch.train import tree
    for t in tree.leaves(out):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                not bool(torch.isfinite(t).all()):
            raise AssertionError(f"[cells] {what}: an output is not finite")


def cell_train(torch, spec, cell, mesh, cfg):
    """A train cell: the reference step (``train.step.make_train_step``
    outside the mesh) from fresh seeded parameters, then the cell's fn
    from the same parameters on the same batch; first losses within
    CELL_LOSS_RTOL.  Returns (times, peak, launches, first loss, note)."""
    import functools

    from repro_torch.configs import registry
    from repro_torch.dist.api import sharding_rules
    from repro_torch.launch import cells
    from repro_torch.models import egnn
    from repro_torch.train import step as st

    arch, fam = spec["arch"], spec["family"]
    mod = registry.get(arch)
    batch = cell_batch(torch, spec, cfg, cell.args[1], cell_gen(torch, spec,
                                                                1))
    extra, note = {}, ""
    if fam == "lm":
        loss = functools.partial(st.lm_loss_fn, cfg=cfg)
        accum, accum_dtype = mod.TRAIN_ACCUM_STEPS, mod.ACCUM_DTYPE
    elif fam == "gnn":
        geom = registry_shape(spec)
        t0 = time.perf_counter()
        plan = egnn.prepare(batch["edge_index"], batch["feat"].shape[0],
                            batch.get("graph_ids"), geom.get("batch"))
        extra["plan"] = plan
        note = (f"; plan of {len(plan.edges.chunks)} edge chunk(s) in "
                f"{time.perf_counter() - t0:.2f} s")
        loss = functools.partial(st.egnn_loss_fn, cfg=cfg,
                                 n_graphs=geom.get("batch"), plan=plan)
        accum, accum_dtype = 1, torch.float32
    else:
        loss = functools.partial(
            st.seqrec_loss_fn if arch in ("sasrec", "bert4rec")
            else st.ctr_loss_fn, cfg=cfg)
        accum, accum_dtype = 1, torch.float32

    def fresh():
        params = cell_params(torch, spec, cfg, cell_gen(torch, spec))
        opt = cells.make_optimizer(mod.OPTIMIZER)
        return {"params": params, "opt": opt.init(params)}, opt

    state, opt = fresh()
    ref_step = st.make_train_step(loss, opt, accum, accum_dtype)
    _, m = ref_step(state, batch)
    ref_loss = float(m["loss"])
    del state, m, ref_step
    gc.collect()
    torch.cuda.empty_cache()
    state, _ = fresh()
    check_tree(torch, state, cell.args[0], f"{arch}@{spec['shape']}")
    losses = []

    def call(i):
        nonlocal state
        with sharding_rules(mesh, cell.rules):
            state, metrics = cell.fn(state, batch, **extra)
        losses.append(metrics["loss"])
        return metrics

    metrics, stream, host, peak, apart, launches = cell_times(
        torch, call, CELL_CALLS[fam], (state, batch, extra))
    all_finite(torch, metrics, f"{arch}@{spec['shape']}")
    losses = [float(x) for x in losses]
    if not all(map(math.isfinite, losses)) or \
            abs(losses[0] - ref_loss) > CELL_LOSS_RTOL * abs(ref_loss):
        raise AssertionError(f"[cells] {arch}@{spec['shape']}: first loss "
                             f"{losses[0]} != make_train_step's {ref_loss}")
    note = (f"; loss {losses[0]:.6f} (make_train_step's {ref_loss:.6f})"
            + (f" -> {losses[-1]:.6f} over {len(losses)} steps"
               if len(losses) > 1 else "") + note)
    del state, batch, extra
    return stream, host, peak, apart, launches, note


def cell_serve(torch, spec, cell, mesh, cfg):
    """A serve / prefill / decode / retrieval cell: fn against the direct
    model path (no mesh, no rules) on the same inputs, within 0 (top-k by
    ``assert_topk_agree``).  Returns (times, peak, launches, note)."""
    from repro_torch.configs import registry
    from repro_torch.dist.api import sharding_rules
    from repro_torch.kernels.parity import assert_topk_agree
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as tf

    arch, shape, fam = spec["arch"], spec["shape"], spec["family"]
    what = f"{arch}@{shape}"
    params = cell_params(torch, spec, cfg, cell_gen(torch, spec))
    check_tree(torch, params, cell.args[0], what)
    gen = cell_gen(torch, spec, 1)
    rows = spec["rows"]
    note = ""
    if fam == "lm" and cell.kind == "prefill":
        tok = cell_batch(torch, spec, cfg, {"tokens": cell.args[1]}, gen)
        args = [(params, tok["tokens"])]

        def direct(_p, t):
            logits, _a, _h, caches = tf.forward(
                params, t, cfg, return_kv=True, kv_len=spec["seq"])
            return logits, caches
    elif fam == "lm":
        b, s = spec["batch"], spec["seq"]
        caches = tf.init_kv_caches(cfg, b, s, device=DEV)
        for group in caches:
            for c in group:
                c.normal_(0.0, 0.5, generator=gen)
        token = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                              device=DEV, dtype=torch.int32)
        ref_caches = [tuple(c.clone() for c in g) for g in caches]
        cur = torch.tensor(s, dtype=torch.int32)
        args = [(params, token, caches, cur)]
        check_tree(torch, caches, cell.args[2], what)

        def direct(_p, t, _c, n):
            return tf.decode_step(params, t, ref_caches, int(n), cfg)
    else:
        names = {"dlrm-rm2": ("dense", "sparse"),
                 "xdeepfm": ("sparse",)}.get(arch, ("items",))
        total = cell_total_rows(spec)
        full = cell_batch(torch, spec, cfg, {
            k: torch.empty((total,) + tuple(m.shape[1:]), dtype=m.dtype,
                           device="meta")
            for k, m in zip(names, cell.args[1:])}, gen)
        step = rows or total
        args = [(params, *(full[k][lo:lo + step] for k in names))
                for lo in range(0, total, step)]
        if cell.kind == "serve" and arch in ("dlrm-rm2", "xdeepfm"):
            fwd = rs.dlrm_forward if arch == "dlrm-rm2" else \
                rs.xdeepfm_forward

            def direct(p, *a):
                return fwd(p, *a, cfg)
        else:
            table = params["item_emb"] if "item_emb" in params \
                else params["tables"][0]
            n_valid = None if cell.kind == "serve" else \
                registry.RECSYS_SHAPES[shape]["n_candidates"]
            index = rs.candidate_index(table, n_valid=n_valid, device=DEV)
            k = 100 if cell.kind == "serve" else 1000

            def direct(p, *a):
                if arch == "dlrm-rm2":
                    q = rs.dlrm_user_tower(p, *a, cfg)
                elif arch == "xdeepfm":
                    q = rs.xdeepfm_user_tower(p, *a, cfg)
                else:
                    q = rs.seqrec_session_repr(p, *a, cfg)
                r = index.search(q, k)
                return r.scores, r.ids
    outs = []
    n_calls = len(args) if rows else CELL_CALLS[fam]

    def call(i):
        with sharding_rules(mesh, cell.rules):
            out = cell.fn(*args[i % len(args)])
        if i < len(args):
            outs.append(out)
        return out

    _, stream, host, peak, apart, launches = cell_times(torch, call,
                                                        n_calls, args)
    for a, got in zip(args, outs):
        all_finite(torch, got, what)
        want = direct(*a)
        if cell.kind in ("serve", "retrieval") and isinstance(got, tuple):
            assert_topk_agree(got[0], got[1], want[0], want[1], SCORE_TOL,
                              f"[cells] {what}")
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"[cells] {what}: scores differ from "
                                     f"the direct path's")
        else:
            from repro_torch.train import tree
            for g, w in zip(tree.leaves(got), tree.leaves(want)):
                if not torch.equal(g, w):
                    raise AssertionError(f"[cells] {what}: output differs "
                                         f"from the direct model path's")
    if rows:
        note = f"; {len(args)} chunks, each equal to the direct path's"
    else:
        note = "; output equal to the direct model path's"
    if rows:
        stream, host = stream * len(args), host * len(args)
    del args, outs, params
    return stream, host, peak, apart, launches, note


def cell_total_rows(spec) -> int:
    """A recsys cell's whole batch (before a row cut)."""
    from repro_torch.configs import registry
    return registry.RECSYS_SHAPES[spec["shape"]]["batch"]


def cells_phase(torch, tmp):
    """[cells]: every cell on the card (module comment above CELL_LM_CUTS),
    each checked, timed and beside its dry-run estimate.  Returns
    {"cells": {kernel: launches}}."""
    import multiprocessing as mp

    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.launch.roofline import Roofline

    t_phase = time.perf_counter()
    specs = cell_specs()
    pool = mp.get_context("spawn").Pool(CELL_WORKERS)
    pending = pool.map_async(cell_estimate, specs)
    _flat, mesh = dist_group(torch, tmp)
    rows, total = [], {}
    try:
        for spec in specs:
            arch, shape = spec["arch"], spec["shape"]
            mod = registry.get(arch)
            if spec["family"] == "lm":
                cfg = cell_config(spec)
            elif spec["family"] == "gnn":
                geom = registry_shape(spec)
                cfg = mod.full_config(
                    d_feat=geom["d_feat"],
                    readout="graph" if geom["kind"] == "batched" else "node")
            else:
                cfg = mod.full_config()
            t0 = time.perf_counter()
            cell = build_spec_cell(spec, mesh)
            runner = cell_train if cell.kind == "train" else cell_serve
            stream, host, peak, apart, launches, note = runner(
                torch, spec, cell, mesh, cfg)
            for n, v in launches.items():
                total[n] = total.get(n, 0) + v
            # a cell run in row chunks: the whole shape's time and flops
            chunks = (cell_total_rows(spec) // spec["rows"]
                      if spec["rows"] and cell.kind == "serve" else 1)
            rows.append({"cell": f"{arch}@{shape}", "kind": cell.kind,
                         "reduced": cell_reduced(spec),
                         "stream_ms": stream, "host_ms": host,
                         "peak_gb": peak / 1e9, "apart_gb": apart / 1e9,
                         "model_flops": cell.meta["model_flops"] * chunks,
                         "chunks": chunks,
                         "launches": launches,
                         "wall_s": time.perf_counter() - t0, "note": note})
            log(f"[cells] {arch}@{shape} ({cell.kind}; reduced: "
                f"{rows[-1]['reduced']}): {stream:.4f} ms on the stream "
                f"(CUDA events), {host:.4f} ms on the host clock a call; "
                f"peak device memory {peak / 1e9:.3f} GB (beside "
                f"{apart / 1e9:.3f} GB held apart from its arguments); "
                f"kernel launches {launches}{note}")
            del cell
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    estimates = pending.get(timeout=900)
    pool.close()
    pool.join()
    for row, est in zip(rows, estimates):
        # a cell run in row chunks: the dry-run traced one chunk
        n = row["chunks"]
        roof = Roofline(flops=est["flops"] * n, hbm_bytes=est["bytes"] * n,
                        coll_bytes=est["coll"] * n,
                        model_flops=row["model_flops"], n_devices=1)
        row.update(est_gb=est["peak"] / 1e9, bound_ms=roof.bound_time * 1e3,
                   dominant=roof.dominant,
                   tflops=row["model_flops"] / row["host_ms"] / 1e9,
                   trace_s=est["trace_s"])
        log(f"[cells] {row['cell']}: model {row['model_flops']:.4g} flops, "
            f"{row['tflops']:.4g} TFLOP/s on the host clock; roofline "
            f"bound {row['bound_ms']:.4f} ms ({row['dominant']}; dry-run "
            f"flops {est['flops'] * n:.4g}, bytes {est['bytes'] * n:.4g}); "
            f"dry-run "
            f"peak estimate {row['est_gb']:.3f} GB beside the measured "
            f"{row['peak_gb']:.3f} GB (traced in {est['trace_s']:.1f} s)")
        if est["peak"] < 0.5 * row["peak_gb"] * 1e9:
            raise AssertionError(f"[cells] {row['cell']}: the dry-run's "
                                 f"estimate {row['est_gb']:.3f} GB is under "
                                 f"half the measured peak")
    for row in rows:
        # the kernels of each serving path: the kNN pair behind every
        # retrieval and seqrec serve, the embedding bag behind the CTR
        # models' pooling
        arch, need = row["cell"].split("@")[0], ()
        if row["kind"] == "retrieval" or (row["kind"] == "serve" and arch in
                                          ("sasrec", "bert4rec")):
            need = ("knn_score", "knn_select")
        if row["kind"] in ("serve", "retrieval") and arch in ("dlrm-rm2",
                                                              "xdeepfm"):
            need += ("embedding_bag",)
        if any(not row["launches"].get(n) for n in need):
            raise AssertionError(f"[cells] {row['cell']}: launches "
                                 f"{row['launches']}, missing one of {need}")
    log("[cells] table " + json.dumps(rows))
    log(f"[cells] {len(rows)} cells; launches {total}; phase in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"cells": total}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (engine needs paper); a subset prints no kernels "
                    "line and no ok line")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES) or ("engine" in phases
                                     and "paper" not in phases):
        ap.error(f"--phases {args.phases}: choose from {PHASES}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all(verbose=True)
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s\n{report}")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    rep = Report()
    t_start = time.perf_counter()
    paths = {}
    if phases & {"kernels", "probe"}:
        timing = probe_timing(torch, args.seed)
    if "kernels" in phases:
        probe_phase(torch, rep, gen, timing)
        probe_single_phase(torch, rep, gen, timing)
        wave_phase(torch, rep, gen)
        wave_single_phase(torch, rep, gen)
    if "recsys" in phases:
        paths.update(recsys_phase(torch, rep, gen, args.seed))
        torch.cuda.empty_cache()
    global SEED
    SEED = args.seed
    if "lm" in phases:         # before the corpus: 31.6 GB of weights
        paths.update(lm_phase(torch))
        torch.cuda.empty_cache()
    if "seqrec" in phases:
        paths.update(seqrec_phase(torch, rep))
        torch.cuda.empty_cache()
    if "egnn" in phases:
        egnn_phase(torch)
        torch.cuda.empty_cache()
    if "train" in phases:      # before the corpus, as [recsys]
        train_phase(torch)
        torch.cuda.empty_cache()
    tier_rows = {}
    dist_tmp = tempfile.mkdtemp() if "dist" in phases else None
    if phases & {"kernels", "encoder", "ab", "main", "tiered", "paper",
                 "dist"}:
        world, corpus, streams = build_corpus(torch, args.seed)
        if "encoder" in phases:
            paths.update(encoder_phase(torch, corpus))
        if "kernels" in phases:
            knn_phase(torch, rep, corpus, streams)
        if "ab" in phases:
            paths["ab"] = ab_phase(torch, rep, corpus, streams)
        if "main" in phases:
            paths["main"] = main_phase(torch, corpus, streams)
        if "tiered" in phases:
            tiered, tier_rows, (ci, served) = tiered_phase(torch, corpus,
                                                           world)
            paths.update(tiered)
            tiered_kernels(torch, rep, corpus, ci, served, world)
            del served
            torch.cuda.empty_cache()
        if "paper" in phases:
            dynamic, paths["paper"] = paper_phase(torch, corpus, world,
                                                  streams)
        if "engine" in phases:
            paths["engine"] = engine_phase(torch, corpus, streams, dynamic)
        if "dist" in phases:
            flat, mesh = dist_group(torch, dist_tmp)
            paths.update(dist_index(torch, corpus, streams, flat))
            paths.update(dist_scorer(torch, mesh))
            dist_forward(torch, mesh)
        # release the corpus and everything that reads it
        world = corpus = streams = dynamic = ci = None
        gc.collect()
        torch.cuda.empty_cache()
    if "dist" in phases:
        held = torch.cuda.memory_allocated() / 1e9
        log(f"[dist] corpus released: {held:.2f} GB allocated on the card")
        dist_moe(torch, mesh)
        import torch.distributed as dist
        dist.destroy_process_group()
        shutil.rmtree(dist_tmp, ignore_errors=True)
    if "cells" in phases:      # last: a world of one of its own
        gc.collect()
        torch.cuda.empty_cache()
        cells_tmp = tempfile.mkdtemp()
        paths.update(cells_phase(torch, cells_tmp))
        shutil.rmtree(cells_tmp, ignore_errors=True)
    log(f"[done] phases in {time.perf_counter() - t_start:.1f} s")
    if phases != set(PHASES):
        print(smi)
        return 0
    launches = {n: sum(p.get(n, 0) for p in paths.values()) for n in KERNELS}
    launches.update({n: sum(paths[p].get(k, 0) for p in
                            ("paper", "engine", "encoder_session",
                             "dist_b1"))
                     for n, k in {**B1_ROWS, **S1_ROWS}.items()})
    launches.update(tier_rows)
    launches.update({
        "knn_score_seqrec": paths["seqrec"]["knn_score"],
        "knn_select_seqrec": paths["seqrec"]["knn_select"],
        "knn_score_cand": paths["seqrec_cand"]["knn_score"]
        + paths["recsys_cand"]["knn_score"]
        + paths["dist_cand"]["knn_score"],
        "knn_select_cand": paths["seqrec_cand"]["knn_select"]
        + paths["recsys_cand"]["knn_select"]
        + paths["dist_cand"]["knn_select"],
        "embedding_bag_cand": paths["recsys_cand"]["embedding_bag"]})
    print(rep.line(launches))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
