"""The inputs a cell makes from ``--seed``: weights, token scripts, the
corpus and SASRec histories.

Both sides get the same inputs: the program receives them as arguments,
and the reference, which never reads what the program holds, makes them
again from the seed.  Everything large is drawn on the device in a few
calls.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK_ROWS = 1 << 20         # corpus rows drawn together (one generator)


def sub_seed(seed: int, *salt) -> int:
    """A 63-bit seed for one stream of the run's draws."""
    words = [int(seed) % (1 << 64)]
    words = [words[0] & 0xFFFFFFFF, words[0] >> 32]
    for s in salt:
        words.append(int(s) if isinstance(s, int) else
                     int.from_bytes(str(s).encode()[:8].ljust(8, b"\0"),
                                    "little"))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31 | int(state[1]) >> 1) & ((1 << 63) - 1)


def generator(seed: int, *salt, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *salt))
    return g


def _fill(shapes: dict, g: torch.Generator, device) -> dict:
    """One ``randn`` over the sum of the shapes, cut into views and scaled:
    {name: (shape, scale, offset)} -> {name: tensor}; ``offset`` is added
    after scaling (1.0 for norm scales)."""
    sizes = {k: int(np.prod(s)) for k, (s, _, _) in shapes.items()}
    flat = torch.randn(sum(sizes.values()), generator=g, device=device)
    out, lo = {}, 0
    for k, (shape, scale, offset) in shapes.items():
        t = flat[lo:lo + sizes[k]].view(shape)
        t.mul_(scale)
        if offset:
            t.add_(offset)
        out[k] = t
        lo += sizes[k]
    return out


def encoder_weights(enc: dict, seed: int, device) -> dict:
    """The query encoder's weights as the program's parameter tree
    (``embed``, ``final_norm``, ``group0_dense`` stacked over layers) and
    the projection ``proj`` (d_model, out_dim).  Norm scales are 1 + 0.1 z
    so that a norm applied without its scale shows."""
    d, n = enc["d_model"], enc["n_layers"]
    hd, kvd = enc["n_heads"] * enc["d_head"], enc["n_kv_heads"] * enc["d_head"]
    f = enc["d_ff"]
    out_scale = (2 * n) ** -0.5
    w = _fill({
        "embed": ((enc["vocab_size"], d), 0.02, 0.0),
        "final_norm": ((d,), 0.1, 1.0),
        "wq": ((n, d, hd), d ** -0.5, 0.0),
        "wk": ((n, d, kvd), d ** -0.5, 0.0),
        "wv": ((n, d, kvd), d ** -0.5, 0.0),
        "wo": ((n, hd, d), hd ** -0.5 * out_scale, 0.0),
        "pre_attn_norm": ((n, d), 0.1, 1.0),
        "pre_ffn_norm": ((n, d), 0.1, 1.0),
        "wi": ((n, d, 2 * f), d ** -0.5, 0.0),
        "wo_ffn": ((n, f, d), f ** -0.5 * out_scale, 0.0),
        "proj": ((d, enc["out_dim"]), d ** -0.5, 0.0),
    }, generator(seed, "encoder", device=device), device)
    params = {
        "embed": w["embed"], "final_norm": w["final_norm"],
        "group0_dense": {
            "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
            "pre_attn_norm": w["pre_attn_norm"],
            "pre_ffn_norm": w["pre_ffn_norm"],
            "ffn": {"wi": w["wi"], "wo": w["wo_ffn"]},
        },
    }
    return {"params": params, "proj": w["proj"]}


def seqrec_weights(cfg: dict, seed: int, device) -> dict:
    """SASRec's weights as the program's parameter tree: the item table,
    positions, ``n_blocks`` blocks (q, k, v, o, a two-layer ReLU FFN with
    biases, two norms) and the final norm."""
    d, v, s = cfg["embed_dim"], cfg["vocab"], cfg["max_len"]
    f = cfg["d_ff_mult"] * d
    shapes = {"item_emb": ((v, d), d ** -0.5, 0.0),
              "pos_emb": ((s, d), 0.02, 0.0),
              "final_norm": ((d,), 0.1, 1.0)}
    for i in range(cfg["n_blocks"]):
        for k in ("wq", "wk", "wv", "wo"):
            shapes[f"{i}.{k}"] = ((d, d), d ** -0.5, 0.0)
        shapes[f"{i}.w0"] = ((d, f), (2.0 / d) ** 0.5, 0.0)
        shapes[f"{i}.b0"] = ((f,), 0.01, 0.0)
        shapes[f"{i}.w1"] = ((f, d), (2.0 / f) ** 0.5, 0.0)
        shapes[f"{i}.b1"] = ((d,), 0.01, 0.0)
        shapes[f"{i}.norm1"] = ((d,), 0.1, 1.0)
        shapes[f"{i}.norm2"] = ((d,), 0.1, 1.0)
    w = _fill(shapes, generator(seed, "seqrec", device=device), device)
    blocks = [{"wq": w[f"{i}.wq"], "wk": w[f"{i}.wk"], "wv": w[f"{i}.wv"],
               "wo": w[f"{i}.wo"],
               "ffn": [{"w": w[f"{i}.w0"], "b": w[f"{i}.b0"]},
                       {"w": w[f"{i}.w1"], "b": w[f"{i}.b1"]}],
               "norm1": w[f"{i}.norm1"], "norm2": w[f"{i}.norm2"]}
              for i in range(cfg["n_blocks"])]
    return {"item_emb": w["item_emb"], "pos_emb": w["pos_emb"],
            "blocks": blocks, "final_norm": w["final_norm"]}


# ------------------------------------------------------------ token scripts
def markov_tokens(n_rows: int, seq: int, vocab: int, n_states: int,
                  seed: int, step: int) -> np.ndarray:
    """(n_rows, seq) int32 tokens of a Markov chain over ``n_states``
    states mapped into the vocabulary (the chain of the program's
    ``data.lm.TokenStream``, drawn from this run's seed)."""
    rng = np.random.default_rng(sub_seed(seed, "markov"))
    proj = rng.integers(0, vocab, n_states).astype(np.int32)
    trans = rng.dirichlet(np.full(n_states, 0.3), size=n_states)
    cum = np.cumsum(trans, axis=1).astype(np.float32)
    rng = np.random.default_rng(sub_seed(seed, "markov-step", step))
    u = rng.random((n_rows, seq), dtype=np.float32)
    states = np.zeros((n_rows, seq), np.int32)
    states[:, 0] = rng.integers(0, n_states, n_rows)
    for t in range(1, seq):
        states[:, t] = np.argmax(u[:, t][:, None] < cum[states[:, t - 1]],
                                 axis=1)
    return proj[states]


@dataclasses.dataclass
class Scripts:
    """A pool of conversation scripts: ``rows`` (n_scripts, turns, seq)
    int32, right-padded with -1; ``unique`` (n_scripts, turns) the index of
    each turn's row among the pool's distinct rows (a repeated turn points
    at the row it repeats); ``unique_rows`` (n_unique, seq)."""

    rows: np.ndarray
    lengths: np.ndarray
    unique: np.ndarray
    unique_rows: np.ndarray


def token_scripts(sc: dict, vocab: int, seed: int) -> Scripts:
    """Turns of a ``prefix``-token topic prefix plus a per-turn suffix of
    ``suffix[0]..suffix[1]`` tokens; the turns in ``repeats`` repeat an
    earlier turn verbatim (the distribution of the program's
    ``chip_smoke.token_conversations``).  Any other turn after the first
    jumps to a new sub-topic with probability ``subtopic_prob``: a new
    prefix, which the later turns keep."""
    n, turns, seq = sc["n_scripts"], sc["turns"], sc["seq"]
    pre, (lo, hi) = sc["prefix"], sc["suffix"]
    repeats = {int(k): int(v) for k, v in sc["repeats"].items()}
    if pre + hi > seq:
        raise ValueError("prefix + longest suffix exceed the row length")
    steps = [markov_tokens(n, seq, vocab, sc["markov_states"], seed, t)
             for t in range(turns + 1)]
    topics = [markov_tokens(n, pre, vocab, sc["markov_states"], seed,
                            turns + 1 + t) for t in range(turns)]
    rng = np.random.default_rng(sub_seed(seed, "suffix"))
    jumps = np.random.default_rng(sub_seed(seed, "jumps")).random(
        (n, turns)) < sc.get("subtopic_prob", 0.0)
    rows = np.full((n, turns, seq), -1, np.int32)
    lengths = np.zeros((n, turns), np.int64)
    unique = np.zeros((n, turns), np.int64)
    uniq_rows = []
    for c in range(n):
        prefix = steps[0][c, :pre]
        for t in range(turns):
            if t in repeats:
                rows[c, t] = rows[c, repeats[t]]
                lengths[c, t] = lengths[c, repeats[t]]
                unique[c, t] = unique[c, repeats[t]]
                continue
            if t > 0 and jumps[c, t]:
                prefix = topics[t][c]
            m = int(rng.integers(lo, hi + 1))
            rows[c, t, :pre] = prefix
            rows[c, t, pre:pre + m] = steps[1 + t][c, :m]
            lengths[c, t] = pre + m
            unique[c, t] = len(uniq_rows)
            uniq_rows.append(rows[c, t])
    return Scripts(rows, lengths, unique, np.stack(uniq_rows))


# ------------------------------------------------------------------ corpus
@dataclasses.dataclass
class CorpusRecipe:
    """How the corpus is drawn, block by block, so that either side can
    draw any block again.  Rows [0, n_planted) lie around ``centres``:
    ``per`` rows a centre, unit(c + sigma z F) with z a ``sub``-dim normal
    and F the centre's script frame; the rest are uniform directions.
    Every row has a norm in [1 - jitter, 1 + jitter]."""

    n: int
    dim: int
    centres: torch.Tensor        # (n_centres, dim) unit, on the device
    frames: torch.Tensor         # (n_scripts, sub, dim) on the device
    centre_script: torch.Tensor  # (n_centres,) int64 script of a centre
    per: int
    sigma: float
    jitter: float
    seed: int

    @property
    def n_planted(self) -> int:
        return self.centres.shape[0] * self.per

    def script_rows(self) -> np.ndarray:
        """(n_scripts + 1,) the first planted row of each script (its
        centres lie together, in script order)."""
        counts = np.bincount(self.centre_script.cpu().numpy(),
                             minlength=self.frames.shape[0])
        return np.concatenate([[0], np.cumsum(counts) * self.per])

    def norms(self) -> torch.Tensor:
        g = generator(self.seed, "norms", device=self.centres.device)
        u = torch.rand(self.n, generator=g, device=self.centres.device)
        return 1.0 + self.jitter * (2.0 * u - 1.0)

    def max_norm(self) -> float:
        return float(self.norms().max())

    def blocks(self, norms: torch.Tensor | None = None,
               block_rows: int = BLOCK_ROWS):
        """Yield (lo, hi, raw rows (hi - lo, dim) f32) over the corpus."""
        norms = self.norms() if norms is None else norms
        dev = self.centres.device
        sub = self.frames.shape[1]
        for b, lo in enumerate(range(0, self.n, block_rows)):
            hi = min(lo + block_rows, self.n)
            g = generator(self.seed, "block", b, device=dev)
            x = torch.randn(hi - lo, self.dim, generator=g, device=dev)
            p_hi = min(hi, self.n_planted)
            if lo < p_hi:
                # planted rows lie centre by centre, a script's centres
                # together: one product per script that the block holds
                r = torch.arange(lo, p_hi, device=dev)
                c = r // self.per
                z = x[:p_hi - lo, :sub] * (self.sigma / sub ** 0.5)
                off = torch.empty(p_hi - lo, self.dim, device=dev)
                first = self.script_rows()
                s = int(np.searchsorted(first, lo, side="right")) - 1
                while s < len(first) - 1 and first[s] < p_hi:
                    a, b = max(first[s], lo) - lo, min(first[s + 1], p_hi) - lo
                    off[a:b] = z[a:b] @ self.frames[s]
                    s += 1
                x[:p_hi - lo] = self.centres[c] + off
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
            yield lo, hi, x * norms[lo:hi, None]


def corpus_recipe(cfg: dict, centres: torch.Tensor,
                  centre_script: np.ndarray, n_scripts: int,
                  seed: int) -> CorpusRecipe:
    c = cfg["corpus"]
    dev = centres.device
    g = generator(seed, "frames", device=dev)
    frames = torch.randn(n_scripts, c["subspace_dim"], c["dim"],
                         generator=g, device=dev) / c["dim"] ** 0.5
    if centres.shape[0] * c["planted_per_centre"] > c["n_docs"]:
        raise ValueError("planted rows exceed the corpus")
    return CorpusRecipe(
        n=c["n_docs"], dim=c["dim"], centres=centres, frames=frames,
        centre_script=torch.as_tensor(centre_script, device=dev),
        per=c["planted_per_centre"], sigma=c["planted_sigma"],
        jitter=c["norm_jitter"], seed=seed)


# --------------------------------------------------------- SASRec histories
def histories(tr: dict, vocab: int, max_len: int, seed: int) -> np.ndarray:
    """(pool, batch, max_len) int32 item histories, right-padded with -1:
    lengths 1..max_len from a power law of exponent ``length_alpha``, items
    Zipf(``zipf_alpha``) over the catalogue, ranks scattered by a seeded
    permutation."""
    rng = np.random.default_rng(sub_seed(seed, "histories"))
    pool, b = tr["pool"], tr["batch"]
    lens = np.arange(1, max_len + 1, dtype=np.float64)
    p_len = lens ** -tr["length_alpha"]
    n = rng.choice(lens.astype(np.int64), size=(pool, b),
                   p=p_len / p_len.sum())
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -tr["zipf_alpha"])
    cdf /= cdf[-1]
    perm = rng.permutation(vocab).astype(np.int32)
    u = rng.random((pool, b, max_len))
    items = perm[np.minimum(np.searchsorted(cdf, u), vocab - 1)]
    pos = np.arange(max_len)[None, None, :]
    return np.where(pos < n[..., None], items, -1).astype(np.int32)
