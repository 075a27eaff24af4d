"""Train the paper's STAR encoder backbone on the synthetic Markov token
stream, with checkpoints and resume: the end-to-end training script.

The port of ``examples/train_encoder.py``::

    PYTHONPATH=src python -m repro_torch.train.encoder [--steps 200] \\
        [--full-size] [--device cpu] [--batch 16 --seq 64 --accum 1 \\
        --remat none] [--ckpt-dir artifacts/encoder_ckpt]

AdamW (lr 3e-4, warmup 20) over ``TokenStream`` batches; a
``CheckpointManager`` saves every ``--interval`` steps and a rerun resumes
from the latest checkpoint (the stream is stateless: batch ``i`` is the
same on every run).  The weights are seeded random (the STAR weights are
not in the repo); the default is the smoke config, ``--full-size`` the
12-layer, d 768 encoder.  The device defaults to the card and raises
without one; ``--device cpu`` runs the plain path.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import star_encoder
from repro_torch.data.lm import LMBatchSpec, TokenStream
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import adamw
from repro_torch.train.step import make_lm_train_step

__all__ = ["train", "main"]

LR, WARMUP, KEEP = 3e-4, 20, 2


def _fresh_state(cfg: tf.TransformerConfig, opt, device, seed: int):
    """{"params", "opt"} with the parameters drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = tf.init_params(cfg, device=device, generator=gen)
    return {"params": params, "opt": opt.init(params)}


def train(cfg: tf.TransformerConfig, steps: int, ckpt_dir: str, *,
          device=None, batch: int = 16, seq: int = 64, accum: int = 1,
          remat: str = "none", interval: int = 50, seed: int = 0,
          on_step: Optional[Callable] = None):
    """Run (or resume) to ``steps`` steps.  Returns (state, the first step
    this run took, its per-step metrics: dicts of scalar tensors).
    ``on_step(step, metrics)`` is called after each step."""
    dev = resolve_device(device)
    opt = adamw(lr=LR, warmup=WARMUP)
    step_fn = make_lm_train_step(cfg, opt, accum_steps=accum, remat=remat)
    stream = TokenStream(LMBatchSpec(global_batch=batch, seq_len=seq,
                                     vocab_size=cfg.vocab_size), device=dev)
    mgr = CheckpointManager(ckpt_dir, interval=interval, keep=KEEP)
    state, start = mgr.restore_or(_fresh_state(cfg, opt, dev, seed))
    history = []
    for step in range(start, steps):
        state, metrics = step_fn(state, stream.batch(step))
        mgr.maybe_save(step + 1, state)
        history.append(metrics)
        if on_step is not None:
            on_step(step, metrics)
    mgr.wait()
    return state, start, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="artifacts/encoder_ckpt")
    ap.add_argument("--full-size", action="store_true",
                    help="the 12-layer, d 768 STAR shape (default: the "
                         "smoke config)")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); cpu runs "
                         "the plain path")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=tf.REMAT_POLICIES)
    ap.add_argument("--interval", type=int, default=50)
    args = ap.parse_args(argv)

    cfg = (star_encoder.full_config() if args.full_size
           else star_encoder.smoke_config())
    t0 = time.perf_counter()

    def report(step, metrics):
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)

    _, start, _ = train(cfg, args.steps, args.ckpt_dir, device=args.device,
                        batch=args.batch, seq=args.seq, accum=args.accum,
                        remat=args.remat, interval=args.interval,
                        on_step=report)
    if start:
        print(f"resumed from checkpoint at step {start}")
    print("done; checkpoints in", args.ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
