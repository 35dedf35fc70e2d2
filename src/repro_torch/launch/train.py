"""Training CLI of the port (``repro/launch/train.py`` with ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --steps 100 --batch 8 --seq 128 [--reduced] [--ckpt-dir DIR] [--device cuda|cpu]

``--arch`` takes every LM config of the port: ``granite-3-2b``,
``h2o-danube-1.8b``, ``minitron-4b`` and ``llama3-405b`` (dense),
``granite-moe-3b-a800m`` and ``llama4-maverick-400b-a17b`` (MoE; the loss
adds 0.01 times the Switch auxiliary loss), ``internvl2-26b`` (VLM; its
batches carry vision embeddings) and ``zamba2-2.7b`` (hybrid).
Synthetic data (``data/pipeline.SyntheticLMStream``), AdamW, the
fault-tolerant restart loop and async checkpoints (``runtime/``).  As in
the reference, ``--reduced`` cannot be turned off (``store_true`` with a
default of True), so the CLI trains the reduced config.  ``--device``
defaults to ``cuda`` and raises without a card.  The reduced configs'
head dim of 32 has no flash kernel, so on the card every family fails at
its first attention; the full widths train through ``make_train_step``
and ``run_training`` as this CLI wires them (``chip_smoke.py`` phase
``train``: granite-3-2b in (a), zamba2-2.7b in (d), granite-moe-3b-a800m
in (e)).
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.runtime.ft import run_training
from repro_torch.train.loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = models.build(cfg, device)
    step_fn = make_train_step(model, ParallelConfig(), peak_lr=args.lr,
                              total_steps=args.steps)
    data = SyntheticLMStream(cfg, batch=args.batch, seq_len=args.seq, device=device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")

    def init_state():
        p = model.init(0)
        return p, step_fn.opt_init(p)

    report = run_training(step_fn, init_state, data.batch_at, args.steps, ckpt_dir,
                          ckpt_every=args.ckpt_every)
    print(f"finished {report.final_step} steps; "
          f"loss {report.losses[0]:.4f} -> "
          f"{report.losses[max(report.losses)]:.4f}; ckpts in {ckpt_dir}")
    return report


if __name__ == "__main__":
    main()
