"""Train-step factory: loss and gradients by autograd, microbatch
accumulation, remat, optimizer update (``repro/train/loop.py``).

There is no ``jit``: the step runs eagerly.  On the card every attention
of the forward runs the hand-written flash kernel and its gradient the
hand-written backward kernel (``kernels/ops.FlashAttention``), and every
SSD scan of the hybrid family the ``mamba_ssd`` kernel's state-writing
entry and its gradient ``mamba_ssd_bwd`` (``kernels/ops.MambaSSD``); with
remat each layer's (dense) or group's (hybrid) forward, its launches
included, runs again in the backward pass.  The optimizer writes the new parameters and state into
the tensors it is given (``optim``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.configs.base import ParallelConfig
from repro_torch.optim import get_optimizer
from repro_torch.optim.schedule import warmup_cosine


def _split(x: torch.Tensor, k: int) -> torch.Tensor:
    b = x.shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by microbatch {k}")
    return x.reshape(k, b // k, *x.shape[1:])


def make_train_step(model, parallel: ParallelConfig, peak_lr: float = 3e-4,
                    total_steps: int = 10_000) -> Callable:
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``, with ``train_step.opt_init(params)``.

    ``parallel.microbatch`` k > 1 splits the batch into k slices, sums
    their losses and gradients (in f32 accumulators) and divides both by
    k; ``parallel.remat`` other than ``"none"`` checkpoints each layer;
    ``parallel.optimizer`` names the update.  The loss and gradient norm
    stay on the device (no synchronisation in the step)."""
    opt_init, opt_update = get_optimizer(parallel.optimizer)
    remat = parallel.remat != "none"

    def loss_and_grads(params, mb):
        leaves, _ = tree.flatten(params)
        # detached views that require grad: the parameters themselves never do
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss = model.loss(tree.unflatten(params, live), mb, remat=remat)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(params, opt_state, batch, step):
        k = parallel.microbatch
        if k <= 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            mbs = {name: _split(x, k) for name, x in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree.flatten(params)[0]]
            loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            for i in range(k):
                l, g = loss_and_grads(params, {name: x[i] for name, x in mbs.items()})
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                loss = loss + l
                del g
            loss = loss / k
            grads = [a.div_(k) for a in acc]
        lr = warmup_cosine(step, peak_lr, total=total_steps)
        params, opt_state, gnorm = opt_update(tree.unflatten(params, grads), opt_state,
                                              params, lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    train_step.opt_init = opt_init
    return train_step
