"""AdamW with decoupled weight decay; f32 moments, bf16-safe updates."""
from __future__ import annotations

import torch

from repro_torch import tree


def adamw_init(params):
    """``{"m", "v"}``: f32 zeros shaped like each parameter; ``step`` int32 0."""
    leaves, _ = tree.flatten(params)
    return {
        "m": tree.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params),
        "v": tree.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree.flatten(grads)[0]))


def _slices(*ts):
    """Stacked leaves (3 or more dims) one layer at a time, so the f32
    temporaries of an update stay the size of a layer; the update is
    elementwise, so the result is the same."""
    if ts[0].ndim >= 3:
        return zip(*(t.unbind(0) for t in ts))
    return [ts]


@torch.no_grad()
def adamw_update(grads, state, params, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """Returns ``(params, state, grad_norm)``: gradients clipped to a global
    norm of ``max_grad_norm``, bias-corrected moments, decay on leaves of 2
    or more dims only.  Writes the new parameters, ``m`` and ``v`` into the
    given tensors."""
    gnorm = global_norm(grads)
    clip = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state["step"] + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    flat_p, _ = tree.flatten(params)
    flat_g, flat_m, flat_v = (tree.flatten(t)[0] for t in (grads, state["m"], state["v"]))
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        decay = weight_decay if p.ndim >= 2 else 0.0       # no decay on norms / biases
        for ps, gs, ms, vs in _slices(p, g, m, v):
            gs = gs.float() * clip
            ms.mul_(b1).add_((1 - b1) * gs)
            vs.mul_(b2).add_((1 - b2) * gs.square())
            u = (ms / c1) / (torch.sqrt(vs / c2) + eps)
            pf = ps.float()
            ps.copy_(pf - lr * (u + decay * pf))
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
