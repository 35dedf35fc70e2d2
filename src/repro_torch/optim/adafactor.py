"""Adafactor (Shazeer & Stern 2018): factored second moments, no momentum.

State for an (a, b) matrix is an (a,) row accumulator and a (b,) column
accumulator.  Leading stacked-layer axes are batch dims (factoring applies
to the trailing two dims), as in the reference; the update's RMS clip and
its parameter scale are taken over the whole leaf, stack included.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from .adamw import global_norm


def _factored(p) -> bool:
    return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adafactor_init(params):
    def init(p):
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    leaves, _ = tree.flatten(params)
    return {"acc": tree.unflatten(params, [init(p) for p in leaves]),
            "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


@torch.no_grad()
def adafactor_update(grads, state, params, lr, decay_exp: float = 0.8, eps1: float = 1e-30,
                     eps2: float = 1e-3, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0, max_grad_norm: float = 1.0):
    """Returns ``(params, state, grad_norm)``; writes the new parameters and
    accumulators into the given tensors."""
    gnorm = global_norm(grads)
    gclip = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state["step"] + 1
    beta2 = 1.0 - step.float() ** (-decay_exp)
    flat_p, _ = tree.flatten(params)
    flat_g, _ = tree.flatten(grads)
    accs = tree.flatten_up_to(params, state["acc"])      # one dict per parameter
    for p, g, acc in zip(flat_p, flat_g, accs):
        g = g.float() * gclip
        g2 = g.square() + eps1
        if _factored(p):
            vr = beta2 * acc["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * acc["vc"] + (1 - beta2) * g2.mean(dim=-2)
            rfac = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps1)
            u = g * torch.rsqrt(rfac)[..., None] \
                * torch.rsqrt(torch.clamp(vc, min=eps1))[..., None, :]
            acc["vr"].copy_(vr)
            acc["vc"].copy_(vc)
        else:
            v = beta2 * acc["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps1))
            acc["v"].copy_(v)
        # update clipping by RMS (adafactor's d=1 rule)
        rms_u = torch.sqrt(u.square().mean() + eps1)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        pf = p.float()
        scale = torch.clamp(torch.sqrt(pf.square().mean()), min=eps2)
        newp = pf - lr * scale * u
        if weight_decay and p.ndim >= 2:
            newp = newp - lr * weight_decay * pf
        p.copy_(newp)
    return params, {"acc": state["acc"], "step": step}, gnorm

