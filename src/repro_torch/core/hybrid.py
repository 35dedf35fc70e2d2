"""Hierarchical hybrid parallelism (paper supplementary §11): a port of
``repro/core/hybrid.py``.

A cluster of K devices is split into M disjoint groups (Eq. 42);
inter-group LP partitions the latent across the groups with the same
overlapping-window machinery (K -> M in Eqs. 7-10), and each group runs
an intra-group operator Phi_m (Eq. 43) over its sub-latent as a black box.

* :func:`hybrid_forward` — the one-process composition (an explicit
  Phi_m list, paper-exact partitions), with the :class:`GroupLayout`
  bookkeeping of Eq. 42.
* :func:`lp_forward_halo_hybrid` — the engine on a 2-D ``(lp, tp)``
  group (``distributed.collectives.HybridGroup``): the halo schedule
  runs over the lp group, each rank runs Phi_m (``denoise_fn``) on its
  group's window, and ``wire_shard`` ships every payload in 1/T chunks,
  one a tp rank, reassembled by a tp all-gather.

The group contract (the reference's mesh contract):

* the lp group has M == plan.num_partitions ranks, the tp group T >= 1;
* ``z`` is the whole latent on every rank; ``denoise_fn`` may use the tp
  group (:func:`tp_cfg_combine`, ...) but must return the same value on
  every tp rank of an LP group;
* every LP collective runs over the lp group only, so each tp rank
  exchanges with its same-tp peers: a rank's bytes are those of the 1-D
  halo model (``comm_model.comm_lp_halo_hybrid``), independent of T.

As in the reference, the serving engine runs the whole guided DiT on
every rank of a group (``serving/engine.py``): the tp axis buys the
sharded wire, not a split of the DiT.  :func:`tp_cfg_branch` /
:func:`tp_cfg_combine`, the only intra-group split the reference has,
are ported and left uncalled by the engine, as there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from .lp_step import lp_forward
from .partition import PartitionPlan, plan_partition
from .uniform import UniformPlan


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """K devices -> M disjoint groups (Eq. 42 constraints)."""

    num_devices: int
    num_groups: int
    groups: Tuple[Tuple[int, ...], ...]

    def validate(self) -> None:
        seen = set()
        for g in self.groups:
            assert g, "empty group"
            assert not (seen & set(g)), "groups must be disjoint"
            seen |= set(g)
        assert seen == set(range(self.num_devices)), "groups must cover G"


def make_groups(num_devices: int, num_groups: int) -> GroupLayout:
    if num_devices % num_groups != 0:
        raise ValueError(f"K={num_devices} must split into M={num_groups}")
    per = num_devices // num_groups
    groups = tuple(tuple(range(m * per, (m + 1) * per)) for m in range(num_groups))
    layout = GroupLayout(num_devices, num_groups, groups)
    layout.validate()
    return layout


def hybrid_forward(
    intra_group_ops: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    z: torch.Tensor,
    extent_axis: int,
    patch: int,
    overlap_ratio: float,
) -> torch.Tensor:
    """One hybrid LP forward: inter-group partition -> Phi_m per group ->
    position-aware reconstruction.  ``intra_group_ops[m]`` is Phi_m
    (Eq. 43), any denoiser of group m's sub-latent."""
    M = len(intra_group_ops)
    plan: PartitionPlan = plan_partition(z.shape[extent_axis], patch, M, overlap_ratio)
    op_iter = iter(intra_group_ops)
    return lp_forward(lambda sub: next(op_iter)(sub), z, plan, extent_axis)


# ------------------------------------------------------ 2-D group engine
@dataclasses.dataclass(frozen=True)
class HybridMeshSpec:
    """The shape of a 2-D group checked against a plan.  The halo schedule
    over the M groups is the 1-D one (``distributed.collectives.halo_spec``):
    T-independent, since every transfer runs over the lp group (a tp rank
    talks to its same-tp peers)."""

    num_groups: int                 # M: lp group size == plan partitions
    tp_size: int                    # T: 1 on a 1-D group

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return (self.num_groups, self.tp_size)


def hybrid_halo_spec(plan: UniformPlan, mesh) -> HybridMeshSpec:
    """Check the group against the plan (``hybrid.py:123``).  ``mesh``: a
    ``HybridGroup`` or a 1-D ``LPGroup``."""
    from repro_torch.distributed.collectives import lp_axis, tp_size

    M = plan.num_partitions
    lp = lp_axis(mesh)
    if lp.size != M:
        raise ValueError(f"the lp group has {lp.size} ranks, the plan has M={M} groups")
    return HybridMeshSpec(num_groups=M, tp_size=tp_size(mesh))


def lp_forward_halo_hybrid(
    denoise_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    plan: UniformPlan,
    axis: int,
    mesh,
    codec=None,
    codec_state=None,
    eager_sends: bool = True,
    wire_shard: bool = False,
    nan_guard: bool = False,
):
    """The hybrid LP x TP halo forward of one rank of a 2-D group.

    The halo engine (``core/spmd.lp_forward_halo``) over the lp group
    behind the group check (:func:`hybrid_halo_spec`), with eager sends
    on by default; ``denoise_fn`` is Phi_m and must give every tp rank of
    a group the same output.  ``wire_shard`` shards every payload over
    the tp group (``comm_model.comm_lp_halo_sharded``: T-fold fewer
    inter-group bytes, the result bit-equal); a no-op at T = 1.  ``codec``,
    ``codec_state`` (this rank's slice, tp-replicated) and ``nan_guard``
    as in ``lp_forward_halo``.
    """
    from repro_torch.distributed.collectives import lp_axis

    from .spmd import lp_forward_halo

    mspec = hybrid_halo_spec(plan, mesh)
    shard = mesh.tp if (wire_shard and mspec.tp_size > 1) else None
    return lp_forward_halo(denoise_fn, z, plan, axis, lp_axis(mesh), codec=codec,
                           codec_state=codec_state, eager_sends=eager_sends,
                           shard_axis=shard, nan_guard=nan_guard)


# ---------------------------------------------- intra-group Phi_m helpers
def tp_cfg_branch(tp_group) -> int:
    """This rank's CFG branch (0 = cond, 1 = uncond) on the tp group:
    ranks alternate (``rank % 2``).  Only 2-way: at T > 2 the extra ranks
    compute a branch again."""
    return tp_group.rank % 2


def tp_cfg_combine(pred_branch: torch.Tensor, tp_group, guidance) -> torch.Tensor:
    """Gather the CFG pair computed on alternating tp ranks (one all-gather
    over the tp group, counted under the intra tier) and combine rows 0
    and 1; the output is the same on every tp rank, as Phi_m must be."""
    from repro_torch.diffusion.cfg import cfg_combine

    stack = tp_group.all_gather(pred_branch)
    return cfg_combine(stack[0], stack[1], guidance)
