"""The port's copy of ``core/comm_model`` gives the reference's numbers.

Every public function of ``repro/core/comm_model.py`` is called on both
packages with the same arguments: the WAN2.1 configurations of the paper
(49, 81 and 161 frames at 480p), the chip smoke's latent (13, 30, 52)
over 4 steps, and the small latents of ``test_torch_dist.py``; K 2-8
where the function takes one, r 0.5 and 1.0, the codecs of
``CODEC_NAMES``.  The results must be equal (integers and dicts
exactly, floats to the last bit).
"""
import dataclasses
import inspect

import pytest

from repro.core import comm_model as jcm
from repro_torch.comm.codecs import CODEC_NAMES
from repro_torch.core import comm_model as tcm


def _configs():
    out = {f"wan{f}": dict(num_frames=f, num_steps=8) for f in (49, 81, 161)}
    out["smoke"] = dict(latent_dims=(13, 30, 52), latent_channels=16,
                        patch_sizes=(1, 2, 2), d_model=1536, num_blocks=30, num_steps=4)
    out["dist_rotating"] = dict(latent_dims=(9, 6, 10), latent_channels=4,
                                patch_sizes=(1, 2, 2), d_model=1, num_blocks=1, num_steps=4)
    out["dist_one_dim"] = dict(latent_dims=(9, 4, 4), latent_channels=4,
                               patch_sizes=(1, 2, 2), d_model=1, num_blocks=1, num_steps=3,
                               bytes_per_el=2)
    return out


CONFIGS = _configs()


def _pair(name):
    kw = CONFIGS[name]
    if "num_frames" in kw:
        return jcm.wan21_comm_config(**kw), tcm.wan21_comm_config(**kw)
    return jcm.VDMCommConfig(**kw), tcm.VDMCommConfig(**kw)


def test_public_functions_are_the_same_set():
    def public(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
                and v.__module__ == mod.__name__}

    assert public(jcm) == public(tcm)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_and_closed_forms_equal_reference(name):
    jc, tc = _pair(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.latent_elems, jc.latent_bytes, jc.num_tokens, jc.activation_bytes) == \
        (tc.latent_elems, tc.latent_bytes, tc.num_tokens, tc.activation_bytes)
    for K in range(2, 9):
        for f in ("comm_nmp", "comm_pp", "comm_tp", "comm_hp_xdit"):
            assert getattr(jcm, f)(jc, K) == getattr(tcm, f)(tc, K), (f, K)
        for r in (0.5, 1.0):
            try:
                want = jcm.comm_lp_hub(jc, K, r)
            except ValueError as e:            # K too large for the latent
                with pytest.raises(ValueError, match=str(e)[:20]):
                    tcm.comm_lp_hub(tc, K, r)
                continue
            assert want == tcm.comm_lp_hub(tc, K, r)
            for f in ("comm_lp_measured", "comm_lp_spmd", "gamma_factor",
                      "reduction_vs_nmp"):
                assert getattr(jcm, f)(jc, K, r) == getattr(tcm, f)(tc, K, r), (f, K, r)
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "collective-permute"):
        for K in (2, 3, 8):
            assert jcm.collective_wire_bytes(kind, 12345, K) == \
                tcm.collective_wire_bytes(kind, 12345, K)
    for K, M in ((4, 2), (8, 4), (6, 3)):
        for intra in ("nmp", "tp"):
            for shard in (False, True):
                assert jcm.comm_hybrid(jc, K, M, 0.5, intra, shard) == \
                    tcm.comm_hybrid(tc, K, M, 0.5, intra, shard)


def _usable_k(jc):
    from repro.core.schedule import usable_dims

    return [K for K in range(2, 9) if usable_dims(jc.latent_dims, jc.patch_sizes, K)]


@pytest.mark.parametrize("name", CONFIGS)
def test_halo_models_equal_reference(name):
    jc, tc = _pair(name)
    from repro.core.schedule import usable_dims

    steps = ["int8-residual", "int8-residual", "bf16", "fp32"][: jc.num_steps] * 2
    for K in _usable_k(jc):
        dims = usable_dims(jc.latent_dims, jc.patch_sizes, K)
        for r in (0.5, 1.0):
            assert jcm.comm_lp_halo(jc, K, r) == tcm.comm_lp_halo(tc, K, r)
            for d in dims:
                assert jcm.lp_halo_step_collectives(jc, K, r, d) == \
                    tcm.lp_halo_step_collectives(tc, K, r, d)
            for codec in CODEC_NAMES:
                assert jcm.comm_lp_halo_codec(jc, K, r, codec) == \
                    tcm.comm_lp_halo_codec(tc, K, r, codec), (K, r, codec)
                assert jcm.comm_lp_gspmd_codec(jc, K, r, "int8") == \
                    tcm.comm_lp_gspmd_codec(tc, K, r, "int8")
                for d in dims:
                    assert jcm.lp_halo_codec_step_collectives(jc, K, r, d, codec) == \
                        tcm.lp_halo_codec_step_collectives(tc, K, r, d, codec)
            assert jcm.comm_lp_halo_scheduled(jc, K, r, steps) == \
                tcm.comm_lp_halo_scheduled(tc, K, r, steps)
            assert jcm.lp_halo_scheduled_segments(jc, K, r, steps) == \
                tcm.lp_halo_scheduled_segments(tc, K, r, steps)


@pytest.mark.parametrize("name", CONFIGS)
def test_hybrid_and_sharded_models_equal_reference(name):
    jc, tc = _pair(name)
    from repro.core.schedule import usable_dims

    steps = ["displaced:int8-residual", "displaced:int8-residual", "int8", "bf16"]
    for M in _usable_k(jc)[:3]:
        dims = usable_dims(jc.latent_dims, jc.patch_sizes, M)
        for T in (1, 2, 4):
            for codec in ("fp32", "bf16", "int8", "int4"):
                assert jcm.comm_lp_halo_hybrid(jc, M, T, 0.5, codec) == \
                    tcm.comm_lp_halo_hybrid(tc, M, T, 0.5, codec)
                for d in dims:
                    assert jcm.lp_halo_hybrid_step_collectives(jc, M, T, 0.5, d, codec) == \
                        tcm.lp_halo_hybrid_step_collectives(tc, M, T, 0.5, d, codec)
                if T > 1:
                    assert jcm.comm_lp_halo_sharded(jc, M, T, 0.5, codec) == \
                        tcm.comm_lp_halo_sharded(tc, M, T, 0.5, codec)
                    for d in dims:
                        assert jcm.lp_halo_sharded_step_collectives(jc, M, T, 0.5, d, codec) \
                            == tcm.lp_halo_sharded_step_collectives(tc, M, T, 0.5, d, codec)
            for shard in ((False, True) if T > 1 else (False,)):
                assert jcm.lp_halo_wire_profile(jc, M, T, 0.5, steps, shard) == \
                    tcm.lp_halo_wire_profile(tc, M, T, 0.5, steps, shard)
            if T > 1:
                assert jcm.comm_lp_halo_sharded(jc, M, T, 0.5, step_codecs=steps) == \
                    tcm.comm_lp_halo_sharded(tc, M, T, 0.5, step_codecs=steps)
