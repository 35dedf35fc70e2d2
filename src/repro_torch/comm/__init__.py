"""Wire codecs of the port: pluggable (lossy) compression of LP messages.

  * ``codecs``   — the :class:`Codec` protocol and the stock codecs
                   (fp32, bf16, int8, int4, each per-slab-scaled); the int
                   codecs quantize through the ``int8_quantize`` kernel on
                   CUDA tensors.
  * ``residual`` — temporal-delta coding with error feedback.
  * ``wire``     — the halo engine's codec'd collectives on each rank of an
                   lp group (``compressed_halo_exchange``,
                   ``compressed_core_gather``, ``rank_wire_state``) and
                   ``simulate_halo_forward``, their single-process mirror,
                   which the serving engine runs off a mesh.
"""
from .codecs import (  # noqa: F401
    Bf16Codec,
    Codec,
    CODEC_NAMES,
    IdentityCodec,
    IntCodec,
    get_codec,
    int4_wire_shape,
)
from .residual import (  # noqa: F401
    ResidualCodec,
    ef_roundtrip,
    residual_decode,
    residual_encode,
)
from .wire import (  # noqa: F401
    HaloTables,
    compressed_core_gather,
    compressed_halo_exchange,
    init_halo_wire_state,
    put_rank_wire_state,
    rank_wire_state,
    simulate_halo_forward,
)
