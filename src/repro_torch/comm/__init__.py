"""Wire codecs of the port: pluggable (lossy) compression of LP messages.

  * ``codecs``   — the :class:`Codec` protocol and the stock codecs
                   (fp32, bf16, int8, int4, each per-slab-scaled); the int
                   codecs quantize through the ``int8_quantize`` kernel on
                   CUDA tensors.
  * ``residual`` — temporal-delta coding with error feedback.
  * ``wire``     — ``simulate_halo_forward``, the single-process mirror of
                   the halo engine the serving engine runs off a mesh.

The SPMD collectives (``compressed_halo_exchange``,
``compressed_core_gather``) and the byte model are ROADMAP Queue 1 item 6.
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
    init_halo_wire_state,
    simulate_halo_forward,
)
