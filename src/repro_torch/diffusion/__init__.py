from .sampler import DDIM, FlowMatchEuler  # noqa: F401
from .cfg import cfg_combine  # noqa: F401
from .pipeline import (  # noqa: F401
    generate_centralized,
    generate_lp,
    make_guided_denoiser,
    make_guided_step_denoiser,
)
