"""The video DiT of the port: ``dit`` (model, init, weight bridge),
``attention`` (plain versions + kernel dispatch), ``layers``, ``frontends``."""
from . import attention, dit, frontends, layers  # noqa: F401
