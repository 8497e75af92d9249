"""Incubating Fluid features (counterpart of
``paddle_tpu/fluid/incubate``): preemption-aware checkpoints
(``checkpoint``).  The JAX package's ``incubate.fleet`` is not ported
(ROADMAP 1.8.9)."""

from . import checkpoint  # noqa: F401
