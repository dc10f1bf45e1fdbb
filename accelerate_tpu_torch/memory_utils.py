"""Deprecated alias of :mod:`accelerate_tpu_torch.utils.memory`, as the JAX
package's ``accelerate_tpu/memory_utils.py`` is of its own."""

import warnings

from .utils.memory import *  # noqa: F401,F403

warnings.warn(
    "accelerate_tpu_torch.memory_utils is deprecated; use accelerate_tpu_torch.utils.memory",
    FutureWarning,
)
