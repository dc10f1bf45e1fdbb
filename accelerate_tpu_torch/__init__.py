"""accelerate_tpu_torch: the PyTorch/CUDA port of ``accelerate_tpu``.

A package of its own beside the JAX one, with the same module names.  It
imports ``torch`` and never ``jax`` or ``accelerate_tpu``.  Its entry points
run on the GPU unless the caller passes ``device="cpu"``, and each Pallas
TPU kernel on a ported path becomes a hand-written Hopper kernel
(``ops/csrc/``) with a plain PyTorch version beside it.

Ported so far:

- paged continuous-batching serving of the llama family
  (:meth:`Accelerator.prepare_serving`, ``serving/``, ``models/llama.py``,
  ``models/generation.py``) with the paged decode and verify-window
  attention kernels (``ops/paged_attention.py``);
- single-GPU training of the llama family (:meth:`Accelerator.prepare`,
  ``backward``/``accumulate``, :meth:`Accelerator.make_train_step`,
  ``optimizer.py``, ``pipeline/train_step.py``, the training forward and
  loss in ``models/llama.py``, ``ops/chunked_ce.py``,
  ``ops/flash_attention.py``) with the flash-attention forward, dQ and
  dK/dV kernels (``ops/fused_attention.py``).

ROADMAP.md lists what remains.
"""

__version__ = "0.1.0"

from .accelerator import Accelerator, FunctionalModel  # noqa: E402

__all__ = ["Accelerator", "FunctionalModel", "__version__"]
