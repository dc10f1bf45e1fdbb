"""Configuration objects of the training loop, under the JAX package's names
(``accelerate_tpu/utils/dataclasses.py``), with the fields the single-GPU
loop reads."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["DataLoaderConfiguration", "GradientAccumulationPlugin", "ProjectConfiguration"]


@dataclass
class DataLoaderConfiguration:
    """How :meth:`Accelerator.prepare` rebuilds a ``DataLoader``.

    - ``split_batches``: the scheduler steps once per optimizer step (at one
      GPU the batches are the same either way);
    - ``even_batches``: with ``static_shape_tail``, the short tail batch is
      filled from the epoch's first samples;
    - ``use_seedable_sampler`` / ``data_seed``: a shuffling sampler becomes a
      :class:`~accelerate_tpu_torch.data_loader.SeedableRandomSampler`
      seeded with ``data_seed`` (42 when None) plus the epoch;
    - ``non_blocking``: host-to-device copies from pinned memory do not
      wait;
    - ``use_stateful_dataloader``: the loader's position within its epoch
      goes into checkpoints (``dl_state_dict.bin``);
    - ``static_shape_tail``: every batch, the tail included, has the full
      batch size;
    - ``prefetch_to_device``: batches a worker thread copies to the device
      ahead of the loop (0: the synchronous one-batch lookahead).
    """

    split_batches: bool = False
    even_batches: bool = True
    use_seedable_sampler: bool = False
    data_seed: Optional[int] = None
    non_blocking: bool = False
    use_stateful_dataloader: bool = False
    static_shape_tail: bool = False
    prefetch_to_device: int = 0


@dataclass
class GradientAccumulationPlugin:
    """``num_steps`` micro-batches per optimizer step (None: 1);
    ``sync_with_dataloader`` also syncs on a dataloader's last batch;
    ``sync_each_batch`` syncs on every batch.  ``adjust_scheduler`` is
    carried for the JAX surface: as there, the scheduler does not step while
    gradients accumulate, whatever its value."""

    num_steps: Optional[int] = None
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class ProjectConfiguration:
    """Where checkpoints go: ``<project_dir>/checkpoints/checkpoint_<iteration>``
    under ``automatic_checkpoint_naming``, keeping the newest
    ``total_limit``."""

    project_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
