"""Training-step construction (:mod:`.train_step`) and the device
prefetcher (:mod:`.prefetch`)."""

from .prefetch import ENV_PREFETCH, DevicePrefetcher, prefetch_depth_from_env
from .train_step import TrainStep, make_train_step

__all__ = ["DevicePrefetcher", "ENV_PREFETCH", "TrainStep", "make_train_step",
           "prefetch_depth_from_env"]
