"""Process-aware logging: the JAX package's ``accelerate_tpu/logging.py``
over the port's :class:`~accelerate_tpu_torch.state.PartialState`.

``get_logger(name)`` returns a :class:`MultiProcessAdapter`, whose
``log(..., main_process_only=True)`` logs on the main process only and
``in_order=True`` logs on every process in rank order.  Before any state
exists every call logs (one process, and no device to resolve yet)."""

from __future__ import annotations

import functools
import logging
import os

__all__ = ["MultiProcessAdapter", "get_logger"]


class MultiProcessAdapter(logging.LoggerAdapter):
    """A ``LoggerAdapter`` whose ``log`` takes ``main_process_only``
    (default True) and ``in_order`` (default False)."""

    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        from .state import PartialState

        if PartialState._shared_state == {}:
            return True
        return not main_process_only or PartialState().is_main_process

    def log(self, level, msg, *args, **kwargs):
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        if not self.isEnabledFor(level):
            return
        if in_order:
            from .state import PartialState

            if PartialState._shared_state == {}:
                msg, kwargs = self.process(msg, kwargs)
                self.logger.log(level, msg, *args, **kwargs)
                return
            state = PartialState()
            for i in range(state.num_processes):
                if i == state.process_index:
                    msg2, kwargs2 = self.process(msg, kwargs)
                    self.logger.log(level, msg2, *args, **kwargs2)
                state.wait_for_everyone()
            return
        if self._should_log(main_process_only):
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        """``warning`` once per distinct arguments."""
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """The named logger wrapped in a :class:`MultiProcessAdapter`;
    ``log_level`` (else ``ACCELERATE_LOG_LEVEL``) sets its level and the
    root logger's."""
    logger = logging.getLogger(name)
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
