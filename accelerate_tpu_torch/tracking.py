"""Experiment trackers: the JAX package's ``accelerate_tpu/tracking.py``
for the port.

:class:`GeneralTracker` is the base class, with ``main_process_only``
gating (:func:`on_main_process`); :class:`GenericTracker` is the
dependency-free JSONL tracker (one line per ``log`` call, ``_step`` and
``_time`` beside the values); the SDK backends (TensorBoard, W&B, Comet,
Aim, MLflow, ClearML, DVCLive) import their SDK when built and are filtered
by availability, so the module works with none of them installed.
``LOGGER_TYPE_TO_CLASS`` names them, :func:`filter_trackers` validates a
``log_with`` list and :func:`init_trackers` builds it, as
``Accelerator.init_trackers`` does.  :func:`telemetry_rows` is the
telemetry registry's scalars, which ``Accelerator.log`` merges into every
``log`` call while telemetry is on.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Optional

from .logging import get_logger
from .state import PartialState
from .utils.imports import (
    is_aim_available,
    is_clearml_available,
    is_comet_ml_available,
    is_dvclive_available,
    is_mlflow_available,
    is_tensorboard_available,
    is_wandb_available,
)

logger = get_logger(__name__)

__all__ = [
    "GeneralTracker",
    "GenericTracker",
    "TensorBoardTracker",
    "WandBTracker",
    "CometMLTracker",
    "AimTracker",
    "MLflowTracker",
    "ClearMLTracker",
    "DVCLiveTracker",
    "LOGGER_TYPE_TO_CLASS",
    "filter_trackers",
    "init_trackers",
    "on_main_process",
    "telemetry_rows",
]


def _is_main_process() -> bool:
    """The main process, or no state yet (one process, before any
    ``Accelerator``: a tracker used on its own)."""
    return PartialState._shared_state == {} or PartialState().is_main_process


def on_main_process(function):
    """Run the tracker method only on the main process (when the tracker's
    ``main_process_only``)."""

    @functools.wraps(function)
    def wrapper(self, *args, **kwargs):
        if getattr(self, "main_process_only", True) and not _is_main_process():
            return None
        return function(self, *args, **kwargs)

    return wrapper


def _is_scalar(v) -> bool:
    """Loggable-as-metric predicate shared by the backends."""
    return isinstance(v, (int, float)) or hasattr(v, "__float__")


class GeneralTracker:
    """Base tracker: ``name``, ``requires_logging_directory``,
    ``main_process_only``, the SDK object as ``tracker``,
    ``store_init_configuration``, ``log`` and ``finish``."""

    name: str = "general"
    requires_logging_directory: bool = False
    main_process_only: bool = True

    def __init__(self, _blank: bool = False):
        pass

    @property
    def tracker(self):
        raise NotImplementedError

    def store_init_configuration(self, values: dict):
        raise NotImplementedError

    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        raise NotImplementedError

    def finish(self):
        pass


class GenericTracker(GeneralTracker):
    """Dependency-free JSONL tracker (each log call appends one line)."""

    name = "generic"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: str = "."):
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        os.makedirs(self.logging_dir, exist_ok=True)
        self.path = os.path.join(self.logging_dir, "metrics.jsonl")

    @property
    def tracker(self):
        return self.path

    @on_main_process
    def store_init_configuration(self, values: dict):
        with open(os.path.join(self.logging_dir, "config.json"), "w") as f:
            json.dump(values, f, default=str)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        rec = {"_step": step, "_time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in values.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")


class TensorBoardTracker(GeneralTracker):
    """Reference ``tracking.py:167``."""

    name = "tensorboard"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(
            {k: v for k, v in values.items() if isinstance(v, (int, float, str, bool))}, {}
        )
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            if _is_scalar(v):
                self.writer.add_scalar(k, float(v), global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """Log a dict of image batches (HF Accelerate ``tracking.py:253``): each
        value is an [N, H, W, C] (or [N, C, H, W]) array."""
        import numpy as np

        explicit_format = kwargs.pop("dataformats", None)
        for k, v in values.items():
            arr = np.asarray(v)
            dataformats = explicit_format or ("NHWC" if arr.shape[-1] in (1, 3, 4) else "NCHW")
            self.writer.add_images(k, arr, global_step=step, dataformats=dataformats, **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self):
        self.writer.close()


class WandBTracker(GeneralTracker):
    """Reference ``tracking.py:278``."""

    name = "wandb"
    requires_logging_directory = False

    def __init__(self, run_name: str, **kwargs):
        import wandb

        self.run_name = run_name
        self.run = wandb.init(project=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """Log image lists as ``wandb.Image``s (HF Accelerate ``tracking.py:343``)."""
        import wandb

        for k, v in values.items():
            self.log({k: [wandb.Image(image) for image in v]}, step=step, **kwargs)

    @on_main_process
    def log_table(
        self,
        table_name: str,
        columns: Optional[list] = None,
        data: Optional[list] = None,
        dataframe=None,
        step: Optional[int] = None,
        **kwargs,
    ):
        """Log a ``wandb.Table`` from columns+data or a dataframe (HF Accelerate
        ``tracking.py:362``)."""
        import wandb

        self.log(
            {table_name: wandb.Table(columns=columns, data=data, dataframe=dataframe)},
            step=step,
            **kwargs,
        )

    @on_main_process
    def finish(self):
        self.run.finish()


class CometMLTracker(GeneralTracker):
    """Reference ``tracking.py:401``."""

    name = "comet_ml"
    requires_logging_directory = False

    def __init__(self, run_name: str, **kwargs):
        import comet_ml

        self.run_name = run_name
        self.experiment = comet_ml.start(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.experiment

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.experiment.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.experiment.log_current_epoch(step)
        for k, v in values.items():
            if _is_scalar(v):
                self.experiment.log_metric(k, float(v), step=step, **kwargs)
            elif isinstance(v, str):
                self.experiment.log_other(k, v, **kwargs)

    @on_main_process
    def finish(self):
        self.experiment.end()


class AimTracker(GeneralTracker):
    """Reference ``tracking.py:493``."""

    name = "aim"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        from aim import Run

        self.run_name = run_name
        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, kwargs: Optional[dict] = None):
        """Track images as ``aim.Image``s (HF Accelerate ``tracking.py:553``);
        ``kwargs`` may hold per-call dicts under "aim_image" and "track"."""
        import aim

        aim_image_kw = (kwargs or {}).get("aim_image", {})
        track_kw = (kwargs or {}).get("track", {})
        for k, v in values.items():
            img, caption = v if isinstance(v, tuple) else (v, "")
            self.writer.track(
                aim.Image(img, caption=caption, **aim_image_kw), name=k, step=step, **track_kw
            )

    @on_main_process
    def finish(self):
        self.writer.close()


class MLflowTracker(GeneralTracker):
    """Reference ``tracking.py:592``."""

    name = "mlflow"
    requires_logging_directory = False

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        import mlflow

        self.run_name = run_name
        experiment_name = kwargs.pop("experiment_name", run_name)
        mlflow.set_experiment(experiment_name)
        self.active_run = mlflow.start_run(run_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.active_run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        # MLflow caps param value length; stringify + truncate like HF Accelerate.
        items = [(k, str(v)[:500]) for k, v in values.items()]
        for i in range(0, len(items), 100):  # batch limit per call
            mlflow.log_params(dict(items[i : i + 100]))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        metrics = {k: float(v) for k, v in values.items() if _is_scalar(v)}
        mlflow.log_metrics(metrics, step=step)

    @on_main_process
    def log_figure(self, figure, artifact_file: str, **save_kwargs):
        """Log a matplotlib figure as an artifact (HF Accelerate ``tracking.py:728``)."""
        import mlflow

        mlflow.log_figure(figure, artifact_file, **save_kwargs)

    @on_main_process
    def log_artifact(self, local_path: str, artifact_path: Optional[str] = None):
        """Upload one local file as an artifact (HF Accelerate ``tracking.py:764``)."""
        import mlflow

        mlflow.log_artifact(local_path, artifact_path)

    @on_main_process
    def log_artifacts(self, local_dir: str, artifact_path: Optional[str] = None):
        """Upload a local directory of artifacts (HF Accelerate ``tracking.py:747``)."""
        import mlflow

        mlflow.log_artifacts(local_dir, artifact_path)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class ClearMLTracker(GeneralTracker):
    """Reference ``tracking.py:790``."""

    name = "clearml"
    requires_logging_directory = False

    def __init__(self, run_name: str, **kwargs):
        from clearml import Task

        self.run_name = run_name
        self.task = Task.init(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(dict(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            if not (_is_scalar(v)):
                continue
            if step is None:
                clearml_logger.report_single_value(name=k, value=float(v), **kwargs)
                continue
            title, _, series = k.partition("/")
            series = series or title
            clearml_logger.report_scalar(
                title=title, series=series, value=float(v), iteration=step, **kwargs
            )

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """Report images to the ClearML debug-samples tab (HF Accelerate
        ``tracking.py:870``)."""
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            title, _, series = k.partition("/")
            series = series or title
            clearml_logger.report_image(
                title=title, series=series, iteration=step, image=v, **kwargs
            )

    @on_main_process
    def log_table(
        self,
        table_name: str,
        columns: Optional[list] = None,
        data: Optional[list] = None,
        dataframe=None,
        step: Optional[int] = None,
        **kwargs,
    ):
        """Report a table from columns+data or a dataframe (HF Accelerate
        ``tracking.py:888``)."""
        if dataframe is None:
            if columns is None or data is None:
                raise ValueError(
                    "log_table needs either a `dataframe` or both `columns` and `data`"
                )
            dataframe = [list(columns)] + [list(row) for row in data]
        title, _, series = table_name.partition("/")
        series = series or title
        self.task.get_logger().report_table(
            title=title, series=series, iteration=step, table_plot=dataframe, **kwargs
        )

    @on_main_process
    def finish(self):
        self.task.close()


class DVCLiveTracker(GeneralTracker):
    """Reference ``tracking.py:942``."""

    name = "dvclive"
    requires_logging_directory = False

    def __init__(self, run_name: Optional[str] = None, live=None, **kwargs):
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(dict(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            if _is_scalar(v):
                self.live.log_metric(k, float(v), **kwargs)
        self.live.next_step()

    @on_main_process
    def finish(self):
        self.live.end()


LOGGER_TYPE_TO_CLASS = {
    "generic": GenericTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "comet_ml": CometMLTracker,
    "aim": AimTracker,
    "mlflow": MLflowTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
}

# name -> availability probe; "generic" has no dependency so it is always on.
_TRACKER_AVAILABLE = {
    "tensorboard": is_tensorboard_available,
    "wandb": is_wandb_available,
    "comet_ml": is_comet_ml_available,
    "aim": is_aim_available,
    "mlflow": is_mlflow_available,
    "clearml": is_clearml_available,
    "dvclive": is_dvclive_available,
}


def filter_trackers(log_with: list, logging_dir: Optional[str] = None) -> list:
    """Validate requested trackers against availability (HF Accelerate
    ``tracking.py:1037``): "all" expands to every installed backend, unavailable
    backends warn + drop, unknown names raise."""
    out = []
    for item in log_with or []:
        if isinstance(item, GeneralTracker):
            out.append(item)
            continue
        name = str(item).lower()
        if name == "all":
            out.extend(n for n, avail in _TRACKER_AVAILABLE.items() if avail())
            continue
        if name not in LOGGER_TYPE_TO_CLASS:
            raise ValueError(f"Unknown tracker {name}; options: {sorted(LOGGER_TYPE_TO_CLASS)}")
        if name in _TRACKER_AVAILABLE and not _TRACKER_AVAILABLE[name]():
            logger.warning(f"{name} not available; skipping tracker")
            continue
        out.append(name)
    # Dedupe preserving order ("all" + an explicit name must not instantiate a
    # backend twice — a second mlflow.start_run/wandb.init would raise).
    seen: set = set()
    deduped = []
    for item in out:
        key = item if isinstance(item, str) else id(item)
        if key not in seen:
            seen.add(key)
            deduped.append(item)
    return deduped


def telemetry_rows(prefix: str = "telemetry/") -> dict:
    """The telemetry registry's scalars under ``prefix``, which
    ``Accelerator.log`` merges into every ``log`` call, so any tracker
    receives step-time / compile / memory / MFU rows once telemetry is on.
    Empty when telemetry is off."""
    from .telemetry import get_telemetry

    tel = get_telemetry()
    if not tel.enabled:
        return {}
    return {
        f"{prefix}{k}": v
        for k, v in tel.registry.snapshot().items()
        if isinstance(v, (int, float))
    }


def init_trackers(log_with, project_name, config, init_kwargs, accelerator) -> list[GeneralTracker]:
    # Constructors create SDK runs/tasks, so non-main processes must not build
    # backends at all (HF Accelerate gates Accelerator.init_trackers itself with
    # @on_main_process): only already-constructed instances pass through.
    if not _is_main_process():
        return [t for t in (log_with or []) if isinstance(t, GeneralTracker)]
    init_kwargs = init_kwargs or {}
    logging_dir = accelerator.project_configuration.logging_dir or "."
    trackers = []
    for item in filter_trackers(log_with, logging_dir):
        if isinstance(item, GeneralTracker):
            trackers.append(item)
            continue
        cls = LOGGER_TYPE_TO_CLASS[item]
        kwargs = init_kwargs.get(item, {})
        if cls.requires_logging_directory:
            trackers.append(cls(project_name, logging_dir=logging_dir, **kwargs))
        else:
            trackers.append(cls(project_name, **kwargs))
    if config is not None:
        for t in trackers:
            t.store_init_configuration(config)
    return trackers
