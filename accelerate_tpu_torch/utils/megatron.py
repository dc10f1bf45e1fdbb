"""The Megatron-LM config dialect of the JAX ``utils/megatron.py``: the
plugin's degrees select axes of the one mesh, with ``dp = world // (tp *
pp)`` as Megatron computes it:

- ``tp_degree`` -> the ``tp`` axis (the llama family's Megatron tensor
  parallelism, :mod:`..models.llama`);
- ``use_distributed_optimizer`` -> the data axis becomes ``fsdp`` under
  ``SHARD_GRAD_OP``;
- ``recompute_activations`` -> the strategy's ``activation_checkpointing``;
- ``sequence_parallelism`` with ``sp_degree`` -> the ``sp`` axis, carved
  out of ``dp`` (without ``sp_degree`` no axis, with a warning);
- ``pp_degree`` > 1 (pipeline parallelism, ROADMAP A7) maps as in the JAX
  package, and the ``Accelerator`` refuses it, naming its part.

The ``MEGATRON_LM_*`` environment variables fill what the fields leave
None.  The engine-shaped names (the dummies, the wrappers,
:class:`MegatronEngine`, the train-step classes and the helpers) run
through the prepared objects.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from .dataclasses import FullyShardedDataParallelPlugin, ParallelismConfig

__all__ = ["MegatronLMPlugin", "megatron_pipeline_loss_fn"]


def _env_int(key: str, default: Optional[int]) -> Optional[int]:
    return int(os.environ[key]) if key in os.environ else default


def _env_bool(key: str, default: bool) -> bool:
    return os.environ.get(key, str(default)).lower() in ("1", "true", "yes")


@dataclass
class MegatronLMPlugin:
    """The JAX ``MegatronLMPlugin``, field for field."""

    tp_degree: Optional[int] = None
    pp_degree: Optional[int] = None
    num_micro_batches: Optional[int] = None
    gradient_clipping: Optional[float] = None
    sequence_parallelism: Optional[bool] = None
    # The sp axis's degree, carved out of dp when sequence_parallelism is on.
    sp_degree: Optional[int] = None
    recompute_activations: Optional[bool] = None
    use_distributed_optimizer: Optional[bool] = None
    seq_length: Optional[int] = None
    megatron_dataset_flag: bool = False
    other_megatron_args: Optional[dict] = None

    def __post_init__(self):
        if self.tp_degree is None:
            self.tp_degree = _env_int("MEGATRON_LM_TP_DEGREE", 1)
        if self.pp_degree is None:
            self.pp_degree = _env_int("MEGATRON_LM_PP_DEGREE", 1)
        if self.num_micro_batches is None:
            self.num_micro_batches = _env_int("MEGATRON_LM_NUM_MICRO_BATCHES", 1)
        if self.gradient_clipping is None and "MEGATRON_LM_GRADIENT_CLIPPING" in os.environ:
            self.gradient_clipping = float(os.environ["MEGATRON_LM_GRADIENT_CLIPPING"])
        if self.sequence_parallelism is None:
            self.sequence_parallelism = _env_bool("MEGATRON_LM_SEQUENCE_PARALLELISM", False)
        if self.recompute_activations is None:
            self.recompute_activations = _env_bool("MEGATRON_LM_RECOMPUTE_ACTIVATIONS", False)
        if self.use_distributed_optimizer is None:
            self.use_distributed_optimizer = _env_bool(
                "MEGATRON_LM_USE_DISTRIBUTED_OPTIMIZER", False
            )
        if self.sp_degree is None:
            self.sp_degree = _env_int("MEGATRON_LM_SP_DEGREE", None)
        if self.tp_degree < 1 or self.pp_degree < 1 or self.num_micro_batches < 1:
            raise ValueError("tp_degree, pp_degree and num_micro_batches must be >= 1")

    def to_parallelism_config(self, num_devices: int, sp_degree: Optional[int] = None) -> ParallelismConfig:
        """``dp = world // (tp * pp)``; with ``use_distributed_optimizer``
        the data axis is ``fsdp``."""
        model_ways = self.tp_degree * self.pp_degree
        if num_devices % model_ways != 0:
            raise ValueError(
                f"tp_degree*pp_degree={model_ways} must divide device count {num_devices}"
            )
        dp = num_devices // model_ways
        sp = 1
        if sp_degree is None:
            sp_degree = self.sp_degree
        if self.sequence_parallelism:
            if sp_degree is None:
                import warnings

                warnings.warn(
                    "sequence_parallelism=True without sp_degree: no sp mesh axis is "
                    "created. Set sp_degree for an sp axis."
                )
            else:
                if dp % sp_degree != 0:
                    raise ValueError(f"sp_degree {sp_degree} must divide dp degree {dp}")
                dp //= sp_degree
                sp = sp_degree
        axes = dict(tp=self.tp_degree, pp=self.pp_degree, sp=sp)
        if self.use_distributed_optimizer:
            return ParallelismConfig(fsdp=dp, **axes)
        return ParallelismConfig(dp=dp, **axes)

    def to_fsdp_plugin(self) -> FullyShardedDataParallelPlugin:
        strategy = "SHARD_GRAD_OP" if self.use_distributed_optimizer else "NO_SHARD"
        return FullyShardedDataParallelPlugin(
            sharding_strategy=strategy,
            activation_checkpointing=bool(self.recompute_activations),
        )


# ---------------------------------------------------------------------------
# The engine-shaped names: they run through the prepared objects.
# ---------------------------------------------------------------------------


class MegatronLMDummyDataLoader:
    """Stands for a loader over Megatron's indexed datasets, which are not
    bundled: ``prepare`` refuses it."""

    def __init__(self, **dataset_kwargs):
        self.dataset_kwargs = dataset_kwargs

    def set_megatron_data_args(self):
        pass

    def __iter__(self):
        raise RuntimeError(
            "MegatronLMDummyDataLoader must be passed through accelerator.prepare() "
            "before iteration"
        )


class MegatronLMDummyScheduler:
    """Stands for the scheduler of the plugin's schedule arguments."""

    def __init__(self, optimizer, total_num_steps=None, warmup_num_steps=0, **kwargs):
        self.optimizer = optimizer
        self.total_num_steps = total_num_steps
        self.warmup_num_steps = warmup_num_steps
        self.kwargs = kwargs


class MegatronLMOptimizerWrapper:
    """``step`` and ``zero_grad`` are no-ops: the engine's ``train_step``
    runs them."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def step(self):
        pass

    def zero_grad(self, set_to_none=None):
        pass

    @property
    def step_was_skipped(self) -> bool:
        return getattr(self.optimizer, "step_was_skipped", False)

    def __getattr__(self, name):
        return getattr(self.optimizer, name)


class MegatronLMSchedulerWrapper:
    def __init__(self, scheduler, optimizers):
        self.scheduler = scheduler
        self.optimizers = optimizers

    def step(self):
        pass

    def __getattr__(self, name):
        return getattr(self.scheduler, name)


class MegatronEngine:
    """Owns ``train_step`` / ``eval_step``: one call runs the forward,
    backward, step, scheduler step and zero_grad through the prepared
    objects."""

    def __init__(self, accelerator, model, optimizer, scheduler):
        self.accelerator = accelerator
        self.module = model
        self.optimizer = optimizer
        self.scheduler = scheduler

    def train(self):
        return self

    def eval(self):
        return self

    def train_step(self, batch):
        out = self.module(**batch) if isinstance(batch, dict) else self.module(batch)
        loss = _loss_of(out)
        self.accelerator.backward(loss)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad()
        return {"loss": loss}

    def eval_step(self, batch):
        out = self.module(**batch) if isinstance(batch, dict) else self.module(batch)
        return {"loss": _loss_of(out)}

    def __call__(self, *args, **kwargs):
        return self.module(*args, **kwargs)


def _loss_of(out):
    if isinstance(out, dict):
        return out["loss"]
    return out.loss if hasattr(out, "loss") else out


class AbstractTrainStep:
    """Per-model-type batch and loss plumbing: subclasses supply
    ``get_batch_func``, ``get_loss_func`` and ``get_forward_step_func``."""

    def __init__(self, name: str):
        self.name = name

    def get_batch_func(self, *a, **k):
        raise NotImplementedError

    def get_loss_func(self, *a, **k):
        raise NotImplementedError

    def get_forward_step_func(self, *a, **k):
        raise NotImplementedError


def megatron_pipeline_loss_fn(plugin: "MegatronLMPlugin", config):
    """The causal-LM loss for the llama family under the plugin's schedule:
    with ``pp_degree`` 1 the dense ``llama.loss_fn`` (micro-batches are then
    the accumulation steps, as in Megatron with one stage); a pipeline
    (``pp_degree`` > 1) raises ``NotImplementedError`` (ROADMAP A7)."""
    from ..models import llama

    pp = plugin.pp_degree or 1
    if pp <= 1:
        return lambda params, batch: llama.loss_fn(params, batch, config)
    raise NotImplementedError(
        f"megatron_pipeline_loss_fn with pp_degree={pp}: pipeline parallelism is not ported "
        "to accelerate_tpu_torch yet (ROADMAP A7)")


def _causal_lm_loss(batch, logits):
    from ..models import llama

    labels, weights = llama.labels_and_weights(batch)
    return llama.cross_entropy(logits, labels, weights)


class GPTTrainStep(AbstractTrainStep):
    """Causal-LM batches; the loss is the next-token cross-entropy
    (``models/llama.py cross_entropy``)."""

    def __init__(self, accelerator=None, args=None):
        super().__init__("GPTTrainStep")
        self._plugin = getattr(accelerator, "megatron_lm_plugin", None)

    def get_batch_func(self, accelerator=None, megatron_dataset_flag=False):
        def get_batch(data_iterator):
            batch = next(data_iterator)
            return batch, batch.get("labels")

        return get_batch

    def get_loss_func(self, accelerator=None):
        return _causal_lm_loss

    def get_forward_step_func(self, config=None):
        """:func:`megatron_pipeline_loss_fn` for ``config`` (a
        ``LlamaConfig``) under the accelerator's plugin."""
        if config is None:
            raise ValueError("get_forward_step_func needs the model config (e.g. LlamaConfig)")
        plugin = self._plugin or MegatronLMPlugin()
        return megatron_pipeline_loss_fn(plugin, config)


class BertTrainStep(AbstractTrainStep):
    """Masked-LM batches (the token cross-entropy over the labelled
    positions)."""

    def __init__(self, accelerator=None, args=None):
        super().__init__("BertTrainStep")

    def get_batch_func(self, accelerator=None, megatron_dataset_flag=False):
        def get_batch(data_iterator):
            batch = next(data_iterator)
            return batch, batch.get("labels")

        return get_batch

    def get_loss_func(self, accelerator=None, pretraining_flag=False, num_labels=None):
        return _causal_lm_loss


class T5TrainStep(AbstractTrainStep):
    """Seq2seq batches: encoder input and decoder labels (``models/t5.py``);
    the loss is the cross-entropy over the non-negative labels."""

    def __init__(self, accelerator=None, args=None):
        super().__init__("T5TrainStep")

    def get_batch_func(self, accelerator=None, megatron_dataset_flag=False):
        def get_batch(data_iterator):
            batch = next(data_iterator)
            return batch, batch.get("labels")

        return get_batch

    def get_loss_func(self, accelerator=None):

        def loss_func(batch, logits):
            import torch

            from ..models import llama

            labels = batch["labels"]
            weights = (labels >= 0).float()
            return llama.cross_entropy(logits, torch.clamp(labels, min=0), weights)

        return loss_func


def avg_losses_across_data_parallel_group(losses):
    """The mean of per-micro-batch losses (the train step's losses are
    already means over the data axes)."""
    return float(sum(float(l) for l in losses) / len(losses))


def gather_across_data_parallel_groups(tensor):
    """Every process's ``tensor``, concatenated (``utils.operations.gather``)."""
    from .operations import gather

    return gather(tensor)


def megatron_lm_initialize(accelerator, args_defaults=None):
    """Megatron boots its global state here; in the port the mesh is that
    state, built with the accelerator: nothing to do."""
    return None


def megatron_lm_prepare_data_loader(accelerator, dataloader):
    if isinstance(dataloader, MegatronLMDummyDataLoader):
        raise ValueError(
            "MegatronLMDummyDataLoader requires indexed-dataset kwargs; build a real "
            "dataset first (megatron indexed datasets are not bundled)"
        )
    return accelerator.prepare_data_loader(dataloader)


def megatron_lm_prepare_optimizer(accelerator, model):
    """A torch ``AdamW`` (lr 1e-4) over ``model``, prepared."""
    import torch

    return accelerator.prepare_optimizer(torch.optim.AdamW(model.parameters(), lr=1e-4))


def megatron_lm_prepare_scheduler(accelerator, optimizer, scheduler):
    if isinstance(scheduler, MegatronLMDummyScheduler):
        return scheduler
    return accelerator.prepare_scheduler(scheduler)


def megatron_lm_prepare_model_optimizer_scheduler(accelerator):
    raise NotImplementedError(
        "megatron_lm_prepare_model_optimizer_scheduler builds from Megatron's arguments; "
        "pass your model/optimizer/scheduler to accelerator.prepare() instead — the "
        "MegatronLMPlugin mesh applies there."
    )


def add_model_config_to_megatron_parser(model_type: str):
    """The model's settings go through ``MegatronLMPlugin``'s fields: the
    parser is returned as it is."""
    def _noop(parser):
        return parser

    return _noop
