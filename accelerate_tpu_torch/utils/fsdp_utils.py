"""The FSDP helpers of the JAX ``utils/fsdp_utils.py``, under its names.

In the port "FSDP" is the ``fsdp`` axis of the mesh: each process holds its
shard of a prepared model's leaves (:mod:`..parallel.sharding`).  The
model and optimizer saves take the consolidated path, the plugin's
``FULL_STATE_DICT``: every process gathers the full tensors (a
collective), the main process writes them; a load re-shards them by each
leaf's spec.  ``SHARDED_STATE_DICT`` (the plugin's default, as in the JAX
package) and ``LOCAL_STATE_DICT`` raise: per-process saves come with
ROADMAP A6 part 3.  The ``fsdp2_*`` helpers, :func:`merge_fsdp_weights` and
:func:`ensure_weights_retied` delegate as the JAX ones do.
"""

from __future__ import annotations

import os

import torch

__all__ = [
    "save_fsdp_model",
    "load_fsdp_model",
    "save_fsdp_optimizer",
    "load_fsdp_optimizer",
    "merge_fsdp_weights",
    "fsdp2_prepare_model",
    "fsdp2_load_full_state_dict",
    "fsdp2_switch_optimizer_parameters",
    "get_fsdp2_grad_scaler",
    "enable_fsdp_ram_efficient_loading",
    "disable_fsdp_ram_efficient_loading",
    "ensure_weights_retied",
]


def _state_dict_type(fsdp_plugin) -> str:
    kind = getattr(fsdp_plugin, "state_dict_type", "FULL_STATE_DICT") or "FULL_STATE_DICT"
    if kind != "FULL_STATE_DICT":
        raise NotImplementedError(
            f"state_dict_type={kind!r} is not ported to accelerate_tpu_torch yet (ROADMAP A6 "
            "part 3, saves across processes); FULL_STATE_DICT saves and loads consolidated")
    return kind


def _weights_name(model_index: int) -> str:
    return "model.safetensors" if model_index == 0 else f"model_{model_index}.safetensors"


def save_fsdp_model(fsdp_plugin, accelerator, model, output_dir, model_index: int = 0,
                    adapter_only: bool = False) -> None:
    """Write ``model``'s full weights as ``model[_<i>].safetensors`` under
    ``output_dir``: gathered by every process, written by the main one."""
    from ..checkpointing import save_model_weights

    _state_dict_type(fsdp_plugin)
    full = accelerator.get_state_dict(model)
    if accelerator.is_main_process:
        save_model_weights(None, output_dir, weights_name=_weights_name(model_index),
                           state_dict=full)
    accelerator.wait_for_everyone()


def load_fsdp_model(fsdp_plugin, accelerator, model, input_dir, model_index: int = 0,
                    adapter_only: bool = False) -> None:
    """Load what :func:`save_fsdp_model` wrote, each process keeping its
    shards."""
    from ..checkpointing import load_model_weights

    _state_dict_type(fsdp_plugin)
    load_model_weights(model, input_dir, weights_name=_weights_name(model_index))


def save_fsdp_optimizer(fsdp_plugin, accelerator, optimizer, model, output_dir,
                        optimizer_index: int = 0) -> None:
    """Write ``optimizer``'s state, gathered to full shapes, as
    ``optimizer_<i>.bin`` (a ``torch.save`` archive) on the main process."""
    _state_dict_type(fsdp_plugin)
    state = optimizer.state_dict()
    if accelerator.is_main_process:
        os.makedirs(output_dir, exist_ok=True)
        torch.save(state, os.path.join(output_dir, f"optimizer_{optimizer_index}.bin"))
    accelerator.wait_for_everyone()


def load_fsdp_optimizer(fsdp_plugin, accelerator, optimizer, model, input_dir,
                        optimizer_index: int = 0, adapter_only: bool = False) -> None:
    """Restore what :func:`save_fsdp_optimizer` wrote (each process keeps
    the shards of its leaves)."""
    _state_dict_type(fsdp_plugin)
    path = os.path.join(input_dir, f"optimizer_{optimizer_index}.bin")
    optimizer.load_state_dict(torch.load(path, map_location="cpu", weights_only=False))


def merge_fsdp_weights(checkpoint_dir: str, output_path: str, safe_serialization: bool = True,
                       remove_checkpoint_dir: bool = False) -> None:
    """Consolidate the weights of ``checkpoint_dir`` into one file under
    ``output_path`` (``model.safetensors``, or ``model.pkl`` without
    ``safe_serialization``).  The port's saves are consolidated already, so
    this reads them (one file or an index of shards) and writes them whole;
    ``remove_checkpoint_dir`` deletes the source."""
    import shutil

    from ..checkpointing import read_safetensors_state_dict, save_model_weights

    state_dict = read_safetensors_state_dict(checkpoint_dir)
    if state_dict is None:
        raise FileNotFoundError(f"No consolidated weights found in {checkpoint_dir}")
    save_model_weights(None, output_path, state_dict=state_dict, max_shard_size=2**62,
                       safe_serialization=safe_serialization)
    if remove_checkpoint_dir:
        shutil.rmtree(checkpoint_dir)


def fsdp2_prepare_model(accelerator, model):
    """``accelerator.prepare_model(model)``: the shards are taken there."""
    return accelerator.prepare_model(model)


def fsdp2_load_full_state_dict(accelerator, model, full_sd: dict):
    """Load a full state dict into a prepared model, each process keeping
    its shards."""
    from ..parallel.sharding import load_full_state_dict

    load_full_state_dict(getattr(model, "module", model), full_sd)
    return model


def fsdp2_switch_optimizer_parameters(optimizer, mapping):
    """The prepared model keeps its ``Parameter`` objects (a shard is the
    same object's new data), so the optimizer needs no re-pointing."""
    return optimizer


def get_fsdp2_grad_scaler(**kwargs):
    """A ``torch.amp.GradScaler`` (bf16 compute needs none; kept for
    scripts that build one)."""
    return torch.amp.GradScaler(**kwargs)


def enable_fsdp_ram_efficient_loading() -> None:
    os.environ["FSDP_CPU_RAM_EFFICIENT_LOADING"] = "True"


def disable_fsdp_ram_efficient_loading() -> None:
    os.environ["FSDP_CPU_RAM_EFFICIENT_LOADING"] = "False"


def _tied_parameters(model) -> list:
    seen: dict = {}
    for name, param in model.named_parameters(remove_duplicate=False):
        seen.setdefault(id(param), []).append(name)
    return [names for names in seen.values() if len(names) > 1]


def _retie(model, tied: list) -> None:
    def owner(name):
        module = model
        *path, leaf = name.split(".")
        for part in path:
            module = getattr(module, part)
        return module, leaf

    for group in tied:
        anchor = None
        for name in group:
            module, leaf = owner(name)
            if getattr(module, leaf).device != torch.device("meta"):
                anchor = getattr(module, leaf)
                break
        if anchor is None:
            continue
        for name in group:
            module, leaf = owner(name)
            setattr(module, leaf, anchor)


def ensure_weights_retied(param_init_fn, model, device):
    """Wrap a meta-device ``param_init_fn`` so the parameters ``model``
    ties (one object under several names) are tied again after it runs."""
    tied = _tied_parameters(model)
    if not tied:
        return param_init_fn

    def wrapped(module):
        result = param_init_fn(module)
        _retie(model, tied)
        return result

    return wrapped
