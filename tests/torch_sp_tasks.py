"""Tasks that every process of a :class:`torch_dp_world.World` runs for
``test_torch_ring_attention.py`` and ``test_torch_sp.py``: the port's
sequence-parallel attention on this process's chunk, and each family's
``apply`` through a layout with an ``sp`` axis (each family's eager SGD
step is ``torch_ep_tasks.family_step``).  Each starts from a fresh port
state on the CPU and returns plain values (numbers, CPU tensors)."""

from __future__ import annotations

import torch

from accelerate_tpu_torch import Accelerator, AcceleratorState, ParallelismConfig
from accelerate_tpu_torch.parallel import collectives


def _state(mesh_kw):
    AcceleratorState._reset_state(reset_partial_state=True)
    return Accelerator(cpu=True, parallelism_config=ParallelismConfig(**mesh_kw)).mesh


def _chunk(x, mesh, heads=None):
    """This process's chunk of ``x`` ``[B, S, ...]`` along the sequence (and,
    where ``heads`` names a ``tp`` head split, its heads along dim 2)."""
    n, i = mesh.shape["sp"], mesh.coords()["sp"]
    s = x.shape[1] // n
    out = x[:, i * s:(i + 1) * s]
    if heads:
        per = out.shape[2] // mesh.shape["tp"]
        out = out[:, :, mesh.coords()["tp"] * per:(mesh.coords()["tp"] + 1) * per]
    return torch.from_numpy(out.copy()) if not isinstance(out, torch.Tensor) else out


def attention(kind, mesh_kw, q, k, v, cot, causal=True, kv_valid=None, tp_heads=False,
              impl=None):
    """``kind`` (``"ring"``: the einsum ring; ``"fused_plain"``: the ring
    over the kernels' plain versions; ``"ulysses"``) on this process's
    chunk of the global numpy ``q``, ``k``, ``v`` (and ``kv_valid``), and
    the gradients of ``sum(out * cot)`` in q, k and v: this process's
    chunks, and the collectives' log keys."""
    from accelerate_tpu_torch.ops.ring_attention import ring_attention
    from accelerate_tpu_torch.ops.ring_fused import ring_fused_attention_plain
    from accelerate_tpu_torch.ops.ulysses_attention import ulysses_attention

    mesh = _state(mesh_kw)
    qc, kc, vc = (_chunk(t, mesh, tp_heads).requires_grad_(True) for t in (q, k, v))
    valid = None if kv_valid is None else _chunk(kv_valid, mesh)
    collectives.reset_comm_log()
    if kind == "ring":
        out = ring_attention(qc, kc, vc, mesh=mesh, causal=causal, kv_valid=valid)
    elif kind == "fused_plain":
        out = ring_fused_attention_plain(qc, kc, vc, mesh=mesh, causal=causal)
    else:
        out = ulysses_attention(qc, kc, vc, mesh=mesh, causal=causal, kv_valid=valid,
                                impl=impl)
    (out * _chunk(cot, mesh, tp_heads)).sum().backward()
    return {"out": out.detach(), "dq": qc.grad, "dk": kc.grad, "dv": vc.grad,
            "coords": mesh.coords(), "comm": sorted(collectives.COMM_LOG)}


def ulysses_error(mesh_kw, shape):
    """The ``ValueError`` text of Ulysses on heads the ``sp`` axis does not
    divide (None where it runs)."""
    from accelerate_tpu_torch.ops.ulysses_attention import ulysses_attention

    mesh = _state(mesh_kw)
    q = torch.zeros(shape)
    try:
        ulysses_attention(q, q, q, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def fused_refusal(mesh_kw):
    """The ``ValueError`` the fused path raises on a live ``sp`` mesh when
    the llama forward is called without its layout, and the kernel ring's
    refusal of ``kv_valid``."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.ring_fused import ring_fused_attention

    mesh = _state(mesh_kw)
    out = {}
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, attention_impl="pallas")
    params = llama.init_params(cfg, seed=0, device="cpu")
    try:
        llama.loss_fn(params, {"input_ids": torch.zeros((1, 16), dtype=torch.long)}, cfg)
    except ValueError as e:
        out["layoutless"] = str(e)
    q = torch.zeros((1, 8, 2, 64))
    try:
        ring_fused_attention(q, q, q, mesh=mesh, kv_valid=torch.ones((1, 8)))
    except ValueError as e:
        out["kv_valid"] = str(e)
    return out


def sp_apply(family, np_params, cfg_kw, mesh_kw, batch):
    """The family's ``apply`` (llama: logits; BERT: sequence output and
    pooled; ViT: features and pooled) through a prepared model's layout:
    the gathered outputs every process returns."""
    import importlib

    import torch_ep_tasks

    acc = torch_ep_tasks._fresh(mesh_kw)
    model = acc.prepare(torch_ep_tasks.build(family, np_params, cfg_kw))
    layout = model._layout
    fam = importlib.import_module(f"accelerate_tpu_torch.models.{family}")
    cfg = torch_ep_tasks.config(family, cfg_kw)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        if family == "llama":
            return {"logits": fam.apply(model.params, b["input_ids"], cfg,
                                        attention_mask=b.get("attention_mask"), layout=layout)}
        if family == "bert":
            x, pooled = fam.apply(model.params, b["input_ids"], cfg,
                                  attention_mask=b.get("attention_mask"), layout=layout)
        else:
            x, pooled = fam.apply(model.params, b["pixel_values"], cfg, layout=layout)
    return {"x": x, "pooled": pooled}
