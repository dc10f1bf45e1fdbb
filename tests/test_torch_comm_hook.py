"""``DistributedDataParallelKwargs(comm_hook="bf16")`` in the port against
the JAX ``Accelerator`` at one process.

The JAX ``PreparedModel`` holds its accumulated gradients in bf16 under an
fp16 or bf16 hook (``_grad_sync_dtype``): each micro-batch's gradient,
scaled by ``1 / gradient_accumulation_steps``, is rounded to bf16 and added
to the sum in bf16.  The port's ``backward`` rounds the same way and keeps
each ``.grad`` in its parameter's fp32.  A tiny llama, 6 micro-batches at
``gradient_accumulation_steps=2`` (3 AdamW steps).

Tolerances.  The rounding itself is held exactly: the same fp32
gradients through the JAX ``_accumulate`` and the port's
``accumulate_grads`` give the same bits.  End to end, the two frameworks
compute the fp32 gradient in another order, so an element near a rounding
boundary may land one bf16 ulp apart, and a sum that cancels keeps that
ulp of its larger addend: gradients are held within 2**-7 relative plus
2**-8 of the leaf's largest entry (one bf16 ulp at the leaf's scale).
Weights after the 3 steps: within 2e-4
(optax's AdamW multiplies the bf16 gradient by (1 - b1) and squares it in
bf16 before adding it to its fp32 moments, torch's AdamW does so in fp32);
the hook's rounding moves the weights by more than 2e-4 from the run
without it, so the test sees the rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import JaxModel
from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils import DistributedDataParallelKwargs as JaxDDPKwargs
from accelerate_tpu_torch import Accelerator, AcceleratorState
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils import DistributedDataParallelKwargs
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

LR, WD, BATCH, MICRO = 1e-2, 1e-4, 8, 6


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _batches(vocab):
    rng = np.random.default_rng(3)
    return [torch.from_numpy(rng.integers(0, vocab, size=(BATCH, 16)).astype(np.int64))
            for _ in range(MICRO)]


def _adamw(params):
    return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=WD)


def _jax_run(jcfg, params, batches, hook):
    handlers = [JaxDDPKwargs(comm_hook=hook)] if hook else None
    acc = JaxAccelerator(gradient_accumulation_steps=2, kwargs_handlers=handlers)

    def apply_fn(p, input_ids):
        return {"loss": jl.loss_fn(p, {"input_ids": input_ids}, jcfg)}

    shadow = _adamw([torch.nn.Parameter(torch.zeros(1))])
    model, opt = acc.prepare(JaxModel(apply_fn, jax.tree.map(jnp.asarray, params)), shadow)
    grads = []
    for ids in batches:
        with acc.accumulate(model):
            acc.backward(model(ids)["loss"])
            accum = jax.device_get(model._accum_grads)
            grads.append({k: (v, str(leaf.dtype)) for (k, v), leaf in zip(
                _flat(accum).items(), jax.tree_util.tree_leaves(accum))})
            opt.step()
            opt.zero_grad()
    return grads, _flat(jax.device_get(model.params))


def _port_run(tcfg, params, batches, hook):
    handlers = [DistributedDataParallelKwargs(comm_hook=hook)] if hook else None
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2, kwargs_handlers=handlers)
    model = tl.LlamaForCausalLM(tcfg, params=llama_params_from_jax(params, tcfg, device="cpu"),
                                device="cpu")
    model, opt = acc.prepare(model, _adamw(model.parameters()))
    grads = []
    for ids in batches:
        with acc.accumulate(model):
            acc.backward(model(input_ids=ids)["loss"])
            grads.append({k: v.grad.detach().clone() for k, v in _leaves(model.params).items()})
            opt.step()
            opt.zero_grad()
    return grads, {k: v.detach().numpy().copy() for k, v in _leaves(model.params).items()}


def _leaves(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def test_bf16_hook_rounds_gradients_as_jax_does():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=1)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=1)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    batches = _batches(jcfg.vocab_size)
    want_grads, want_params = _jax_run(jcfg, params, batches, "bf16")
    got_grads, got_params = _port_run(tcfg, params, batches, "bf16")
    assert len(got_grads) == len(want_grads) == MICRO
    for i, (got, want) in enumerate(zip(got_grads, want_grads)):
        assert sorted(got) == sorted(want)
        for name, g in got.items():
            w, wdtype = want[name]
            assert wdtype == "bfloat16" and g.dtype == torch.float32, name
            # Stored in fp32, valued in bf16.
            assert torch.equal(g, g.to(torch.bfloat16).float()), f"micro-batch {i}: {name}"
            np.testing.assert_allclose(g.numpy(), w, rtol=2 ** -7,
                                       atol=2 ** -8 * float(np.abs(w).max()),
                                       err_msg=f"micro-batch {i}: {name}")
    for name, g in got_params.items():
        np.testing.assert_allclose(g, want_params[name], rtol=0, atol=2e-4, err_msg=name)

    # Without a hook nothing changes: no handler and comm_hook="no" give the
    # same fp32 gradients (not all of them bf16 values) bit for bit, and the
    # hook moves the weights by more than the tolerance above.
    runs = []
    for hook in (None, "no"):
        AcceleratorState._reset_state(reset_partial_state=True)
        runs.append(_port_run(tcfg, params, batches, hook))
    (plain_grads, plain_params), (no_grads, no_params) = runs
    for got, want in zip(plain_grads, no_grads):
        assert all(torch.equal(got[n], want[n]) for n in got)
    assert all(np.array_equal(plain_params[n], no_params[n]) for n in plain_params)
    assert not all(torch.equal(g, g.to(torch.bfloat16).float())
                   for g in plain_grads[1].values())
    moved = max(np.abs(plain_params[n] - got_params[n]).max() for n in got_params)
    assert moved > 2e-4, moved


def test_rounding_is_jax_accumulate_bit_for_bit():
    """Two micro-batches of the same fp32 gradients, scaled by 1/2: the
    port's ``accumulate_grads(..., hold_dtype=bf16)`` gives JAX
    ``PreparedModel._accumulate``'s bf16 sums bit for bit, in fp32."""
    from accelerate_tpu_torch.pipeline.train_step import accumulate_grads

    rng = np.random.default_rng(5)
    micro = [{"w": rng.standard_normal((64, 32)).astype(np.float32) * 1e-2,
              "b": rng.standard_normal((32,)).astype(np.float32)} for _ in range(2)]
    acc = JaxAccelerator(kwargs_handlers=[JaxDDPKwargs(comm_hook="bf16")])
    jmodel = acc.prepare(JaxModel(lambda p, x: {"loss": (x @ p["w"]).sum() + p["b"].sum()},
                                  {"w": jnp.zeros((64, 32)), "b": jnp.zeros((32,))}))
    sums = [None, None]
    for g in micro:
        jmodel._accumulate({k: jnp.asarray(v) for k, v in g.items()}, 0.5)
        sums = accumulate_grads(sums, [torch.from_numpy(g["w"]), torch.from_numpy(g["b"])], 0.5,
                                hold_dtype=torch.bfloat16)
    want = jax.device_get(jmodel._accum_grads)
    for got, name in zip(sums, ("w", "b")):
        assert got.dtype == torch.float32 and want[name].dtype == jnp.bfloat16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[name], np.float32))
