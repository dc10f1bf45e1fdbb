"""``LlamaConfig(remat_policy="dots")`` in the port (a selective
``torch.utils.checkpoint`` policy) against ``"nothing"`` and against the
JAX ``loss_fn`` under ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.

Tolerance: fp32, atol = rtol = 1e-4 against JAX (the frameworks sum in
other orders); against the port's ``"nothing"`` the loss and gradients are
bit-identical (remat changes no arithmetic).

The policy keeps the outputs of the seven projections (q, k, v, o, gate,
up, down: every ``mm``), so the backward recomputes none of them; under
``"nothing"`` it recomputes six per layer.  Not seven: torch's
non-reentrant checkpoint stops recomputing once the last tensor the
backward needs is back, and the down projection's output is needed by no
backward formula (it only enters the residual sum).  So ``"dots"`` runs 6
fewer ``mm`` per layer in the backward, 2 x 7 per layer plus the LM
head's 2 in all.  Counted with a ``TorchDispatchMode``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
LAYERS = 3


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _port(params, batch, policy, attention_impl):
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=LAYERS, remat=True,
                               remat_policy=policy, attention_impl=attention_impl)
    tparams = llama_params_from_jax(params, tcfg, device="cpu")
    leaves = _leaves(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tl.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    with _CountMM() as count:
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), count.n


@pytest.mark.parametrize("attention_impl", ["einsum", "pallas"])
def test_dots_matches_nothing_and_jax(attention_impl):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=LAYERS, remat=True,
                               remat_policy="dots", attention_impl=attention_impl)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    batch = {"input_ids": np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(2, 64)).astype(np.int32)}
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch), jcfg)
    want = _leaves(jax.tree.map(np.asarray, jgrads))
    loss_d, grads_d, mm_d = _port(params, batch, "dots", attention_impl)
    loss_n, grads_n, mm_n = _port(params, batch, "nothing", attention_impl)
    assert torch.equal(loss_d, loss_n)
    np.testing.assert_allclose(loss_d.item(), float(jloss), **TOL)
    for name, g in grads_d.items():
        assert torch.equal(g, grads_n[name]), name
        np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)
    assert mm_d == 2 * 7 * LAYERS + 2, mm_d
    assert mm_n - mm_d == 6 * LAYERS, (mm_n, mm_d)
