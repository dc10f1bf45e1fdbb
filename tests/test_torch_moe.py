"""The port's MoE routing and expert FFN (``accelerate_tpu_torch/ops/moe.py``)
against the JAX package's ``accelerate_tpu/ops/moe.py`` on the same inputs.

Inputs come from a numpy seed.  fp32 throughout, tolerance 1e-6 (outputs,
aux losses) and 1e-5 (gradients, summed in other orders).  The cases: a
random router, a zero router (every probability equal: the top-k ties
break to the lower expert index in both packages), and a capacity of one
token an expert, so tokens overflow and are dropped."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops import moe as jm
from accelerate_tpu_torch.ops import moe as tm

TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, E, F = 2, 12, 16, 4, 24


def _inputs(seed=0, zero_router=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w_router = (np.zeros((D, E)) if zero_router else rng.standard_normal((D, E))).astype(
        np.float32)
    w_gate = (rng.standard_normal((E, D, F)) / 4).astype(np.float32)
    w_up = (rng.standard_normal((E, D, F)) / 4).astype(np.float32)
    w_down = (rng.standard_normal((E, F, D)) / 5).astype(np.float32)
    return x, w_router, w_gate, w_up, w_down


CASES = {"random": dict(), "all_tie": dict(zero_router=True)}


def test_expert_capacity_matches_jax():
    for s, e, k, cf in ((12, 4, 2, 1.25), (1, 8, 2, 1.25), (256, 8, 2, 1.25), (7, 3, 3, 1.0)):
        assert tm.expert_capacity(s, e, k, cf) == jm.expert_capacity(s, e, k, cf)


@pytest.mark.parametrize("capacity", [None, 1], ids=["cf1.25", "overflow"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("top_k", [2, 3])
def test_dispatch_combine_matches_jax(case, capacity, top_k):
    x, w_router, *_ = _inputs(**CASES[case])
    cap = capacity or jm.expert_capacity(S, E, top_k, 1.25)
    jprobs, _ = jm.router(jnp.asarray(x), jnp.asarray(w_router))
    jd, jc, jaux = jax.jit(jm.dispatch_combine, static_argnums=(1, 2))(jprobs, top_k, cap)
    tprobs, _ = tm.router(torch.from_numpy(x), torch.from_numpy(w_router))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
    td, tc, taux = tm.dispatch_combine(tprobs, top_k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(taux["fraction_dropped"].item(),
                               float(jaux["fraction_dropped"]), **TOL)
    if capacity == 1:
        assert taux["fraction_dropped"].item() > 0.5
    if case == "all_tie":
        # Every token's top-k are experts 0 .. k-1, slot 0 on expert 0.
        assert td[:, :, top_k:].sum() == 0 and td[:, 0, 0, 0].eq(1).all()
    np.testing.assert_allclose(tm.load_balancing_loss(tprobs, td).item(),
                               float(jm.load_balancing_loss(jprobs, jd)), **TOL)


def _jax_fn(ragged, **kw):
    def fn(x, wr, wg, wu, wd):
        if ragged:
            return jm.moe_ffn_ragged(x, wr, wg, wu, wd, compute_dtype=jnp.float32, **kw)
        return jm.moe_ffn(x, wr, wg, wu, wd, compute_dtype=jnp.float32, **kw)
    return fn


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ragged,capacity", [(False, None), (False, 2), (True, None)],
                         ids=["dense", "dense-overflow", "ragged"])
def test_moe_ffn_and_grads_match_jax(ragged, capacity, case):
    arrays = _inputs(seed=1, **CASES[case])
    kw = {} if ragged else dict(capacity=capacity)

    def jloss(*a):
        y, aux = _jax_fn(ragged, **kw)(*a)
        return (jnp.sum(y * y) + aux["load_balancing_loss"] + aux["router_z_loss"]), (y, aux)

    (jl, (jy, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fn = tm.moe_ffn_ragged if ragged else tm.moe_ffn
    y, aux = fn(*leaves, compute_dtype=torch.float32, **kw)
    ((y * y).sum() + aux["load_balancing_loss"] + aux["router_z_loss"]).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    for k in ("load_balancing_loss", "router_z_loss", "fraction_dropped"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), err_msg=k, **TOL)
    if capacity:
        assert aux["fraction_dropped"].item() > 0
    for name, t, g in zip(("x", "router", "gate", "up", "down"), leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), err_msg=name, **GRAD_TOL)


def test_ragged_equals_dense_without_drops():
    """With capacity for every token, the two paths compute the same FFN."""
    x, wr, wg, wu, wd = map(torch.from_numpy, _inputs(seed=2))
    yd, auxd = tm.moe_ffn(x, wr, wg, wu, wd, capacity=S * 2, compute_dtype=torch.float32)
    yr, auxr = tm.moe_ffn_ragged(x, wr, wg, wu, wd, compute_dtype=torch.float32)
    assert auxd["fraction_dropped"].item() == 0
    np.testing.assert_allclose(yr.numpy(), yd.numpy(), **TOL)
    np.testing.assert_allclose(auxr["load_balancing_loss"].item(),
                               auxd["load_balancing_loss"].item(), **TOL)


def test_bf16_compute_matches_jax():
    """The casts of the dense path: dispatch and activations to the compute
    dtype before the einsums, the output back to ``x.dtype``."""
    arrays = _inputs(seed=3)
    jy, _ = jax.jit(lambda *a: jm.moe_ffn(*a, compute_dtype=jnp.bfloat16))(
        *map(jnp.asarray, arrays))
    ty, _ = tm.moe_ffn(*map(torch.from_numpy, arrays), compute_dtype=torch.bfloat16)
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-2, atol=2e-2)
