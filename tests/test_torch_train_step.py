"""The port's training step (``accelerate_tpu_torch/accelerator.py``,
``optimizer.py``, ``pipeline/train_step.py``) against the JAX package.

- The N-step loss trajectory of the port's ``make_train_step`` and of its
  eager ``accumulate``/``backward()``/``step()`` loop against JAX
  ``Accelerator.prepare(JaxModel(...), optax.adamw(...))`` +
  ``make_train_step`` on a tiny llama with shared weights and numpy-seeded
  batches, for accum {1, 4} x clip on/off.  Tolerance: rtol = 2e-5 on the
  losses.  The JAX side runs on the suite's 8 virtual CPU devices, where
  its default ``Accelerator`` builds a data-parallel mesh and takes the
  dp-chunked gradient norm, and the two frameworks sum in different
  orders, so the trajectories agree to fp32 rounding, not bit for bit.
- In the port, the eager loop and the fused step are bit-identical.
- ``_update_body`` (health gate, value clip, then norm clip, AdamW) against
  the JAX ``_update_body`` with ``optax.adamw`` on one shared gradient tree,
  rtol = 1e-6.
- The health gate: a NaN in a batch leaves parameters and AdamW state
  untouched, step count included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import JaxModel
from accelerate_tpu.models import llama as jl
from accelerate_tpu.optimizer import _update_body as jax_update_body
from accelerate_tpu_torch import Accelerator, FunctionalModel
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.optimizer import _update_body
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

LR, WD, STEPS = 1e-2, 1e-4, 3


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    """The JAX ``AcceleratorState`` reset after each test installs a 1-device
    global mesh; put back the mesh this module found, so tests that run
    after it in the same process see the context they would see alone."""
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


def _setup():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=1)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=1)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    return jcfg, tcfg, params


def _windows(vocab, accum):
    """One window of ``accum`` left-padded micro-batches, taken ``STEPS``
    times (on fixed data the loss must fall)."""
    rng = np.random.default_rng(7)
    window = []
    for _ in range(accum):
        mask = np.ones((2, 16), np.int32)
        mask[1, : rng.integers(1, 8)] = 0
        window.append({"input_ids": rng.integers(0, vocab, size=(2, 16)).astype(np.int32),
                       "attention_mask": mask})
    return [window] * STEPS


def _jax_run(jcfg, params, windows, accum, clip):
    acc = JaxAccelerator(gradient_accumulation_steps=accum)

    def apply_fn(p, input_ids, attention_mask):
        return {"loss": jl.loss_fn(p, {"input_ids": input_ids,
                                       "attention_mask": attention_mask}, jcfg)}

    model, opt = acc.prepare(JaxModel(apply_fn, jax.tree.map(jnp.asarray, params)),
                             optax.adamw(LR, weight_decay=WD))
    step = acc.make_train_step(model, opt, clip_norm=clip)
    losses = []
    for window in windows:
        jw = [jax.tree.map(jnp.asarray, b) for b in window]
        losses.extend(np.atleast_1d(np.asarray(step(jw if accum > 1 else jw[0]))).tolist())
    return np.asarray(losses)


def _port_model(tcfg, params, accum):
    acc = Accelerator(cpu=True, gradient_accumulation_steps=accum)

    def apply_fn(p, input_ids, attention_mask):
        return {"loss": tl.loss_fn(p, {"input_ids": input_ids,
                                       "attention_mask": attention_mask}, tcfg)}

    model = FunctionalModel(apply_fn, llama_params_from_jax(params, tcfg, device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WD)
    model, opt = acc.prepare(model, opt)
    return acc, model, opt


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_fused(tcfg, params, windows, accum, clip):
    acc, model, opt = _port_model(tcfg, params, accum)
    step = acc.make_train_step(model, opt, clip_norm=clip)
    losses = []
    for window in windows:
        tw = [_tensors(b) for b in window]
        out = step(tw if accum > 1 else tw[0])
        losses.extend(out.reshape(-1).tolist())
        assert step.last_grad_norm is not None and torch.isfinite(step.last_health_norm)
    assert step.step_count == step.dispatch_count == STEPS
    return np.asarray(losses), [p.detach().clone() for p in model.parameters()], opt


def _port_eager(tcfg, params, windows, accum, clip):
    acc, model, opt = _port_model(tcfg, params, accum)
    losses = []
    for window in windows:
        for batch in window:
            with acc.accumulate(model):
                out = model(**_tensors(batch))
                acc.backward(out["loss"])
                if acc.sync_gradients and clip is not None:
                    acc.clip_grad_norm_(None, clip)
                opt.step()
                opt.zero_grad()
                losses.append(out["loss"].item())
    return np.asarray(losses), [p.detach().clone() for p in model.parameters()], opt


@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("accum", [1, 4])
def test_trajectory_matches_jax_and_eager_equals_fused(accum, clip):
    jcfg, tcfg, params = _setup()
    windows = _windows(jcfg.vocab_size, accum)
    want = _jax_run(jcfg, params, windows, accum, clip)
    fused, fused_params, fused_opt = _port_fused(tcfg, params, windows, accum, clip)
    eager, eager_params, eager_opt = _port_eager(tcfg, params, windows, accum, clip)
    assert len(fused) == len(want) == STEPS * accum
    np.testing.assert_allclose(fused, want, rtol=2e-5)
    assert want[-accum] < want[0]  # it learns
    np.testing.assert_array_equal(eager, fused)
    for a, b in zip(eager_params, fused_params):
        assert torch.equal(a, b)
    assert fused_opt._step_count == eager_opt._step_count == STEPS


def test_gemma_shaped_trajectory_matches_jax():
    """A tiny Gemma-shaped llama: head dim 256 against hidden 64 / 2 heads
    (MQA, one kv head), GeGLU, (1 + w) norms, sqrt(d) embeddings and a tied
    head.  The port trains through ``attention_impl="pallas"``, the fused
    op whose plain versions (what it runs on CPU tensors) stand in for the
    d-256 kernels; JAX through its own path.  3 AdamW steps through
    ``make_train_step``, losses within rtol 2e-5."""
    gemma = dict(num_layers=2, num_heads=2, num_kv_heads=1, head_dim=256,
                 hidden_act="gelu_tanh", rms_offset=True, embed_scale=True,
                 tie_embeddings=True)
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **gemma)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, attention_impl="pallas", **gemma)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(3)))
    rng = np.random.default_rng(5)  # nonzero (1 + w) offsets, so the norms count
    for k in ("ln_attn", "ln_mlp"):
        params["layers"][k] = rng.standard_normal(params["layers"][k].shape).astype(
            np.float32) * 0.1
    assert "lm_head" not in params and params["layers"]["wq"].shape == (2, 64, 512)
    windows = _windows(jcfg.vocab_size, 1)
    want = _jax_run(jcfg, params, windows, 1, None)
    got, _, _ = _port_fused(tcfg, params, windows, 1, None)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert want[-1] < want[0]


@pytest.mark.parametrize("clip_norm,clip_value", [
    (-1.0, -1.0), (0.5, -1.0), (-1.0, 0.01), (0.5, 0.01), (0.0, -1.0), (float("inf"), 0.02),
])
def test_update_body_matches_jax(clip_norm, clip_value):
    rng = np.random.default_rng(11)
    shapes = {"a": (8, 4), "b": (4,), "c": (3, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adamw(LR, weight_decay=WD)
    jp = jax.tree.map(jnp.asarray, params)
    want, _, jgnorm, jhealth = jax_update_body(
        tx.update, jp, tx.init(jp), jax.tree.map(jnp.asarray, grads),
        jnp.float32(clip_norm), jnp.float32(clip_value))
    tp = [torch.tensor(params[k], requires_grad=True) for k in sorted(shapes)]
    opt = torch.optim.AdamW(tp, lr=LR, weight_decay=WD)
    gnorm, health, ok = _update_body(opt, tp, [torch.tensor(grads[k]) for k in sorted(shapes)],
                                     clip_norm, clip_value)
    assert bool(ok)
    np.testing.assert_allclose(gnorm.item(), float(jgnorm), rtol=1e-6)
    np.testing.assert_allclose(health.item(), float(jhealth), rtol=1e-6)
    for k, t in zip(sorted(shapes), tp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def _regression(poison_at):
    """A FunctionalModel regression; batch ``poison_at`` carries a NaN."""
    rng = np.random.default_rng(13)
    params = {"w": torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32) * 0.3),
              "b": torch.zeros(3)}

    def apply_fn(p, x, y):
        return {"loss": ((torch.tanh(x @ p["w"] + p["b"]) - y) ** 2).mean()}

    batches = []
    for i in range(4):
        x = rng.standard_normal((5, 6)).astype(np.float32)
        if i == poison_at:
            x[0, 0] = np.nan
        batches.append({"x": torch.from_numpy(x),
                        "y": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))})
    return FunctionalModel(apply_fn, params), batches


def _snapshot(model, opt):
    state = {k: {n: v.clone() if torch.is_tensor(v) else v for n, v in s.items()}
             for k, s in opt.optimizer.state.items()}
    return [p.detach().clone() for p in model.parameters()], state


def _assert_same(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        for n in a[1][k]:
            assert torch.equal(torch.as_tensor(a[1][k][n]), torch.as_tensor(b[1][k][n])), n


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_health_gate_skips_poisoned_step(fused):
    model, batches = _regression(poison_at=2)
    acc = Accelerator(cpu=True)
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR,
                                                      weight_decay=WD))
    step = acc.make_train_step(model, opt, clip_value=0.5)

    def run(batch):
        if fused:
            return step(batch)
        out = model(**batch)
        acc.backward(out["loss"])
        acc.clip_grad_value_(None, 0.5)  # a value clip must not launder the NaN
        opt.step()
        opt.zero_grad()
        return out["loss"]

    for batch in batches[:2]:
        assert torch.isfinite(run(batch))
    before = _snapshot(model, opt)
    assert not torch.isfinite(run(batches[2]))
    _assert_same(before, _snapshot(model, opt))
    assert not torch.isfinite(opt._last_health_norm)
    assert next(iter(opt.optimizer.state.values()))["step"].item() == 2
    assert torch.isfinite(run(batches[3]))
    assert next(iter(opt.optimizer.state.values()))["step"].item() == 3


def test_accumulate_gates_step_and_zero_grad():
    model, batches = _regression(poison_at=-1)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
    w0 = model.params["w"].detach().clone()
    with acc.accumulate(model):
        acc.backward(model(**batches[0])["loss"])
        assert not acc.sync_gradients
        opt.step()
        opt.zero_grad()
    assert opt.step_was_skipped and torch.equal(model.params["w"], w0)
    assert model.params["w"].grad is not None  # kept for the next micro-batch
    with acc.accumulate(model):
        acc.backward(model(**batches[1])["loss"])
        assert acc.sync_gradients
        norm = acc.clip_grad_norm_(None, 1e-3)
        opt.step()
        opt.zero_grad()
    assert norm is not None and norm.item() > 1e-3
    assert not opt.step_was_skipped and not torch.equal(model.params["w"], w0)
    assert model.params["w"].grad is None


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: x for k, v in tree.items() for n, x in _leaves(v, f"{prefix}{k}/").items()}
    return {prefix: tree}


@pytest.mark.parametrize("norm_type", [1.0, 2.0])
def test_clip_grad_norm_ignores_norm_type_like_jax(norm_type):
    """``clip_grad_norm_`` with any ``norm_type`` arms the global 2-norm
    clip and returns the 2-norm, as the JAX ``Accelerator`` does (the port
    warns that ``norm_type`` is ignored): one eager backward on the same
    tiny llama and batch, then one clipped SGD step.  The norms agree to
    1e-5 and the stepped parameters to 2e-5 (fp32, summed in different
    orders on the two sides)."""
    jcfg, tcfg, params = _setup()
    batch = _windows(jcfg.vocab_size, 1)[0][0]
    max_norm, lr = 0.05, 0.1

    jacc = JaxAccelerator()

    def japply(p, input_ids, attention_mask):
        return {"loss": jl.loss_fn(p, {"input_ids": input_ids,
                                       "attention_mask": attention_mask}, jcfg)}

    jmodel, jopt = jacc.prepare(JaxModel(japply, jax.tree.map(jnp.asarray, params)),
                                optax.sgd(lr))
    jacc.backward(jmodel(**jax.tree.map(jnp.asarray, batch))["loss"])
    want = float(jacc.clip_grad_norm_(None, max_norm, norm_type=norm_type))
    jopt.step()
    jopt.zero_grad()

    acc = Accelerator(cpu=True)

    def apply_fn(p, input_ids, attention_mask):
        return {"loss": tl.loss_fn(p, {"input_ids": input_ids,
                                       "attention_mask": attention_mask}, tcfg)}

    model = FunctionalModel(apply_fn, llama_params_from_jax(params, tcfg, device="cpu"))
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=lr))
    acc.backward(model(**_tensors(batch))["loss"])
    if norm_type == 2.0:
        got = acc.clip_grad_norm_(None, max_norm, norm_type=norm_type)
    else:
        with pytest.warns(UserWarning, match="norm_type"):
            got = acc.clip_grad_norm_(None, max_norm, norm_type=norm_type)
    opt.step()
    opt.zero_grad()

    assert want > 10 * max_norm  # the clip is active
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    stepped = _leaves(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), tcfg,
                                            device="cpu"))
    mine = _leaves(model.params)
    assert stepped.keys() == mine.keys()
    for name, p in mine.items():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=name)


def test_prepare_pairs_by_parameter_identity_and_checks():
    m1, _ = _regression(poison_at=-1)
    m2, _ = _regression(poison_at=-1)
    acc = Accelerator(cpu=True)
    o2 = torch.optim.SGD(m2.parameters(), lr=0.1)
    o1 = torch.optim.SGD(m1.parameters(), lr=0.1)
    p1, p2, q2, q1 = acc.prepare(m1, m2, o2, o1)
    assert q2.model is p2 and q1.model is p1
    with pytest.raises(ValueError, match="paired"):
        acc.make_train_step(p1, q2)
    with pytest.raises(ValueError, match="prepare the model"):
        Accelerator(cpu=True).prepare(torch.optim.SGD(m1.parameters(), lr=0.1))
    step = acc.make_train_step(p1, q1, accum_steps=2)
    with pytest.raises(ValueError, match="LIST"):
        step({"x": torch.zeros(5, 6), "y": torch.zeros(5, 3)})
