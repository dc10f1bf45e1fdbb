"""The port's llama training forward and loss (``accelerate_tpu_torch/models/
llama.py`` with ``ops/chunked_ce.py``, ``ops/flash_attention.py`` and
``ops/fused_attention.py``) against the JAX package on shared weights.

Weights are the JAX ``init_params`` with norm scales redrawn from a numpy
seed, converted by ``llama_params_from_jax``; token batches come from a
numpy seed.  ``loss_fn`` and its gradients (torch autograd against
``jax.value_and_grad``) agree in fp32 to atol = rtol = 1e-4, the fp32
tolerance of ``tests/test_torch_llama.py`` (the frameworks sum matmuls and
softmaxes in different orders).  ``ACCELERATE_ATTN_BLOCK=32`` makes the
flash and fused paths run two key blocks over the 64-token sequence on both
sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ = 64


def _setup(seed=0, **kw):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(seed)))
    for name in ("ln_attn", "ln_mlp"):
        params["layers"][name] = rng.normal(1.0, 0.3, params["layers"][name].shape).astype(
            np.float32)
    params["final_norm"] = rng.normal(1.0, 0.3, params["final_norm"].shape).astype(np.float32)
    return jcfg, tcfg, params


def _batch(seed, vocab, masked, labels=False):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, vocab, size=(2, SEQ)).astype(np.int32)}
    if masked:
        mask = np.ones((2, SEQ), np.int32)
        mask[0, :20] = 0  # left padding
        batch["attention_mask"] = mask
    if labels:
        lab = rng.integers(0, vocab, size=(2, SEQ)).astype(np.int32)
        lab[1, :5] = -100
        batch["labels"] = lab
    return batch


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "leftpad"])
@pytest.mark.parametrize("loss_impl", ["dense", "chunked"])
@pytest.mark.parametrize("attention_impl", ["einsum", "flash", "pallas"])
def test_loss_and_grads_match_jax(monkeypatch, attention_impl, loss_impl, masked, remat):
    monkeypatch.setenv("ACCELERATE_ATTN_BLOCK", "32")
    kw = dict(attention_impl=attention_impl, loss_impl=loss_impl, remat=remat,
              loss_chunk_size=96)  # 256 = 2 * 96 + 64: the padded last tile runs too
    jcfg, tcfg, params = _setup(**kw)
    batch = _batch(1, jcfg.vocab_size, masked)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch), jcfg)
    tparams = llama_params_from_jax(params, tcfg, device="cpu")
    leaves = _leaves(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tloss = tl.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    want = _leaves(jax.tree.map(np.asarray, jgrads))
    for (name, _), got in zip(leaves.items(), grads):
        np.testing.assert_allclose(got.numpy(), want[name], **TOL, err_msg=name)


@pytest.mark.parametrize("attention_impl", ["einsum", "pallas"])
def test_apply_logits_with_labels_and_positions_match_jax(monkeypatch, attention_impl):
    """``apply`` logits and the ``labels`` branch of ``labels_and_weights``
    (negative labels ignored) against JAX."""
    monkeypatch.setenv("ACCELERATE_ATTN_BLOCK", "32")
    jcfg, tcfg, params = _setup(2, attention_impl=attention_impl, attention_bias=True)
    batch = _batch(3, jcfg.vocab_size, True, labels=True)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams = llama_params_from_jax(params, tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    want = jl.apply(jp, jb["input_ids"], jcfg, attention_mask=jb["attention_mask"])
    got = tl.apply(tparams, tb["input_ids"], tcfg, attention_mask=tb["attention_mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tl.loss_fn(tparams, tb, tcfg).item(),
                               float(jl.loss_fn(jp, jb, jcfg)), **TOL)
    for t, j in zip(tl.labels_and_weights(tb), jl.labels_and_weights(jb)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_chunked_cross_entropy_matches_dense():
    from accelerate_tpu_torch.ops.chunked_ce import chunked_cross_entropy

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32)).requires_grad_()
    head = torch.from_numpy(rng.standard_normal((16, 50)).astype(np.float32)).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, 50, size=(2, 8)))
    weights = torch.from_numpy((rng.random((2, 8)) > 0.3).astype(np.float32))
    got = chunked_cross_entropy(x, head, labels, weights, chunk_size=16)
    want = tl.cross_entropy(x @ head, labels, weights)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    gx, gh = torch.autograd.grad(got, (x, head))
    wx, wh = torch.autograd.grad(want, (x, head))
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gh, wh, rtol=1e-5, atol=1e-6)


def test_auto_dispatch_rules(monkeypatch):
    """``"auto"`` on CPU tensors takes the blockwise flash path at S >= 1024
    and einsum below; ``"pallas"`` always takes the fused op, and on CPU
    tensors that is its plain version (no kernel launch)."""
    from accelerate_tpu_torch.ops import fused_attention as fu

    cpu = torch.device("cpu")
    auto = tl.LlamaConfig.tiny(attention_impl="auto")
    assert not tl._use_fused(auto, 2048, 128, cpu)
    assert tl._use_fused(auto, 2048, 128, torch.device("cuda"))
    assert not tl._use_fused(auto, 512, 128, torch.device("cuda"))
    # A head dim the kernels do not take still goes to them (and raises
    # there) rather than to a plain path on the card.
    assert tl._use_fused(auto, 2048, 256, torch.device("cuda"))
    assert tl._use_fused(tl.LlamaConfig.tiny(attention_impl="pallas"), 64, 16, cpu)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, attention_impl="pallas", max_seq_len=256)
    params = tl.init_params(cfg, seed=0, device="cpu")
    before = fu.fused_attention_fwd.launches
    ids = torch.randint(0, cfg.vocab_size, (1, 96))
    assert torch.isfinite(tl.apply(params, ids, cfg)).all()
    assert fu.fused_attention_fwd.launches == before
    with pytest.raises(ValueError, match="seq_len"):
        tl.apply(params, torch.randint(0, cfg.vocab_size, (1, 1100)),
                 tl.LlamaConfig.tiny(dtype=torch.float32, attention_impl="pallas",
                                     max_seq_len=2048, num_layers=1))


def test_trainable_module_trains_and_still_serves():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = tl.LlamaForCausalLM(cfg, seed=1, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    acc = Accelerator(cpu=True)
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                                      weight_decay=1e-4))
    step = acc.make_train_step(model, opt)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 32)))
    losses = [float(step({"input_ids": ids})) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    logits, _ = model(ids[:, :5], tl.init_cache(cfg, 2, 8, device="cpu"))
    assert logits.shape == (2, 5, cfg.vocab_size) and torch.isfinite(logits).all()
