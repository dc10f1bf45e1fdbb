"""``mixed_precision`` in the port (``MixedPrecisionPolicy``,
``AcceleratorState``, :class:`~accelerate_tpu_torch.PreparedModel`)
against the JAX ``Accelerator``'s ``PreparedModel`` on the CPU.

Tolerances: the examples' ``PairClassifier`` under ``"bf16"`` gives the JAX
logits and first fp32 gradients within 2e-2 relative to the largest entry
(bf16 rounds the weights and every product's inputs to 8 bits of mantissa;
the two frameworks also reduce in other orders).  The embedding table's
gradient is summed over repeated rows in bf16 in both packages, which puts
each far from the fp32 gradient (on this batch 0.107 relative for the port,
0.212 for JAX, and 0.105 between them): it is held to be no farther from
the fp32 gradient than JAX's.  Everything else is exact: the policy's dtypes,
parameter identity, the checkpoint's fp32 names and values, and a llama
whose weights llama itself casts to ``config.dtype`` at use, which gives the
same loss bit for bit with or without the policy.
"""

import os

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import _flatten_tree
from accelerate_tpu.utils import MixedPrecisionPolicy as JaxMixedPrecisionPolicy
from accelerate_tpu_torch import (
    Accelerator,
    AcceleratorState,
    FunctionalModel,
    MixedPrecisionPolicy,
    PreparedModel,
)
from accelerate_tpu_torch.models import llama as tl
from chip_smoke import PairClassifier, collate, make_dataset

BF16_REL = 2e-2


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


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mode,compute", [("no", torch.float32), (None, torch.float32),
                                          ("bf16", torch.bfloat16), ("fp16", torch.bfloat16)])
def test_policy_matches_jax(mode, compute):
    got = MixedPrecisionPolicy.from_mixed_precision(mode)
    want = JaxMixedPrecisionPolicy.from_mixed_precision(mode)
    assert got.compute_dtype == compute
    for field in ("param_dtype", "compute_dtype", "output_dtype", "reduce_dtype"):
        assert str(getattr(got, field)).replace("torch.", "") == getattr(want, field)
    assert got.fp8 is want.fp8 is False
    with pytest.raises(NotImplementedError, match="A8"):
        MixedPrecisionPolicy.from_mixed_precision("fp8")
    with pytest.raises(ValueError):
        MixedPrecisionPolicy.from_mixed_precision("int4")


def _pair_batch(n=16):
    return collate(make_dataset(n, seed=3))


def test_pair_classifier_bf16_matches_jax_prepared_model():
    batch = _pair_batch()
    torch.manual_seed(0)
    model = PairClassifier()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    jacc = JaxAccelerator(mixed_precision="bf16")
    jmodel = jacc.prepare(model)
    jlogits = jmodel(batch["input_ids_a"], batch["input_ids_b"])
    jacc.backward(torch.nn.functional.cross_entropy(jlogits, batch["labels"]))
    jgrads = {k: np.asarray(v) for k, v in _flatten_tree(jax.device_get(
        jmodel._accum_grads)).items()}

    fresh = PairClassifier()
    fresh.load_state_dict(state)
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    pmodel = acc.prepare(fresh)
    assert isinstance(pmodel, PreparedModel) and acc.unwrap_model(pmodel) is fresh
    logits = pmodel(batch["input_ids_a"], batch["input_ids_b"])
    assert logits.dtype == torch.float32
    acc.backward(torch.nn.functional.cross_entropy(logits, batch["labels"]))
    rel = _rel(logits.detach(), jlogits.detach())
    assert rel <= BF16_REL, f"logits: max|diff|/max|JAX| = {rel:.3e}"
    assert logits.detach().ne(
        PairClassifier.forward(fresh, batch["input_ids_a"], batch["input_ids_b"])).any()
    ref = PairClassifier()
    ref.load_state_dict(state)
    torch.nn.functional.cross_entropy(ref(batch["input_ids_a"], batch["input_ids_b"]),
                                      batch["labels"]).backward()
    for (name, p), r in zip(fresh.named_parameters(), ref.parameters()):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        if name == "embed.weight":
            got, want = _rel(p.grad, r.grad), _rel(jgrads[name], r.grad)
            assert got <= want, f"embedding gradient off fp32 by {got:.3e}, JAX's by {want:.3e}"
            continue
        rel = _rel(p.grad, jgrads[name])
        assert rel <= BF16_REL, f"{name} gradient: max|diff|/max|JAX| = {rel:.3e}"


def test_prepared_model_keeps_identity_names_and_fp32_checkpoints(tmp_path):
    torch.manual_seed(0)
    model = PairClassifier()
    ids = [id(p) for p in model.parameters()]
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    pmodel, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2))
    assert [id(p) for p in pmodel.parameters()] == ids and opt.model is pmodel
    assert acc.prepare(model) is pmodel and acc.prepare_model(pmodel) is pmodel
    assert pmodel.embed is model.embed  # attributes read through
    assert list(pmodel.state_dict()) == list(model.state_dict())
    batch = _pair_batch(8)
    acc.backward(pmodel(batch["input_ids_a"], batch["input_ids_b"]).sum())
    opt.step()
    saved = acc.save_state(str(tmp_path / "ckpt"))
    want = {k: v.clone() for k, v in model.state_dict().items()}
    from accelerate_tpu_torch.checkpointing import read_safetensors_state_dict

    on_disk = read_safetensors_state_dict(saved)
    assert sorted(on_disk) == sorted(want)
    assert all(on_disk[k].dtype == torch.float32 and torch.equal(on_disk[k], want[k])
               for k in want)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    acc.load_state(saved)
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)
    assert acc.get_state_dict(pmodel) .keys() == want.keys()


def test_no_policy_returns_the_module_itself():
    model = torch.nn.Linear(2, 2)
    acc = Accelerator(cpu=True, mixed_precision="no")
    assert acc.prepare(model) is model
    with acc.autocast():
        assert model(torch.ones(1, 2)).dtype == torch.float32


def test_buffers_are_cast_and_in_place_updates_kept():
    net = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.BatchNorm1d(4))
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    pnet = acc.prepare(net)
    seen = []
    net[1].register_forward_pre_hook(lambda m, a: seen.append(m.running_mean.dtype))
    out = pnet(torch.randn(8, 4))
    assert seen == [torch.bfloat16] and out.dtype == torch.float32
    assert net[1].running_mean.dtype == torch.float32 and net[1].running_mean.abs().sum() > 0
    assert net[1].num_batches_tracked.item() == 1


def test_functional_model_under_the_policy():
    seen = []

    def apply_fn(params, x):
        seen.append(params["w"]["a"].dtype)
        return {"loss": (x @ params["w"]["a"]).float().square().mean()}

    w = torch.ones(3, 2)
    model = FunctionalModel(apply_fn, {"w": {"a": w}})
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    pmodel = acc.prepare(model)
    loss = pmodel(torch.ones(4, 3))["loss"]
    acc.backward(loss)
    assert seen == [torch.bfloat16] and model._leaves[0].grad.dtype == torch.float32
    assert model.params["w"]["a"] is model._leaves[0]
    assert list(pmodel.state_dict()) == ["w.a"]


def test_llama_loss_is_bit_identical_with_and_without_the_policy():
    """llama casts every weight to ``config.dtype`` at use, so the bf16
    policy's copies change no value of the first loss; gradients agree too,
    but for the embedding table's, which the policy accumulates over
    repeated rows in bf16."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, num_layers=2, remat=True)
    params = tl.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    ids[:, 16:] = ids[:, :16]  # repeated rows in the embedding's gradient
    out = {}
    for mode in ("no", "bf16"):
        AcceleratorState._reset_state(reset_partial_state=True)
        acc = Accelerator(cpu=True, mixed_precision=mode)
        model = tl.LlamaForCausalLM(cfg, params={k: (dict(v) if k == "layers" else v)
                                                 for k, v in params.items()}, device="cpu")
        pmodel = acc.prepare(model)
        loss = pmodel(input_ids=ids)["loss"]
        acc.backward(loss)
        out[mode] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()})
    assert torch.equal(out["no"][0], out["bf16"][0])
    for name, g in out["no"][1].items():
        if name != "top.embed":
            assert torch.equal(g, out["bf16"][1][name]), name
    assert _rel(out["bf16"][1]["top.embed"], out["no"][1]["top.embed"]) <= BF16_REL


def test_trace_dir_env_and_profile_handler(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_TRACE_DIR", str(tmp_path))
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    pmodel = acc.prepare(torch.nn.Linear(4, 4))
    with acc.profile():
        pmodel(torch.ones(2, 4))
    assert os.listdir(tmp_path / "profile_0")


class _CastBeforeForward(tl.LlamaForCausalLM):
    """llama without the cast-at-use protocol: the bf16 policy's
    ``PreparedModel`` casts every parameter before the forward, as it does
    for any other module."""

    _forward_cast_at_use = None


def _policy_step(cls, cfg, params, ids):
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    model = cls(cfg, params={k: (dict(v) if k == "layers" else v) for k, v in params.items()},
                device="cpu")
    pmodel = acc.prepare(model)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = pmodel(input_ids=ids)["loss"]
    acc.backward(loss)
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, saved, model


_GEMMA_LIKE = dict(hidden_act="gelu_tanh", rms_offset=True, embed_scale=True,
                   tie_embeddings=True, head_dim=32)


@pytest.mark.parametrize("gemma", [False, True], ids=["llama", "gemma"])
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_llama_casts_at_use_bit_identical_to_casting_before_forward(policy, gemma):
    """Under ``"bf16"`` llama casts each layer's weights inside its
    checkpointed layer (``_forward_cast_at_use``); the loss and every
    gradient, the embedding's included, equal the cast-before-forward path
    bit for bit (gemma's (1 + w) norms read the bf16-rounded w either way)."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, num_layers=2, remat=True,
                              remat_policy=policy, **(_GEMMA_LIKE if gemma else {}))
    params = tl.init_params(cfg, seed=0, device="cpu")
    if gemma:  # nonzero (1 + w) offsets, so the norms' weights are read
        for k in ("ln_attn", "ln_mlp"):
            params["layers"][k] = torch.randn(params["layers"][k].shape,
                                              generator=torch.Generator().manual_seed(2)) * 0.1
    ids = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    loss, grads, _, _ = _policy_step(tl.LlamaForCausalLM, cfg, params, ids)
    want_loss, want_grads, _, _ = _policy_step(_CastBeforeForward, cfg, params, ids)
    assert torch.equal(loss, want_loss)
    assert list(grads) == list(want_grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and torch.equal(g, want_grads[name]), name


def test_no_saved_tensor_aliases_a_stacked_16bit_layer_weight():
    """What autograd saves in a ``"bf16"`` forward under ``remat=True``: a
    checkpointed layer saves its inputs, and with the cast at use those
    are views of the fp32 layer parameters; no saved tensor is a view of a
    stacked [L, ...] 16-bit copy, which the cast-before-forward path holds
    for every layer until the backward."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, num_layers=3, remat=True)
    params = tl.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    stacked = {tuple(v.shape) for v in params["layers"].values()}

    def stacked_16bit(saved):
        return [t for t in saved if t._base is not None and t._base.dtype == torch.bfloat16
                and tuple(t._base.shape) in stacked]

    _, _, saved, model = _policy_step(tl.LlamaForCausalLM, cfg, params, ids)
    assert stacked_16bit(saved) == []
    layer_params = {p.data_ptr() for p in model.layers.values()}
    assert sum(t._base is not None and t._base.data_ptr() in layer_params for t in saved) == \
        cfg.num_layers * len(params["layers"])
    _, _, saved, _ = _policy_step(_CastBeforeForward, cfg, params, ids)
    assert len(stacked_16bit(saved)) == cfg.num_layers * len(params["layers"])


def test_cached_forward_casts_at_use_to_the_same_logits():
    """``forward(input_ids, cache)`` (the serving forward) through the bf16
    policy: llama casts every weight at use there too, to the logits and
    cache of the cast-before-forward path, bit for bit."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, num_layers=2)
    params = tl.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(4))
    out = []
    for cls in (tl.LlamaForCausalLM, _CastBeforeForward):
        AcceleratorState._reset_state(reset_partial_state=True)
        pmodel = Accelerator(cpu=True, mixed_precision="bf16").prepare(
            cls(cfg, params={k: (dict(v) if k == "layers" else v) for k, v in params.items()},
                device="cpu"))
        with torch.no_grad():
            out.append(pmodel(ids, tl.init_cache(cfg, 2, 16, device="cpu")))
    (logits, cache), (want_logits, want_cache) = out
    assert torch.equal(logits, want_logits)
    assert all(torch.equal(cache[k], want_cache[k]) for k in ("k", "v"))
