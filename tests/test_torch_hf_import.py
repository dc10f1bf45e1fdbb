"""The port's HF import and export for every family
(``accelerate_tpu_torch/models/hf_import.py`` / ``hf_export.py``) against
the JAX package's and against transformers itself.

For llama, qwen2, mistral, gemma, phi3 and gpt2, a tiny transformers model
is built in code from a torch seed; then:

- the port's ``from_hf`` gives the params JAX's ``from_hf`` gives, exactly
  (both copy the same fp32 tensors; transposes and splits move no bits);
- the port's fp32 logits match the transformers forward and JAX's
  ``llama.apply`` (``gpt2.apply``) within 1e-5 (the three sum in other
  orders);
- ``export_hf_checkpoint`` writes a directory ``from_pretrained`` loads,
  whose logits match the original model's within 1e-5, and importing it
  again (``load_hf_checkpoint``) gives the params bit for bit.

The same holds for Mixtral, BERT, T5, ViT and ResNet (the A3 families):
params equal to JAX's ``from_hf``, fp32 outputs within 1e-5 of
transformers and of the JAX forward (1e-4 for ResNet, whose convolutions
sum in other orders), export -> import bit for bit, and the exported
directory loads in transformers.  BERT and ViT are built with the tanh
GELU, the port's; Mixtral imports with a capacity no token overflows
(transformers has none).

``config_from_hf``'s refusals raise what JAX's raise, with the same
message.  No network: every config is written here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import bert as jb
from accelerate_tpu.models import gpt2 as jg
from accelerate_tpu.models import hf_import as jhf
from accelerate_tpu.models import llama as jl
from accelerate_tpu.models import mixtral as jmx
from accelerate_tpu.models import resnet as jr
from accelerate_tpu.models import t5 as jt
from accelerate_tpu.models import vit as jv
from accelerate_tpu_torch.models import bert as tb
from accelerate_tpu_torch.models import gpt2 as tg
from accelerate_tpu_torch.models import hf_export, hf_import
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models import mixtral as tmx
from accelerate_tpu_torch.models import resnet as tr
from accelerate_tpu_torch.models import t5 as tt
from accelerate_tpu_torch.models import vit as tv

transformers = pytest.importorskip("transformers")

SMALL = dict(vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


def _hf_model(family, seed):
    if family == "llama":
        cfg = transformers.LlamaConfig(**SMALL, rms_norm_eps=1e-6, tie_word_embeddings=False)
        cls = transformers.LlamaForCausalLM
    elif family == "qwen2":
        cfg = transformers.Qwen2Config(**SMALL, use_sliding_window=False,
                                       tie_word_embeddings=False)
        cls = transformers.Qwen2ForCausalLM
    elif family == "mistral":
        cfg = transformers.MistralConfig(**SMALL, sliding_window=None)
        cls = transformers.MistralForCausalLM
    elif family == "gemma":
        # head_dim 32 against hidden 48 / 4 heads: Gemma's head dim is its own.
        cfg = transformers.GemmaConfig(**SMALL, head_dim=32, rms_norm_eps=1e-6)
        cls = transformers.GemmaForCausalLM
    elif family == "phi3":
        cfg = transformers.Phi3Config(**SMALL, pad_token_id=0, sliding_window=None)
        cls = transformers.Phi3ForCausalLM
    else:
        cfg = transformers.GPT2Config(vocab_size=96, n_embd=48, n_layer=2, n_head=4,
                                      n_positions=64, activation_function="gelu_new")
        cls = transformers.GPT2LMHeadModel
    torch.manual_seed(seed)
    model = cls(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if family == "gemma" and "norm" in name:
                # nonzero (1 + w) norm offsets, so the norms' weights count
                p.normal_(0.0, 0.1)
            elif family == "gpt2" and (name.endswith("bias") or ".ln_" in name):
                # biases and LayerNorms away from their init, so each counts
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.1)
    return model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _ids(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (2, 10)).astype(np.int64)


FAMILIES = ["llama", "qwen2", "mistral", "gemma", "phi3", "gpt2"]
# The config fields each native family must carry over as JAX's does.
FIELDS = {
    "llama": ("hidden_size", "num_heads", "num_kv_heads", "head_dim_", "hidden_act",
              "rms_offset", "embed_scale", "tie_embeddings", "attention_bias", "rms_eps",
              "rope_theta", "rope_scaling", "max_seq_len"),
    "gpt2": ("vocab_size", "hidden_size", "num_layers", "num_heads", "max_seq_len",
             "layer_norm_eps", "head_dim"),
}


def _native(family):
    return "gpt2" if family == "gpt2" else "llama"


@pytest.mark.parametrize("family", FAMILIES)
def test_import_matches_jax_and_transformers(family):
    hf = _hf_model(family, seed=FAMILIES.index(family))
    got_family, cfg, params = hf_import.from_hf(hf, device="cpu", dtype=torch.float32)
    jfamily, jcfg, jparams = jhf.from_hf(hf, dtype=jnp.float32, param_dtype=jnp.float32)
    assert got_family == jfamily == _native(family)
    for field in FIELDS[_native(family)]:
        assert getattr(cfg, field) == getattr(jcfg, field), field
    got, want = _flat(params), _flat(jparams)
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)
    ids = _ids(cfg.vocab_size)
    tmod, jmod = (tg, jg) if family == "gpt2" else (tl, jl)
    logits = tmod.apply(params, torch.from_numpy(ids), cfg).numpy()
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()
    jlogits = np.asarray(jmod.apply(jparams, jnp.asarray(ids, jnp.int32), jcfg))
    np.testing.assert_allclose(logits, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(logits, jlogits, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_loads_in_transformers_and_round_trips(family, tmp_path):
    hf = _hf_model(family, seed=10 + FAMILIES.index(family))
    native, cfg, params = hf_import.from_hf(hf, device="cpu", dtype=torch.float32)
    sd = hf_export.export_state_dict(native, params, cfg)
    again = hf_import.import_state_dict(native, sd, cfg)
    for name, t in _flat(params).items():
        assert torch.equal(_flat(again)[name], t), name
    out = hf_export.export_hf_checkpoint(native, params, cfg, str(tmp_path / family))
    loaded = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    assert type(loaded).__name__ == {"gemma": "GemmaForCausalLM",
                                     "gpt2": "GPT2LMHeadModel"}.get(family, "LlamaForCausalLM")
    ids = torch.from_numpy(_ids(cfg.vocab_size, seed=1))
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ids).logits.numpy(), hf(ids).logits.numpy(),
                                   atol=1e-5, rtol=1e-5)
    fam, cfg2, params2 = hf_import.load_hf_checkpoint(out, device="cpu", dtype=torch.float32)
    assert fam == native
    if native == "gpt2":
        assert cfg2 == cfg
    else:
        # config.json names the head dim even where the HF config left it implied.
        assert cfg2.head_dim_ == cfg.head_dim_
        assert dataclasses.replace(cfg2, head_dim=None) == dataclasses.replace(cfg,
                                                                              head_dim=None)
    for name, t in _flat(params).items():
        assert torch.equal(_flat(params2)[name], t), name


A3 = ["mixtral", "bert", "t5", "vit", "resnet"]


def _a3_model(family, seed):
    """A tiny transformers model of an A3 family, its non-unit norms and
    zero biases drawn away from their init so each counts."""
    if family == "mixtral":
        cfg = transformers.MixtralConfig(**SMALL, num_local_experts=4, num_experts_per_tok=2,
                                         rms_norm_eps=1e-6, sliding_window=None)
        cls = transformers.MixtralForCausalLM
    elif family == "bert":
        cfg = transformers.BertConfig(vocab_size=96, hidden_size=48, num_hidden_layers=2,
                                      num_attention_heads=4, intermediate_size=192,
                                      max_position_embeddings=64, num_labels=3,
                                      hidden_act="gelu_pytorch_tanh")
        cls = transformers.BertForSequenceClassification
    elif family == "t5":
        cfg = transformers.T5Config(vocab_size=96, d_model=48, d_kv=12, d_ff=96, num_layers=2,
                                    num_heads=4, relative_attention_num_buckets=8,
                                    relative_attention_max_distance=32,
                                    feed_forward_proj="relu", tie_word_embeddings=True)
        cls = transformers.T5ForConditionalGeneration
    elif family == "vit":
        cfg = transformers.ViTConfig(image_size=16, patch_size=4, num_channels=3, hidden_size=48,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     intermediate_size=192, num_labels=4,
                                     hidden_act="gelu_pytorch_tanh")
        cls = transformers.ViTForImageClassification
    else:
        cfg = transformers.ResNetConfig(num_channels=3, embedding_size=8, hidden_sizes=[32, 64],
                                        depths=[2, 1], layer_type="bottleneck", num_labels=4,
                                        downsample_in_first_stage=False)
        cls = transformers.ResNetForImageClassification
    torch.manual_seed(seed)
    model = cls(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name.lower() or name.endswith("bias"):
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.1)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5)
    return model


def _a3_inputs(family, seed=0):
    rng = np.random.default_rng(seed)
    if family in ("vit", "resnet"):
        size = 16 if family == "vit" else 32
        return rng.normal(size=(2, size, size, 3)).astype(np.float32)
    return rng.integers(0, 96, (2, 10)).astype(np.int64)


def _a3_outputs(family, hf, cfg, params, jcfg, jparams, x):
    """(port, transformers, JAX) fp32 outputs of one forward over ``x``.  The
    JAX forwards run jitted: eager, a sharding constraint on a committed
    input raises under a mesh an earlier test in the process installed."""
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x.astype(np.float32) if x.dtype != np.int64 else x.astype(np.int32))
    if family == "mixtral":
        with torch.no_grad():
            ref = hf(tx).logits
        return (tmx.apply(params, tx, cfg)[0], ref,
                jax.jit(jmx.apply, static_argnums=2)(jparams, jx, jcfg)[0])
    if family == "t5":
        dec = torch.from_numpy(x[:, :6] % 50)
        with torch.no_grad():
            ref = hf(input_ids=tx, decoder_input_ids=dec).logits
        return (tt.apply(params, tx, dec, cfg), ref,
                jax.jit(jt.apply, static_argnums=3)(
                    jparams, jx, jnp.asarray(dec.numpy().astype(np.int32)), jcfg))
    if family == "resnet":
        with torch.no_grad():
            ref = hf(tx.permute(0, 3, 1, 2)).logits
        p, st = params["params"], params["batch_stats"]
        pooled, _ = tr.apply(p, st, tx, cfg)
        jpooled, _ = jax.jit(jr.apply, static_argnums=(3, 4))(
            jparams["params"], jparams["batch_stats"], jx, jcfg, False)
        head = p["classifier"]
        jhead = jparams["params"]["classifier"]
    else:
        with torch.no_grad():
            ref = hf(tx.permute(0, 3, 1, 2) if family == "vit" else tx).logits
        pooled = (tv.apply(params, tx, cfg) if family == "vit" else tb.apply(params, tx, cfg))[1]
        jpooled = jax.jit(jv.apply if family == "vit" else jb.apply, static_argnums=2)(
            jparams, jx, jcfg)[1]
        head, jhead = params["classifier"], jparams["classifier"]
    return (pooled @ head["w"] + head["b"], ref,
            jnp.asarray(jpooled) @ jhead["w"] + jhead["b"])


@pytest.mark.parametrize("family", A3)
def test_a3_import_matches_jax_and_transformers(family):
    hf = _a3_model(family, seed=30 + A3.index(family))
    over = dict(dtype=torch.float32)
    jover = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    if family == "mixtral":  # transformers drops no token: a capacity none overflows
        over["capacity_factor"] = jover["capacity_factor"] = 8.0
    got_family, cfg, params = hf_import.from_hf(hf, device="cpu", **over)
    jfamily, jcfg, jparams = jhf.from_hf(hf, **jover)
    assert got_family == jfamily == family
    got, want = _flat(params), _flat(jparams)
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)
    ours, ref, jours = _a3_outputs(family, hf, cfg, params, jcfg, jparams, _a3_inputs(family))
    tol = 1e-4 if family == "resnet" else 1e-5
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jours), atol=tol, rtol=tol)


_AUTO = {"mixtral": "AutoModelForCausalLM", "bert": "AutoModelForSequenceClassification",
         "t5": "AutoModelForSeq2SeqLM", "vit": "AutoModelForImageClassification",
         "resnet": "AutoModelForImageClassification"}


@pytest.mark.parametrize("family", A3)
def test_a3_export_round_trips_and_loads_in_transformers(family, tmp_path):
    hf = _a3_model(family, seed=40 + A3.index(family))
    _, cfg, params = hf_import.from_hf(hf, device="cpu", dtype=torch.float32)
    again = hf_import.import_state_dict(family, hf_export.export_state_dict(family, params, cfg),
                                        cfg)
    for name, t in _flat(params).items():
        assert torch.equal(_flat(again)[name], t), name
    out = hf_export.export_hf_checkpoint(family, params, cfg, str(tmp_path / family))
    loaded = getattr(transformers, _AUTO[family]).from_pretrained(out).eval()
    assert type(loaded) is type(hf)
    for (name, a), (_, b) in zip(loaded.state_dict().items(), hf.state_dict().items()):
        assert torch.equal(a, b), name
    fam, cfg2, params2 = hf_import.load_hf_checkpoint(out, device="cpu", dtype=torch.float32)
    assert fam == family and cfg2 == cfg
    for name, t in _flat(params).items():
        assert torch.equal(_flat(params2)[name], t), name


def _refusals():
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=2)
    return {
        "mistral-window": lambda: transformers.MistralConfig(**kw, sliding_window=8),
        "qwen2-window": lambda: transformers.Qwen2Config(**kw, use_sliding_window=True),
        "phi3-window": lambda: transformers.Phi3Config(**kw, pad_token_id=0,
                                                       sliding_window=2047),
        "phi3-partial-rotary": lambda: transformers.Phi3Config(
            **kw, pad_token_id=0, sliding_window=None, partial_rotary_factor=0.5),
        "yarn": lambda: transformers.LlamaConfig(
            **kw, rope_scaling={"rope_type": "yarn", "factor": 4.0}),
        "llama-gelu": lambda: transformers.LlamaConfig(**kw, hidden_act="gelu"),
        "gemma-erf-gelu": lambda: transformers.GemmaConfig(**kw, hidden_activation="gelu"),
        "unknown-type": lambda: type("Cfg", (), {"model_type": "falcon"})(),
        "resnet-v1-downsampling": lambda: transformers.ResNetConfig(
            downsample_in_bottleneck=True),
        "resnet-first-stage-stride": lambda: transformers.ResNetConfig(
            downsample_in_first_stage=True),
        "resnet-non-doubling": lambda: transformers.ResNetConfig(
            embedding_size=64, hidden_sizes=[256, 512, 768, 2048]),
        "t5-gated": lambda: transformers.T5Config(feed_forward_proj="gated-gelu"),
        "t5-untied": lambda: transformers.T5Config(tie_word_embeddings=False),
        "t5-unequal-stacks": lambda: transformers.T5Config(num_layers=2, num_decoder_layers=3),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_config_refusals_match_jax(case):
    hf_cfg = _refusals()[case]()
    with pytest.raises(ValueError) as want:
        jhf.config_from_hf(hf_cfg)
    with pytest.raises(ValueError) as got:
        hf_import.config_from_hf(hf_cfg)
    if case == "unknown-type":  # the port lists the families it knows of
        assert "Unsupported HF model_type 'falcon'" in str(got.value)
    else:
        assert str(got.value) == str(want.value)


def test_config_from_hf_reads_any_object_with_the_attributes():
    """No transformers needed: Gemma-2B's published ``config.json`` values
    (google/gemma-2b) in a plain namespace."""
    from types import SimpleNamespace

    cfg = hf_import.config_from_hf(SimpleNamespace(
        model_type="gemma", vocab_size=256000, hidden_size=2048, intermediate_size=16384,
        num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1, head_dim=256,
        max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
        hidden_act="gelu_pytorch_tanh", hidden_activation=None, attention_bias=False,
        tie_word_embeddings=True))
    assert (cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads, cfg.hidden_act, cfg.rms_offset,
            cfg.embed_scale, cfg.tie_embeddings) == (256, 8, 1, "gelu_tanh", True, True, True)
    assert cfg.num_params() == 2_506_172_416


def test_strict_import_refuses_unmapped_tensors_and_other_families():
    hf = _hf_model("llama", seed=20)
    sd = dict(hf.state_dict())
    sd["model.layers.0.self_attn.extra.weight"] = torch.zeros(3)
    cfg = hf_import.config_from_hf(hf.config)
    with pytest.raises(ValueError, match="unmapped"):
        hf_import.import_state_dict("llama", dict(sd), cfg)
    params = hf_import.import_state_dict("llama", dict(sd), cfg, strict=False)
    assert params["layers"]["wq"].shape == (2, 48, 48)
    for fn in (lambda: hf_import.import_state_dict("falcon", {}, cfg),
               lambda: hf_export.export_state_dict("falcon", params, cfg)):
        with pytest.raises(ValueError, match="falcon"):
            fn()
    # Every family of the JAX module is ported: each config maps to its own.
    for hf_cfg, cls in ((transformers.MixtralConfig(num_hidden_layers=1), tmx.MixtralConfig),
                        (transformers.BertConfig(num_hidden_layers=1), tb.BertConfig),
                        (transformers.T5Config(num_layers=1), tt.T5Config),
                        (transformers.ViTConfig(num_hidden_layers=1), tv.ViTConfig),
                        (transformers.ResNetConfig(), tr.ResNetConfig),
                        (transformers.GPT2Config(n_layer=1), tg.GPT2Config)):
        assert isinstance(hf_import.config_from_hf(hf_cfg), cls)
