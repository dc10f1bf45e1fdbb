"""The port's checkpoints (``accelerate_tpu_torch/checkpointing.py``,
``resilience/manifest.py``, ``utils/safetensors_io.py``, the
``Accelerator`` save/load/resume surface, ``utils/convert.adamw_state_from_optax``)
against the JAX package's.

Tolerances, per test: file names, manifests, safetensors bytes and the
port's own save -> load -> continue are compared exactly; a JAX llama's
weights loaded into the port give the JAX loss within 1e-5 (the two
frameworks sum in another order); the port's AdamW step continued from
two optax steps matches optax's third within 2e-5.  The JAX accelerators
here run on the suite's 8-device CPU mesh; nothing compared depends on
its data shards (weights and file names, not step counts).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.data import DataLoader

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import JaxModel
from accelerate_tpu.models import llama as jl
from accelerate_tpu.resilience import manifest as jmanifest
from accelerate_tpu.utils import DataLoaderConfiguration as JaxDataLoaderConfiguration
from accelerate_tpu.utils import ProjectConfiguration as JaxProjectConfiguration
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.checkpointing import load_model_weights, read_safetensors_state_dict
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.resilience.manifest import (
    CheckpointVerificationError,
    find_latest_complete,
    read_manifest,
    verify_checkpoint,
    write_manifest,
)
from accelerate_tpu_torch.utils import safetensors_io
from accelerate_tpu_torch.utils.convert import adamw_state_from_optax, llama_params_from_jax
from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration, ProjectConfiguration

LR, WD = 1e-2, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    """Put back the global mesh this module found (a JAX ``Accelerator``
    installs its own), so later modules see the context they would alone."""
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


class Counter:
    def __init__(self):
        self.n = 0

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, sd):
        self.n = sd["n"]


def _objects(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: 1 - n / 10)
    data = [{"x": torch.full((3,), float(i)), "y": torch.zeros(2)} for i in range(16)]
    return model, opt, DataLoader(data, batch_size=4, shuffle=True), sched


def _port(tmp_path, seedable=False, stateful=True, **proj):
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(
        use_seedable_sampler=seedable, use_stateful_dataloader=stateful),
        project_config=ProjectConfiguration(project_dir=str(tmp_path), **proj))
    model, opt, dl, sched = acc.prepare(*_objects())
    counter = Counter()
    acc.register_for_checkpointing(counter)
    return acc, model, opt, dl, sched, counter


def _train(acc, model, opt, dl, sched, batches):
    it = iter(dl)
    for _ in range(batches):
        batch = next(it)
        with acc.accumulate(model):
            acc.backward(torch.nn.functional.mse_loss(model(batch["x"]), batch["y"]))
            opt.step()
            sched.step()
            opt.zero_grad()
    return it


@pytest.mark.parametrize("seedable", [False, True], ids=["plain_sampler", "seedable_sampler"])
def test_directory_contract_matches_jax(tmp_path, seedable):
    """The same objects saved by both packages give the same file names.
    With a seedable sampler the port also writes ``sampler.bin``: the JAX
    loader's ``sampler`` is the torch ``DataLoader``'s unused
    ``SequentialSampler``, so its save never finds the seedable one."""
    jacc = JaxAccelerator(
        dataloader_config=JaxDataLoaderConfiguration(use_seedable_sampler=seedable,
                                                     use_stateful_dataloader=True),
        project_config=JaxProjectConfiguration(project_dir=str(tmp_path / "jax")))
    jacc.prepare(*_objects())
    jacc.register_for_checkpointing(Counter())
    jax_files = set(os.listdir(jacc.save_state(str(tmp_path / "jax" / "ckpt"), step=3)))
    acc, *_ = _port(tmp_path / "port", seedable=seedable)
    port_files = set(os.listdir(acc.save_state(str(tmp_path / "port" / "ckpt"), step=3)))
    extra = {"sampler.bin"} if seedable else set()
    assert port_files == jax_files | extra
    assert jax_files == {"model.safetensors", "optimizer.bin", "scheduler.bin",
                         "dl_state_dict.bin", "custom_checkpoint_0.pkl", "random_states_0.pkl",
                         "manifest.json"}


def test_manifests_cross_verify(tmp_path):
    """Each package's ``verify_checkpoint`` accepts the other's checkpoint
    and rejects it after one flipped byte."""
    jacc = JaxAccelerator(project_config=JaxProjectConfiguration(project_dir=str(tmp_path)))
    jacc.prepare(*_objects())
    jdir = jacc.save_state(str(tmp_path / "jax_ckpt"), step=4)
    acc, *_ = _port(tmp_path)
    pdir = acc.save_state(str(tmp_path / "port_ckpt"), step=4)
    for d in (jdir, pdir):
        for verify in (verify_checkpoint, jmanifest.verify_checkpoint):
            assert verify(d)["step"] == 4
    ours = read_manifest(pdir)
    assert ours["format"] == jmanifest.MANIFEST_FORMAT and ours["hashed"]
    assert set(ours) == set(jmanifest.read_manifest(jdir))
    assert set(ours["topology"]) == set(jmanifest.read_manifest(jdir)["topology"])
    for d in (jdir, pdir):
        path = os.path.join(d, "model.safetensors")
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 1
        open(path, "wb").write(bytes(blob))
        with pytest.raises(CheckpointVerificationError, match="sha256"):
            verify_checkpoint(d)
        with pytest.raises(jmanifest.CheckpointVerificationError, match="sha256"):
            jmanifest.verify_checkpoint(d)


def test_truncated_file_rejected(tmp_path):
    acc, *_ = _port(tmp_path)
    path = acc.save_state(str(tmp_path / "ckpt"), step=1)
    weights = os.path.join(path, "model.safetensors")
    blob = open(weights, "rb").read()
    open(weights, "wb").write(blob[: len(blob) // 2])
    with pytest.raises(CheckpointVerificationError, match="size"):
        verify_checkpoint(path)
    with pytest.raises(CheckpointVerificationError):
        acc.load_state(path)
    with pytest.raises(ValueError, match="truncated"):
        safetensors_io.load_file(weights)
    open(weights, "wb").write(blob[:-4] + b"\x00\x00\x00\x01")
    with pytest.raises(CheckpointVerificationError, match="sha256"):
        verify_checkpoint(path)


def test_resume_skips_torn_partial(tmp_path):
    acc, model, opt, dl, sched, counter = _port(tmp_path, automatic_checkpoint_naming=True)
    assert acc.resume_from_latest() is None
    counter.n = 5
    acc.save_state(step=5)
    base = tmp_path / "checkpoints"
    torn = base / "checkpoint_1"
    shutil.copytree(base / "checkpoint_0", torn)
    os.remove(torn / "manifest.json")
    os.utime(torn, (os.path.getmtime(base / "checkpoint_0") + 10,) * 2)
    (base / "checkpoint_2.tmp").mkdir()
    assert find_latest_complete(str(base)) == str(base / "checkpoint_0")
    counter.n = 0
    assert acc.resume_from_latest() == 5
    assert counter.n == 5
    assert acc.project_configuration.iteration == 1
    acc.load_state()  # the default target skips the torn one too


def test_rotation_keeps_total_limit(tmp_path):
    acc, *_ = _port(tmp_path, automatic_checkpoint_naming=True, total_limit=1)
    stale = tmp_path / "checkpoints" / "checkpoint_99.tmp"
    stale.mkdir(parents=True)
    for step in (1, 2, 3):
        acc.save_state(step=step)
    base = str(tmp_path / "checkpoints")
    assert sorted(os.listdir(base)) == ["checkpoint_2"]
    assert acc.resume_from_latest(base) == 3


def test_same_path_overwrite_swaps(tmp_path):
    acc, *_ = _port(tmp_path)
    path = str(tmp_path / "ckpt")
    acc.save_state(path, step=1)
    acc.save_state(path, step=2)
    assert read_manifest(path)["step"] == 2
    verify_checkpoint(path)
    assert not os.path.exists(path + ".tmp") and not os.path.exists(path + ".old")


def test_displaced_checkpoint_recovered_on_next_publish(tmp_path):
    acc, *_ = _port(tmp_path)
    path = str(tmp_path / "ckpt")
    acc.save_state(path, step=1)
    os.rename(path, path + ".old")  # a crash between the two renames of a publish
    acc.save_state(path, step=2)
    assert read_manifest(path)["step"] == 2
    assert not os.path.exists(path + ".old") and not os.path.exists(path + ".tmp")


def test_failed_rename_restores_previous_checkpoint(tmp_path, monkeypatch):
    acc, *_ = _port(tmp_path)
    path = str(tmp_path / "ckpt")
    acc.save_state(path, step=1)
    real_rename = os.rename

    def failing(src, dst):
        if src.endswith(".tmp"):
            raise OSError("disk full")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", failing)
    with pytest.raises(OSError, match="disk full"):
        acc.save_state(path, step=2)
    monkeypatch.setattr(os, "rename", real_rename)
    assert read_manifest(path)["step"] == 1
    verify_checkpoint(path)
    assert not os.path.exists(path + ".old")


def test_manifest_hash_env_opt_out(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_MANIFEST_HASH", "0")
    acc, *_ = _port(tmp_path)
    path = acc.save_state(str(tmp_path / "ckpt"))
    assert read_manifest(path)["hashed"] is False
    assert "sha256" not in read_manifest(path)["files"]["model.safetensors"]
    verify_checkpoint(path)


def test_save_load_restores_every_part(tmp_path):
    """Optimizer, scheduler, seedable sampler, loader position, registered
    object and RNG states come back exactly; pre-hooks run."""
    acc, model, opt, dl, sched, counter = _port(tmp_path, seedable=True)
    it = _train(acc, model, opt, dl, sched, 2)
    counter.n = 7
    calls = []

    def save_hook(models, weights, output_dir):
        calls.append(("save", output_dir.endswith(".tmp")))
        weights[0]["bias"] = weights[0]["bias"] + 1.0

    def load_hook(models, input_dir):
        calls.append(("load", input_dir))

    handle = acc.register_save_state_pre_hook(save_hook)
    acc.register_load_state_pre_hook(load_hook)
    np.random.seed(11)
    path = acc.save_state(str(tmp_path / "ckpt"), step=2)
    handle.remove()
    rng_after_save = (np.random.rand(), torch.rand(1).item())
    want_bias = model.bias.detach() + 1.0
    want_opt = opt.optimizer.state_dict()
    sd_lr = sched.get_last_lr()
    del it

    acc2, model2, opt2, dl2, sched2, counter2 = _port(tmp_path / "b", seedable=True)
    acc2.register_load_state_pre_hook(load_hook)
    assert acc2.load_state(path) == path
    assert calls == [("save", True), ("load", path)]
    assert torch.equal(model2.bias, want_bias) and torch.equal(model2.weight, model.weight)
    got_opt = opt2.optimizer.state_dict()
    for k, v in want_opt["state"].items():
        for name in v:
            assert torch.equal(got_opt["state"][k][name], v[name])
    assert opt2._step_count == opt._step_count == 2
    assert sched2.get_last_lr() == sd_lr and opt2.learning_rate == sd_lr[0]
    assert counter2.n == 7
    assert dl2.state_dict() == {"batches_yielded": 2, "iteration": 0}
    assert (dl2.sampler.epoch, dl2.sampler.initial_seed) == (dl.sampler.epoch, 42)
    assert (np.random.rand(), torch.rand(1).item()) == rng_after_save
    assert acc2.last_load_timing["verify_s"] >= 0 and acc.last_save_timing["bytes"] > 0


def test_set_seed_repeats_every_generator():
    import random

    from accelerate_tpu_torch.utils.random import set_seed

    draws = []
    for _ in range(2):
        set_seed(123)
        draws.append((random.random(), np.random.rand(), torch.rand(2).tolist()))
    assert draws[0] == draws[1]


def test_register_for_checkpointing_rejects_plain_objects(tmp_path):
    acc, *_ = _port(tmp_path)
    with pytest.raises(ValueError, match="state_dict"):
        acc.register_for_checkpointing(object())


def _tiny():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=2)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=2)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    return jcfg, tcfg, params


def _batches(vocab, n, b=2, s=16, seed=5):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, size=(b, s)).astype(np.int32)}
            for _ in range(n)]


def test_jax_llama_weights_load_into_the_port(tmp_path):
    """A JAX ``save_state`` of a llama loads into the port's
    ``LlamaForCausalLM`` by name, unchanged: the loss matches within 1e-5."""
    jcfg, tcfg, params = _tiny()
    batch = _batches(jcfg.vocab_size, 1)[0]
    want = float(jl.loss_fn(jax.tree.map(jnp.asarray, params),
                            {"input_ids": jnp.asarray(batch["input_ids"])}, jcfg))

    def apply_fn(p, input_ids):
        return {"loss": jl.loss_fn(p, {"input_ids": input_ids}, jcfg)}

    jacc = JaxAccelerator()
    jacc.prepare(JaxModel(apply_fn, jax.tree.map(jnp.asarray, params)), optax.adamw(LR))
    jdir = jacc.save_state(str(tmp_path / "jax_ckpt"))
    model = tl.LlamaForCausalLM(tcfg, seed=3, device="cpu")
    load_model_weights(model, jdir)
    got = model(input_ids=torch.from_numpy(batch["input_ids"]))["loss"].item()
    assert abs(got - want) <= 1e-5
    # The port's own save uses the same names, so the JAX reader takes it.
    from accelerate_tpu.checkpointing import read_safetensors_state_dict as jax_read

    Accelerator(cpu=True).save_model(model, str(tmp_path / "port_weights"))
    theirs = jax_read(str(tmp_path / "port_weights"))
    assert set(theirs) == set(model.state_dict())
    np.testing.assert_array_equal(theirs["layers.wq"], params["layers"]["wq"])


def test_adamw_state_from_optax_continues_optax(tmp_path):
    """Two optax ``adamw`` steps in JAX, the state moved across, then a
    third step in the port matches optax's third within 2e-5."""
    jcfg, tcfg, params = _tiny()
    batches = _batches(jcfg.vocab_size, 3)
    tx = optax.adamw(LR, weight_decay=WD)
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    grad = jax.grad(lambda p, b: jl.loss_fn(p, b, jcfg))
    snapshots = []
    for b in batches:
        snapshots.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, state)))
        updates, state = tx.update(grad(p, jax.tree.map(jnp.asarray, b)), state, p)
        p = optax.apply_updates(p, updates)
    p2, s2 = snapshots[2]
    model = tl.LlamaForCausalLM(tcfg, params=llama_params_from_jax(p2, tcfg, device="cpu"),
                                device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WD)
    moved = adamw_state_from_optax(s2, model.params, tcfg)
    assert len(moved) == len(list(model.parameters()))
    assert all(v["step"].item() == 2 for v in moved.values())
    opt.state.update(moved)
    loss = model(input_ids=torch.from_numpy(batches[2]["input_ids"]))["loss"]
    loss.backward()
    opt.step()
    want = llama_params_from_jax(jax.tree.map(np.asarray, p), tcfg, device="cpu")
    for name, got in model.params.items():
        if name == "layers":
            for k, g in got.items():
                torch.testing.assert_close(g.detach(), want["layers"][k], rtol=0, atol=2e-5)
        else:
            torch.testing.assert_close(got.detach(), want[name], rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="no optax Adam state"):
        adamw_state_from_optax((), model.params, tcfg)


def _llama_run(tmp_path, resume, seed, cfg, data, micro_batches=7, save_after_step=2):
    acc = Accelerator(
        cpu=True, gradient_accumulation_steps=2,
        dataloader_config=DataLoaderConfiguration(use_seedable_sampler=True,
                                                  use_stateful_dataloader=True,
                                                  prefetch_to_device=2),
        project_config=ProjectConfiguration(project_dir=str(tmp_path),
                                            automatic_checkpoint_naming=True, total_limit=2))
    model = tl.LlamaForCausalLM(cfg, seed=seed, device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: min(1.0, (n + 1) / 3))
    model, opt, dl, sched = acc.prepare(model, opt, DataLoader(data, batch_size=2, shuffle=True),
                                        sched)
    resumed = acc.resume_from_latest() if resume else None
    losses, lrs = [], []
    for batch in dl:
        with acc.accumulate(model):
            loss = model(**batch)["loss"]
            acc.backward(loss)
            opt.step()
            sched.step()
            opt.zero_grad()
        losses.append(loss.item())
        lrs.append(opt.learning_rate)
        if not resume and acc.sync_gradients and opt._step_count == save_after_step:
            acc.save_state(step=save_after_step)
    return resumed, losses, lrs, model, opt


def test_port_save_load_continue_is_bit_exact(tmp_path):
    """The README loop with a checkpoint after optimizer step 2 (micro-batch
    4 of 7, accumulation 2, prefetch depth 2); a fresh run from another
    seed resumes from it and ends bit-identical to the uninterrupted run."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=1)
    rng = np.random.default_rng(0)
    data = [{"input_ids": torch.from_numpy(rng.integers(0, 256, size=16))} for _ in range(14)]
    _, losses_a, lrs_a, model_a, opt_a = _llama_run(tmp_path, False, 0, cfg, data)
    assert opt_a._step_count == 4
    step, losses_b, lrs_b, model_b, opt_b = _llama_run(tmp_path, True, 1, cfg, data)
    assert step == 2
    assert losses_b == losses_a[4:] and lrs_b == lrs_a[4:]
    for a, b in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(a, b)
    sa, sb = opt_a.optimizer.state_dict()["state"], opt_b.optimizer.state_dict()["state"]
    for k in sa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][name], sb[k][name])


# -- the safetensors reader and writer --------------------------------------


def _tensors():
    gen = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=gen), "f16": torch.randn(4, generator=gen).half(),
            "i64": torch.arange(6).reshape(2, 3), "i32": torch.arange(3, dtype=torch.int32),
            "u8": torch.arange(7, dtype=torch.uint8), "flag": torch.tensor([True, False]),
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}


def test_safetensors_written_here_read_by_safetensors(tmp_path):
    from safetensors.numpy import load_file as np_load

    path = str(tmp_path / "a.safetensors")
    src = _tensors()
    safetensors_io.save_file(src, path)
    theirs = np_load(path)
    assert set(theirs) == set(src)
    for k, v in src.items():
        np.testing.assert_array_equal(theirs[k], v.numpy())


def test_safetensors_written_by_safetensors_read_here(tmp_path):
    from safetensors.numpy import save_file as np_save

    path = str(tmp_path / "b.safetensors")
    src = {k: v.numpy() for k, v in _tensors().items()}
    np_save(src, path, metadata={"k": "v"})
    ours = safetensors_io.load_file(path)
    for k, v in src.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)


def test_safetensors_bf16_both_ways(tmp_path):
    """bf16 through a byte view: safetensors' numpy API has no bf16, so the
    bits go across as int16 one way and come back as the library's torch
    bf16 the other."""
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import load_file as pt_load

    t = torch.randn(4, 6, generator=torch.Generator().manual_seed(1)).bfloat16()
    path = str(tmp_path / "bf16.safetensors")
    safetensors_io.save_file({"w": t}, path)
    assert torch.equal(pt_load(path)["w"].view(torch.int16), t.view(torch.int16))
    np_save({"w": t.view(torch.int16).numpy()}, path)
    back = safetensors_io.load_file(path)["w"]
    assert torch.equal(back.view(torch.bfloat16).view(torch.int16), t.view(torch.int16))


def test_safetensors_rejects_malformed(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    open(path, "wb").write(b"\x05")
    with pytest.raises(ValueError, match="too short"):
        safetensors_io.load_file(path)
    safetensors_io.save_file({"a": torch.ones(4)}, path)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob + b"\x00")
    with pytest.raises(ValueError, match="beyond the last tensor"):
        safetensors_io.load_file(path)
    with pytest.raises(ValueError, match="no safetensors name"):
        safetensors_io.save_file({"c": torch.ones(2, dtype=torch.complex64)}, path)


def test_sharded_weights_roundtrip(tmp_path):
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), seed=0, device="cpu")
    acc = Accelerator(cpu=True)
    index = acc.save_model(model, str(tmp_path / "w"), max_shard_size="40KB")
    assert index.endswith("model.safetensors.index.json")
    shards = [f for f in os.listdir(tmp_path / "w") if f.startswith("model-")]
    assert len(shards) > 1
    sd = read_safetensors_state_dict(str(tmp_path / "w"))
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    acc.save_model(model, str(tmp_path / "w"))  # one file again: the shards go
    assert sorted(os.listdir(tmp_path / "w")) == ["model.safetensors"]


def test_write_manifest_covers_files_and_skips_its_tmp(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "weights.bin").write_bytes(b"w" * 8)
    (d / "manifest.json.tmp").write_text("{torn")
    manifest = write_manifest(str(d), step=1)
    assert list(manifest["files"]) == ["weights.bin"]
    assert jmanifest.verify_checkpoint(str(d))["step"] == 1
