"""Data-parallel training over several processes in the port
(``optimizer.py``, ``pipeline/train_step.py``, ``parallel/zero.py``,
``checkpointing.py``), in gloo worlds of CPU processes
(``torch_dp_world``), against one process and against the JAX package.

In a 2-process world (module-scoped):

- the eager loop's averaged gradient (``accumulate``; ``no_sync`` on all
  but the last micro-batch) equals one process's gradient of the global
  batch within 1e-6 relative, and so does the norm ``clip_grad_norm_``
  returns (ROADMAP C12);
- the ZeRO ``make_train_step`` is bit-exact against the replicated one
  (losses, parameters on every process, the state dict gathered to full
  shapes) at ``accum`` 1 and 2 with a binding clip, holds about half the
  optimizer-state bytes per process, and a step the health gate skips
  (``ACCELERATE_TPU_FAULT_NAN_STEP``) keeps the shards and the state;
  under a bf16 ``comm_hook`` both modes sync in bf16, still bit for bit;
- ``save_state`` / ``load_state`` resume bit-exact across both processes,
  each with its own RNG states and loader position;
- the slice against JAX: the 2-process trajectory of a 2-layer tiny llama
  (fp32, 3 steps, binding clip, zero off and on; weights carried across by
  the converter) within 2e-5 relative of the JAX ``make_train_step`` on the
  suite's 8-device mesh over the same global batch.

In a 4-process world: ZeRO against the replicated step (the losses
exact; the parameters within 1e-6, since gloo's all-reduce and
reduce-scatter add four terms in different orders: 6e-8 measured), and the
loader rows against the JAX ``BatchSamplerShard`` at 4 processes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import JaxModel
from accelerate_tpu.data_loader import BatchSamplerShard as JaxBatchSamplerShard
from accelerate_tpu.models import llama as jl
from torch_dp_world import World

LR, WD, CLIP = 1e-2, 1e-4, 0.05


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("world2"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world4"), threads=1)
    yield w
    w.close()


@pytest.mark.parametrize("accum,no_sync", [(1, False), (2, False), (3, True)])
def test_eager_dp_gradient_equals_the_global_batch(world, accum, no_sync):
    for errs in world.run("torch_dp_tasks:dp_grads_match_global", accum, no_sync):
        assert max(errs.values()) <= 1e-6, errs


@pytest.mark.parametrize("accum", [1, 2])
def test_clip_grad_norm_returns_the_averaged_gradients_norm(world, accum):
    """``clip_grad_norm_`` returns the norm of the gradient averaged over
    the processes, as the JAX ``Accelerator`` returns the global gradient's
    (ROADMAP C12): the one-process norm of the concatenated batch's
    gradient, within 1e-6, on every process."""
    for out in world.run("torch_dp_tasks:clip_norm_is_the_global_norm", accum):
        assert abs(out["got"] - out["want"]) <= 1e-6 * out["want"], out


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def _same_state(a, b):
    return a.keys() == b.keys() and all(
        a[i].keys() == b[i].keys() and all(torch.equal(a[i][k], b[i][k]) for k in a[i])
        for i in a)


@pytest.mark.parametrize("accum", [1, 2])
def test_zero_is_bit_exact_against_the_replicated_step(world, accum):
    outs = world.run("torch_dp_tasks:zero_vs_replicated", accum, CLIP)
    for out in outs:
        rep, zero = out["rep"], out["zero"]
        assert zero["zero_active"] and not rep["zero_active"]
        assert zero["layout"] == {"kind": "zero", "axes": ["dp"], "degree": 2}
        assert rep["layout"] == {"kind": "replicated", "axes": [], "degree": 1}
        assert rep["losses"] == zero["losses"]
        # The norms the gate and the clip read: equal only if both modes
        # average the gradients (a binding clip would hide a scaled sum).
        assert rep["health"] == zero["health"] and rep["grad_norm"] == zero["grad_norm"]
        assert _same(rep["params"], zero["params"])
        assert _same_state(rep["state"], zero["state"])  # gathered to full shapes
        assert zero["bytes"] <= 0.55 * rep["bytes"], (zero["bytes"], rep["bytes"])
    assert _same(outs[0]["zero"]["params"], outs[1]["zero"]["params"])
    # The clip binds: the norms the steps saw are above it.
    assert min(outs[0]["zero"]["health"]) > CLIP


def test_the_health_gate_keeps_the_shards(world):
    for out in world.run("torch_dp_tasks:zero_vs_replicated", 1, CLIP, 3, 2):
        for mode in ("rep", "zero"):
            health = out[mode]["health"]
            assert np.isnan(health[1]) and np.isfinite(health[0]) and np.isfinite(health[2])
            assert out[mode]["kept"] == [True]
        np.testing.assert_array_equal(out["rep"]["health"], out["zero"]["health"])
        assert out["rep"]["losses"] == out["zero"]["losses"]
        assert _same(out["rep"]["params"], out["zero"]["params"])


def test_bf16_comm_hook_syncs_in_bf16_in_both_modes(world):
    """``DistributedDataParallelKwargs(comm_hook="bf16")``: the gradients are
    averaged in bf16 (the JAX ``_grad_sync_dtype``), replicated and ZeRO
    alike, bit for bit; the trajectory leaves the fp32 one."""
    fp32 = world.run("torch_dp_tasks:zero_vs_replicated", 1, CLIP)[0]
    for out in world.run("torch_dp_tasks:zero_vs_replicated", 1, CLIP, 3, None, "bf16"):
        assert out["rep"]["losses"] == out["zero"]["losses"]
        assert _same(out["rep"]["params"], out["zero"]["params"])
        assert out["rep"]["losses"][1:] != fp32["rep"]["losses"][1:]


def test_save_and_load_state_resume_bit_exact(world, tmp_path):
    outs = world.run("torch_dp_tasks:resume_bit_exact", str(tmp_path / "ckpt"))
    for out in outs:
        assert out["equal"] and out["rng"]
    files = outs[0]["files"]
    assert {"model.safetensors", "optimizer.bin", "manifest.json", "random_states_0.pkl",
            "random_states_1.pkl"} <= set(files)


def test_each_process_resumes_its_loader_position(world, tmp_path):
    outs = world.run("torch_dp_tasks:loader_position_resume", str(tmp_path / "ckpt"))
    for r, out in enumerate(outs):
        assert [row[0] % 4 for row in out["seen"]] == [2 * r] * 3
        assert out["resumed"] == out["rest"]
    import os

    assert {"dl_state_dict.bin", "dl_state_dict.rank1.bin"} <= set(os.listdir(tmp_path / "ckpt"))


def _llama_setup():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=2)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(11)
    batches = [{"input_ids": rng.integers(0, jcfg.vocab_size, size=(4, 16)).astype(np.int32),
                "attention_mask": np.ones((4, 16), np.int32)} for _ in range(3)]
    return jcfg, params, batches


def _jax_losses(jcfg, params, batches):
    """JAX's global losses and pre-clip norms over the same batches."""
    acc = JaxAccelerator()

    def apply_fn(p, input_ids, attention_mask):
        return {"loss": jl.loss_fn(p, {"input_ids": input_ids,
                                       "attention_mask": attention_mask}, jcfg)}

    model, opt = acc.prepare(JaxModel(apply_fn, jax.tree.map(jnp.asarray, params)),
                             optax.adamw(LR, weight_decay=WD))
    step = acc.make_train_step(model, opt, clip_norm=CLIP)
    losses, health = [], []
    for b in batches:
        losses.append(float(step(jax.tree.map(jnp.asarray, b))))
        health.append(float(step.last_health_norm))
    return np.asarray(losses), np.asarray(health)


def test_two_process_llama_trajectory_matches_jax(world):
    jcfg, params, batches = _llama_setup()
    want, want_health = _jax_losses(jcfg, params, batches)
    assert want_health.min() > CLIP  # the clip binds
    for zero in (False, True):
        outs = world.run("torch_dp_tasks:llama_trajectory", params, batches, zero, CLIP, LR, WD)
        for out in outs:
            assert out["zero_active"] == zero
            np.testing.assert_allclose(out["losses"], want, rtol=2e-5, atol=0)
            # The pre-clip norm of the averaged gradient: a sum left
            # unaveraged would be dp times JAX's.
            np.testing.assert_allclose(out["health"], want_health, rtol=2e-5, atol=0)
        assert outs[0]["losses"] == outs[1]["losses"]


def test_zero_at_four_processes(world4):
    outs = world4.run("torch_dp_tasks:zero_vs_replicated", 2, CLIP)
    for out in outs:
        rep, zero = out["rep"], out["zero"]
        assert zero["zero_active"] and rep["losses"] == zero["losses"]
        assert rep["health"] == zero["health"] and rep["grad_norm"] == zero["grad_norm"]
        gap = max(float((rep["params"][k] - zero["params"][k]).abs().max()) for k in rep["params"])
        assert gap <= 1e-6, gap
        assert zero["bytes"] <= 0.3 * rep["bytes"]
    assert _same(outs[0]["zero"]["params"], outs[3]["zero"]["params"])


@pytest.mark.parametrize("n_rows,bs,split,even", [(37, 4, False, True), (37, 4, False, False),
                                                  (40, 8, True, True)])
def test_loader_rows_equal_jax_at_four_processes(world4, n_rows, bs, split, even):
    got = world4.run("torch_dp_tasks:loader_rows", n_rows, bs, split, even)
    for r in range(4):
        sampler = torch.utils.data.BatchSampler(range(n_rows), bs, False)
        want = [list(b) for b in JaxBatchSamplerShard(sampler, num_processes=4, process_index=r,
                                                      split_batches=split, even_batches=even)]
        assert got[r] == want
