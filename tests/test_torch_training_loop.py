"""The slice as a whole: the README's training loop in the port against the
JAX package, on a tiny llama with shared weights.

``prepare(model, optimizer, dataloader, scheduler)``, then for every batch
``accumulate`` / ``backward`` / ``optimizer.step()`` / ``scheduler.step()``
/ ``zero_grad()``, over 7 batches with ``gradient_accumulation_steps=2``:
both take 4 optimizer steps, the last on the dataloader's last batch.  The
JAX side runs under ``split_batches=True``: on the suite's 8-device CPU
mesh each batch of 8 is split over the 8 data shards and its scheduler
steps once per optimizer step, as one GPU's does.  Tolerance: parameters
within 2e-5 after each optimizer step (the two frameworks sum in another
order; the JAX batch is also split over devices), LRs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import JaxModel
from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils import DataLoaderConfiguration as JaxDataLoaderConfiguration
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils.convert import llama_params_from_jax
from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration

LR, WD, BATCH, BATCHES = 1e-2, 1e-4, 8, 7


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    """Put back the global mesh this module found (a JAX ``Accelerator``
    installs its own), so later modules see the context they would alone."""
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


def _data(vocab):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, size=(BATCH * BATCHES, 16)).astype(np.int64)
    return [{"input_ids": torch.from_numpy(row)} for row in ids]


def _schedule(opt):
    return torch.optim.lr_scheduler.LambdaLR(opt, lambda n: min(1.0, (n + 1) / 3))


def _loop(acc, model, opt, dl, sched, read_params):
    """Run one epoch; return the parameters and LR after each optimizer
    step, and the micro-batches (1-based) on which it stepped."""
    snapshots, synced = [], []
    for i, batch in enumerate(dl, 1):
        with acc.accumulate(model):
            loss = model(**batch)["loss"]
            acc.backward(loss)
            opt.step()
            sched.step()
            opt.zero_grad()
            if acc.sync_gradients:
                synced.append(i)
                snapshots.append((read_params(), sched.get_last_lr()[0]))
    return snapshots, synced


def _jax_side(jcfg, params, data, prefetch):
    acc = JaxAccelerator(
        gradient_accumulation_steps=2,
        dataloader_config=JaxDataLoaderConfiguration(
            split_batches=True, use_seedable_sampler=True, prefetch_to_device=prefetch))

    def apply_fn(p, input_ids):
        return {"loss": jl.loss_fn(p, {"input_ids": input_ids}, jcfg)}

    shadow = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=LR, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=WD)
    model, opt, dl, sched = acc.prepare(JaxModel(apply_fn, jax.tree.map(jnp.asarray, params)),
                                        shadow, DataLoader(data, batch_size=BATCH, shuffle=True),
                                        _schedule(shadow))
    out = _loop(acc, model, opt, dl, sched,
                lambda: llama_params_from_jax(jax.tree.map(np.asarray, model.params),
                                              tl.LlamaConfig.tiny(num_layers=1), device="cpu"))
    return out, opt._step_count


def _port_side(tcfg, params, data, prefetch):
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2,
                      dataloader_config=DataLoaderConfiguration(use_seedable_sampler=True,
                                                                prefetch_to_device=prefetch))
    model = tl.LlamaForCausalLM(tcfg, params=llama_params_from_jax(params, tcfg, device="cpu"),
                                device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WD)
    model, opt, dl, sched = acc.prepare(model, opt,
                                        DataLoader(data, batch_size=BATCH, shuffle=True),
                                        _schedule(opt))
    out = _loop(acc, model, opt, dl, sched,
                lambda: {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                             if isinstance(v, dict) else v.detach().clone())
                         for k, v in model.params.items()})
    return out, opt._step_count


@pytest.mark.parametrize("prefetch", [0, 2], ids=["lookahead", "prefetch2"])
def test_readme_loop_matches_jax(prefetch):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=1)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=1)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    data = _data(jcfg.vocab_size)
    (want, want_synced), want_steps = _jax_side(jcfg, params, data, prefetch)
    (got, got_synced), got_steps = _port_side(tcfg, params, data, prefetch)
    assert got_synced == want_synced == [2, 4, 6, 7]
    assert got_steps == want_steps == 4
    for (gp, glr), (wp, wlr) in zip(got, want):
        assert glr == wlr
        for k, v in gp.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    torch.testing.assert_close(vv, wp[k][kk], rtol=0, atol=2e-5)
            else:
                torch.testing.assert_close(v, wp[k], rtol=0, atol=2e-5)
    # The parameters moved: a loop that never updated would match too.
    start = llama_params_from_jax(params, tcfg, device="cpu")
    assert (got[-1][0]["embed"] - start["embed"]).abs().max() > 1e-3


def test_prepare_returns_a_device_loader_and_a_scheduler():
    from accelerate_tpu_torch.data_loader import DataLoaderShard
    from accelerate_tpu_torch.scheduler import AcceleratedScheduler

    acc = Accelerator(cpu=True)
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    out = acc.prepare(model, opt, DataLoader([torch.ones(2)] * 4, batch_size=2),
                      torch.optim.lr_scheduler.StepLR(opt, 1))
    assert isinstance(out[2], DataLoaderShard) and isinstance(out[3], AcceleratedScheduler)
    assert all(b.device == acc.device for b in out[2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Accelerator()
