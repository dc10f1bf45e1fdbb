"""The port's serving engine over GPT-2 against the JAX package's engine.

The twin of ``tests/test_serving.py``'s randomized arrival/length mix on
gpt2-tiny (fp32, the JAX weights carried across): the same six requests,
submitted two per tick, through the JAX ``ServingEngine`` and the port's,
with ``paged_kernel`` both ways (on CPU tensors the port's kernel path runs
the paged kernels' plain versions, the JAX one the Pallas kernels in
interpret mode) and ``spec_tokens`` 0 and 3.  Every request's tokens equal
the JAX engine's and the port's greedy ``generate``'s (held to JAX's in
``test_torch_gpt2.py``).  Exact: no tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import gpt2 as jg
from accelerate_tpu.serving import ServingConfig as JaxServingConfig
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch import Accelerator, AcceleratorState
from accelerate_tpu_torch.models import gpt2 as tg
from accelerate_tpu_torch.utils.convert import gpt2_params_from_jax

GEOMETRY = dict(block_size=4, num_blocks=40, max_slots=3, prefill_chunk=8, max_blocks_per_seq=8)


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


@pytest.fixture(scope="module")
def mix():
    """gpt2-tiny weights in both packages, the six requests of the JAX
    test's mix, their arrival order and the port's greedy ``generate`` for
    each."""
    jcfg = jg.GPT2Config.tiny(dtype=jnp.float32)
    tcfg = tg.GPT2Config.tiny(dtype=torch.float32)
    jparams = jg.init_params(jcfg, jax.random.key(0))
    tparams = gpt2_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(42)
    lengths = [int(rng.integers(3, 20)) for _ in range(6)]
    max_new = [int(rng.integers(1, 10)) for _ in range(6)]
    prompts = [list(rng.integers(0, jcfg.vocab_size, size=n)) for n in lengths]
    want = [tg.generate(tparams, torch.tensor([p]), tcfg, max_new_tokens=m)[0].tolist()
            for p, m in zip(prompts, max_new)]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, prompts=prompts,
                max_new=max_new, arrivals=rng.permutation(6), want=want)


def _serve(engine, mix):
    """Submit in the mix's arrival order, ticking after every second
    request; returns each request's tokens in prompt order."""
    ids = {}
    for k, i in enumerate(mix["arrivals"]):
        ids[engine.submit(mix["prompts"][i], mix["max_new"][i])] = i
        if k % 2 == 1:
            engine.step()
    outputs = engine.run(max_ticks=1000)
    assert len(outputs) == 6
    got = [None] * 6
    for rid, out in outputs.items():
        got[ids[rid]] = [int(t) for t in out]
    return got


@pytest.mark.parametrize("spec_tokens", [0, 3])
@pytest.mark.parametrize("paged_kernel", [False, True], ids=["plain", "kernel"])
def test_randomized_mix_matches_the_jax_engine(mix, paged_kernel, spec_tokens):
    jeng = JaxServingEngine(jg.apply_cached, jg.init_cache, mix["jparams"], mix["jcfg"],
                            serving=JaxServingConfig(paged_kernel=paged_kernel,
                                                     spec_tokens=spec_tokens, **GEOMETRY))
    want = _serve(jeng, mix)
    assert want == mix["want"]
    teng = Accelerator(cpu=True).prepare_serving(
        tg.apply_cached, tg.init_cache, mix["tparams"], mix["tcfg"],
        paged_kernel=paged_kernel, spec_tokens=spec_tokens, **GEOMETRY)
    got = _serve(teng, mix)
    assert got == want
    assert teng.decode_dispatches <= teng.ticks
    assert teng.cache.allocator.used_blocks == 0
    if spec_tokens:
        assert teng.stats()["spec"]["rounds"] == teng.stats()["decode_dispatches"]


def test_serving_refuses_a_table_past_the_position_table(mix):
    """``max_blocks_per_seq * block_size`` beyond GPT-2's 128 positions is
    refused when the engine is built, in both packages."""
    too_long = dict(GEOMETRY, max_blocks_per_seq=40)  # 160 positions
    with pytest.raises(ValueError, match="max_seq_len"):
        JaxServingEngine(jg.apply_cached, jg.init_cache, mix["jparams"], mix["jcfg"],
                         serving=JaxServingConfig(**too_long))
    with pytest.raises(ValueError, match="max_seq_len"):
        Accelerator(cpu=True).prepare_serving(tg.apply_cached, tg.init_cache, mix["tparams"],
                                              mix["tcfg"], **too_long)
