"""The port's serving chaos (``serving/chaos.py``) and its two serving fault
arms against the JAX package's.

- ``plan_serving_campaign`` / ``plan_tiering_campaign`` equal JAX's for
  several seeds, exactly.
- ``ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST``: on gpt2-tiny with the JAX
  weights carried across, the armed request is quarantined in both
  packages, every other request's tokens equal the unarmed run's and the
  JAX engine's, and the paged (kernel and plain) and dense decode paths all
  take the poison.
- ``ACCELERATE_TPU_FAULT_SERVING_HOST_FULL``: under the tiering campaign's
  tight pool, fallbacks > 0 and promotions == 0 in both packages, with the
  same tokens as the unarmed run and the JAX engine.
- The serving campaign end to end at its CPU size (child processes, a
  SIGTERM drain, a SIGKILL and two journal recoveries: ~15 s).
No tolerance: tokens and counts are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import gpt2 as jg
from accelerate_tpu.resilience import faultinject as jfi
from accelerate_tpu.serving import ServingConfig as JServingConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.serving import chaos as jchaos
from accelerate_tpu_torch import AcceleratorState
from accelerate_tpu_torch.models import gpt2 as tg
from accelerate_tpu_torch.resilience import faultinject as tfi
from accelerate_tpu_torch.serving import ServingConfig, ServingEngine
from accelerate_tpu_torch.serving import chaos as tchaos
from accelerate_tpu_torch.utils.convert import gpt2_params_from_jax

NAN = "ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST"
HOST_FULL = "ACCELERATE_TPU_FAULT_SERVING_HOST_FULL"
CHAOS_GEOMETRY = dict(block_size=4, num_blocks=40, max_slots=2, prefill_chunk=8,
                      max_blocks_per_seq=8, host_blocks=16)
TIER_GEOMETRY = dict(block_size=4, num_blocks=9, max_slots=3, prefill_chunk=4,
                     max_blocks_per_seq=6, host_blocks=16)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(NAN, raising=False)
    monkeypatch.delenv(HOST_FULL, raising=False)
    jfi.reload()
    tfi.reload()
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    jfi.reload()
    tfi.reload()


@pytest.fixture(scope="module")
def weights():
    jcfg = jg.GPT2Config.tiny(dtype=jnp.float32)
    tcfg = tg.GPT2Config.tiny(dtype=torch.float32)
    jparams = jg.init_params(jcfg, jax.random.key(0))
    tparams = gpt2_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("seed", [0, 1, 7, 20260804, 123456789])
def test_campaign_plans_equal_jax(seed):
    assert tchaos.plan_serving_campaign(seed) == jchaos.plan_serving_campaign(seed)
    assert tchaos.plan_tiering_campaign(seed) == jchaos.plan_tiering_campaign(seed)
    assert tchaos.QUEUE_DEPTH == jchaos.QUEUE_DEPTH and tchaos.MAX_TICKS == jchaos.MAX_TICKS


def _serve(engine, requests):
    for rec in requests:
        engine.submit(rec["prompt"], rec["max_new"], tag=rec["tag"])
    engine.run(max_ticks=2000)
    done = {c.tag: (c.status, [int(t) for t in c.tokens]) for c in engine.pop_finished()}
    stats = engine.stats()
    return done, engine.quarantined_count, stats["tiering"]


_JAX_RUNS = {}


def _run_pair(weights, monkeypatch, env, geometry, requests, **port_kw):
    """The JAX engine's and the port's outcome on ``requests`` under
    ``env``; the JAX one is computed once per (env, traffic) in this module
    (its engine compiles per shape on the CPU, the cost of these tests)."""
    jcfg, tcfg, jparams, tparams = weights
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jfi.reload()
    tfi.reload()
    key = (tuple(sorted(env.items())), tuple(sorted(geometry.items())),
           tuple(r["tag"] for r in requests), tuple(tuple(r["prompt"]) for r in requests))
    if key not in _JAX_RUNS:
        jeng = JServingEngine(jg.apply_cached, jg.init_cache, jparams, jcfg,
                              serving=JServingConfig(**geometry))
        _JAX_RUNS[key] = _serve(jeng, requests)
    teng = ServingEngine(tg.apply_cached, tg.init_cache, tparams, tcfg,
                         serving=ServingConfig(**geometry, **port_kw), device="cpu")
    return _JAX_RUNS[key], _serve(teng, requests)


def _port_run(weights, monkeypatch, env, geometry, requests, **port_kw):
    _, tcfg, _, tparams = weights
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    tfi.reload()
    teng = ServingEngine(tg.apply_cached, tg.init_cache, tparams, tcfg,
                         serving=ServingConfig(**geometry, **port_kw), device="cpu")
    return _serve(teng, requests)


def _requests(seed):
    plan = tchaos.plan_serving_campaign(seed)
    return plan["burst"][:3] + [plan["poison"]] + plan["late"]


@pytest.mark.parametrize("path", [dict(paged_kernel=True), dict(paged_kernel=False),
                                  dict(decode_path="dense")], ids=["kernel", "plain", "dense"])
@pytest.mark.parametrize("ordinal", [1, 4])
def test_nan_request_quarantines_only_that_request(weights, monkeypatch, path, ordinal):
    requests = _requests(20260804)
    (jdone, jq, _), (tdone, tq, _) = _run_pair(weights, monkeypatch, {NAN: str(ordinal)},
                                               CHAOS_GEOMETRY, requests, **path)
    clean, cq, _ = _port_run(weights, monkeypatch, {NAN: ""}, CHAOS_GEOMETRY, requests, **path)
    poisoned = requests[ordinal - 1]["tag"]
    assert tq == jq == 1 and cq == 0
    assert tdone[poisoned][0] == jdone[poisoned][0] == "quarantined"
    for tag, (status, tokens) in tdone.items():
        if tag != poisoned:
            assert status == "ok" and tokens == clean[tag][1] == jdone[tag][1], tag
    # Up to its quarantine the poisoned request emitted what the clean run did.
    assert tdone[poisoned][1] == clean[poisoned][1][:len(tdone[poisoned][1])]


def test_nan_request_unarmed_engine_carries_nothing(weights):
    _, tcfg, _, tparams = weights
    eng = ServingEngine(tg.apply_cached, tg.init_cache, tparams, tcfg,
                        serving=ServingConfig(**CHAOS_GEOMETRY), device="cpu")
    assert eng._poison_ordinal is None


@pytest.mark.parametrize("seed", [20260804])
def test_host_full_forces_fallbacks_with_the_same_tokens(weights, monkeypatch, seed):
    requests = tchaos.plan_tiering_campaign(seed)["requests"]
    (jdone, _, jst), (tdone, _, tst) = _run_pair(weights, monkeypatch, {HOST_FULL: "1"},
                                                 TIER_GEOMETRY, requests, paged_kernel=True)
    clean, _, cst = _port_run(weights, monkeypatch, {HOST_FULL: ""}, TIER_GEOMETRY, requests,
                              paged_kernel=True)
    assert tst["fallback_reprefills"] > 0 and tst["promotions"] == 0
    assert jst["fallback_reprefills"] == tst["fallback_reprefills"]
    assert jst["promotions"] == 0
    assert cst["promotions"] > 0  # unarmed, the same traffic migrates
    assert tdone == jdone == clean
    assert all(status == "ok" for status, _ in tdone.values())


def test_serving_campaign_end_to_end(tmp_path):
    summary = tchaos.run_serving_campaign(20260804, str(tmp_path), size="tiny", device="cpu")
    assert (summary["shed"], summary["quarantined"], summary["deadline_expired"],
            summary["survivors"], summary["recoveries"]) == (2, 1, 3, 6, 2)
    first = summary["lives"][0]
    assert first["counters"] == {"shed": 2, "deadline_expired": 3, "quarantined": 1}
    assert [life["role"] for life in summary["lives"]] == ["first", "victim", "finisher"]
