"""Import hygiene of the port: ``accelerate_tpu_torch`` and ``chip_smoke.py``
load neither ``jax`` nor anything of ``accelerate_tpu``, nor the
``safetensors`` package (the GPU machine has none; the port reads and
writes the format itself), at run time or in their source."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "accelerate_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "accelerate_tpu", "safetensors")


def _module_names():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    script = (
        "import importlib, json, sys\n"
        f"for name in {_module_names() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.level == 0 and node.module and _forbidden(node.module) else []
        else:
            continue
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("name", [
    "accelerate_tpu_torch.resilience.preemption",
    "accelerate_tpu_torch.serving.journal",
    "accelerate_tpu_torch.serving.blocks",
    "accelerate_tpu_torch.serving.engine",
    "accelerate_tpu_torch.models.generation",
    "accelerate_tpu_torch.serving.tracing",
    "accelerate_tpu_torch.serving.drafter",
    "accelerate_tpu_torch.models.llama",
    "accelerate_tpu_torch.utils.random",
    "accelerate_tpu_torch.state",
    "accelerate_tpu_torch.utils.other",
    "accelerate_tpu_torch.utils.modeling",
    "accelerate_tpu_torch.models.hf_import",
    "accelerate_tpu_torch.models.hf_export",
    "accelerate_tpu_torch.models.gpt2",
    "accelerate_tpu_torch.tracking",
    "accelerate_tpu_torch.logging",
    "accelerate_tpu_torch.local_sgd",
    "accelerate_tpu_torch.memory_utils",
    "accelerate_tpu_torch.utils.memory",
    "accelerate_tpu_torch.utils.environment",
    "accelerate_tpu_torch.utils.imports",
    "accelerate_tpu_torch.utils.versions",
    "accelerate_tpu_torch.utils.constants",
    "accelerate_tpu_torch.utils.convert",
    "accelerate_tpu_torch.ops.moe",
    "accelerate_tpu_torch.models.mixtral",
    "accelerate_tpu_torch.models.bert",
    "accelerate_tpu_torch.models.vit",
    "accelerate_tpu_torch.models.resnet",
    "accelerate_tpu_torch.models.t5",
    "accelerate_tpu_torch.telemetry",
    "accelerate_tpu_torch.telemetry.core",
    "accelerate_tpu_torch.telemetry.names",
    "accelerate_tpu_torch.telemetry.metrics",
    "accelerate_tpu_torch.telemetry.sentinel",
    "accelerate_tpu_torch.telemetry.watchdog",
    "accelerate_tpu_torch.telemetry.memledger",
    "accelerate_tpu_torch.telemetry.flightrec",
    "accelerate_tpu_torch.telemetry.spans",
    "accelerate_tpu_torch.telemetry.goodput",
    "accelerate_tpu_torch.telemetry.export",
    "accelerate_tpu_torch.telemetry.timeline",
    "accelerate_tpu_torch.telemetry.profile_scan",
    "accelerate_tpu_torch.telemetry.report",
    "accelerate_tpu_torch.parallel",
    "accelerate_tpu_torch.parallel.collectives",
    "accelerate_tpu_torch.parallel.mesh",
    "accelerate_tpu_torch.parallel.sharding",
    "accelerate_tpu_torch.parallel.zero",
    "accelerate_tpu_torch.parallel.host_offload",
    "accelerate_tpu_torch.parallel.zero_smoke",
])
def test_robustness_modules_are_checked(name):
    """The serving robustness layer's modules and the generation and tracing
    slice's are among those the two checks above import and parse, and
    they export the JAX package's names."""
    import importlib

    assert name in _module_names()
    mod = importlib.import_module(name)
    assert set(getattr(mod, "__all__", ())) <= set(dir(mod))


def test_robustness_exports_match_jax_names():
    import accelerate_tpu_torch.resilience as res
    import accelerate_tpu_torch.serving as srv

    for n in ("HostBlockPool", "JournalError", "ServingJournal", "AdmissionRejected"):
        assert n in srv.__all__ and hasattr(srv, n)
    assert res.__all__ == ["CheckpointVerificationError", "ENV_MANIFEST_HASH", "HealthGuard",
                           "HealthVerdict", "MANIFEST_NAME", "NumericalDivergenceError",
                           "PreemptionGuard", "RetryPolicy", "find_latest_complete",
                           "is_complete", "list_checkpoints", "prune_checkpoints",
                           "read_manifest", "retrying", "verify_checkpoint", "write_manifest"]


def test_generation_and_tracing_exports_match_jax_names():
    """The names this slice ports exist under the JAX package's names."""
    import accelerate_tpu_torch.serving as srv
    from accelerate_tpu_torch.models import generation, llama
    from accelerate_tpu_torch.serving import tracing

    for n in ("DraftModelDrafter", "RequestTrace", "ServingTracer", "export_chrome_trace",
              "load_serving_traces", "stitch_traces", "summarize_traces"):
        assert n in srv.__all__ and hasattr(srv, n)
    for n in ("select_token", "generate_loop", "speculative_generate_loop", "beam_search"):
        assert n in generation.__all__
    for n in ("generate", "speculative_generate", "generate_beam"):
        assert n in llama.__all__
    for n in ("PHASES", "BADPUT_PHASES", "PhaseInterval", "decompose_blame", "tracing_enabled",
              "resolve_trace_dir", "format_trace_block", "ENV_ENABLE", "ENV_DIR",
              "ENV_CAPACITY", "ENV_FLUSH_EVERY"):
        assert hasattr(tracing, n)
