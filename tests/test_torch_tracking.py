"""The port's experiment trackers (``accelerate_tpu_torch/tracking.py`` and
the ``Accelerator``'s ``log_with`` / ``init_trackers`` / ``log`` /
``get_tracker`` / ``end_training``) against the JAX package's.

The same calls go through both packages; the JSONL lines, the stored
config and what ``filter_trackers`` keeps are equal, but for the wall-clock
``_time`` of each line.  Exact: no tolerance."""

import json

import pytest
import torch

import accelerate_tpu
from accelerate_tpu import tracking as jtracking
from accelerate_tpu_torch import Accelerator, AcceleratorState
from accelerate_tpu_torch import tracking as ttracking


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


def _dummy(base):
    class Dummy(base):
        """An in-memory tracker, as a user would subclass it."""

        name = "dummy"
        requires_logging_directory = False

        def __init__(self):
            self.config, self.records, self.finished = None, [], False

        @property
        def tracker(self):
            return self.records

        def store_init_configuration(self, values):
            self.config = dict(values)

        def log(self, values, step=None, **kwargs):
            self.records.append((step, dict(values)))

        def finish(self):
            self.finished = True

    return Dummy()


def _lines(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert all(isinstance(r.pop("_time"), float) for r in rows)
    return rows


def test_registry_and_availability_match_jax():
    assert list(ttracking.LOGGER_TYPE_TO_CLASS) == list(jtracking.LOGGER_TYPE_TO_CLASS)
    for name, cls in ttracking.LOGGER_TYPE_TO_CLASS.items():
        jcls = jtracking.LOGGER_TYPE_TO_CLASS[name]
        assert cls.name == jcls.name == name
        assert cls.requires_logging_directory == jcls.requires_logging_directory
    assert ttracking.__all__ == jtracking.__all__


@pytest.mark.parametrize("log_with", [
    ["generic"], ["generic", "generic"], ["all"], ["all", "tensorboard", "generic"],
    ["mlflow", "clearml", "generic"], ["WandB", "generic"], ["Generic"], [], None,
], ids=lambda v: "+".join(v) if v else str(v))
def test_filter_trackers_matches_jax(log_with):
    assert ttracking.filter_trackers(log_with) == jtracking.filter_trackers(log_with)


def test_filter_trackers_unknown_names_and_instances_match_jax():
    for mod in (ttracking, jtracking):
        with pytest.raises(ValueError, match="Unknown tracker not_a_tracker"):
            mod.filter_trackers(["generic", "not_a_tracker"])
    t = _dummy(ttracking.GeneralTracker)
    assert ttracking.filter_trackers([t, "generic", t]) == [t, "generic"]


def test_generic_tracker_lines_match_jax(tmp_path):
    rows = [({"loss": 1.5}, 0), ({"loss": torch.tensor(0.25), "note": "mid"}, 1),
            ({"acc": 0.75, "epoch": 2}, None)]
    paths = {}
    for name, mod in (("port", ttracking), ("jax", jtracking)):
        t = mod.GenericTracker("run", logging_dir=str(tmp_path / name))
        t.store_init_configuration({"lr": 0.1, "layers": 2, "dtype": torch.float32})
        for values, step in rows:
            t.log(values, step=step)
        t.finish()
        assert t.tracker == t.path == str(tmp_path / name / "run" / "metrics.jsonl")
        paths[name] = t.path
    assert _lines(paths["port"]) == _lines(paths["jax"])
    configs = [json.loads((tmp_path / n / "run" / "config.json").read_text())
               for n in ("port", "jax")]
    assert configs[0] == configs[1] == {"lr": 0.1, "layers": 2, "dtype": "torch.float32"}


def test_tracker_used_before_any_state_logs():
    """A tracker on its own, before any ``Accelerator``: the process is the
    main one, so its ``on_main_process`` methods run."""
    assert AcceleratorState._shared_state == {}
    t = _dummy(ttracking.GeneralTracker)
    ttracking.on_main_process(type(t).log)(t, {"x": 1}, step=3)
    assert t.records == [(3, {"x": 1})]


def test_accelerator_trackers_match_jax(tmp_path):
    """``log_with=[instance, "generic"]``: ``init_trackers`` stores the
    config in each, ``log`` reaches each, ``get_tracker`` finds each by name
    (unwrapped: the SDK object, the JSONL path), ``end_training`` finishes
    each; the JSONL lines equal the JAX ``Accelerator``'s."""
    got = {}
    for name, make, base in (("port", lambda **kw: Accelerator(cpu=True, **kw),
                              ttracking.GeneralTracker),
                             ("jax", accelerate_tpu.Accelerator, jtracking.GeneralTracker)):
        dummy = _dummy(base)
        acc = make(log_with=[dummy, "generic"], project_dir=str(tmp_path / name))
        assert acc.log_with == [dummy, "generic"] and acc.trackers == []
        acc.init_trackers("proj", config={"seed": 42})
        acc.log({"loss": 2.0}, step=3)
        acc.log({"loss": 1.0, "tag": "b"}, step=4)
        assert acc.get_tracker("dummy") is dummy and acc.get_tracker("dummy", unwrap=True) == \
            dummy.records
        path = acc.get_tracker("generic", unwrap=True)
        assert path == str(tmp_path / name / "proj" / "metrics.jsonl")
        with pytest.raises(ValueError, match="Tracker wandb not found"):
            acc.get_tracker("wandb")
        acc.end_training()
        assert dummy.finished and dummy.config == {"seed": 42}
        got[name] = (dummy.records, _lines(path))
    assert got["port"] == got["jax"]
    assert got["port"][1] == [{"_step": 3, "loss": 2.0}, {"_step": 4, "loss": 1.0, "tag": "b"}]


def test_log_with_a_name_string_and_unknown_names(tmp_path):
    acc = Accelerator(cpu=True, log_with="generic", project_dir=str(tmp_path))
    assert acc.log_with == ["generic"]
    acc.init_trackers("run")
    assert [type(t) for t in acc.trackers] == [ttracking.GenericTracker]
    acc.log({"x": 1}, step=0)
    acc.end_training()
    bad = Accelerator(cpu=True, log_with="jsonl")
    with pytest.raises(ValueError, match="Unknown tracker jsonl"):
        bad.init_trackers("run")


def test_telemetry_rows_are_empty_until_telemetry_is_ported():
    assert ttracking.telemetry_rows() == {} == jtracking.telemetry_rows()
