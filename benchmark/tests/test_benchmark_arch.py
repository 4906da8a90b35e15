"""What the harness knows of a network sits in one file, ``arch/<name>.py``,
found by the name its configuration gives: the ``mast3r`` architecture
gives what the harness gave before it (weights, operation count, the
check's numbers), and a second architecture runs a cell with no edit to
the harness."""

import hashlib
import importlib
import json
import re
import textwrap
import time
import types

import pytest
import torch

from benchmark import flops, harness
from benchmark.tests._tiny import TINY_LIMITS, tiny_cell

NAMES = {"net_config", "make_state_dict", "build_program", "reference",
         "model_step", "ATTENTION_MODULES", "tiny"}
STILL = "vitl512-int8.solo-still"

# read from the harness before the architectures were split out of it
# (weights.make_state_dict of harness.net_config, flops.model_step of the
# configuration, harness.run_cell): the tiny int8 configuration's state
# dict, the two full-size configurations' operations a frame, and the
# tiny int8 still cell's compared numbers at seed 2**31 + 177
PINNED_SD_SHA256 = \
    "ec8f4b898209cb18e877181e3b907379ba684037da4b47935f629bebd2b9a7c0"
PINNED_MODEL_STEP = {
    "mast3r-vitl512-bf16": {"bf16": 1514126966784.0, "int8": 0.0},
    "mast3r-vitl512-int8": {"bf16": 1050270498816.0,
                            "int8": 463856467968.0}}
PINNED_CHECKS = {"net_gap": 0.0039929612539708614, "kf_decisions": 0,
                 "start_pose_miss": 0.22260924656976622}


def _config(name):
    return json.loads((harness.BENCH / "configs" / f"{name}.json")
                      .read_text())


def _sha256(sd: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(str(v.dtype).encode())
        h.update(v.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def test_the_mast3r_file_defines_the_seven_names():
    mod = harness.load_arch({"architecture": "mast3r"})
    public = {k for k, v in vars(mod).items()
              if not k.startswith("_") and k != "annotations"
              and not isinstance(v, types.ModuleType)}
    assert public == NAMES


def test_the_weights_are_the_same_bit_for_bit():
    cfg = tiny_cell(STILL).config
    sd = harness.load_arch(cfg).make_state_dict(cfg, "cpu")
    assert _sha256(sd) == PINNED_SD_SHA256


@pytest.mark.parametrize("name", sorted(PINNED_MODEL_STEP))
def test_the_operation_count_is_the_same(name):
    cfg = _config(name)
    assert harness.load_arch(cfg).model_step(cfg) == PINNED_MODEL_STEP[name]


def test_the_compared_numbers_are_the_same():
    torch.set_num_threads(2)
    cell = tiny_cell(STILL, TINY_LIMITS[STILL])
    out = harness.run_cell(cell, 2 ** 31 + 177, 3.0, False, "cpu",
                           time.perf_counter(), log=lambda m: None)
    assert {k: c["value"] for k, c in out["checks"].items()} == \
        PINNED_CHECKS


TWIN = '''
"""MASt3R under another name, each use recorded in {log!r}."""
import importlib
import importlib.util
import json

from benchmark import harness

_spec = importlib.util.spec_from_file_location(
    "twin_base", harness.BENCH / "arch" / "mast3r.py")
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)


def _record(name, **kw):
    with open({log!r}, "a") as f:
        f.write(json.dumps(dict(name=name, **kw)) + "\\n")


def net_config(config):
    _record("net_config")
    return _base.net_config(config)


def make_state_dict(config, device):
    _record("make_state_dict")
    return _base.make_state_dict(config, device)


def build_program(config, sd, device):
    _record("build_program")
    return _base.build_program(config, sd, device)


def reference(config, sd, prec, device):
    _record("reference", prec=list(prec))
    return _base.reference(config, sd, prec, device)


def model_step(config):
    # called once the window has closed, while kernel A is still counted
    _record("model_step", attention=[
        importlib.import_module(m).flash_attention.__name__
        for m in _base.ATTENTION_MODULES])
    return {{k: 2.0 * v + 1.0 for k, v in _base.model_step(config).items()}}


def tiny(config):
    _record("tiny")
    return _base.tiny(config)


def __getattr__(name):
    if name == "ATTENTION_MODULES":
        _record(name)
        return _base.ATTENTION_MODULES
    raise AttributeError(name)
'''


def test_a_second_architecture_runs_a_cell_with_no_edit(tmp_path,
                                                        monkeypatch):
    """A tiny traced cell whose configuration names ``twin``, a file in
    another ``arch`` directory: the harness uses all seven names, divides
    ``frame_mfu`` by the twin's operation count, and counts kernel A where
    the twin's ``ATTENTION_MODULES`` say."""
    torch.set_num_threads(2)
    log = tmp_path / "calls.jsonl"
    arch = tmp_path / "arch"
    arch.mkdir()
    (arch / "twin.py").write_text(textwrap.dedent(TWIN.format(log=str(log))))
    monkeypatch.setattr(harness, "ARCH", arch)
    runs = []
    run_data = harness.RunData

    def captured(*a, **kw):
        runs.append(run_data(*a, **kw))
        return runs[-1]
    monkeypatch.setattr(harness, "RunData", captured)
    cell = tiny_cell(STILL, TINY_LIMITS[STILL], architecture="twin")
    mast3r_mod = importlib.import_module("mast3r_slam_torch.models.mast3r")
    attention = mast3r_mod.flash_attention
    out = harness.run_cell(cell, 2 ** 31 + 93, 3.0, True, "cpu",
                           time.perf_counter(), log=lambda m: None)
    assert mast3r_mod.flash_attention is attention
    assert out["correct"], out["checks"]
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert {c["name"] for c in calls} == NAMES
    (run,) = runs
    want = {k: 2.0 * v + 1.0 for k, v in flops.model_step(
        cell.config["network"], cell.config["img_hw"],
        bool(cell.config["int8_encoder"])).items()}
    assert run.step_flops == want
    assert out["metrics"]["frame_mfu"]["value"] == pytest.approx(
        100.0 * flops.step_seconds_at_peak(want) * len(run.frames)
        / run.seconds)
    (step,) = [c for c in calls if c["name"] == "model_step"]
    assert step["attention"] == ["counted"]
    assert run.attn and all(len(shape) == 5 for _, shape in run.attn)


@pytest.mark.parametrize("architecture", [None, "no_such_network"])
def test_a_configuration_without_its_architecture_fails_before_weights(
        monkeypatch, architecture):
    from benchmark import weights

    cell = tiny_cell(STILL, TINY_LIMITS[STILL])
    if architecture is None:
        del cell.config["architecture"]
    else:
        cell.config["architecture"] = architecture
    made = []
    monkeypatch.setattr(weights, "make_state_dict",
                        lambda *a: made.append(a))
    with pytest.raises(SystemExit, match=re.escape(cell.config_file)):
        harness.run_cell(cell, 1, 1.0, False, "cpu", time.perf_counter(),
                         log=lambda m: None)
    assert not made


@pytest.mark.parametrize("name", ["harness.py", "correct.py", "drive.py",
                                  "run.py", "clips.py", "trace.py",
                                  "flops.py"]
                         + sorted(str(p.relative_to(harness.BENCH)) for d in
                                  ("metrics", "tools") for p in
                                  (harness.BENCH / d).glob("*.py")))
def test_only_the_architectures_know_the_network(name):
    text = (harness.BENCH / name).read_text()
    for word in ("models.mast3r", "mast3r_slam_torch.models", "NetConfig",
                 "network.build", "Network("):
        assert word not in text, (name, word)
