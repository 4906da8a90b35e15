"""Package rules of the PyTorch port: it stands alone beside the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# the JAX package and its scripts, and the card's smoke script, which no
# program imports
FORBIDDEN = ("jax", "jaxlib", "flax", "mast3r_slam_tpu", "scripts",
             "chip_smoke")
PORT_FILES = sorted((ROOT / "mast3r_slam_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "main_torch.py",
    ROOT / "main_quantized_torch.py", ROOT / "bench_torch.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _tiny_engine_parts():
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig

    return MASt3R(MASt3RConfig.tiny()), (32, 48)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.testing import OracleEngine, SyntheticSequence
    from mast3r_slam_torch.utils.config import load_config

    model, hw = _tiny_engine_parts()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, hw)
    engine = InferenceEngine(model, hw, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSystem(load_config("config/base.yaml"), engine, hw)
    with pytest.raises(RuntimeError, match="CUDA"):
        OracleEngine(SyntheticSequence(n_frames=1, h=8, w=8))


def test_system_refuses_an_engine_on_another_device():
    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.utils.config import load_config

    model, hw = _tiny_engine_parts()
    engine = InferenceEngine(model, hw, device="cpu")
    with pytest.raises(ValueError, match="engine runs on"):
        SLAMSystem(load_config("config/base.yaml"), engine, hw,
                   device="meta")


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A wrapper takes its plain version only on a CPU tensor; any other
    device is refused, never silently computed."""
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.pack import pack_rows

    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        gn.gn_sums(torch.zeros(9, 4, device="meta"),
                   torch.zeros(13, device="meta"), 1.345)
    with pytest.raises(ValueError, match="unsupported device"):
        pack_rows(torch.zeros(1, 8, 2, device="meta"), (0, 1))


def test_engine_takes_img_downsample():
    """``downsample=2`` (``dataset.img_downsample``) is taken: the engine's
    ``out_hw`` halves the image, and a decode's outputs have that shape
    (``tests/test_torch_downsample.py`` holds them against JAX's)."""
    from mast3r_slam_torch.inference import InferenceEngine

    model, hw = _tiny_engine_parts()
    engine = InferenceEngine(model, hw, downsample=2, device="cpu")
    assert engine.out_hw == (16, 24)
    feat, pos = engine.encode(torch.zeros(1, *hw, 3))
    for view in engine.decode_pair(feat, pos, feat, pos):
        assert [tuple(A.shape[1:3]) for A in view] == [(16, 24)] * 4


@pytest.mark.parametrize("path", ["config/base.yaml",
                                  "config/eval_calib.yaml",
                                  "config/eval_no_calib.yaml"])
@pytest.mark.parametrize("reference_exact", [False, True])
def test_every_shipped_config_loads_into_the_port(path, reference_exact):
    """The matching and tracking blocks of every shipped config, as written
    and with ``reference_exact: true``, are taken by the port and equal
    what the JAX package reads from them."""
    from mast3r_slam_tpu.ops.matching import MatchingConfig as JaxMatching
    from mast3r_slam_tpu.utils.config import load_config as jax_load
    from mast3r_slam_torch.ops.matching import MatchingConfig
    from mast3r_slam_torch.tracker import TrackerConfig
    from mast3r_slam_torch.utils.config import (apply_reference_exact,
                                                load_config)

    cfg = load_config(path)
    if reference_exact:
        cfg = apply_reference_exact(cfg)
    jcfg = jax_load(path, set_global=False)
    assert load_config(path) == jcfg
    m = MatchingConfig.from_dict(cfg["matching"])
    assert m._asdict() == JaxMatching.from_dict(cfg["matching"])._asdict()
    assert m.coarse_subsample == (1 if reference_exact else 2)
    assert TrackerConfig.from_config(cfg).joint_ray_huber != reference_exact
