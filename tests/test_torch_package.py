"""Package rules of the PyTorch port: it stands alone beside the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mast3r_slam_tpu")
PORT_FILES = sorted((ROOT / "mast3r_slam_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
    from mast3r_slam_torch.utils.config import frontend_config

    model, hw = _tiny_engine_parts()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, hw)
    engine = InferenceEngine(model, hw, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSystem(frontend_config("config/base.yaml"), engine, hw)


def test_system_refuses_an_engine_on_another_device():
    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.utils.config import frontend_config

    model, hw = _tiny_engine_parts()
    engine = InferenceEngine(model, hw, device="cpu")
    with pytest.raises(ValueError, match="engine runs on"):
        SLAMSystem(frontend_config("config/base.yaml"), engine, hw,
                   device="meta")


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A wrapper takes its plain version only on a CPU tensor; any other
    device is refused, never silently computed."""
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.ops.attention import flash_attention

    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        gn.gn_sums(torch.zeros(9, 4, device="meta"),
                   torch.zeros(13, device="meta"), 1.345)
