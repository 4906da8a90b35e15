"""The port's per-block network breakdown (``utils/breakdown.py``,
``main_torch.py --profile-blocks``) against the JAX package's.

Timings differ by nature, so what is held to JAX is what does not: the
report ``print_network_summary`` prints for the same dict (the same text),
and the per-frame totals ``network_breakdown`` synthesises from one
sub-block call's time (``enc_depth`` encoder blocks, ``2 x dec_depth``
decoder blocks): with each package's per-call timer replaced by the same
constant, the two dicts are equal.  The port's own timer runs on the tiny
model on the CPU (host clock) and must give the six sections, each >= 0.
"""

import pytest
import torch

from mast3r_slam_tpu.models.convert import convert_state_dict
from mast3r_slam_tpu.models.mast3r import MASt3RConfig as JaxConfig
from mast3r_slam_tpu.utils import breakdown as jbreakdown
from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig
from mast3r_slam_torch.utils import breakdown

KEYS = ("PatchEmbed", "Encoder_attn", "Encoder_mlp", "Decoder_attn",
        "Decoder_cross_attn", "Decoder_mlp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("res,extra", [
    ({"PatchEmbed": 1.25e-4, "Encoder_attn": 3.5e-3, "Encoder_mlp": 6.1e-3,
      "Decoder_attn": 2.2e-3, "Decoder_cross_attn": 2.9e-3,
      "Decoder_mlp": 4.4e-3}, None),
    ({"Encoder_attn": 1e-3, "Decoder_mlp": 2e-3}, {"frames": 6, "note": "x"}),
    ({}, None)], ids=["full", "partial_with_extra", "empty"])
def test_print_network_summary_prints_jax_text(res, extra, capsys):
    jbreakdown.print_network_summary(res, extra)
    ref = capsys.readouterr().out
    breakdown.print_network_summary(res, extra)
    assert capsys.readouterr().out == ref
    assert "NETWORK TIMING BREAKDOWN" in ref


@pytest.mark.parametrize("kw,hw", [
    (dict(), (64, 96)),
    (dict(enc_depth=3, dec_depth=2), (32, 48))], ids=["tiny", "depth_3_2"])
def test_synthesized_totals_equal_jax(kw, hw, monkeypatch):
    """Each sub-block call timed at the same constant in both packages: the
    per-frame totals are equal, key for key."""
    per_call = 1.7e-3
    monkeypatch.setattr(jbreakdown, "_timed_chain",
                        lambda *a, **k: per_call)
    monkeypatch.setattr(breakdown, "_seconds_per_call",
                        lambda *a, **k: per_call)
    torch.manual_seed(0)
    model = MASt3R(MASt3RConfig.tiny(**kw)).eval()
    jcfg = JaxConfig.tiny(**kw)
    params = convert_state_dict(model.state_dict(), jcfg.enc_depth,
                                jcfg.dec_depth)
    ref = jbreakdown.network_breakdown(jcfg, params, hw)
    got = breakdown.network_breakdown(model, hw)
    assert set(got) == set(ref) == set(KEYS)
    for k in KEYS:
        assert got[k] == ref[k], k
    assert got["Encoder_mlp"] == per_call * jcfg.enc_depth
    assert got["Decoder_cross_attn"] == per_call * 2 * jcfg.dec_depth


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tiny_model_breakdown_on_the_cpu(dtype, capsys):
    """The port's timer on the tiny model (host clock on the CPU): the six
    sections, each finite and >= 0, and the report prints them."""
    torch.manual_seed(0)
    model = MASt3R(MASt3RConfig.tiny(dtype=dtype)).eval()
    res = breakdown.network_breakdown(model, (64, 96), n_chain=2)
    assert set(res) == set(KEYS)
    assert all(v >= 0.0 and v == v and v < float("inf")
               for v in res.values())
    breakdown.print_network_summary(res)
    out = capsys.readouterr().out
    assert all(f"  - {k}: " in out for k in KEYS)


def test_seconds_per_call_runs_warm_up_and_chain():
    calls = []
    s = breakdown._seconds_per_call(lambda: calls.append(1), 5,
                                    torch.device("cpu"))
    assert len(calls) == 6 and s >= 0.0

