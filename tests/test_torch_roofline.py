"""The port's roofline accounting (``repro_torch.roofline.analysis``),
on the CPU: ``model_flops`` equal to ``repro.roofline.analysis``'s for
every architecture and kind (rtol 1e-12: the same sums over the same
shapes), and the ports of ``tests/test_roofline.py``'s tests that do
not parse HLO (the port has no HLO; its HLO parsers have no
counterpart)."""
import pytest

from repro.configs import get_config as jax_config
from repro.configs import list_configs
from repro.roofline.analysis import model_flops as jax_model_flops
from repro_torch.configs import get_config
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import model_flops, roofline


@pytest.mark.parametrize("kind,batch,seq", [("train", 256, 4096),
                                            ("prefill", 32, 32768),
                                            ("decode", 128, 32768)])
@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_equal_jax(arch, kind, batch, seq):
    got = model_flops(get_config(arch), kind, batch, seq)
    want = jax_model_flops(jax_config(arch), kind, batch, seq)
    assert got == pytest.approx(want, rel=1e-12) and got > 0


def test_model_flops_moe_uses_active_params():
    moe = get_config("qwen3-moe-235b-a22b")
    f_moe = model_flops(moe, "train", 1, 1)
    # active fraction: top-8 of 128 experts -> expert flops scaled by 1/16
    total_expert_params = (moe.n_experts * moe.d_model * moe.d_ff * 3
                           * moe.n_layers)
    active_expert_params = total_expert_params * moe.moe_top_k / moe.n_experts
    assert f_moe < 6 * (total_expert_params + 1e12)
    assert f_moe > 6 * active_expert_params  # attn etc on top


def test_roofline_identifies_bottleneck():
    r = roofline({"flops": 1e12, "bytes accessed": 1e9}, 0, 256)
    assert r["bottleneck"] == "compute"
    r = roofline({"flops": 1e9, "bytes accessed": 1e12}, 0, 256)
    assert r["bottleneck"] == "memory"
    r = roofline({"flops": 1e9, "bytes accessed": 1e9}, int(1e12), 256)
    assert r["bottleneck"] == "collective"


def test_roofline_uses_h100_peaks_and_model_flops():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    cfg = get_config("hymba-1.5b")
    r = roofline({"flops": 989e12, "bytes accessed": 3.35e12}, 450e9, 4,
                 cfg=cfg, kind="train", batch=2, seq=2048)
    assert r["t_compute_s"] == r["t_memory_s"] == r["t_collective_s"] == 1.0
    mf = model_flops(cfg, "train", 2, 2048)
    assert r["model_flops_per_device"] == mf / 4
    assert r["roofline_fraction"] == pytest.approx(mf / 4 / 989e12)
