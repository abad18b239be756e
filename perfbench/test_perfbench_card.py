"""The harness on the card at a small size: a traced run reads every
per-layer metric of the cell from the device trace (needs an NVIDIA
card; skips elsewhere)."""
import pytest
import torch

from perfbench import bench


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_layer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    result, notes = bench.run_cell(
        "uci-xlarge.fit-blobs", seed=2 ** 35 + 9, seconds=1.0, trace=True,
        started=0.0, device=torch.device("cuda", 0),
        config_override={"n_points": 1 << 16})
    assert result["correct"] is True
    want = {m["name"] for m in bench.spec()["per_layer"]}
    assert set(result["metrics"]) == want
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"]
