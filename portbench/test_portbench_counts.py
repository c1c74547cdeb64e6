"""The count functions against hand-worked shapes (PERF.md's kernel
table), the peaks, the model FLOPs and the statistics."""
import pytest
import torch

from portbench import manifest, modelflops, peaks, stats

H100 = peaks.peak("NVIDIA H100 80GB HBM3")


def test_mca_matmul_fixed_o_proj_is_bound_by_bytes_at_1_21_us():
    mod = manifest.count("mca_matmul_fixed")
    x = torch.empty(128, 3072, dtype=torch.bfloat16)
    w = torch.empty(3072, 3072, dtype=torch.bfloat16)
    idx = torch.tensor([3, 9, 0, 17], dtype=torch.int32)
    rec = mod.settle(mod.record((x, w, idx, torch.empty(4)),
                                {"block": 128}))
    flops, nbytes = mod.flops_bytes(rec)
    assert flops == 2 * 128 * 4 * 128 * 3072
    assert nbytes == 2 * (128 * 512 + 512 * 3072 + 128 * 3072) + 32
    t = peaks.bound_seconds(flops, nbytes, H100)
    assert t == pytest.approx(1.21e-6, abs=0.005e-6)
    assert t == nbytes / H100["hbm_bytes_per_s"]


def test_mca_matmul_fixed_reads_a_block_drawn_twice_once():
    mod = manifest.count("mca_matmul_fixed")
    x = torch.empty(128, 3072, dtype=torch.bfloat16)
    w = torch.empty(3072, 3072, dtype=torch.bfloat16)
    idx = torch.tensor([5, 5, 5, 2], dtype=torch.int32)
    rec = mod.settle(mod.record((x, w, idx, torch.empty(4)),
                                {"block": 128}))
    flops, nbytes = mod.flops_bytes(rec)
    assert flops == 2 * 128 * 4 * 128 * 3072
    assert nbytes == 2 * (128 * 256 + 256 * 3072 + 128 * 3072) + 32


def test_kv_slot_update_layer_write_is_0_0025_us():
    mod = manifest.count("kv_slot_update")
    k = torch.empty(4, 1, 2, 128, dtype=torch.bfloat16)
    pos = torch.empty(4, 512, dtype=torch.int32)
    rec = mod.record((None, k, None, k, pos, 7), {"window": 0})
    flops, nbytes = mod.flops_bytes(rec)
    assert flops == 0 and nbytes == 2 * 4 * (512 + 512) + 16
    assert peaks.bound_seconds(flops, nbytes, H100) == pytest.approx(
        0.0025e-6, abs=0.0001e-6)


def test_model_flops_of_starcoder2_3b():
    m = manifest.config("starcoder2-3b")["model"]
    w = modelflops.layer_weights(m)
    assert w == 3072 * 128 * (48 + 4) + 2 * 3072 * 12288
    one = modelflops.request_flops(m, 1, 1)
    assert one == 2 * w * 30 + 4 * 24 * 128 * 30 + 2 * 3072 * 49152
    # about 2 x 3.0e9 FLOPs a token for a 2k prompt, plus attention
    per_tok = modelflops.request_flops(m, 2048, 32) / 2079
    assert 5.5e9 < per_tok < 7.5e9


def test_percentile_over_all_samples():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 90) == 5.0
    assert stats.percentile(xs, 0) == 1.0
