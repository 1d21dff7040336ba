"""The counts of operations and bytes on hand-worked shapes."""
import pytest

from port_bench.counts import kernels, model, peaks


@pytest.mark.parametrize("sq,skv,causal,window,want", [
    (4, 4, False, None, 16),
    (4, 4, True, None, 1 + 2 + 3 + 4),
    (5, 5, True, 2, 1 + 2 + 2 + 2 + 2),
    (3, 3, True, 10, 6),
])
def test_visible_keys(sq, skv, causal, window, want):
    assert kernels.visible_keys(sq, skv, causal, window) == want


def test_scan_counts():
    w = kernels.scan_fwd(2, 3, 5, 7)
    assert w.ops == 6 * 2 * 3 * 5 * 7
    assert w.nbytes == 4 * (3 * 30 + 2 * 42 + 35)
    wb = kernels.scan_bwd(2, 3, 5, 7)
    assert wb.ops == 14 * 210
    assert wb.nbytes == 4 * (5 * 30 + 4 * 42 + 2 * 35)
    assert w.bound_s() == max(w.ops / peaks.FP32_FLOPS,
                              w.nbytes / peaks.HBM_BYTES)


def test_flash_counts():
    w = kernels.flash_bwd(1, 4, 2, 4, 4, 8, True, None, 2)
    assert w.ops == 10 * 4 * 8 * 10
    assert w.nbytes == 2 * (4 * 4 * 4 * 8 + 4 * 2 * 4 * 8) + 4 * 16
    assert w.ops_rate == peaks.BF16_FLOPS
    assert kernels.flash_bwd(1, 4, 2, 4, 4, 8, False, None,
                             4).ops_rate == peaks.FP32_FLOPS


CFG = {"family": "hybrid", "num_layers": 2, "d_model": 4, "num_heads": 2,
       "num_kv_heads": 1, "head_dim": 2, "d_ff": 3, "vocab_size": 10,
       "d_inner": 8, "ssm_state": 2, "dt_rank": 1, "sliding_window": 2,
       "full_attn_layers": [0]}


def test_model_flops_by_hand():
    # attention 4*4 + 2*4*2 + 4*4 = 48; mlp 36; ssm 4*16 + 8*5 + 8 + 32 = 144
    assert model.layer_matmul_params(CFG) == 48 + 36 + 144
    # pairs at seq 3: layer 0 full 6, layer 1 window 2: 1 + 2 + 2 = 5
    att = 4 * 1 * 2 * 2 * (6 + 5)
    assert model.attention_flops(CFG, 1, 3, 3) == att
    fwd = 2 * 3 * 2 * 228 + 2 * 3 * 4 * 10 + att
    assert model.forward_flops(CFG, 1, 3) == fwd
    assert model.train_flops(CFG, 1, 3) == 3 * fwd
    assert model.prefill_flops(CFG, 1, 3) == fwd - 2 * 2 * 4 * 10
    ssm = dict(CFG, family="ssm", d_ff=0)
    assert model.decode_flops(ssm, 5, 100) == 2 * 5 * (2 * 144 + 40)
