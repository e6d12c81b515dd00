"""Each kernel's and the model's work, against a count by hand at one shape."""
from perfbench.roofline import causal, dense_lm, flash_bwd, flash_fwd, paged_decode, peaks
from perfbench.testing import REDUCED, SERVE
import types


def brute_pairs(sq, skv, off):
    return sum(1 for i in range(sq) for j in range(skv) if j <= off + i)


def test_causal_pairs():
    for sq, skv, off in ((5, 5, 0), (3, 10, 7), (4, 10, 2), (6, 3, 0), (1, 9, 8)):
        assert causal.pairs(sq, skv, off) == brute_pairs(sq, skv, off)


def test_flash_forward_at_one_shape():
    # B=1, S=4, H=2 over KV=1, hd=8, bf16: 10 kept pairs
    f, b = flash_fwd.work(B=1, Sq=4, Skv=4, H=2, KV=1, hd=8, elem=2)
    assert f == 10 * 2 * (2 * 8 + 2 * 8)  # q.k and p.v, 2 FLOP a multiply-add
    assert b == 2 * (4 * 2 * 8 * 2 + 4 * 1 * 8 * 2)  # q, out; k, v
    assert flash_fwd.matches("void flash_attention_wgmma_kernel<128, 48>(...)")
    assert not flash_fwd.matches("flash_bwd_dq_wgmma_kernel")


def test_flash_backward_at_one_shape():
    f, b = flash_bwd.work(B=2, Sq=3, Skv=3, H=4, KV=2, hd=16, elem=2)
    assert f == 2 * 6 * 4 * 5 * 2 * 16
    assert b == 2 * (4 * 2 * 3 * 4 * 16 + 4 * 2 * 3 * 2 * 16) + 4 * 2 * 3 * 4
    assert flash_bwd.matches("flash_bwd_dkdv_wgmma_kernel")


def test_paged_decode_at_one_shape():
    f, b = paged_decode.work(valid=[10, 20], H=48, KV=1, hd=128, elem=2)
    assert f == 4 * 48 * 128 * 30
    assert b == 2 * (2 * 30 * 128 + 2 * 2 * 48 * 128)
    assert paged_decode.matches("void decode_mma_kernel<128, 48, PagedRows>(Params)")
    assert not paged_decode.matches("void decode_mma_kernel<128, 48, DenseRows>(Params)")


def test_model_work_at_one_shape():
    a = types.SimpleNamespace(num_layers=1, d_model=4, num_heads=2, num_kv_heads=1,
                              head_dim=2, d_ff=8, vocab_size=10, act="silu")
    per_layer = 4 * 4 + 4 * 2 + 4 * 2 + 4 * 4 + 3 * 4 * 8  # q, k, v, o, gate / up / down
    assert dense_lm.layer_params(a) == per_layer
    assert dense_lm.prefill_flops(a, 3) == 2 * per_layer * 3 + 4 * 2 * 2 * 6 + 2 * 40
    assert dense_lm.tick_flops(a, 5) == 2 * per_layer + 4 * 2 * 2 * 6 + 2 * 40
    fwd = 2 * per_layer * 2 * 3 + 4 * 2 * 2 * 2 * 6 + 2 * 40 * 2 * 3
    assert dense_lm.train_step_flops(a, 2, 3) == 3 * fwd


def test_bound_is_the_larger_term():
    p = peaks.for_device("NVIDIA H100 80GB HBM3")
    assert peaks.bound_s(989e12, 0, p, "bfloat16") == 1.0
    assert peaks.bound_s(0, 3.35e12, p, "bfloat16") == 1.0
    assert peaks.for_device("some other card") is None
    assert REDUCED[SERVE]["num_layers"] == 3
