"""The frozen counts against values worked out by hand at small shapes."""
import pytest

from portbench import counts
from portbench.stepcounts import gqa

TINY = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "d_ff": 16,
        "mlp_type": "squared_relu", "vocab_size": 10, "stages": [{"unit": ["attn"], "n_units": 2}]}


def test_paged_decode_attention():
    # q 2*4*8*2 + K/V 10*2*(8+8)*2 + valid_len 4*2 + out 2*4*8*2 + table 4*3
    c = counts.paged_decode_attention(2, 4, 2, 8, 8, 2, 10, 3)
    assert c == counts.Cost(916, 1280, "bfloat16")
    assert counts.paged_decode_attention(2, 4, 2, 8, 8, 4, 10, 3).dtype == "float32"


def test_kernel2_call_counts_live_rows():
    # rows of 3 and 20 cached tokens attend 4 + 21 keys over 1 + 2 pages of 16
    cfg = {"n_heads": 4, "n_kv_heads": 2, "head_dim": 8}
    assert counts.kernel2_call(cfg, [3, 20], 16) == counts.Cost(1876, 3200, "bfloat16")


def test_gqa_step_counts():
    assert gqa.layer_params(TINY) == 8 * 4 * 4 + 2 * 4 * 8 + 2 * 8 * 16 == 448
    assert counts.n_layers(TINY) == 2
    assert gqa.weight_bytes(TINY) == 2 * (2 * (448 + 16) + 8 + 80) == 2032
    assert gqa.kv_bytes_per_token(TINY) == 32
    assert counts.step_counts("gqa") is gqa
    # one row of 5 cached tokens: weights, 5 rows read, 1 written; matmuls,
    # unembedding, attention over 6 keys (2 layers x 4 H hd)
    assert gqa.decode_step(TINY, [5]) == counts.Cost(2224, 1792 + 160 + 384, "bfloat16")
    # a 3-token prompt: 3 tokens of matmuls, one unembedding, 1 + 2 + 3 keys
    assert gqa.prefill(TINY, 3) == counts.Cost(2128, 5376 + 160 + 384, "bfloat16")


@pytest.mark.parametrize("cost,seconds", [
    (counts.Cost(3_350_000_000_000, 0, "bfloat16"), 1.0),
    (counts.Cost(0, 989_000_000_000_000, "bfloat16"), 1.0),
    (counts.Cost(3_350_000_000_000, 2 * 989_000_000_000_000, "bfloat16"), 2.0),
])
def test_bound(cost, seconds):
    assert counts.bound_s(cost) == pytest.approx(seconds)
