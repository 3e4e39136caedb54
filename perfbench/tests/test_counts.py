"""The yardstick's own arithmetic: the flash kernels' operations and bytes,
the model FLOPs of both configurations by hand, and the token generator
bitwise the port's ``SyntheticLM``."""

import numpy as np
import pytest

from perfbench import flops, harness, traffic
from perfbench.reference import lm


def test_flash_counts_match_the_kernel_table():
    """(B 2, H 32, S 1024, D 80, causal, bf16): the counts the port's kernel
    table was measured against."""
    work = flops.attention_work(2, 32, 32, 1024, 1024, 80)
    assert work["flash_fwd"] == (10_747_904_000, 42_205_184)
    assert work["flash_bwd_dq"] == (16_121_856_000, 52_953_088)
    assert work["flash_bwd_dkv"] == (21_495_808_000, 63_438_848)
    assert round(work["flash_fwd"][0] / 1e9, 2) == 10.75
    assert round(work["flash_bwd_dq"][1] / 1e6, 1) == 53.0
    assert round(work["flash_bwd_dkv"][1] / 1e6, 1) == 63.4


def test_causal_pairs():
    assert flops.causal_pairs(16384, 16384) == 16384 * 16385 // 2
    assert flops.causal_pairs(4, 6) == 3 + 4 + 5 + 6  # queries end-aligned to the keys
    assert flops.causal_pairs(3, 5, causal=False) == 15


@pytest.mark.parametrize("name,rows,seq", [("stablelm-3b", 1, 16384), ("stablelm-3b", 4, 4096),
                                           ("granite-moe-3b-a800m", 1, 16384)])
def test_model_flops_by_hand(name, rows, seq):
    cfg = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    if name == "stablelm-3b":
        # q, k, v, o of 2560 x 2560, SwiGLU 3 x 2560 x 6912, the head
        per_layer = 4 * 2560 * 2560 + 3 * 2560 * 6912
        matmul = 32 * per_layer + 50304 * 2560
        heads, d_head = 32, 80
    else:
        # q and o 1536 x 1536, k and v 1536 x 512, router 1536 x 40, 8 of 40
        # experts of 3 x 1536 x 512, the head
        per_layer = 2 * 1536 * 1536 + 2 * 1536 * 512 + 1536 * 40 + 8 * 3 * 1536 * 512
        matmul = 32 * per_layer + 49155 * 1536
        heads, d_head = 24, 64
    # the published (active) count less the norm scales and an untied input
    # embedding (a tied table is counted once, as the head)
    d, V = cfg["port"]["d_model"], cfg["port"]["vocab_size"]
    embed = 0 if cfg["port"]["tie_embeddings"] else V * d
    assert matmul == cfg["active_params"] - embed - (2 * 32 + 1) * d
    assert lm.matmul_params(cfg) == matmul
    pairs = seq * (seq + 1) // 2
    want = 6 * matmul * rows * seq + 32 * 12 * d_head * heads * pairs * rows
    assert flops.model_flops(cfg, rows, seq) == want


def test_least_seconds_takes_the_longer_bound():
    assert flops.least_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert flops.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [0, 1234, 2147483647 + 5, 9 * 10**12])
def test_generator_is_bitwise_the_ports_pipeline(seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    port = SyntheticLM(DataConfig(vocab_size=50304, seq_len=512, global_batch=2, seed=seed))
    mine = traffic.Generator(traffic.Mix(vocab_size=50304, seq_len=512, rows=2, seed=seed))
    for step in (0, 1, 7):
        a, b = port.batch(step), mine.batch(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
