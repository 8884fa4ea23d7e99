"""The yardstick's arithmetic against hand counts."""
import pytest

from portbench.harness import flops

VITS8 = {"patch_size": 8, "embed_dim": 384, "depth": 12, "num_heads": 6, "hidden_dim": 1536}
VITB8 = {"patch_size": 8, "embed_dim": 768, "depth": 12, "num_heads": 12, "hidden_dim": 3072}
EXTRACT = {"batch_size": 8, "feature_output_size": 64, "slice_along": "all", "return_keys": ["k"]}


def test_vit_slice_flops_by_hand():
    N, D = 4097, 384
    block = 24 * N * D * D + 4 * N * N * D
    by_hand = 11 * block + 2 * 4096 * D * 64 + 2 * N * D * D
    assert flops.vit_slice_flops(N, VITS8) == by_hand
    assert flops.vit_slice_flops(N, VITS8) == pytest.approx(444.5e9, rel=1e-3)
    assert flops.vit_slice_flops(N, VITB8) == pytest.approx(1210.4e9, rel=1e-3)


def test_sweep_of_a_256_volume():
    plan = flops.extraction_plan((256, 256, 256), VITS8, EXTRACT)
    assert [a["slices"] for a in plan] == [256] * 3 and [a["batches"] for a in plan] == [32] * 3
    assert {a["tokens"] for a in plan} == {4097}
    assert flops.extraction_flops((256,) * 3, VITS8, EXTRACT) == pytest.approx(341.4e12, rel=1e-3)
    assert flops.extraction_flops((256,) * 3, VITB8, EXTRACT) == pytest.approx(929.6e12, rel=1e-3)


def test_kernel_bounds_match_the_kernel_table():
    # K3 at (8, 4097, 384): 0.3258 ms bound (PERF.md's kernel table)
    k3 = flops.bound_seconds(8 * flops.block_flops(4097, 384, 1536),
                             flops.block_bytes(8, 4097, 384, 1536), flops.PEAK_BF16_FLOPS)
    assert k3 == pytest.approx(0.3258e-3, rel=2e-3)
    # K1 at (8, 6, 4097, 64): 0.2086 ms
    k1 = flops.bound_seconds(flops.attention_flops(8, 6, 4097, 64),
                             flops.attention_bytes(8, 6, 4097, 64), flops.PEAK_BF16_FLOPS)
    assert k1 == pytest.approx(0.2086e-3, rel=2e-3)
    # K2, one class of 256 annotations on 64^3 x 384 features: the dot and the mean
    V = 64 ** 3
    assert flops.similarity_flops(V, 384, 256, 1) == 2 * V * 384 * 256 + 2 * V * 256
    assert flops.similarity_flops(V, 384, 256, 1) == pytest.approx(51.7e9, rel=2e-3)
