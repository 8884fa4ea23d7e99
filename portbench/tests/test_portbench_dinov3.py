"""The DINOv3 extraction loop (``harness/extract_dinov3.py``): a tiny cell
end to end on the CPU through the program's plain twins, the weights and
their published names, the FLOP and byte plan at the cell's size, the launch
counters' check, the readers, and, on the card, the control and the planted
faults at the cell's own size."""
import json
import time

import pytest
import torch

from portbench import control_dinov3
from portbench.harness import extract_dinov3 as loop
from portbench.harness import flops, spec
from portbench.harness.outcome import limit_checks

SEED = 2**33 + 17
CELL = "vit7b16-extract-256"
MODEL = {"patch_size": 16, "embed_dim": 256, "depth": 3, "num_heads": 2, "ffn_ratio": 3,
         "hidden_dim": 512, "swiglu_align": 64, "n_storage_tokens": 4, "rope_base": 100.0,
         "norm_eps": 1e-5, "ffn": "swiglu", "layerscale": True, "qkv_bias": False,
         "proj_bias": True, "ffn_bias": True, "position": "rope",
         "rope_normalize_coords": "separate"}
EXTRACT = {"compute_dtype": "bfloat16", "block_impl": "xla", "batch_size": 4,
           "feature_output_size": 4, "slice_along": "all", "return_keys": ["k"]}


def tiny_cell(model=MODEL, extract=EXTRACT) -> spec.Cell:
    """A 3-block DINOv3 at width 256 (2 heads of 128) on a 16³ phantom, held
    to the real cell's limits."""
    return spec.Cell("tiny-dinov3", 1, {"name": "tiny", "model": model, "extract": extract},
                     {"loop": "extract_dinov3", "volume": 16, "check_slots": 3},
                     spec.load_cell(CELL).limits, [], [])


def test_a_tiny_cell_runs_and_is_correct():
    out = loop.run(tiny_cell(), SEED, 0.5, False, time.perf_counter(), device="cpu")
    assert out.correct and out.attempted >= 1 and out.end_to_end["extract_mvox_s"] > 0
    # the CPU runs the twins
    assert out.counters == {"rope_launches": 0, "swiglu_launches": 0, "layer_norm_launches": 0}
    n = out.attempted * 4 * (MODEL["depth"] - 1)  # an axis: 16 slices in batches of 4
    assert [w[0] for w in out.work["rope_attention"]] == [n] * 3
    assert [w[0] for w in out.work["layer_norm"]] == [n + out.attempted * 4, n, n] * 3


def test_the_weights_and_their_published_names():
    a = loop.weights(MODEL, SEED, torch.device("cpu"))
    b = loop.weights(MODEL, SEED, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert "pos_embed" not in a and "blocks.0.attn.qkv.bias" not in a
    pub = loop.published(a, MODEL)
    H = MODEL["hidden_dim"]
    w12 = a["blocks.1.mlp.w12.weight"]
    assert pub["blocks.1.mlp.w1.weight"].data_ptr() == w12.data_ptr()  # views, no copy
    assert torch.equal(torch.cat([pub["blocks.1.mlp.w1.bias"], pub["blocks.1.mlp.w2.bias"]]),
                       a["blocks.1.mlp.w12.bias"])
    assert pub["blocks.1.mlp.w2.weight"].shape == (H, MODEL["embed_dim"])
    assert pub["storage_tokens"] is a["register_tokens"]
    assert not any("w12" in k or k == "register_tokens" for k in pub)


def test_the_plan_at_the_cells_size():
    model, ex = loop.settings(spec.load_cell(CELL))
    plan = loop.plan((256,) * 3, model, ex)
    assert [(a["slices"], a["batches"], a["batch"], a["tokens"], a["grid"]) for a in plan] == \
        [(256, 8, 32, 1029, (32, 32))] * 3
    N, D, H = 1029, 4096, 8192
    block = loop.block_flops(N, D, H)
    assert block == pytest.approx(362.6e9, rel=1e-3)
    assert loop.extraction_flops((256,) * 3, model, ex) == pytest.approx(10.89e15, rel=1e-3)
    # attention's two products are 4.8% of a call's FLOPs
    assert 39 * 4 * N * N * D / loop.slice_flops(N, model) == pytest.approx(0.048, abs=0.001)
    work = loop.window_work((256,) * 3, model, ex, calls=2)
    assert sum(n for n, _, _ in work["rope_attention"]) == 2 * 936
    assert work["rope_attention"][0][1] == flops.attention_flops(32, 32, N, 128)
    table = 4 * 2 * 64 * 32
    assert work["rope_attention"][0][2] == flops.attention_bytes(32, 32, N, 128) + table
    assert sum(n for n, _, _ in work["layer_norm"]) == 2 * 2832
    assert work["layer_norm"][1][2] == 2 * (4 * 32 * N * D + 3 * D)  # residual + LN
    assert work["vit_flops"] == 2 * loop.extraction_flops((256,) * 3, model, ex)


def test_the_launch_counters_are_checked():
    model, ex = loop.settings(spec.load_cell(CELL))
    want = {"rope_launches": 1872, "swiglu_launches": 1872, "layer_norm_launches": 2 * 2832}
    assert loop.expected_launches((256,) * 3, model, ex, 2, torch.device("cuda", 0)) == want
    assert set(loop.expected_launches((256,) * 3, model, ex, 2,
                                      torch.device("cpu")).values()) == {0}
    loop.check_launches(want, want)
    with pytest.raises(RuntimeError, match="rope_launches are 1871"):
        loop.check_launches(dict(want, rope_launches=1871), want)
    with pytest.raises(RuntimeError, match="layer_norm_launches are 5616"):
        loop.check_launches(dict(want, layer_norm_launches=5616), want)


def test_a_configuration_the_loop_does_not_run_raises():
    for section, key, value in (("model", "qkv_bias", True), ("model", "position", "learned"),
                                ("model", "pos_embed", True), ("model", "swiglu_align", 8),
                                ("extract", "slice_along", "z")):
        cfg = {"model": dict(MODEL), "extract": dict(EXTRACT)}
        cfg[section][key] = value
        with pytest.raises(ValueError):
            loop.settings(spec.Cell("x", 1, cfg, {}, {}, [], []))


def test_a_rope_base_the_program_does_not_run_raises():
    loop.program_config(MODEL, EXTRACT)
    with pytest.raises(ValueError, match="RoPE base"):
        loop.program_config(dict(MODEL, rope_base=10000.0), EXTRACT)


def test_the_readers_read_the_cells_work():
    from portbench.harness.trace import Trace

    ctx = loop.run(tiny_cell(), SEED, 0.2, False, time.perf_counter(), device="cpu")
    for metric in ("rope_attention_roofline", "layer_norm_roofline"):
        assert spec.layer_reader(metric)(ctx) is None  # no trace: nothing to read
    ctx.trace = Trace(window_s=1.0, device=[
        ("void (anonymous namespace)::rope_attention_kernel(...)", 0.0, 1e6),
        ("void (anonymous namespace)::residual_layer_norm_kernel<16, true, true>(...)", 0, 1e6)])
    share = spec.layer_reader("rope_attention_roofline")(ctx)
    bound = sum(n * flops.bound_seconds(f, b, flops.PEAK_BF16_FLOPS)
                for n, f, b in ctx.work["rope_attention"])
    assert share == pytest.approx(100 * bound)
    assert spec.layer_reader("layer_norm_roofline")(ctx) > 0


@pytest.mark.card
def test_the_control_and_the_faults_fail_the_limits_at_cell_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(CELL)
    line = control_dinov3.seed_line(cell, SEED, torch.device("cuda", 0), faults=True)
    print(json.dumps(line))
    assert line["sound"]["correct"]
    assert not any(v["correct"] for k, v in line.items() if k != "sound")
    assert limit_checks(line["sound"], cell.limits)
