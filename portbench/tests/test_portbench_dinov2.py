"""The DINOv2 extraction loop (``harness/extract_dinov2.py``): a tiny cell
end to end on the CPU through the program's plain twins, the SwiGLU and
register-token arithmetic of its FLOP and byte plan, the gate counter's
check, and, on the card, the control and the planted faults at the cell's
own size."""
import json
import time

import pytest
import torch

from portbench import control_dinov2
from portbench.harness import extract_dinov2 as loop
from portbench.harness import flops, spec
from portbench.harness.outcome import limit_checks

SEED = 2**33 + 17
CELL = "vitg14reg-extract-256"
MODEL = {"patch_size": 4, "embed_dim": 64, "depth": 3, "num_heads": 2, "mlp_ratio": 4.0,
         "hidden_dim": 176, "img_size": 148, "num_register_tokens": 4,
         "interpolate_antialias": True, "interpolate_offset": 0.0, "ffn": "swiglu",
         "layerscale": True, "qkv_bias": True, "ffn_bias": True}
EXTRACT = {"compute_dtype": "bfloat16", "block_impl": "xla", "batch_size": 4,
           "feature_output_size": 8, "slice_along": "all", "return_keys": ["k"]}


def tiny_cell(model=MODEL, extract=EXTRACT) -> spec.Cell:
    """A 3-block DINOv2 at width 64 on a 32³ phantom, held to the real cell's limits."""
    return spec.Cell("tiny-dinov2", 1, {"name": "tiny", "model": model, "extract": extract},
                     {"loop": "extract_dinov2", "volume": 32, "check_slots": 3},
                     spec.load_cell(CELL).limits, [], [])


def test_a_tiny_cell_runs_and_is_correct():
    out = loop.run(tiny_cell(), SEED, 0.5, False, time.perf_counter(), device="cpu")
    assert out.correct and out.attempted >= 1 and out.end_to_end["extract_mvox_s"] > 0
    assert out.counters == {"swiglu_launches": 0}  # the CPU runs the gate's plain twin
    n = out.attempted * 8 * (MODEL["depth"] - 1)  # an axis: 32 slices in batches of 4
    assert [w[0] for w in out.work["swiglu"]] == [n] * 3
    assert [w[0] for w in out.work["attention"]] == [n] * 3


def test_the_same_seed_draws_the_same_weights():
    a = loop.weights(MODEL, SEED, torch.device("cpu"))
    b = loop.weights(MODEL, SEED, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    gammas = torch.cat([v for k, v in a.items() if k.endswith(".gamma")])
    assert 0.25 <= float(gammas.min()) and float(gammas.max()) <= 1.25
    assert float(gammas.std()) > 0.2  # spread per channel, away from 1
    assert set(a) == set(loop.param_shapes(MODEL)[i][0] for i in range(len(a)))


def test_the_plan_counts_registers_and_the_swiglu_ffn():
    model, ex = loop.settings(spec.load_cell(CELL))
    plan = loop.plan((256,) * 3, model, ex)
    assert [(a["slices"], a["batches"], a["batch"], a["tokens"]) for a in plan] == \
        [(256, 8, 32, 1029)] * 3
    N, D, H = 1029, 1536, 4096
    block = 8 * N * D * D + 6 * N * D * H + 4 * N * N * D
    assert loop.block_flops(N, D, H) == block
    assert loop.slice_flops(N, model) == 2 * 1024 * D * 14 * 14 + 39 * block + 2 * N * D * D
    assert loop.extraction_flops((256,) * 3, model, ex) == pytest.approx(1.944e15, rel=1e-3)
    # the FFN is 60% of a call's FLOPs, attention's two products 10%
    assert 39 * 6 * N * D * H / loop.slice_flops(N, model) == pytest.approx(0.60, abs=0.01)
    assert 39 * 4 * N * N * D / loop.slice_flops(N, model) == pytest.approx(0.10, abs=0.01)
    work = loop.window_work((256,) * 3, model, ex, calls=2)
    assert sum(n for n, _, _ in work["swiglu"]) == 2 * 936
    assert work["swiglu"][0][2] == 6 * 32 * 1029 * 4096  # 809 MB a launch
    bound = flops.bound_seconds(0.0, work["swiglu"][0][2], flops.PEAK_BF16_FLOPS)
    assert bound == pytest.approx(0.2416e-3, rel=1e-3)
    assert work["attention"][0][1] == flops.attention_flops(32, 24, 1029, 64)
    assert work["vit_flops"] == 2 * loop.extraction_flops((256,) * 3, model, ex)


def test_the_gate_counter_is_checked():
    model, ex = loop.settings(spec.load_cell(CELL))
    assert loop.expected_launches((256,) * 3, model, ex, 3, torch.device("cuda", 0)) == 3 * 936
    assert loop.expected_launches((256,) * 3, model, ex, 3, torch.device("cpu")) == 0
    loop.check_launches(2808, 2808)
    with pytest.raises(RuntimeError, match="2807"):
        loop.check_launches(2807, 2808)


@pytest.mark.parametrize("section,key,value", [
    ("model", "ffn", "mlp"),
    ("model", "layerscale", False),
    ("model", "qkv_bias", False),
    ("model", "register_dim", 4),  # a key the harness does not read
    ("extract", "slice_along", "z"),
    ("extract", "return_keys", ["q"]),
])
def test_a_configuration_the_loop_cannot_run_raises(section, key, value):
    cell = spec.load_cell(CELL)
    loop.settings(cell)
    config = json.loads(json.dumps(cell.config))
    config[section][key] = value
    with pytest.raises(ValueError):
        loop.settings(spec.Cell(cell.name, 1, config, cell.traffic, cell.limits, [], []))


def test_a_width_the_program_does_not_give_raises():
    model, ex = loop.settings(spec.load_cell(CELL))
    with pytest.raises(ValueError, match="SwiGLU width"):
        loop.program_config(dict(model, hidden_dim=4104), ex)


def test_the_cell_and_its_configuration():
    cell = spec.load_cell(CELL)
    assert cell.traffic == {"loop": "extract_dinov2", "volume": 256, "check_slots": 8}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "extract_mvox_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "extract_mfu", "extract_idle_share", "attention_roofline", "extract_build_share",
        "extract_host_gap_share", "swiglu_roofline"}
    vit, ecfg = loop.program_config(*loop.settings(cell))
    assert (vit.hidden_dim, vit.prefix_tokens, ecfg.batch_size) == (4096, 5, 32)


def test_the_control_is_not_correct_at_a_tiny_size():
    line = control_dinov2.seed_line(tiny_cell(), SEED, torch.device("cpu"), faults=False)
    assert line["sound"]["correct"] and not line["control"]["correct"]


# ---- on the card: the control and the planted faults at the cell's size


@pytest.mark.card
def test_control_and_faults_at_cell_size_are_not_correct(card):
    line = control_dinov2.seed_line(spec.load_cell(CELL), SEED, card, faults=True)
    assert line["sound"]["correct"]
    assert not any(v["correct"] for name, v in line.items() if name != "sound"), line


@pytest.mark.card
def test_the_swiglu_roofline_reads_a_traced_window(card):
    out = loop.run(spec.load_cell(CELL), SEED, 1.0, True, time.perf_counter())
    value = spec.layer_reader("swiglu_roofline")(out)
    assert value is not None and 0 < value <= 105
    assert out.counters["swiglu_launches"] == 936 * out.attempted and out.correct
