"""Tiny test-only cells that run end to end on the CPU through the program's
plain twins."""
import json

from portbench.harness import spec

MODEL = {"patch_size": 8, "embed_dim": 128, "depth": 2, "num_heads": 2, "mlp_ratio": 4.0,
         "img_size": 32, "qkv_bias": True, "layerscale": False}
EXTRACT = {"compute_dtype": "bfloat16", "block_impl": "fused", "batch_size": 4,
           "feature_output_size": 8, "slice_along": "all", "return_keys": ["k"]}
SIMILARITY = {"dtype": "float32", "threshold": 0.25, "exponent": 2.5}
REFINEMENT = {"dtype": "float32", "sigma_spatial": 7, "sigma_luma": 5, "lam": 256,
              "cg_maxiter": 25}
EDIT = {"loop": "edit", "volume": 64, "annotations_per_class": 64, "stroke": 4,
        "strokes_per_class": 64, "warm_rounds": 2, "bilateral_solver": True,
        "bls_shape_bucket": 8, "dirty_tracking": True, "check_share": 0.2, "check_max": 4}


def limits(workload: str) -> dict:
    """The limits of a real cell, which the tiny cells are held to."""
    with open(spec.BENCH_DIR / "limits" / f"{workload}.json") as f:
        return json.load(f)


def extract_cell(block_impl: str = "fused", workload: str = "vits8-extract-256") -> spec.Cell:
    config = {"name": "tiny", "model": MODEL, "extract": dict(EXTRACT, block_impl=block_impl)}
    traffic = {"loop": "extract", "volume": 32, "check_slots": 3}
    return spec.Cell("tiny-extract", 1, config, traffic, limits(workload), [], [])


def edit_cell(refined: bool = True, workload: str = "vits8-edit-refined-256") -> spec.Cell:
    config = {"name": "tiny", "model": MODEL, "extract": dict(EXTRACT, feature_output_size=16),
              "similarity": SIMILARITY, "refinement": REFINEMENT}
    traffic = dict(EDIT, bilateral_solver=refined)
    return spec.Cell("tiny-edit", 1, config, traffic, limits(workload), [], [])

