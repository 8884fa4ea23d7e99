"""The planted faults and ablations of ``scripts/kernel_variants.py`` are text
edits of the CUDA sources: each must still apply, exactly once, to the source
it names, or the list has rotted away from the kernels it is meant to break.
(The variants themselves build and run on a card only.)"""
import pytest

from vittf_tpu_torch import kernels
from vittf_tpu_torch.scripts import kernel_variants as kv

FAULTS = [(name, edits) for name, _, edits in kv.FAULTS if edits]
CASES = FAULTS + [v for v in kv.ATTENTION_ABLATION + kv.SIMILARITY_ABLATION + kv.GEMM_ABLATION
                  + kv.BILATERAL_ABLATION if v[1]]


@pytest.mark.parametrize("name,edits", CASES, ids=[c[0] for c in CASES])
def test_edit_applies_exactly_once(name, edits):
    for fname, old, new in edits:
        text = (kernels.CSRC / fname).read_text()
        assert text.count(old) == 1, f"{name}: {old!r} occurs {text.count(old)} times in {fname}"
        assert new != old


def test_every_redesigned_kernel_has_three_faults():
    for kernel in ("K1", "K2", "K4", "K5", "K6a", "K6b", "K7a", "K7b", "K8", "K3 attention", "K3 gemm",
                   "K9 gemm", "K9 requant", "K10"):
        assert sum(name.startswith(kernel) for name, _ in FAULTS) >= 3, kernel


def test_fault_phases_exist_in_chip_smoke():
    import chip_smoke

    for _, phase, _ in kv.FAULTS:
        assert callable(getattr(chip_smoke, "phase_" + phase))


def test_cli_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert kv.main(["faults"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("fault", kv.GRAPH_FAULTS, ids=[f[0] for f in kv.GRAPH_FAULTS])
def test_graph_fault_patches_a_name_that_exists(fault):
    """Each planted graph fault replaces a name its module (``utils/
    cuda_graphs.py``, ``ops/bilateral.py``, ``pipeline/refine.py``) still
    has, with a value of the same kind."""
    _, owner, attr, value = fault
    old = getattr(kv._owner(owner), attr)
    new = value(kv._owner(owner.partition(":")[0]))
    assert callable(old) == callable(new) and new != old


def test_graph_faults_cover_the_refine_core():
    """At least three planted faults of the refine core's graph route."""
    assert sum("starts" in name or "refine core" in name for name, *_ in kv.GRAPH_FAULTS) >= 3
