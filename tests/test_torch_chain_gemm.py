"""Port parity: the chained GEMM probe (K9) of vittf_tpu_torch vs the Pallas
bodies of scripts/bench_int8_gemm.py.

The JAX side runs the probe's own ``run`` (its ``pl.pallas_call``) under
``pltpu.force_tpu_interpret_mode()`` on the CPU. On CPU tensors
``chain_gemm`` runs ``chain_gemm_plain``; the CUDA kernel
(``csrc/chain_gemm.cu``) is held against the same plain version on the card
by ``chip_smoke.py``. The integer modes are bit-defined and must be equal;
bf16 is held at one bf16 step for chain 1 and, for longer chains, at
0.03·max|ref|: two fp32 accumulation orders flip a bf16 rounding per step
and the chain feeds it forward (``chip_smoke.py`` reads 0.009–0.012 between
two orders of the plain version at chain 32, dim 1536).
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vittf_tpu_torch.ops.chain_gemm import (
    MODES,
    chain_gemm,
    chain_gemm_plain,
    kernel_tile,
    wrap_int8,
)
from vittf_tpu_torch.scripts import bench_int8_gemm as port_probe

REPO = Path(__file__).resolve().parents[1]
ROWS, DIM = 64, 128


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_int8_gemm", REPO / "scripts" / "bench_int8_gemm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_chain(probe, x, w, chain, mode):
    body = {"bf16": probe._bf16_kernel, "int8+requant": probe._int8_kernel,
            "int8+shift": probe._int8_noquant_kernel}[mode]
    with pltpu.force_tpu_interpret_mode():
        f = pl.pallas_call(
            functools.partial(body, chain=chain),
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )
        return np.asarray(f(x, w).astype(jnp.float32))


def _int_inputs(seed):
    """int8 operands with the bit-defined corners: row 0 of x is zero (row
    max 0: the 1e-6 floor); row 1 is a single 1 against a W row that holds
    ±127, so its scale is exactly 1 and the step is the identity; row 2 is
    all 127 against a W column of 8, so (y >> 8) leaves int8 and must wrap."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (ROWS, DIM)).astype(np.int8)
    w = rng.integers(-8, 9, (DIM, DIM)).astype(np.int8)
    x[0] = 0
    x[1] = 0
    x[1, 0] = 1
    w[0] = rng.integers(-127, 128, DIM)
    w[0, :2] = [127, -127]
    x[2] = 127
    w[:, 5] = 8
    return x, w


@pytest.mark.parametrize("chain", [1, 4, 32])
@pytest.mark.parametrize("mode", ["int8+requant", "int8+shift"])
def test_int8_modes_bit_equal_jax(jax_probe, mode, chain):
    x, w = _int_inputs(chain)
    want = _jax_chain(jax_probe, jnp.asarray(x), jnp.asarray(w), chain, mode)
    got = chain_gemm(torch.from_numpy(x), torch.from_numpy(w), chain, mode)
    assert got.dtype == torch.int8 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
    if chain == 1:
        y = x.astype(np.int64) @ w.astype(np.int64)
        if mode == "int8+requant":
            assert not got[0].any()  # the zero row stays zero
            assert np.abs(y[1]).max() == 127  # scale exactly 1: identity row
        else:
            assert np.abs(y[2] >> 8).max() > 127  # the wrap is exercised
            np.testing.assert_array_equal(got.numpy(), (y >> 8).astype(np.int8))


def test_requant_rounds_half_to_even(jax_probe):
    """Products that scale to exactly 0.5, 2.5, 4.5: ``round`` takes the even
    neighbour (0, 2, 4), where C's ``roundf`` would give 1, 3, 5. Row 0 is
    zero: its max is 0, the 1e-6 floor makes the scale 1.27e8, the result 0.
    Held against the Pallas body on the same operands and against the
    numbers written out."""
    x = np.zeros((8, DIM), np.int8)
    w = np.zeros((DIM, DIM), np.int8)
    x[1, 0], x[1, 1] = 2, 1
    w[0, 0] = 127  # y[1, 0] = 254: the row max, scale exactly 0.5
    w[1, :6] = [0, 1, 5, 9, -1, -5]
    want = _jax_chain(jax_probe, jnp.asarray(x), jnp.asarray(w), 1, "int8+requant")
    got = chain_gemm_plain(torch.from_numpy(x), torch.from_numpy(w), 1, "int8+requant").numpy()
    np.testing.assert_array_equal(want[1, :6], [127, 0, 2, 4, 0, -2])
    np.testing.assert_array_equal(got.astype(np.float32), want)
    np.testing.assert_array_equal(got[1, :6], [127, 0, 2, 4, 0, -2])
    assert not got[0].any()


@pytest.mark.parametrize("chain", [1, 4, 32])
def test_bf16_mode_matches_jax(jax_probe, chain):
    rng = np.random.default_rng(chain)
    x = jnp.asarray(rng.standard_normal((ROWS, DIM)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((DIM, DIM)) / np.sqrt(DIM), jnp.bfloat16)
    want = _jax_chain(jax_probe, x, w, chain, "bf16")
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    wt = torch.from_numpy(np.asarray(w.astype(jnp.float32))).to(torch.bfloat16)
    got = chain_gemm(xt, wt, chain, "bf16")
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    if chain == 1:  # one bf16 step
        assert (err <= 2.0**-7 * np.abs(want) + 1e-3).all(), err.max()
    else:
        assert err.max() <= 0.03 * np.abs(want).max(), (err.max(), np.abs(want).max())


@pytest.mark.parametrize("rows", [1, 127, 129])
@pytest.mark.parametrize("mode", MODES)
def test_ragged_rows_chain_2_match_jax(jax_probe, mode, rows):
    """Row counts on both sides of the kernel's 128-row block, two steps (both
    ping-pong buffers): the plain version against the Pallas body."""
    rng = np.random.default_rng(rows)
    if mode == "bf16":
        x = jnp.asarray(rng.standard_normal((rows, DIM)), jnp.bfloat16)
        w = jnp.asarray(rng.standard_normal((DIM, DIM)) / np.sqrt(DIM), jnp.bfloat16)
        xt, wt = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (x, w))
    else:
        xn = rng.integers(-127, 128, (rows, DIM)).astype(np.int8)
        wn = rng.integers(-8, 9, (DIM, DIM)).astype(np.int8)
        x, w, xt, wt = jnp.asarray(xn), jnp.asarray(wn), torch.from_numpy(xn), torch.from_numpy(wn)
    want = _jax_chain(jax_probe, x, w, 2, mode)
    got = chain_gemm(xt, wt, 2, mode).float().numpy()
    assert got.shape == (rows, DIM)
    if mode == "bf16":
        assert np.abs(got - want).max() <= 0.03 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


def _cluster_requant_model(x, w, chain, bn):
    """The CUDA kernel's int8+requant step in numpy: a row block's columns are
    ``dim / bn`` tiles, one thread block each; a block takes max|y| over its
    own ``bn`` columns per row, the blocks of the cluster read each other's
    partial maxima, and each quantises its own tile with scale = 127 /
    max(m, 1e-6) in IEEE fp32, rounding half to even, keeping the low 8 bits."""
    x = x.astype(np.int64)
    n_tiles = w.shape[1] // bn
    for _ in range(chain):
        y = x @ w.astype(np.int64)
        partial = np.stack([np.abs(y[:, t * bn:(t + 1) * bn]).max(1) for t in range(n_tiles)])
        row_max = partial.max(0).astype(np.float32)  # an integer max has no order
        scale = np.float32(127.0) / np.maximum(row_max, np.float32(1e-6))
        out = np.empty_like(y)
        for t in range(n_tiles):
            tile = y[:, t * bn:(t + 1) * bn].astype(np.float32)
            out[:, t * bn:(t + 1) * bn] = np.rint(tile * scale[:, None]).astype(np.int64)
        x = ((out + 128) & 255) - 128
    return x.astype(np.int8)


@pytest.mark.parametrize("dim,chain", [(128, 3), (384, 3), (1536, 2)])
def test_cluster_requant_model_bit_equal_to_plain(dim, chain):
    bn = kernel_tile(dim)
    assert dim // bn in (1, 2, 8)
    rng = np.random.default_rng(dim)
    x = rng.integers(-127, 128, (37, dim)).astype(np.int8)
    w = rng.integers(-8, 9, (dim, dim)).astype(np.int8)
    x[0] = 0  # the 1e-6 floor
    x[1] = 0
    x[1, 0], x[1, 1] = 2, 1  # scale exactly 0.5: ties
    w[0], w[1] = 0, 0
    w[0, 0] = 127
    w[1, :6] = [0, 1, 5, 9, -1, -5]
    want = chain_gemm_plain(torch.from_numpy(x), torch.from_numpy(w), chain, "int8+requant").numpy()
    np.testing.assert_array_equal(_cluster_requant_model(x, w, chain, bn), want)
    if chain:
        first = _cluster_requant_model(x, w, 1, bn)
        np.testing.assert_array_equal(first[1, :6], [127, 0, 2, 4, 0, -2])


@pytest.mark.parametrize("dim,tile", [
    (128, 128), (256, 128), (384, 192), (512, 128), (768, 192), (1024, 128), (1536, 192),
    (0, 0), (64, 0), (192, 0), (200, 0), (640, 0), (1152, 0), (1280, 0), (2048, 0), (3072, 0),
])
def test_kernel_tile_widths_and_refusals(dim, tile):
    """The kernel's column tiles: 192 where it divides, else 128, and a row
    block's tiles are a thread block cluster of 1, 2, 4 or 8; other dims are
    refused by the CUDA wrapper (the plain version takes any)."""
    assert kernel_tile(dim) == tile
    if tile:
        assert dim % tile == 0 and dim // tile in (1, 2, 4, 8)


def test_wrap_int8_keeps_low_bits():
    v = torch.tensor([-32768, -129, -128, -1, 0, 127, 128, 255, 256, 32767], dtype=torch.int32)
    np.testing.assert_array_equal(wrap_int8(v).numpy(), v.numpy().astype(np.int8))


@pytest.mark.parametrize("mode", MODES)
def test_chain_zero_and_bad_inputs(mode):
    dt = torch.bfloat16 if mode == "bf16" else torch.int8
    x, w = torch.ones((4, DIM), dtype=dt), torch.ones((DIM, DIM), dtype=dt)
    assert torch.equal(chain_gemm(x, w, 0, mode), x)
    with pytest.raises(ValueError, match="takes"):
        chain_gemm(x.float(), w, 1, mode)
    with pytest.raises(ValueError, match="square"):
        chain_gemm(x, w[:, :64], 1, mode)
    with pytest.raises(ValueError, match="unknown mode"):
        chain_gemm(x, w, 1, "fp8")


def test_probe_inputs_are_the_jax_probes_draws():
    """``make_inputs`` draws from ``default_rng(0)`` in the JAX probe's order
    and rounds to bf16 as ``jnp.asarray(..., bfloat16)`` does."""
    rng = np.random.default_rng(0)
    xb = jnp.asarray(rng.standard_normal((ROWS, DIM)), jnp.bfloat16)
    wb = jnp.asarray(rng.standard_normal((DIM, DIM)) / np.sqrt(DIM), jnp.bfloat16)
    xi = rng.integers(-127, 128, (ROWS, DIM)).astype(np.int8)
    wi = rng.integers(-8, 9, (DIM, DIM)).astype(np.int8)
    got = port_probe.make_inputs(ROWS, DIM, "cpu")
    np.testing.assert_array_equal(got["bf16"][0].float().numpy(), np.asarray(xb.astype(jnp.float32)))
    np.testing.assert_array_equal(got["bf16"][1].float().numpy(), np.asarray(wb.astype(jnp.float32)))
    np.testing.assert_array_equal(got["int8+requant"][0].numpy(), xi)
    np.testing.assert_array_equal(got["int8+shift"][1].numpy(), wi)


def test_probe_main_prints_its_five_lines(capsys):
    assert port_probe.main(["--cpu", "--rows", "32", "--dim", "128", "--chain", "2",
                            "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5
    assert [ln.split(":")[0].strip() for ln in lines[:3]] == list(MODES)
    assert all("ms" in ln and "Tops/s" in ln for ln in lines[:3])
    assert lines[3].startswith("speedup int8+requant vs bf16:") and lines[3].endswith("x")
    assert lines[4].startswith("speedup int8+shift   vs bf16:") and lines[4].endswith("x")


def test_probe_requires_cuda_without_cpu_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_probe.main(["--rows", "32", "--dim", "128", "--chain", "1", "--iters", "1"])


def test_bf16_two_accumulation_orders_stay_inside_the_limit():
    """Two fp32 accumulation orders of the plain bf16 chain (one product over
    K; two half-K products summed) move apart, and by less than the 0.03
    share that the kernel is held to."""
    x, w = port_probe.make_inputs(ROWS, DIM, "cpu")["bf16"]
    wf, half = w.float(), DIM // 2
    a = b = x
    for _ in range(32):
        a = (a.float() @ wf).to(torch.bfloat16)
        bf = b.float()
        b = (bf[:, :half] @ wf[:half] + bf[:, half:] @ wf[half:]).to(torch.bfloat16)
    assert torch.equal(a, chain_gemm_plain(x, w, 32, "bf16"))
    share = ((a.float() - b.float()).abs().max() / a.float().abs().max()).item()
    assert 0 < share <= 0.03, share
