"""Port parity: vittf_tpu_torch.core.synthetic and cli.synth vs vittf_tpu.

Noise-free SDF fixtures and the multi-class phantom equal the JAX twin bit
for bit (the phantom with its noise too: both draw it from
``np.random.default_rng(seed)``); the hard phantom's bias field takes torch's
``cos``, which may differ from numpy's by an ulp, so its volume is held at
1e-6 and its labels exactly. The SDF fixtures' noise is numpy's in the port
(threefry bits in JAX): held to its range, clip and moments.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vittf_tpu.core import synthetic as js
from vittf_tpu_torch.cli import synth
from vittf_tpu_torch.core import synthetic as ts

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("size", [16, 33, 48])
def test_sdf_fixtures_equal_jax_without_noise(size):
    want = js.make_synthetic_volumes(size, 0.0)
    got = ts.make_synthetic_volumes(size, 0.0, device="cpu")
    assert list(got) == list(want)
    for name, (vol, lab) in want.items():
        assert got[name][0].dtype == torch.float16 and got[name][1].dtype == torch.uint8
        np.testing.assert_array_equal(got[name][0].numpy(), vol)
        np.testing.assert_array_equal(got[name][1].numpy(), lab)


@pytest.mark.parametrize("noise", [0.0, 0.05])
@pytest.mark.parametrize("size", [24, 37])
def test_multiclass_volume_equals_jax(size, noise):
    vol, lab = js.make_multiclass_volume(size, noise, seed=3)
    got_v, got_l = ts.make_multiclass_volume(size, noise, seed=3, device="cpu")
    np.testing.assert_array_equal(got_v.numpy(), vol)
    np.testing.assert_array_equal(got_l.numpy(), lab)
    assert set(np.unique(lab)) == {0, 1, 2, 3}


@pytest.mark.parametrize("noise,bias", [(0.0, 0.12), (0.05, 0.12), (0.05, 0.0)])
def test_hard_phantom_matches_jax(noise, bias):
    """Volume at 1e-6 (cos to an ulp), labels exact, noise numpy's own."""
    vol, lab = js.make_hard_phantom(32, noise, seed=5, bias=bias)
    got_v, got_l = ts.make_hard_phantom(32, noise, seed=5, bias=bias, device="cpu")
    np.testing.assert_allclose(got_v.numpy(), vol, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_l.numpy(), lab)
    assert set(np.unique(lab)) == {0, 1, 2, 3, 4, 5}


def test_sdf_fixture_noise_statistics():
    """U[0, noise) added, then clipped to [0, 1]: background voxels (0) carry
    the noise itself, foreground ones (1) stay 1; a seed repeats, another
    seed differs."""
    noise, size = 0.2, 40
    clean = ts.make_synthetic_volumes(size, 0.0, device="cpu")
    noisy = ts.make_synthetic_volumes(size, noise, seed=1, device="cpu")
    for name, (vol, lab) in noisy.items():
        v = vol.float().numpy()
        bg = clean[name][0].numpy() == 0
        assert np.array_equal(lab.numpy(), clean[name][1].numpy())
        assert v.min() >= 0.0 and v.max() <= 1.0
        assert np.all(v[~bg] == 1.0)
        u = v[bg] / noise
        assert u.min() >= 0.0 and u.max() <= 1.0
        # U[0, 1) moments over ~60k voxels: mean 1/2, variance 1/12
        assert abs(u.mean() - 0.5) < 0.01 and abs(u.var() - 1 / 12) < 0.005
    again = ts.make_synthetic_volumes(size, noise, seed=1, device="cpu")
    other = ts.make_synthetic_volumes(size, noise, seed=2, device="cpu")
    assert torch.equal(again["sphere_thick"][0], noisy["sphere_thick"][0])
    assert not torch.equal(other["sphere_thick"][0], noisy["sphere_thick"][0])


def test_synth_cli_writes_the_jax_files(tmp_path):
    assert synth.main([str(tmp_path / "port"), "--size", "20", "--cpu"]) == 0
    js.write_synthetic_volumes(tmp_path / "jax", size=20)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 8
    for n in names:
        a, b = np.load(tmp_path / "jax" / n), np.load(tmp_path / "port" / n)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert synth.main([str(tmp_path / "pt"), "--size", "8", "--torch", "--cpu"]) == 0
    assert torch.load(tmp_path / "pt" / "torus_filled_label.pt").dtype == torch.uint8


def test_synth_cli_needs_a_card_without_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth.main([str(tmp_path / "x"), "--size", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.make_multiclass_volume(8)
    assert not (tmp_path / "x").exists()
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "-m", "vittf_tpu_torch.cli.synth", str(tmp_path / "y"),
                          "--size", "8"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not (tmp_path / "y").exists()
