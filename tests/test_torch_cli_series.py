"""The ``series`` subcommand of aerobulk_tpu_torch.cli against
aerobulk_tpu.cli's with the same arguments, fp64 on the CPU (``--device
cpu``), compared as the written files: every column at rtol 1e-12 with
atol 1e-12 * max|ref| (tests/test_torch_cli.py's ``assert_close``).
``--chunk 5`` over 12 records (a ragged final chunk) equals the resident
run at rtol 1e-12, and ``--backend fused`` on the CPU refuses to run.
"""

import numpy as np
import pytest

from aerobulk_tpu import cli as jcli
from aerobulk_tpu import io as jio
from aerobulk_tpu_torch import cli as tcli
from aerobulk_tpu_torch import io as tio
from test_torch_cli import assert_close

NT = 12


def _ocean_forcing(path):
    h = np.arange(NT)
    rng = np.random.default_rng(12)
    np.savez(path, sst=np.full(NT, 295.0), t_air=294.0 + rng.random(NT),
             q_air=np.full(NT, 0.013), wndspd=4.0 + 0.3 * h,
             msl=np.full(NT, 101000.0),
             ssrd=np.maximum(0, 500 * np.sin(h / 24 * 2 * np.pi)),
             strd=np.full(NT, 400.0), time=h * 3600.0)
    return str(path)


def _series(tmp_path, forcing, argv, tag):
    out = str(tmp_path / f"{tag}.nc")
    main = jcli.main if tag.startswith("jax") else tcli.main
    pre = [] if tag.startswith("jax") else ["--device", "cpu"]
    main([*pre, "series", forcing, *argv, "--out", out])
    return (jio if tag.startswith("jax") else tio).read_forcing(out)


def _assert_series(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k], ref[k], k)


@pytest.mark.parametrize("skin", [False, True], ids=["bulk", "skin"])
def test_series_matches_jax(skin, tmp_path):
    forcing = _ocean_forcing(tmp_path / "forcing.npz")
    argv = ["--algo", "coare3p6", "--niter", "6"] + (["--skin"] if skin
                                                     else [])
    _assert_series(_series(tmp_path, forcing, argv, "torch"),
                   _series(tmp_path, forcing, argv, "jax"))


def test_series_chunked_equals_resident(tmp_path):
    forcing = _ocean_forcing(tmp_path / "forcing.npz")
    argv = ["--algo", "coare3p6", "--skin", "--niter", "6"]
    resident = _series(tmp_path, forcing, argv, "torch")
    chunked = _series(tmp_path, forcing, [*argv, "--chunk", "5"],
                      "torch_chunked")
    assert set(chunked) == set(resident)
    for k in resident:
        np.testing.assert_allclose(chunked[k], resident[k], rtol=1e-12,
                                   err_msg=k)


def test_ice_series_matches_jax(tmp_path):
    forcing = str(tmp_path / "ice_forcing.npz")
    np.savez(forcing, sst=np.full(8, 258.0), t_air=np.full(8, 255.0),
             q_air=np.full(8, 0.0008), wndspd=np.linspace(3, 10, 8),
             msl=np.full(8, 100000.0), frice=np.full(8, 0.85),
             time=np.arange(8) * 3600.0)
    argv = ["--algo", "ice_lg15", "--niter", "5"]
    _assert_series(_series(tmp_path, forcing, argv, "torch"),
                   _series(tmp_path, forcing, argv, "jax"))


def test_series_fused_on_cpu_refuses(tmp_path):
    """Kernel 1 has no CPU route: the CLI exits instead of running the
    plain version."""
    forcing = _ocean_forcing(tmp_path / "forcing.npz")
    with pytest.raises(SystemExit, match="no CPU route"):
        tcli.main(["--device", "cpu", "series", forcing, "--skin",
                   "--backend", "fused", "--out", str(tmp_path / "x.nc")])
    assert not (tmp_path / "x.nc").exists()
