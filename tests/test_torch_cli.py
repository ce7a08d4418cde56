"""aerobulk_tpu_torch.cli against aerobulk_tpu.cli with the same arguments,
fp64 on the CPU (``--device cpu``).

Tolerances: the JSON curves and the written series at rtol 1e-12, with
atol 1e-12 * max|ref| for the fields that cross zero (QH, QL, Evap, Tau_x,
psi); the printed tables as parsed numbers, each within one unit of its
last printed digit, the text around them equal.  The ``series``
subcommand is held in tests/test_torch_cli_series.py.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from aerobulk_tpu import cli as jcli
from aerobulk_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parent.parent
_NUMBER = re.compile(r"-?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?")
# README.md's toy table, niter=20: coare3p0, coare3p6, ncar, ecmwf, andreas
# (tests/test_tools.py::test_cli_toy_bare_subprocess_defaults_to_cpu_fp64)
CD_ROW = [1.1952, 1.0773, 1.2037, 1.2861, 1.0166]


def _unit(token):
    """One unit of the last printed digit of a number token."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (-decimals + (int(exp) if exp else 0))


def assert_same_table(got, ref):
    """Equal text, and every printed number within one unit of the last
    digit printed."""
    assert _NUMBER.sub("#", got) == _NUMBER.sub("#", ref)
    g, r = _NUMBER.findall(got), _NUMBER.findall(ref)
    assert len(g) == len(r) and g
    for a, b in zip(g, r):
        assert abs(float(a) - float(b)) <= _unit(b) * (1 + 1e-9), (a, b)


def _printed(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def assert_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    atol = 1e-12 * np.max(np.abs(ref)) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("extra", [[], ["--neutral"], ["--hum-rh", "75"],
                                   ["--hum-dp", "15"]],
                         ids=["plain", "neutral", "hum_rh", "hum_dp"])
def test_toy_matches_jax(extra, capsys):
    argv = ["toy", "--sst", "22", "--t", "20", "--q", "12", "--wind", "5",
            *extra]
    ref = _printed(jcli.main, argv, capsys)
    got = _printed(tcli.main, ["--device", "cpu", *argv], capsys)
    assert_same_table(got, ref)


@pytest.mark.parametrize("cmd", ["ice-toy", "oce-ice-toy"])
def test_ice_toys_match_jax(cmd, capsys):
    ref = _printed(jcli.main, [cmd], capsys)
    got = _printed(tcli.main, ["--device", "cpu", cmd], capsys)
    assert_same_table(got, ref)


def _curves(tmp_path, argv):
    out = {}
    for tag, main, pre in (("jax", jcli.main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        path = tmp_path / f"{tag}.json"
        main([*pre, *argv, "--out", str(path)])
        out[tag] = json.loads(path.read_text())
    return out["torch"], out["jax"]


def _assert_tree(got, ref, what=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            _assert_tree(got[k], ref[k], f"{what}/{k}")
    else:
        assert_close(got, ref, what)


@pytest.mark.parametrize("argv", [
    ["cdnf", "--n", "21"],
    ["cx-vs-wind", "--algos", "coare3p6,ncar", "--dtheta=-2,2"],
    ["coef-n10", "--algos", "coare3p0,coare3p6,ncar,ecmwf,andreas"],
    ["psi-stab"]], ids=lambda a: a[0])
def test_curve_files_match_jax(argv, tmp_path):
    got, ref = _curves(tmp_path, argv)
    _assert_tree(got, ref)


def _run_cli(*argv, env=None):
    return subprocess.run(
        [sys.executable, "-m", "aerobulk_tpu_torch.cli", *argv],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


def test_bare_cli_without_gpu_names_the_cpu_option():
    """In a process that sees no GPU the CLI computes nowhere by default:
    it exits non-zero and names --device cpu."""
    r = _run_cli("toy", env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "--device cpu" in r.stderr


def test_bare_cli_on_cpu_reproduces_the_readme_row():
    r = _run_cli("--device", "cpu", "toy", "--sst", "22", "--t", "20",
                 "--q", "12", "--wind", "5")
    assert r.returncode == 0, r.stderr[-2000:]
    cd_line = next(ln for ln in r.stdout.splitlines()
                   if ln.strip().startswith("C_D "))
    row = cd_line.strip().removeprefix("C_D").rsplit("[", 1)[0]
    np.testing.assert_allclose([float(v) for v in row.split("|")], CD_ROW,
                               atol=2e-4)
