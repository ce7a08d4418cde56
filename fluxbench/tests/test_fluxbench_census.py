"""The benchmark's frozen census (fluxbench/census/*.json) against the
program's: the operations per point by class against
``aerobulk_tpu_torch.roofline.CENSUS`` (the JAX graph's count, niter=5) and
the port's own count (``roofline.flux_step_counts``), the bytes per point
against the kernels' argument lists."""

import json

import pytest

from aerobulk_tpu_torch import roofline
from aerobulk_tpu_torch.kernels import fused
from fluxbench.run import HERE

TRANS = ("exp", "log", "pow", "sqrt", "div", "atan")
FILES = sorted((HERE / "census").glob("*.json"))
#: the census key of each kernel and algorithm
KEYS = {("kernel1", "coare3p6"): "skin_coare3p6",
        ("kernel1", "ecmwf"): "skin_ecmwf",
        ("kernel2", "coare3p6"): "grad_skin_coare3p6",
        ("kernel2", "ecmwf"): "grad_skin_ecmwf"}


def _load(path):
    return json.loads(path.read_text())


def test_every_kernel_of_the_configs_has_a_census():
    found = {(c["kernel"], c["algo"]) for c in map(_load, FILES)}
    assert found == set(KEYS)
    for path in FILES:
        c = _load(path)
        assert path.name == f"{c['kernel']}.{c['algo']}.niter{c['niter']}.json"


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_ops_match_the_programs_census(path):
    c = _load(path)
    want = roofline.CENSUS[KEYS[c["kernel"], c["algo"]]]
    assert c["niter"] == 5 and c["dtype"] == "float32"
    assert c["ops_by_class"] == dict(want)
    assert c["ops_per_point"] == sum(want.values())


@pytest.mark.parametrize("algo", ("coare3p6", "ecmwf"))
def test_forward_census_matches_the_ports_own_count(algo):
    """The port's count of its eager step agrees class by class in the
    transcendentals and within 10% in the cheap ops (the packages write
    their cheap ops differently: tests/test_torch_census.py)."""
    c = _load(HERE / "census" / f"kernel1.{algo}.niter5.json")
    port = roofline.flux_step_counts(algo=algo, niter=5)
    for k in TRANS:
        assert c["ops_by_class"].get(k, 0) == port.get(k, 0), k
    assert abs(c["ops_by_class"]["cheap"] - port["cheap"]) \
        <= 0.1 * c["ops_by_class"]["cheap"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_bytes_are_the_kernels_arguments(path):
    c = _load(path)
    n_in, n_out = len(fused._INPUTS), len(fused._OUTPUTS)
    if c["kernel"] == "kernel1":
        fields = (n_in, n_out)                    # 13 fields in, 10 out
        assert c["trace_name"] == "fused_step_kernel"
    else:
        fields = (n_in + n_out, n_in)             # + 10 cotangents; 13 grads
        assert c["trace_name"] == "fused_grad_kernel"
    assert (c["fields_in"], c["fields_out"]) == fields
    assert c["bytes_per_point"] == 4 * sum(fields)
