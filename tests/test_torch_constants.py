"""The port's constants against aerobulk_tpu.constants, and the constants
written into the CUDA source against the port's."""

import math
import re
from pathlib import Path

import pytest

from aerobulk_tpu import constants as jc
from aerobulk_tpu_torch import constants as tc
from aerobulk_tpu_torch import skin
from aerobulk_tpu_torch.algos import andreas, ecmwf

PUBLIC = sorted(n for n, v in vars(jc).items()
                if not n.startswith("_") and isinstance(v, (int, float)))


def test_public_names_cover_reference():
    assert len(PUBLIC) > 50


@pytest.mark.parametrize("name", PUBLIC)
def test_constant_matches_reference(name):
    # exact: the constants are Python floats computed the same way
    assert getattr(tc, name) == getattr(jc, name)


_CSRC = Path(tc.__file__).parent / "kernels" / "csrc"
# literals that are not constants.py names, with their Python definitions
_DERIVED = {
    "rCp0_w_pow15": tc.rCp0_w ** 1.5,
    "LOG2_10": math.log2(10.0),
    "c_b": 0.004 * 600.0 * 1.2 ** 3,
    "HWL_MAX": skin.HWL_MAX,
    "RICH0": skin.RICH0,
    # algos_point.cuh: ECMWF, Andreas and the Andreas psi functions
    "CHARN0_ECMWF": ecmwf.CHARN0_ECMWF,
    "RRI_MAX": andreas._RRI_MAX,
    "RCS_MIN": andreas._RCS_MIN,
    "SQRT_CX_MIN": math.sqrt(tc.Cx_min),
    "SQRT3": math.sqrt(3.0),
    "SQRT5": math.sqrt(5.0),
    "BBM": abs((1.0 - 5.0 / 6.5) / (5.0 / 6.5)) ** (1.0 / 3.0),
    "ATAN_BBM": math.atan(
        (2.0 - abs((1.0 - 5.0 / 6.5) / (5.0 / 6.5)) ** (1.0 / 3.0))
        / (math.sqrt(3.0)
           * abs((1.0 - 5.0 / 6.5) / (5.0 / 6.5)) ** (1.0 / 3.0))),
    "LOG_BBH": math.log(abs((3.0 - math.sqrt(5.0)) / (3.0 + math.sqrt(5.0)))),
}


def test_cuda_source_literals_match_python():
    """Every ``constexpr double NAME = <literal>;`` in the kernel sources is
    the Python value of NAME, to the last bit."""
    text = "".join(p.read_text() for p in sorted(_CSRC.glob("*.cu*")))
    found = re.findall(r"constexpr double (\w+) = ([-+0-9.eE]+);", text)
    assert len(found) >= 25
    for name, literal in found:
        want = _DERIVED[name] if name in _DERIVED else getattr(tc, name)
        assert float(literal) == want, name
