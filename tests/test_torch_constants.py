"""The port's constants against aerobulk_tpu.constants, and the constants
written into the CUDA source against the port's."""

import math
import re
from pathlib import Path

import pytest

from aerobulk_tpu import constants as jc
from aerobulk_tpu_torch import constants as tc
from aerobulk_tpu_torch import skin
from aerobulk_tpu_torch import thermo
from aerobulk_tpu_torch.algos import andreas, ecmwf
from aerobulk_tpu_torch.ice import best, form_drag, lg15

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
    # flux_point.cuh: the ECMWF warm layer (skin.wl_ecmwf, La = 0.3)
    "RNUWL0": skin._RNUWL0,
    "FLA_ECMWF": max(0.3 ** (-2.0 / 3.0), 1.0),
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
    # ice_point.cuh: the ice branch of thermo, Louis-79, form drag, LG15, BEST
    "RAG_I": thermo._rAg_i,
    "RBG_I": thermo._rBg_i,
    "RCG_I": thermo._rCg_i,
    "RDG_I": thermo._rDg_i,
    "RC3_LOUIS": 3.0 * thermo._rc2_louis,
    "RAM_LOUIS": thermo._ram_louis,
    "RAH_LOUIS": thermo._rah_louis,
    "RCE_0": form_drag._RCE_0,
    "LU13_COEF": form_drag._RNU_0 + 1.0 / (10.0 * form_drag._RBETA_0),
    "RCE10_I_0": form_drag._RCE10_I_0,
    "RBETA_0": form_drag._RBETA_0,
    "RALPHA_0": lg15.RALPHA_0,
    "RZ0_I_S_0": lg15.RZ0_I_S_0,
    "RZ0_I_F_0": lg15.RZ0_I_F_0,
    "RZ0_W_0": lg15.RZ0_W_0,
    "LG15_CHF": math.log(1.0 / lg15.RALPHA_0) / tc.vkarmn,
    "Z0_ICE_BEST": best._Z0_ICE,
    "Z1_ALPHA_BEST": best._Z1_ALPHA,
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


def test_ice_constants_shared_by_the_kernel():
    """ice_point.cuh uses one skin roughness for LG15, LU12 and BEST, and
    the MIZ RZ0_W_0 of the form-drag module for LG15_IO's water side; the
    Louis exponents of LU13 are 1 and 0."""
    from aerobulk_tpu_torch.ice import lu12
    assert best._Z0_SKIN_ICE == lu12.RZ0_I_S_0 == lg15.RZ0_I_S_0
    assert lg15.RZ0_W_0 == form_drag._RZ0_W_0
    assert form_drag._RMU_0 - 1.0 == 0.0 and best._Z1_ALPHAF == best._Z1_ALPHA
