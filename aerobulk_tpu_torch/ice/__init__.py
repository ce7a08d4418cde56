"""Sea-ice bulk-algorithm family on tensors, with the names and flags of
``aerobulk_tpu.ice.ICE_ALGOS``.

``needs_frice`` marks algorithms that take the sea-ice concentration.
"""

from .an05 import rough_leng_m, rough_leng_tq, turb_ice_an05
from .best import cx_lupkes2015, turb_ice_best
from .easy import turb_ice_easy
from .form_drag import (cdn10_f_lu12, cdn10_f_lu13, cdn_f_lg15,
                        cdn_f_lg15_light, cdn_f_lu12_eq36)
from .lg15 import turb_ice_lg15, turb_ice_lg15_io, turb_ice_lg15_io_ice
from .lu12 import turb_ice_lu12
from .nemo import turb_ice_nemo

#: name -> (function, needs_frice)
ICE_ALGOS = {
    "ice_nemo": (turb_ice_nemo, False),
    "ice_easy": (turb_ice_easy, False),
    "ice_an05": (turb_ice_an05, False),
    "ice_lu12": (turb_ice_lu12, True),
    "ice_lg15": (turb_ice_lg15, True),
    "ice_lg15_io": (turb_ice_lg15_io_ice, True),
    "ice_best": (turb_ice_best, False),
}

__all__ = [
    "ICE_ALGOS", "cdn10_f_lu12", "cdn10_f_lu13", "cdn_f_lg15",
    "cdn_f_lg15_light", "cdn_f_lu12_eq36", "cx_lupkes2015", "rough_leng_m",
    "rough_leng_tq", "turb_ice_an05", "turb_ice_best", "turb_ice_easy",
    "turb_ice_lg15", "turb_ice_lg15_io", "turb_ice_lg15_io_ice",
    "turb_ice_lu12", "turb_ice_nemo",
]
