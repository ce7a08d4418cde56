"""Physical constants and reference ranges for aerobulk_tpu_torch.

The same values as ``aerobulk_tpu.constants`` (which mirrors the reference
``src/mod_const.f90``): e.g. grav = 9.8 (not 9.80665), and the Goff
saturation-vapour formula uses rt0 = 273.15 (``mod_const.f90:38``,
``mod_phymbl.f90:793``).

All constants are plain Python floats.  PyTorch casts a Python scalar to
the dtype of the tensor it combines with, so they follow the tensors: fp64
for validation runs, fp32 for speed runs.
"""

import math

# --- general -------------------------------------------------------------
grav = 9.8                      # gravity [m/s^2]                (mod_const.f90:38)
rpi = math.pi
to_rad = rpi / 180.0

# --- Earth / radiation ---------------------------------------------------
R_earth = 6.37e6                # Earth radius [m]
rtilt_earth = 23.5
Sol0 = 1366.0                   # solar constant [W/m^2]
roce_alb0 = 0.066               # default ocean surface albedo   (mod_const.f90:49)
rice_alb0 = 0.8                 # default ice albedo

emiss_w = 0.98                  # LW emissivity of sea water     (mod_const.f90:55)
emiss_i = 0.996                 # LW emissivity of ice/snow
stefan = 5.67e-8                # Stefan-Boltzmann [W/m^2/K^4]

# --- water ---------------------------------------------------------------
rt0 = 273.15                    # freezing point of fresh water [K]
rtt0 = 273.16                   # triple point [K]
rCp0_w = 4190.0                 # specific heat capacity of seawater [J/K/kg]
rho0_w = 1025.0                 # density of sea water [kg/m^3]
rnu0_w = 1.0e-6                 # kinematic viscosity of water [m^2/s]
rk0_w = 0.6                     # thermal conductivity of water [W/m/K]

# --- air -----------------------------------------------------------------
rCp0_a = 1015.0                 # specific heat of moist air [J/K/kg]
rCp_dry = 1005.0                # specific heat of dry air [J/K/kg]
rCp_vap = 1860.0                # specific heat of water vapour [J/K/kg]
R_dry = 287.05                  # gas constant, dry air [J/K/kg]
R_vap = 461.495                 # gas constant, water vapour [J/K/kg]
R_gas = 8.314510                # universal molar gas constant [J/mol/K]
rmm_dryair = 28.9647e-3         # dry-air molar mass [kg/mol]
rmm_water = 18.0153e-3          # water molar mass [kg/mol]
rmm_ratio = rmm_water / rmm_dryair

rpoiss_dry = R_dry / rCp_dry    # Poisson constant for dry air
rgamma_dry = grav / rCp_dry     # dry adiabatic lapse rate [K/m]

reps0 = R_dry / R_vap           # ~0.622
rctv0 = R_vap / R_dry - 1.0     # ~0.608, virtual-temperature factor

rnu0_air = 1.5e-5               # kinematic viscosity of air [m^2/s]
rLevap = 2.46e6                 # latent heat of vaporization, sea water [J/kg]
rLsub = 2.834e6                 # latent heat of sublimation, ice [J/kg]

Patm = 101000.0                 # reference sea-level pressure [Pa]
rho0_a = 1.2                    # reference air density [kg/m^3]

# --- bulk model ----------------------------------------------------------
vkarmn = 0.4                    # von Karman constant
vkarmn2 = vkarmn * vkarmn
rdct_qsat_salt = 0.98           # salinity reduction factor on q_sat(SST)
z0_sea_max = 0.0025             # max realistic sea-surface roughness [m]

# cool-skin constant: -16 g rho_w cp_w nu_w^3 / k_w^2, Fairall et al. 1996
# eq.(14).  NB: uses g = 9.80665 here, exactly as mod_const.f90:109 does.
rcst_cs = -16.0 * 9.80665 * rho0_w * rCp0_w * rnu0_w ** 3 / (rk0_w * rk0_w)

radrw = rho0_a / rho0_w         # air/water density ratio
sq_radrw = math.sqrt(rho0_a / rho0_w)

Cx_min = 0.1e-3                 # floor for bulk transfer coefficients

# --- sea ice -------------------------------------------------------------
rCd_ice = 1.4e-3                # constant transfer coefficient over ice
to_mm_p_day = 24.0 * 3600.0     # kg/m^2/s -> mm/day
wspd_thrshld_ice = 0.2          # min scalar wind speed over ice [m/s]

# --- sanity-check ranges (AEROBULK_INIT masking, mod_const.f90:138-149) ---
ref_sst_min, ref_sst_max = 270.0, 320.0      # SST [K]
ref_taa_min, ref_taa_max = 180.0, 330.0      # absolute air temp [K]
ref_sha_min, ref_sha_max = 0.0, 0.08         # specific humidity [kg/kg]
ref_dpt_min, ref_dpt_max = 150.0, 330.0      # dew-point temp [K]
ref_rlh_min, ref_rlh_max = 0.0, 100.0        # relative humidity [%]
ref_slp_min, ref_slp_max = 80000.0, 110000.0 # sea-level pressure [Pa]
ref_wnd_min, ref_wnd_max = 0.0, 50.0         # wind speed [m/s]
ref_rsw_min, ref_rsw_max = 0.0, 1500.0       # downwelling SW [W/m^2]
ref_rlw_min, ref_rlw_max = 0.0, 750.0        # downwelling LW [W/m^2]
ref_tau_max = 10.0                           # max wind stress [N/m^2]
