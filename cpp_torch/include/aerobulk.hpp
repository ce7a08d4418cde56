/* aerobulk_tpu_torch C++ binding — same public surface as the reference's
 * include/aerobulk.hpp (aerobulk::model two overloads + algorithm enum),
 * backed by the PyTorch/CUDA port instead of the Fortran library.
 *
 * The implementation embeds a CPython interpreter and hands the caller's
 * buffers to aerobulk_tpu_torch.capi.model_buffers as zero-copy
 * memoryviews; the flux step runs in float64 on the CUDA device, or on the
 * CPU when the environment sets AEROBULK_CAPI_DEVICE=cpu.  Thread-safety:
 * calls are serialized on the GIL, which is released between calls.
 */

#ifndef AEROBULK_TPU_TORCH_HPP
#define AEROBULK_TPU_TORCH_HPP 1

#include <string>
#include <vector>

namespace aerobulk {

enum class algorithm {
    OTHER    = 0,
    COARE3p0 = 1,
    COARE3p6 = 2,
    NCAR     = 3,
    ECMWF    = 4,
    ANDREAS  = 5
};

std::string algorithm_to_string(algorithm algo);

// Verify that `count` sizes agree; returns the common size.
int check_sizes(int count, ...);

// With radiative inputs + skin temperature output (skin schemes active).
//
// `series_id` disambiguates INTERLEAVED series sharing the same
// algorithm and grid size: the per-series state registry (warm-layer
// state + detected humidity kind) is keyed by (algo, size, series_id),
// so two concurrently-stepped same-shape series must pass distinct ids
// or they silently share warm-layer state — the hidden-module-state
// hazard of the reference (mod_skin_coare.f90:31-36) that its C++ API
// cannot express at all.  The default 0 preserves reference-compatible
// single-series behavior.
void model(int jt, int Nt, algorithm algo, double zt, double zu,
           const std::vector<double> &sst, const std::vector<double> &t_zt,
           const std::vector<double> &hum_zt, const std::vector<double> &U_zu,
           const std::vector<double> &V_zu, const std::vector<double> &slp,
           std::vector<double> &QL, std::vector<double> &QH,
           std::vector<double> &Tau_x, std::vector<double> &Tau_y,
           std::vector<double> &Evap, int Niter, bool l_use_skin,
           const std::vector<double> &rad_sw,
           const std::vector<double> &rad_lw, std::vector<double> &T_s,
           int series_id = 0);

// Without radiative inputs (bulk SST, no skin schemes).
void model(int jt, int Nt, algorithm algo, double zt, double zu,
           const std::vector<double> &sst, const std::vector<double> &t_zt,
           const std::vector<double> &hum_zt, const std::vector<double> &U_zu,
           const std::vector<double> &V_zu, const std::vector<double> &slp,
           std::vector<double> &QL, std::vector<double> &QH,
           std::vector<double> &Tau_x, std::vector<double> &Tau_y,
           std::vector<double> &Evap, int Niter, int series_id = 0);

}  // namespace aerobulk

#endif
