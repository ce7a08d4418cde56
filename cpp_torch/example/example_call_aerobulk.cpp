/* C++ example mirroring the reference's example_call_aerobulk.cpp, on the
 * aerobulk_tpu_torch binding: the 2-point (unstable + stable) case through
 * aerobulk::model for each ocean algorithm, printing QH / QL / Evap / T_s /
 * Tau, then two interleaved same-shape series told apart by series_id.
 * The COARE 3.0 unstable point prints QH = -15.15530, QL = -81.38902 W/m^2
 * (the current reference semantics; doc/ex_ab.dat predates a change to
 * its viscosity, tests/test_golden_ocean.py). */

#include <cstdio>
#include <stdexcept>
#include <vector>

#include "aerobulk.hpp"

static void print_case(const char *name, const std::vector<double> &QH,
                       const std::vector<double> &QL,
                       const std::vector<double> &E,
                       const std::vector<double> &Tx,
                       const std::vector<double> *Ts)
{
    std::printf("\n *********** %s *****************\n", name);
    std::printf(" QH    = %12.5f %12.5f W/m^2\n", QH[0], QH[1]);
    std::printf(" QL    = %12.5f %12.5f W/m^2\n", QL[0], QL[1]);
    std::printf(" Evap  = %12.6f %12.6f mm/day\n", E[0] * 86400.0,
                E[1] * 86400.0);
    if (Ts)
        std::printf(" T_s   = %12.5f %12.5f deg.C\n", (*Ts)[0] - 273.15,
                    (*Ts)[1] - 273.15);
    std::printf(" Tau_x = %12.7e %12.7e N/m^2\n", Tx[0], Tx[1]);
}

static int run()
{
    const int Niter = 50;   // doc/ex_ab.dat was generated fully converged
    const double zt = 2.0, zu = 10.0;

    std::vector<double> sst = {295.15, 295.15};
    std::vector<double> t_zt = {293.15, 298.15};
    std::vector<double> q_zt = {0.012, 0.012};
    std::vector<double> U = {5.0, 5.0}, V = {0.0, 0.0};
    std::vector<double> slp = {101000.0, 101000.0};
    std::vector<double> rsw = {0.0, 0.0}, rlw = {350.0, 350.0};

    std::vector<double> QL, QH, Tx, Ty, E, Ts;

    struct Case { aerobulk::algorithm algo; const char *name; bool skin; };
    const Case cases[] = {
        {aerobulk::algorithm::COARE3p0, "COARE 3.0", true},
        {aerobulk::algorithm::COARE3p6, "COARE 3.6", true},
        {aerobulk::algorithm::ECMWF, "ECMWF", true},
        {aerobulk::algorithm::NCAR, "NCAR", false},
        {aerobulk::algorithm::ANDREAS, "ANDREAS", false},
    };

    for (const auto &c : cases) {
        if (c.skin) {
            aerobulk::model(1, 1, c.algo, zt, zu, sst, t_zt, q_zt, U, V,
                            slp, QL, QH, Tx, Ty, E, Niter, true, rsw, rlw,
                            Ts);
            print_case(c.name, QH, QL, E, Tx, &Ts);
        } else {
            aerobulk::model(1, 1, c.algo, zt, zu, sst, t_zt, q_zt, U, V,
                            slp, QL, QH, Tx, Ty, E, Niter);
            print_case(c.name, QH, QL, E, Tx, nullptr);
        }
    }

    /* Two INTERLEAVED same-shape stateful series, disambiguated by
     * series_id: series B runs warmer SST, so sharing warm-layer state
     * (the reference's hidden-module-state hazard,
     * mod_skin_coare.f90:31-36) would corrupt series A's trajectory.
     * The interleaved series-A result must equal a sequential series-A
     * run (done first, id 2, so it never coexists with another id). */
    {
        const int nrec = 3;
        std::vector<double> sstB = {300.15, 300.15};
        std::vector<double> rswD = {800.0, 800.0};

        std::vector<double> QL2, QH2, Tx2, Ty2, E2, Ts2;
        std::vector<double> seqQL;
        for (int jt = 1; jt <= nrec; jt++) {
            aerobulk::model(jt, nrec, aerobulk::algorithm::COARE3p6, zt,
                            zu, sst, t_zt, q_zt, U, V, slp, QL2, QH2, Tx2,
                            Ty2, E2, Niter, true, rswD, rlw, Ts2, 2);
            seqQL = QL2;
        }
        for (int jt = 1; jt <= nrec; jt++) {
            aerobulk::model(jt, nrec, aerobulk::algorithm::COARE3p6, zt,
                            zu, sst, t_zt, q_zt, U, V, slp, QL2, QH2, Tx2,
                            Ty2, E2, Niter, true, rswD, rlw, Ts2, 0);
            aerobulk::model(jt, nrec, aerobulk::algorithm::COARE3p6, zt,
                            zu, sstB, t_zt, q_zt, U, V, slp, QL, QH, Tx,
                            Ty, E, Niter, true, rswD, rlw, Ts, 1);
        }
        double diff = 0.0;
        for (size_t i = 0; i < QL2.size(); i++) {
            double d = QL2[i] - seqQL[i];
            diff += d > 0 ? d : -d;
        }
        if (diff > 1e-9) {
            std::printf("interleaved series FAILED: |dQL|=%g\n", diff);
            return 1;
        }
        std::printf("\n interleaved series_id OK (|dQL|=%g)\n", diff);
    }
    return 0;
}

int main()
{
    try {
        return run();
    } catch (const std::exception &e) {
        std::fprintf(stderr, "%s\n", e.what());
        return 1;
    }
}
