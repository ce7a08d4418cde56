/* aerobulk_tpu_torch C++ binding implementation.
 *
 * Architecture mirrors the reference's interop chain
 * (aerobulk.cpp -> extern "C" shim -> compute core), with the Fortran
 * core replaced by the PyTorch/CUDA port reached through an embedded
 * CPython interpreter.  Input vectors are exposed to Python as read-only
 * memoryviews and outputs as writable memoryviews — no data copies on
 * this side.
 *
 * The interpreter starts on the first call, with sys.argv set (some
 * modules torch imports read it) and the program name "python3", so that
 * it finds the installation a shell's python3 finds (a virtual
 * environment included); PYTHONPATH must reach the aerobulk_tpu_torch
 * package.  After start-up the GIL is released, and every call takes it
 * for its duration, so threads of the host program may call in turn.
 */

#include "aerobulk.hpp"

#include <Python.h>

#include <cassert>
#include <cstdarg>
#include <mutex>
#include <stdexcept>

namespace aerobulk {

std::string algorithm_to_string(algorithm algo)
{
    switch (algo) {
    case algorithm::OTHER:    return "other";
    case algorithm::COARE3p0: return "coare3p0";
    case algorithm::COARE3p6: return "coare3p6";
    case algorithm::NCAR:     return "ncar";
    case algorithm::ECMWF:    return "ecmwf";
    case algorithm::ANDREAS:  return "andreas";
    }
    return "unknown";
}

int check_sizes(int count, ...)
{
    va_list ap;
    va_start(ap, count);
    int size = va_arg(ap, int);
    for (int i = 1; i < count; i++)
        assert(size == va_arg(ap, int));
    va_end(ap);
    return size;
}

namespace {

PyObject *g_model_fn = nullptr;
std::once_flag g_started;

void start_interpreter()
{
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;
    config.parse_argv = 0;
    char *argv[] = {const_cast<char *>("aerobulk")};
    PyStatus st = PyConfig_SetString(&config, &config.program_name,
                                     L"python3");
    if (!PyStatus_Exception(st))
        st = PyConfig_SetBytesArgv(&config, 1, argv);
    if (!PyStatus_Exception(st))
        st = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(st))
        throw std::runtime_error(
            std::string("aerobulk: cannot start Python: ") +
            (st.err_msg ? st.err_msg : "unknown error"));
    // the interpreter holds the GIL after start-up: release it, calls
    // take it with PyGILState_Ensure
    PyEval_SaveThread();
}

// Imports the capi module once; the caller holds the GIL.
void ensure_model_fn()
{
    if (g_model_fn)
        return;
    PyObject *mod = PyImport_ImportModule("aerobulk_tpu_torch.capi");
    if (!mod) {
        PyErr_Print();
        throw std::runtime_error(
            "aerobulk: cannot import aerobulk_tpu_torch.capi — is the "
            "package on PYTHONPATH?");
    }
    g_model_fn = PyObject_GetAttrString(mod, "model_buffers");
    Py_DECREF(mod);
    if (!g_model_fn) {
        PyErr_Print();
        throw std::runtime_error("aerobulk: capi.model_buffers missing");
    }
}

PyObject *ro_view(const std::vector<double> &v)
{
    return PyMemoryView_FromMemory(
        reinterpret_cast<char *>(const_cast<double *>(v.data())),
        static_cast<Py_ssize_t>(v.size() * sizeof(double)), PyBUF_READ);
}

PyObject *rw_view(std::vector<double> &v)
{
    return PyMemoryView_FromMemory(
        reinterpret_cast<char *>(v.data()),
        static_cast<Py_ssize_t>(v.size() * sizeof(double)), PyBUF_WRITE);
}

// Sets kw[name] = value and drops the reference to value.
void set_item(PyObject *kw, const char *name, PyObject *value)
{
    PyDict_SetItemString(kw, name, value);
    Py_DECREF(value);
}

void call_model(int jt, int Nt, const std::string &calgo, double zt,
                double zu, const std::vector<double> &sst,
                const std::vector<double> &t_zt,
                const std::vector<double> &hum_zt,
                const std::vector<double> &U_zu,
                const std::vector<double> &V_zu,
                const std::vector<double> &slp, std::vector<double> &QL,
                std::vector<double> &QH, std::vector<double> &Tau_x,
                std::vector<double> &Tau_y, std::vector<double> &Evap,
                int Niter, bool use_skin, const std::vector<double> *rad_sw,
                const std::vector<double> *rad_lw, std::vector<double> *T_s,
                int series_id)
{
    std::call_once(g_started, [] {
        if (!Py_IsInitialized())
            start_interpreter();
    });
    PyGILState_STATE gst = PyGILState_Ensure();
    try {
        ensure_model_fn();
    } catch (...) {
        PyGILState_Release(gst);
        throw;
    }

    PyObject *args = Py_BuildValue(
        "(iisddNNNNNNNNNNN)", jt, Nt, calgo.c_str(), zt, zu,
        ro_view(sst), ro_view(t_zt), ro_view(hum_zt), ro_view(U_zu),
        ro_view(V_zu), ro_view(slp), rw_view(QL), rw_view(QH),
        rw_view(Tau_x), rw_view(Tau_y), rw_view(Evap));

    PyObject *kw = PyDict_New();
    set_item(kw, "niter", PyLong_FromLong(Niter));
    set_item(kw, "use_skin", PyBool_FromLong(use_skin));
    set_item(kw, "series_id", PyLong_FromLong(series_id));
    if (rad_sw) set_item(kw, "rad_sw", ro_view(*rad_sw));
    if (rad_lw) set_item(kw, "rad_lw", ro_view(*rad_lw));
    if (T_s)    set_item(kw, "T_s", rw_view(*T_s));

    PyObject *res = PyObject_Call(g_model_fn, args, kw);
    Py_DECREF(args);
    Py_DECREF(kw);
    if (!res) {
        PyErr_Print();
        PyGILState_Release(gst);
        throw std::runtime_error("aerobulk: model_buffers call failed");
    }
    Py_DECREF(res);
    PyGILState_Release(gst);
}

}  // namespace

void model(int jt, int Nt, algorithm algo, double zt, double zu,
           const std::vector<double> &sst, const std::vector<double> &t_zt,
           const std::vector<double> &hum_zt, const std::vector<double> &U_zu,
           const std::vector<double> &V_zu, const std::vector<double> &slp,
           std::vector<double> &QL, std::vector<double> &QH,
           std::vector<double> &Tau_x, std::vector<double> &Tau_y,
           std::vector<double> &Evap, int Niter, bool l_use_skin,
           const std::vector<double> &rad_sw,
           const std::vector<double> &rad_lw, std::vector<double> &T_s,
           int series_id)
{
    int m = check_sizes(8, (int)sst.size(), (int)t_zt.size(),
                        (int)hum_zt.size(), (int)U_zu.size(),
                        (int)V_zu.size(), (int)slp.size(),
                        (int)rad_sw.size(), (int)rad_lw.size());
    QL.resize(m); QH.resize(m); Tau_x.resize(m); Tau_y.resize(m);
    Evap.resize(m); T_s.resize(m);
    call_model(jt, Nt, algorithm_to_string(algo), zt, zu, sst, t_zt, hum_zt,
               U_zu, V_zu, slp, QL, QH, Tau_x, Tau_y, Evap, Niter,
               l_use_skin, &rad_sw, &rad_lw, &T_s, series_id);
}

void model(int jt, int Nt, algorithm algo, double zt, double zu,
           const std::vector<double> &sst, const std::vector<double> &t_zt,
           const std::vector<double> &hum_zt, const std::vector<double> &U_zu,
           const std::vector<double> &V_zu, const std::vector<double> &slp,
           std::vector<double> &QL, std::vector<double> &QH,
           std::vector<double> &Tau_x, std::vector<double> &Tau_y,
           std::vector<double> &Evap, int Niter, int series_id)
{
    int m = check_sizes(6, (int)sst.size(), (int)t_zt.size(),
                        (int)hum_zt.size(), (int)U_zu.size(),
                        (int)V_zu.size(), (int)slp.size());
    QL.resize(m); QH.resize(m); Tau_x.resize(m); Tau_y.resize(m);
    Evap.resize(m);
    call_model(jt, Nt, algorithm_to_string(algo), zt, zu, sst, t_zt, hum_zt,
               U_zu, V_zu, slp, QL, QH, Tau_x, Tau_y, Evap, Niter,
               false, nullptr, nullptr, nullptr, series_id);
}

}  // namespace aerobulk
