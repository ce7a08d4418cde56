"""The comparison that decides ``correct``: the numbers a call's answers
give against the reference's, each a worst case over the fields and
records compared.

* ``sig_frac`` — the largest fraction of significant points of one field in
  one record: |got - ref| above a tenth of the field's scale, the median
  magnitude of the reference over its nonzero points (1e-6 absolute in a
  field that is zero everywhere), or a finite value on one side only.  The
  fp32 gate of the program's own parity checks (docs/PARITY.md, "The fp32
  tail").
* ``med_err`` — the largest median, over one field in one record, of
  |got - ref| over that scale: the error of the typical point, which a
  lower precision moves everywhere at once.
* ``grad_sig_frac``, ``grad_med_err`` — the same for a gradient, whose
  scale is the point's own magnitude with the median as a floor: a
  gradient field spans six decades where a flux does not (F8, ROADMAP §3).
* ``loss_rel`` — |loss - ref| / |ref|.

Every number is computed in float64 on the device the answers are on.
"""

from __future__ import annotations

import torch


def _median(x):
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return float((s[(n - 1) // 2] + s[n // 2]) / 2)


def field_errors(got, ref):
    """``(sig_frac, med_err)`` of one field (any shape) against its
    reference."""
    got = torch.as_tensor(got).to(ref.device, torch.float64).reshape(-1)
    ref = ref.to(torch.float64).reshape(-1)
    fin = torch.isfinite(ref)
    mag = torch.where(fin, ref.abs(), 0.0)
    nonzero = mag[mag != 0]
    scale = _median(nonzero) if nonzero.numel() else 0.0
    scale = scale if scale >= 1e-20 else 1e-5     # threshold 1e-6 absolute
    err = torch.where(fin & torch.isfinite(got), (got - ref).abs() / scale,
                      torch.where(fin == torch.isfinite(got), 0.0,
                                  float("inf")))
    return float((err > 0.1).double().mean()), _median(err)


def grad_errors(got, ref):
    """``(grad_sig_frac, grad_med_err)`` of a gradient against its
    reference: the scale of a point is max(|ref|, m), m the median
    magnitude over the nonzero finite points of ``ref``; points where
    ``ref`` is not finite are not compared."""
    got = torch.as_tensor(got).to(ref.device, torch.float64).reshape(-1)
    ref = ref.to(torch.float64).reshape(-1)
    fin = torch.isfinite(ref)
    mag = torch.where(fin, ref.abs(), 0.0)
    nonzero = mag[mag != 0]
    m = _median(nonzero) if nonzero.numel() else 0.0
    scale = torch.clamp(mag, min=max(m, 1e-300))
    err = torch.where(fin, torch.where(torch.isfinite(got),
                                       (got - ref).abs() / scale,
                                       float("inf")), 0.0)
    return float((err > 0.1).double().mean()), _median(err[fin])


def worst(pairs):
    """The largest of each number over ``pairs`` of (where, {name:
    value}): {name: (value, where)}."""
    out = {}
    for where, numbers in pairs:
        for name, value in numbers.items():
            if name not in out or not value <= out[name][0]:
                out[name] = (value, where)
    return out


def fields_numbers(got: dict, ref: dict):
    """``sig_frac`` and ``med_err`` over the fields of ``got`` (name ->
    tensor), each against ``ref`` under the same name: {name: (value,
    field)}."""
    def numbers(name):
        s, m = field_errors(got[name], ref[name])
        return name, {"sig_frac": s, "med_err": m}
    return worst(numbers(name) for name in ref)
