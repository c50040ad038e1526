"""Carry the JAX package's stage state into the port.

`from_jax` takes the JAX package's `System`, `IntStore`, HF result, spin
slices and CC result, or the restricted `Slices` and `CCSDResult` (with
`t1_prev`/`t2_prev`) — any objects with those field names, whose arrays
convert with `numpy.asarray` (jax arrays do, without this module
importing jax) — and returns the port's dataclasses, with the tensors on
`device`.  The tests use it to start a port stage from exactly the JAX
stage's inputs.  This system has no weights; these arrays play their
part.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import F64, default_device
from .io.dat import IntStore, System
from .methods.ccsd_spatial import CCSDResult, Slices
from .methods.ccsd_spinorb import CCSDSpinorbResult, SpinSlices
from .methods.hf import HFResult


def _host(x):
    return None if x is None else np.array(np.asarray(x))


def from_jax(*, device, sys_=None, ints=None, hf=None, slices=None, cc=None) -> dict:
    """Port-side copies of the given JAX stage objects, keyed by argument
    name.  `cc` needs `slices` (the JAX CC result's own `slices` are used
    when not given).  Spin-orbital or restricted is told by the objects'
    fields: restricted slices have `v_oovv`, a restricted CC result
    `t1_diagnostic`."""
    dev = default_device(device)
    tensor = lambda x: torch.as_tensor(_host(x), dtype=F64, device=dev)
    out = {}
    if sys_ is not None:
        out["sys_"] = System(**{
            f.name: _host(getattr(sys_, f.name)) if f.name in ("charges", "coords")
            else getattr(sys_, f.name)
            for f in dataclasses.fields(System)
        })
    if ints is not None:
        out["ints"] = IntStore(**{
            f.name: float(ints.e_nuc) if f.name == "e_nuc"
            else int(ints.nbasis) if f.name == "nbasis"
            else _host(getattr(ints, f.name))
            for f in dataclasses.fields(IntStore)
        })
    if hf is not None:
        out["hf"] = HFResult(
            e_hf=float(hf.e_hf), coeff=_host(hf.coeff), levels=_host(hf.levels),
            ao_fock=_host(hf.ao_fock), converged=bool(hf.converged),
            iterations=int(hf.iterations),
        )
    if cc is not None and slices is None:
        slices = cc.slices
    if slices is not None:
        kind = Slices if hasattr(slices, "v_oovv") else SpinSlices
        out["slices"] = kind(**{
            f.name: tensor(getattr(slices, f.name)) for f in dataclasses.fields(kind)
        })
    if cc is not None and hasattr(cc, "t1_diagnostic"):
        out["cc"] = CCSDResult(
            e_ccsd=float(cc.e_ccsd), t1=tensor(cc.t1), t2=tensor(cc.t2),
            t1_diagnostic=float(cc.t1_diagnostic), converged=bool(cc.converged),
            iterations=int(cc.iterations), slices=out["slices"],
            t1_prev=None if cc.t1_prev is None else tensor(cc.t1_prev),
            t2_prev=None if cc.t2_prev is None else tensor(cc.t2_prev),
        )
    elif cc is not None:
        out["cc"] = CCSDSpinorbResult(
            e_ccsd=float(cc.e_ccsd), t1=tensor(cc.t1), t2=tensor(cc.t2),
            converged=bool(cc.converged), iterations=int(cc.iterations),
            slices=out["slices"],
        )
    return out
