"""The memory tier's releases (`afesp_tpu_torch/methods/tiers.py`) on the
CPU: the driver on the 24-bf H2O at CRCCSD(T)_spatial on each tier, with
its stages wrapped to record, after each, which device forms of the
integrals are still held.  Dense: the AO ERI from RHF on (kept below 100
bf) and v_vvvv kept for (T).  Stream (AFESP_FORCE_STREAM=1, the stream
Fock build from 20 bf): the packed store gone after the sliced transform,
v_vvvv never formed, the limbs dropped once CCSD returns.  Sliced (the
rule's budget forced to one byte): the row table gone after the f64
transform, v_vvvv dropped after CCSD.  Every stage gets the same tier,
and MP2 writes the FCIDUMP only from a dense MO tensor, naming the tier
that has none."""

from __future__ import annotations

import functools
import io

import pytest
from torch_fixtures import write_h2o

from afesp_tpu_torch import driver as tdriver
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import hf as thf
from afesp_tpu_torch.methods import mp2 as tmp2
from afesp_tpu_torch.methods import tiers


def _held(ints) -> dict:
    return {"eri": ints._eri_dev is not None, "packed": ints._packed_dev is not None,
            "rows": ints._rows_dev is not None}


def _run(wd, monkeypatch) -> dict:
    """The driver's run, and what each wrapped stage saw."""
    seen = {"tiers": []}

    def wrap(module, name, after):
        original = getattr(module, name)

        def stage(*args, **kwargs):
            if "tier" in kwargs:
                seen["tiers"].append(kwargs["tier"])
            out = original(*args, **kwargs)
            after(args, out)
            return out

        monkeypatch.setattr(module, name, stage)

    def after_rhf(args, out):
        seen["ints"] = args[1]
        seen["rhf"] = _held(args[1])

    def after_mp2(args, out):
        seen["mp2_result"] = out
        seen["mp2"] = _held(args[1]) | {"limbs": out.vvvv_B is not None,
                                        "mo_dense": out.eri_mo is not None}

    def after_ccsd(args, out):
        seen["ccsd"] = {"v_vvvv": out.slices.v_vvvv is not None,
                        "cr_term": out.cr_vvvv_term is not None,
                        "limbs": seen["mp2_result"].vvvv_B is not None}

    def triples(original, sys_, cc, *args, **kwargs):
        seen["triples"] = {"v_vvvv": cc.slices.v_vvvv is not None,
                           "limbs": seen["mp2_result"].vvvv_B is not None}
        return original(sys_, cc, *args, **kwargs)

    wrap(thf, "do_rhf", after_rhf)
    wrap(tmp2, "do_mp2_spatial", after_mp2)
    wrap(tdriver, "do_ccsd_spatial", after_ccsd)
    monkeypatch.setattr(tdriver, "do_ccsd_t_spatial",
                        functools.partial(triples, tdriver.do_ccsd_t_spatial))
    out = io.StringIO()
    seen["res"] = tdriver.run_calculation(wd, Reporter(stream=out), device="cpu")
    seen["text"] = out.getvalue()
    return seen


CASES = {
    "dense": dict(
        precision="f64",
        fcidump=None,
        rhf={"eri": True, "packed": False, "rows": False},
        mp2={"eri": True, "packed": False, "rows": False, "limbs": False, "mo_dense": True},
        ccsd={"v_vvvv": True, "cr_term": False, "limbs": False},
        triples={"v_vvvv": True, "limbs": False},
    ),
    "stream": dict(
        precision="hybrid",
        fcidump="streaming",
        rhf={"eri": False, "packed": True, "rows": False},
        mp2={"eri": False, "packed": False, "rows": False, "limbs": True, "mo_dense": False},
        ccsd={"v_vvvv": False, "cr_term": True, "limbs": True},
        triples={"v_vvvv": False, "limbs": False},
    ),
    "sliced": dict(
        precision="f64",
        fcidump="sliced f64",
        rhf={"eri": False, "packed": False, "rows": True},
        mp2={"eri": False, "packed": False, "rows": False, "limbs": False, "mo_dense": False},
        ccsd={"v_vvvv": False, "cr_term": True, "limbs": False},
        triples={"v_vvvv": False, "limbs": False},
    ),
}


@pytest.mark.parametrize("tier", list(CASES))
def test_each_tier_releases_its_forms_where_it_should(tmp_path, monkeypatch, tier):
    want = CASES[tier]
    wd = write_h2o(tmp_path, "CRCCSD(T)_spatial", f'ccsd_precision = "{want["precision"]}",\nwrite_fcidump = .true.,\n')
    if tier == "stream":
        monkeypatch.setenv("AFESP_FORCE_STREAM", "1")
        monkeypatch.setattr(tiers, "_TPU_FOCK_NBASIS", 20)
    if tier == "sliced":
        monkeypatch.setattr(tiers, "choose_tier",
                            functools.partial(tiers.choose_tier, budget_bytes=1))
    seen = _run(wd, monkeypatch)

    assert seen["res"].sys.nbasis == 24 and seen["res"].cc.converged
    (first, *rest) = seen["tiers"]
    assert first.name == tier and len(rest) == 2 and all(t is first for t in rest)
    for stage in ("rhf", "mp2", "ccsd", "triples"):
        assert seen[stage] == want[stage], stage
    skipped = f"FCIDUMP skipped: no dense MO tensor on the {want['fcidump']} tier."
    assert (wd / "FCIDUMP").exists() == (want["fcidump"] is None)
    assert seen["text"].count("FCIDUMP skipped") == (want["fcidump"] is not None)
    assert want["fcidump"] is None or skipped in seen["text"]
