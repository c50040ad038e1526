"""The f32 "hybrid" (T) tiers' gaps, measured on the CPU.

    JAX_PLATFORMS=cpu python tools/hybrid_triples_gaps.py [--small] [--pvtz-chain]
        [--pvtz-spatial] [--pvtz-spinorb]

--small: on JAX's converged amplitudes of the generated 24-bf H2O
(tests/torch_fixtures.write_h2o), the port's "hybrid" E(T) (both
formulations, every restricted value) against JAX's "hybrid" and both
packages' f64 tiers; the port's "fused" tier (K3's plain version here)
with the f32 chain against the same with the f64 chain; and the f32 CR
intermediates against JAX's and the f64 chain (relative to their
largest element).

--pvtz-chain: on JAX's converged restricted amplitudes of the committed
H2O/cc-pVTZ inputs (the els.in of expected_jax_cpu_crccsd_t_spatial.json),
the shift of the CR sums e_CR and e_CRT (and of CR-CCSD[T]) that the
f32 CR chain alone causes, in each package: each package's
cr_intermediates at f32 and at f64, both fed to JAX's f64 slab sums.
The port's f32 products on the CPU depend on its thread count.

--pvtz-spatial: the port's CRCCSD(T)_spatial on the same inputs at f64
(its f64 tier on the CPU), then its "hybrid" tier on those amplitudes
against it, every value.

--pvtz-spinorb: the port's CCSD(T)_spinorb on the same inputs at f64,
then its "hybrid" E(T) against its f64 E(T) on those amplitudes, split
into what the f32 GEMMs and the f32 P(a/bc) algebra each add: the
panels with f32 GEMMs but f64 algebra, and exact (f64) products of the
operands rounded to f32, then rounded to f32 panels.

Prints one JSON line a measurement.  Writes nothing into the checkout
(inputs are staged in a temporary directory).  ~1 min each on 8 cores.
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]
PVTZ = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
KEYS = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t", "e_crccsd_tt",
        "D_T", "D_TT")


def emit(what: str, **values) -> None:
    print(json.dumps({"measure": what} | {k: (f"{v:.3e}" if isinstance(v, float) else v)
                                          for k, v in values.items()}), flush=True)


def jax_stages(wd: Path) -> dict:
    from afesp_tpu.config import read_els_in
    from afesp_tpu.io import dat
    from afesp_tpu.io.report import Reporter
    from afesp_tpu.methods.ccsd_spatial import do_ccsd_spatial
    from afesp_tpu.methods.ccsd_spinorb import do_ccsd_spinorb
    from afesp_tpu.methods.hf import do_rhf
    from afesp_tpu.methods.mp2 import do_mp2_spatial

    cfg = read_els_in(wd)
    sys_, ints = dat.read_integrals(wd, cfg.restricted)
    rep = Reporter(stream=io.StringIO())
    hf = do_rhf(sys_, ints, cfg, rep, wd)
    mp2 = do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
    solve = do_ccsd_spatial if cfg.restricted else do_ccsd_spinorb
    return dict(sys_=sys_, cfg=cfg, hf=hf, cc=solve(sys_, mp2.eri_mo, cfg, hf, rep, wd))


def small(tmp: Path) -> None:
    import numpy as np
    from torch_fixtures import write_h2o

    from afesp_tpu.io.report import Reporter as JaxReporter
    from afesp_tpu.methods import triples_spatial as JS
    from afesp_tpu.methods import triples_spinorb as JO
    from afesp_tpu_torch import config as tcfg
    from afesp_tpu_torch.convert import from_jax
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods import triples_spatial as TS
    from afesp_tpu_torch.methods import triples_spinorb as TO

    st = jax_stages(write_h2o(tmp / "so"))
    port = from_jax(device="cpu", cc=st["cc"])["cc"]
    args = (st["sys_"], st["cc"], st["cfg"], st["hf"].levels)
    jax_t = {p: JO.do_ccsd_t_spinorb(*args, JaxReporter(stream=io.StringIO()), precision=p)
             for p in ("hybrid", "f64")}
    port_t = {p: TO.do_ccsd_t_spinorb(st["sys_"], port, st["cfg"], st["hf"].levels,
                                      Reporter(stream=io.StringIO()), precision=p)
              for p in ("hybrid", "f64")}
    emit("24-bf spin-orbital E(T)", port_hybrid_vs_jax_hybrid=port_t["hybrid"] - jax_t["hybrid"],
         port_hybrid_vs_port_f64=port_t["hybrid"] - port_t["f64"],
         jax_hybrid_vs_jax_f64=jax_t["hybrid"] - jax_t["f64"])

    st = jax_stages(write_h2o(tmp / "sp", "CRCCSD(T)_spatial"))
    got = from_jax(device="cpu", sys_=st["sys_"], cc=st["cc"])
    cfg = tcfg.parse_els_in(st["cfg"].raw_text)
    args = (st["sys_"], st["cc"], st["cfg"], st["hf"].levels)
    jt = {p: JS.do_ccsd_t_spatial(*args, JaxReporter(stream=io.StringIO()), precision=p)
          for p in ("hybrid", "f64")}
    pt = {p: TS.do_ccsd_t_spatial(got["sys_"], got["cc"], cfg, st["hf"].levels,
                                  Reporter(stream=io.StringIO()), precision=p)
          for p in ("hybrid", "f64")}
    for k in KEYS:
        emit(f"24-bf restricted {k}",
             port_hybrid_vs_jax_hybrid=getattr(pt["hybrid"], k) - getattr(jt["hybrid"], k),
             port_hybrid_vs_port_f64=getattr(pt["hybrid"], k) - getattr(pt["f64"], k),
             jax_hybrid_vs_jax_f64=getattr(jt["hybrid"], k) - getattr(jt["f64"], k))
    chain = {}
    for request in ("hybrid", "f64"):
        cfg.ccsd_precision = request
        chain[request] = TS.do_ccsd_t_spatial(got["sys_"], got["cc"], cfg, st["hf"].levels,
                                              Reporter(stream=io.StringIO()), precision="fused")
    emit("24-bf restricted, fused tier, f32 chain minus f64 chain",
         **{k: getattr(chain["hybrid"], k) - getattr(chain["f64"], k) for k in KEYS})
    cc, nocc, tc = st["cc"], st["sys_"].nocc, got["cc"]
    p32 = TS.cr_intermediates(tc.t1, tc.t2, tc.t1_prev, tc.t2_prev, tc.slices, nocc,
                              precision="hybrid")
    p64 = TS.cr_intermediates(tc.t1, tc.t2, tc.t1_prev, tc.t2_prev, tc.slices, nocc)
    j32 = JS.cr_intermediates(cc.t1, cc.t2, cc.t1_prev, cc.t2_prev, cc.slices, nocc=nocc,
                              precision="hybrid")
    for name, a, b, c in zip(("I_vovv''", "I_ooov''"), p32, j32, p64):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        emit(f"24-bf f32 {name}, relative to its largest element",
             port_vs_jax=float(np.abs(a.numpy() - b).max()) / scale,
             port_vs_f64=float(np.abs(a.double().numpy() - c.numpy()).max()) / scale,
             jax_vs_f64=float(np.abs(b - c.numpy()).max()) / scale)


def stage_pvtz(tmp: Path, els_in: str | None) -> Path:
    wd = tmp / "pvtz"
    wd.mkdir(exist_ok=True)
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "els.in"):
        shutil.copy(PVTZ / f, wd / f)
    if els_in is not None:
        (wd / "els.in").write_text(els_in)
    (wd / "eri.dat").unlink(missing_ok=True)
    (wd / "eri.dat").symlink_to(REPO / "data" / "h2o-cc-pvtz" / "eri.dat")
    return wd


def pvtz_chain(tmp: Path) -> None:
    import jax.numpy as jnp
    import numpy as np

    from afesp_tpu.methods import triples_spatial as JS
    from afesp_tpu_torch.convert import from_jax
    from afesp_tpu_torch.methods import triples_spatial as TS

    want = json.loads((PVTZ / "expected_jax_cpu_crccsd_t_spatial.json").read_text())
    st = jax_stages(stage_pvtz(tmp, want["els_in"]))
    cc, nocc, nv = st["cc"], st["sys_"].nocc, st["sys_"].nvirt
    lv = np.asarray(st["hf"].levels)
    v = cc.slices

    def sums(I):
        f64 = lambda x: jnp.asarray(np.asarray(x, dtype=np.float64))
        return [float(x) for x in JS._triples_total_spatial(
            cc.t1, cc.t2, v.v_vvov, v.v_oovo, v.v_oovv, f64(lv[:nocc]),
            f64(lv[nocc:nocc + nv]), f64(I[0]), f64(I[1]), nocc=nocc, jlen=1,
            doing_T=True, doing_R=True, doing_CR=True, precision="f64")]

    j = {p: sums(JS.cr_intermediates(cc.t1, cc.t2, cc.t1_prev, cc.t2_prev, v, nocc=nocc,
                                     precision=p)) for p in ("hybrid", "f64")}
    tc = from_jax(device="cpu", cc=cc)["cc"]
    p = {q: sums([x.numpy() for x in TS.cr_intermediates(
        tc.t1, tc.t2, tc.t1_prev, tc.t2_prev, tc.slices, nocc, precision=q)])
        for q in ("hybrid", "f64")}
    # CR-CCSD[T] is e_ccsd + e_CR / D[T]: its shift is e_CR's over D[T]
    d_t = want["triples"]["D_T"]
    for who, s in (("JAX", j), ("port", p)):
        emit(f"pVTZ CR sums, f32 chain minus f64 chain, {who}",
             e_CR=s["hybrid"][4] - s["f64"][4], e_CRT=s["hybrid"][5] - s["f64"][5],
             e_crccsd_t=(s["hybrid"][4] - s["f64"][4]) / d_t)


def pvtz_spatial(tmp: Path) -> None:
    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods import triples_spatial as TS

    want = json.loads((PVTZ / "expected_jax_cpu_crccsd_t_spatial.json").read_text())
    res = run_calculation(stage_pvtz(tmp, want["els_in"]), Reporter(stream=io.StringIO()),
                          device="cpu")
    tr = TS.do_ccsd_t_spatial(res.sys, res.cc, res.cfg, res.hf.levels,
                              Reporter(stream=io.StringIO()), precision="hybrid")
    emit("pVTZ restricted, the port's hybrid tier minus its f64 tier",
         tiers=f"{tr.precision_used} vs {res.triples.precision_used}",
         **{k: getattr(tr, k) - getattr(res.triples, k) for k in KEYS})


def pvtz_spinorb(tmp: Path) -> None:
    import torch

    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods import triples_spinorb as T
    from afesp_tpu_torch.ops.spin import spinorb_levels
    from afesp_tpu_torch.ops.triples_cuda import triples_finale_plain

    res = run_calculation(stage_pvtz(tmp, None), Reporter(stream=io.StringIO()), device="cpu")
    cc, o = res.cc, res.sys.nocc
    lv = spinorb_levels(torch.as_tensor(res.hf.levels, dtype=torch.float64), o // 2)
    v = cc.slices
    ops = (cc.t1, cc.t2, v.vovv, v.ovoo, v.oovv)
    e_o, e_v = lv[:o], lv[o:]
    ii, jj, kk, clen = T.strict_plan(o, cc.t1.shape[1], "hybrid")
    idx = [torch.as_tensor(x, dtype=torch.long) for x in (ii, jj, kk)]
    total = {p: float(T._triples_total_strict(*ops, e_o, e_v, *idx, clen=clen, precision=p))
             for p in ("f64", "hybrid")}

    def split(panels):
        acc = 0.0
        for c0 in range(0, len(ii), clen):
            s = slice(c0, c0 + clen)
            c, d = panels(idx[0][s], idx[1][s], idx[2][s])
            acc += float(triples_finale_plain(c, d, e_o[idx[0][s]] + e_o[idx[1][s]]
                                              + e_o[idx[2][s]], e_v))
        return acc / 6.0

    f32, rounded = [x.float() for x in ops], [x.float().double() for x in ops]
    gemm_f32 = split(lambda i, j, k: [x.double() for x in T._chunk_panels(i, j, k, *f32)])
    operands_f32 = split(lambda i, j, k: [x.float() for x in T._chunk_panels(i, j, k, *rounded)])
    emit("pVTZ spin-orbital E(T), the f32 tier's gap to f64 on the port's f64 amplitudes",
         hybrid=total["hybrid"] - total["f64"], f32_gemms_f64_algebra=gemm_f32 - total["f64"],
         operands_rounded_exact_products=operands_f32 - total["f64"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--small", action="store_true")
    p.add_argument("--pvtz-chain", action="store_true")
    p.add_argument("--pvtz-spatial", action="store_true")
    p.add_argument("--pvtz-spinorb", action="store_true")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        for flag, fn in ((args.small, small), (args.pvtz_chain, pvtz_chain),
                         (args.pvtz_spatial, pvtz_spatial), (args.pvtz_spinorb, pvtz_spinorb)):
            if flag:
                fn(Path(tmp))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
