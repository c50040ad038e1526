"""spinorb_ccsd_roofline_pct: the spin-orbital CCSD iterations' share of
their roofline, %: the least time the card could take for the profiled
calculation's CC iterations, over the device's busy time inside its
CCSD span (the union of its kernels, copies and sets, from the
profiler's trace).  The work is the frozen count of the spin-orbital
iteration (`harness/counts.py`, spin-orbital extents: twice the spatial
sizes): at "f64" the Sz-blocked f64 operations at the f64 tensor-core
peak, on the digit-GEMM route the digit-pair products at the int8 peak,
against the Sz-allowed blocks of the slices and the amplitudes at the
HBM bandwidth, whichever bound is longer.  On a card only."""

from gpubench.harness import counts

SPANS = {"ccsd": ("afesp_tpu_torch.driver:do_ccsd_spinorb",)}


def read(run):
    p, calc = run.profile, run.profiled
    busy = p.span_busy_s.get("ccsd", 0.0) if p is not None else 0.0
    if busy <= 0 or not calc or not calc.get("cc_iterations"):
        return None
    o, v = 2 * run.sizes["nocc"], 2 * run.sizes["nvirt"]
    peak = counts.PEAK_INT8 if run.precision in counts.HYBRID else counts.PEAK_F64
    bound = counts.bound_s(counts.spinorb_ccsd_iteration_flops(o, v, run.precision),
                           counts.spinorb_ccsd_iteration_bytes(o, v), peak)
    return 100.0 * bound * calc["cc_iterations"] / busy
