"""fock_roofline_pct: the sliced f64 tier's Fock builds' share of their
roofline, %: the least time the card could take for the profiled
calculation's Fock builds (one each SCF iteration but the last), each
reading the unique two-electron integrals once at the HBM bandwidth
(`harness/counts_sliced.py`), over the device's busy time inside the
builds (the union of their kernels, copies and sets, from the
profiler's trace; the span wraps the program's row-table Fock build).
On a card only; None where the program has no such build."""

from gpubench.harness import counts, counts_sliced

SPANS = {"fock": ("afesp_tpu_torch.methods.hf:fock_build_rows",)}


def read(run):
    p, calc = run.profile, run.profiled
    busy = p.span_busy_s.get("fock", 0.0) if p is not None else 0.0
    if busy <= 0 or not calc or not calc.get("scf_iterations"):
        return None
    builds = calc["scf_iterations"] - 1
    bound = counts_sliced.fock_build_bytes(run.sizes["nbasis"]) / counts.HBM_BYTES_S
    return 100.0 * bound * builds / busy
