"""spinorb_triples_roofline_pct: the spin-orbital (T)'s share of its
roofline, %: the least time the card could take for the work these
inputs need, over the device's busy time inside the (T) span of the
profiled calculation (the span around `driver._run`'s call of
`do_ccsd_t_spinorb`: K1, or the tier the program runs, with its
operands).  The work is the frozen count of the spin-orbital (T) over
the triples i<j<k (`harness/counts.py`, spin-orbital extents: twice the
spatial sizes), over the spin blocks that the RHF reference leaves
nonzero, in f64 at the tensor-core peak, against the allowed blocks of
t1, t2 and the three slices read once at the HBM bandwidth, whichever
is longer.  A kernel that runs the dense cube reads about a seventh of
its share of the dense roofline.  On a card only."""

from gpubench.harness import counts

SPANS = {"triples": ("afesp_tpu_torch.driver:do_ccsd_t_spinorb",)}


def read(run):
    p = run.profile
    busy = p.span_busy_s.get("triples", 0.0) if p is not None else 0.0
    if busy <= 0:
        return None
    o, v = 2 * run.sizes["nocc"], 2 * run.sizes["nvirt"]
    bound = counts.bound_s(counts.spinorb_triples_flops(o, v, strict=True),
                           counts.spinorb_triples_bytes(o, v), counts.PEAK_F64)
    return 100.0 * bound / busy
