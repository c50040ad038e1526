"""triples_roofline_pct: the (T) stage's share of its roofline, %: the
least time the card could take for the work these inputs need, over the
device's busy time inside the (T) span of the profiled calculation (the
union of its kernels, copies and sets, from the profiler's trace: the
CR chain and the kernel, without the host's time between them).  The
work is the frozen count of the restricted family with the CR moment
over the sorted triples i<=j<=k (`harness/counts.py`) in f64 at the
tensor-core peak, against the amplitudes, integrals and CR
intermediates read once at the HBM bandwidth, whichever is longer.  On
a card only."""

from gpubench.harness import counts

SPANS = {"triples": ("afesp_tpu_torch.driver:do_ccsd_t_spatial",)}


def read(run):
    p = run.profile
    busy = p.span_busy_s.get("triples", 0.0) if p is not None else 0.0
    if busy <= 0:
        return None
    o, v = run.sizes["nocc"], run.sizes["nvirt"]
    bound = counts.bound_s(counts.spatial_triples_flops(o, v, doing_CR=True, strict=True),
                           counts.spatial_triples_bytes(o, v), counts.PEAK_F64)
    return 100.0 * bound / busy
