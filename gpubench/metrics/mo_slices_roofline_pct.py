"""mo_slices_roofline_pct: the sliced f64 AO->MO transform's share of its
roofline, %: the least time the card could take for it, its f64
operations at the tensor-core peak or its operands' bytes at the HBM
bandwidth, whichever is longer (`harness/counts_sliced.py`), over the
device's busy time inside the transform of the profiled calculation
(the union of its kernels, copies and sets, from the profiler's trace).
On a card only; None where the program has no such transform."""

from gpubench.harness import counts, counts_sliced

SPANS = {"mo_slices": ("afesp_tpu_torch.methods.mo_slices:ao_to_mo_slices_f64",)}


def read(run):
    p = run.profile
    busy = p.span_busy_s.get("mo_slices", 0.0) if p is not None else 0.0
    if busy <= 0:
        return None
    n, o = run.sizes["nbasis"], run.sizes["nocc"]
    bound = counts.bound_s(counts_sliced.sliced_transform_flops(n, o),
                           counts_sliced.sliced_transform_bytes(n, o), counts.PEAK_F64)
    return 100.0 * bound / busy
