"""triples_ms: the (T) stage (`methods/triples_spatial.py` -> K3/K4), ms a
calculation: the synchronised span around `driver._run`'s call of the
triples function (the CR intermediates and the kernel), summed over the
traced window over its calculations."""

SPANS = {"triples": ("afesp_tpu_torch.driver:do_ccsd_t_spatial",
                     "afesp_tpu_torch.driver:do_ccsd_t_spinorb")}


def read(run):
    return run.span_ms("triples")
