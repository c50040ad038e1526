"""mp2_ms: the AO->MO transform and MP2 (`methods/mp2.py`), ms a
calculation: the synchronised span around `driver._run`'s call of
`mp2_mod.do_mp2_spatial`, summed over the traced window over its
calculations."""

SPANS = {"mp2": ("afesp_tpu_torch.driver:mp2_mod.do_mp2_spatial",)}


def read(run):
    return run.span_ms("mp2")
