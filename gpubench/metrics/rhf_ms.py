"""rhf_ms: restricted Hartree-Fock (`methods/hf.py`), ms a calculation:
the synchronised span around `driver._run`'s call of `hf_mod.do_rhf`, summed
over the traced window over its calculations."""

SPANS = {"rhf": ("afesp_tpu_torch.driver:hf_mod.do_rhf",)}


def read(run):
    return run.span_ms("rhf")
