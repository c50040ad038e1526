"""Building blocks on tensors: spin-orbital slicing, the CC step with
DIIS, and the CUDA triples kernels with their plain versions (port of
`afesp_tpu/ops/`)."""
