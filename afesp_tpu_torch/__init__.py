"""afesp_tpu_torch — the PyTorch/CUDA port of `afesp_tpu`.

A second package beside the JAX reference: the same `els.in` inputs, the
same `.dat` integral files, the same stdout report and energies, with
plain PyTorch on f64 tensors around hand-written CUDA kernels for the
triples (`csrc/`).  It imports `torch`, numpy and scipy, never `jax` and
nothing of `afesp_tpu`.

Entry points take `device=None`, which means `cuda:0` and raises when no
card is present; the tests pass `device="cpu"`.
"""

__version__ = "0.1.0"
