"""The electronic-structure methods (port of `afesp_tpu/methods/`)."""
