"""Input files and the stdout report (port of `afesp_tpu/io/`)."""
