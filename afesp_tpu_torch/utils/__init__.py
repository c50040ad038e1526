"""Drivers around the pipeline (port of `afesp_tpu/utils/`)."""
