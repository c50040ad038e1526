"""The benchmark of the PyTorch/CUDA port (`afesp_tpu_torch`): see run.py."""
