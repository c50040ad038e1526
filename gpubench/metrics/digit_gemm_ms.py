"""digit_gemm_ms: the digit GEMM (`ops/exact_gemm.py`), ms a calculation:
the device time between CUDA events recorded around each outermost call
into `exact_gemm`, `exact_einsum` and `gemm_B_pre_streamed`, summed over
the traced window over its calculations.  On a card only."""

TARGETS = ("afesp_tpu_torch.ops.exact_gemm:exact_gemm",
           "afesp_tpu_torch.ops.exact_gemm:exact_einsum",
           "afesp_tpu_torch.ops.exact_gemm:gemm_B_pre_streamed")


class Probe:
    """CUDA events around the outermost digit-GEMM calls."""

    def __init__(self):
        self.pairs = []
        self.depth = 0

    def install(self, patches) -> None:
        for target in TARGETS:
            patches.wrap_everywhere(target, self._wrap)

    def _wrap(self, fn):
        import torch

        def wrapped(*args, **kwargs):
            if self.depth == 0:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                if self.depth == 0:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.pairs.append((start, end))
        return wrapped

    def seconds(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs) * 1e-3


def read(run):
    probe = run.probes.get("digit_gemm_ms")
    if probe is None or not probe.pairs or not run.calcs:
        return None
    return probe.seconds() / run.calcs * 1e3
