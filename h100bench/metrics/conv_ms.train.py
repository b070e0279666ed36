"""Device ms a train step spends in convolution kernels: cuDNN's
forward, data-gradient and weight-gradient engines and their layout
transforms, by kernel name, over the traced steps."""

NAMES = ("cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm", "convolve",
         "nchwToNhwc", "nhwcToNchw")


def read(cell, traced):
    if traced is None:
        return None
    seconds = sum(s for k, (s, _) in traced.kernels.items()
                  if any(n in k for n in NAMES))
    if not seconds:
        return None
    return 1e3 * seconds / cell.trace_stats["steps"]
