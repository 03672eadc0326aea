"""Device ms a step outside the port's three ops' kernels (cuDNN, cuBLAS,
eager elementwise ops, Adam, copies), from torch.profiler over the traced
segment."""


def read(run):
    t = run.trace_summary
    if run.loop_name != "train" or t is None or not t.units:
        return None
    return t.library_s / t.units * 1e3
