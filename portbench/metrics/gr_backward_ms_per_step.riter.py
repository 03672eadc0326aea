"""Device ms a step of the kernels launched inside the program's
`riter.gr_backward` span (the G/R loss's backward through the correction
chain; the autograd engine's launches count for the span its caller is
in), in one eager step under torch.profiler (`portbench.loops.riter`)."""


def read(run):
    return run.counts.get("gr_backward_ms") if run.loop_name == "riter" else None
