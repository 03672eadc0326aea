"""Device ms a step of the kernels launched inside the program's
`riter.link` spans (each link's R pass, residual add and render), in one
eager step under torch.profiler with the span ranges on, where the
program's counters read 2T links and 2(T + 1) renders
(`portbench.loops.riter`)."""


def read(run):
    return run.counts.get("chain_ms") if run.loop_name == "riter" else None
