"""The 95th percentile of every request's time in the window, from the
call of `sample_filtered` to its return; a failed request counts as
infinite."""


def read(run):
    if run.loop_name != "filter":
        return None
    return run.counts.get("request_p95_ms")
