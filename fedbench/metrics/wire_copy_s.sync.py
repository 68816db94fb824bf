"""Device seconds of the host-device copies (HtoD and DtoH) the profiler
recorded in the traced window, per round committed in it: the
uplink's and downlink's pageable copies."""


def read(run):
    if run.protocol != "sync" or run.trace is None or run.traced_steps <= 0:
        return None
    return run.trace.copy_s / run.traced_steps
