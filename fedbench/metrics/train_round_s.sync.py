"""Mean ``RoundTimings.train_round_s`` over the window's rounds: dispatch to
the last upload's arrival, the learners' local steps and the uplink."""


def read(run):
    if run.protocol != "sync" or not run.timings:
        return None
    return sum(t.train_round_s for t in run.timings) / len(run.timings)
