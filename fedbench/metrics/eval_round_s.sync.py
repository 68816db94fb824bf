"""Mean ``RoundTimings.eval_round_s`` over the window's rounds: the committed
model's broadcast, every learner's receive and its eval forward."""


def read(run):
    if run.protocol != "sync" or not run.timings:
        return None
    return sum(t.eval_round_s for t in run.timings) / len(run.timings)
