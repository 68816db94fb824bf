"""Mean seconds of a train task's local steps in the traced rounds: span
``learner.steps``, from the first step's launch to the learner's wait on the
stream returning (8 steps a task; the wait covers work other learners queued
on the shared stream before the last step)."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "sync":
        return None
    return spans.mean_s(run, "learner.steps")
