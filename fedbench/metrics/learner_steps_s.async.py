"""Mean seconds of a task's local steps in the traced window: span
``learner.steps``, from the first step's launch to the learner's wait on the
stream returning (2 steps a task; the wait covers work other learners queued
on the shared stream before the last step)."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "async":
        return None
    return spans.mean_s(run, "learner.steps")
