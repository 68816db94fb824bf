"""Mean seconds of the controller's commit wait a community update: span
``controller.commit_wait``, the wait for the reduce and the server step on
the stream the learners share (so it holds their work queued before it)."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "async":
        return None
    return spans.mean_s(run, "controller.commit_wait")
