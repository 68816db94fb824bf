"""Host seconds of the uplink a traced round: spans ``learner.upload`` (pack
the trained row, encode it: the copy to the host) and ``controller.ingest``
(decode: the copy to the card, screen, arena write), summed over the traced
window and divided by its rounds.  Uploads of the two workers overlap."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "sync":
        return None
    return spans.per_step_s(run, "learner.upload", "controller.ingest")
