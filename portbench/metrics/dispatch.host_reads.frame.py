"""Reads from the card to the host a frame that the program makes
(``.cpu()``, ``.item()``, ``.tolist()``, ``int()`` / ``float()`` /
``bool()`` of a device tensor, a ``nonzero``'s size): its
``sync.host_reads`` counter, 0 where it counts none."""

from portbench import program_trace

UNIT = "reads"


def read(obs):
    prog = program_trace.read(obs, "frame")
    return None if prog is None else prog["counts"].get("sync.host_reads",
                                                         0.0)
