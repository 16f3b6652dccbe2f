"""The share of the program-traced stretch's device idle seconds that fall
inside the program's ``whitted.level`` spans (their children included):
each idle interval split among the innermost spans open over it
(``portbench.program_trace.attribute``)."""

from portbench import program_trace

UNIT = "fraction"


def read(obs):
    prog = program_trace.read(obs, "frame")
    if prog is None or not prog["idle_s"]:
        return None
    return prog["idle_in"].get("whitted.level", 0.0) / prog["idle_s"]
