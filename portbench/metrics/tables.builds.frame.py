"""Kernel-table packings a frame: every ``tables.builds.<table>`` counter
of the program (level tables, object tables, material rows, packed
objects, ray permutations, pixel grids), each packing counted where it
runs, nested ones too."""

from portbench import program_trace

UNIT = "calls"


def read(obs):
    prog = program_trace.read(obs, "frame")
    if prog is None:
        return None
    return sum(v for k, v in prog["counts"].items()
               if k.startswith("tables.builds."))
