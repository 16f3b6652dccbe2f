"""The median over the span stretch's steps of ``loss.backward()``,
ending in a synchronise (the benchmark's own span)."""

from portbench.harness import median

UNIT = "ms"


def read(obs):
    v = median(obs.get("spans", {}).get("backward", []))
    return None if v is None else 1e3 * v
