"""The median over the span stretch's requests of the server state's
``frame(...)`` call (render, accumulate, copy to the host), timed around
the state object the benchmark built."""

from portbench.harness import median

UNIT = "ms"


def read(obs):
    v = median(obs.get("spans", {}).get("render", []))
    return None if v is None else 1e3 * v
