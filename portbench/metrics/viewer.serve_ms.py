"""The median over the span stretch's requests of the request's time
minus its ``frame(...)`` span: PNG encoding, copies and HTTP."""

from portbench.harness import median

UNIT = "ms"


def read(obs):
    v = median(obs.get("spans", {}).get("serve", []))
    return None if v is None else 1e3 * v
