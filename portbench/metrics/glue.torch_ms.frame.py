"""Device milliseconds a frame in PyTorch's own kernels, copies and memsets
(``portbench.trace.is_torch``: any other kernel is the program's)."""

from portbench import trace

UNIT = "ms"


def read(obs):
    prof = obs.get("profile")
    if obs.get("unit") != "frame" or not prof:
        return None
    s = sum(v[1] for k, v in prof["device"].items() if trace.is_torch(k))
    return 1e3 * s / prof["units"]
