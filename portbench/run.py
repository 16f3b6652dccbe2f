"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``workloads/<cell>.json``) names its configuration and its
traffic kind.  The run makes its inputs from ``--seed``, sets up and warms
every shape the window uses, runs the window for ``--seconds``, checks what
the window produced against the reference, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device`` and, traced, ``breakdown``, then ``checks``: each number
compared beside its limit, also written as the last lines of standard
error.  Without a CUDA device, or with fewer than the cell asks for, it
exits with code 3 and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from portbench import harness


def run_cell(ctx):
    """The traffic kind's Outcome of the run ``ctx``."""
    kind = importlib.import_module("portbench.traffic."
                                   + ctx.workload["kind"])
    return kind.run(ctx)


def result(ctx, out, chips):
    """(result dict, standard-error lines) of an Outcome."""
    import torch

    cuda = ctx.device != "cpu"
    if ctx.trace:
        obs = dict(out.obs, profile=out.profile)
        metrics = harness.read_metrics(obs)
    else:
        metrics = {k: {"value": float(v), "unit": u}
                   for k, (v, u) in out.end_to_end.items()}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": chips, "memory_peak_bytes": out.memory_peak_bytes}
    res = {"correct": out.checks.correct, "attempted": out.attempted,
           "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace and out.profile is not None:
        from portbench import trace
        device["busy_s"] = out.profile["busy_s"]
        device["window_s"] = out.profile["window_s"]
        res["breakdown"] = trace.breakdown(out.profile)
    res["checks"] = out.checks.as_dict()
    return res, out.checks.lines()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = harness.process_start()
    ctx = harness.Context(args.workload, args.seed, args.seconds, args.trace,
                          t_start=t_start)
    chips = int(ctx.workload["chips"])
    # every cache the run writes stays at a fixed path in the checkout
    cache = os.path.join(harness.ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    import torch

    ctx.mark("import torch")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.init()
    ctx.mark("CUDA context")
    out = run_cell(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that a run may not load: {bad}",
              file=sys.stderr)
        return 4
    res, lines = result(ctx, out, chips)
    sys.stdout.flush()
    for phase, t in ctx.phases:
        print(f"setup phase {phase}: ends at {t:.3f} s", file=sys.stderr)
    print(f"setup: reference left out {ctx.excluded:.3f} s", file=sys.stderr)
    if out.profile is not None and out.obs.get("unit_s"):
        per = out.profile["window_s"] / out.profile["units"]
        print(f"profiled stretch: {per:.6f} s a {out.obs['unit']}; window: "
              f"{out.obs['unit_s']:.6f} s (profiler's stretch "
              f"{per / out.obs['unit_s']:.4f})", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
