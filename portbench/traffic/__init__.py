"""Traffic kinds, one module a kind; each has ``run(ctx) -> Outcome``.
A cell's file (``workloads/<cell>.json``) names its kind and holds the
parameters the kind reads."""
