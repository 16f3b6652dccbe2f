"""The benchmark of ``distributionraytracer_tpu_torch`` on NVIDIA GPUs.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell (``workloads/<cell>.json``) of a configuration
(``configs/<config>.json``) under a traffic kind (``traffic/<kind>.py``) and
prints one JSON line.  Per-layer metrics are read by ``metrics/<name>.py``.
The plain reference that decides ``correct`` lives in ``reference/`` and
imports nothing of the program.
"""
