"""Training helpers (counterpart of ``distributionraytracer_tpu.parallel``).

Ported so far: the single-card pieces a gradient step needs
(:mod:`parallel.mesh`: ``accel_intersectors``, ``l2_render_loss``,
``detached``).  The sharded renders and training steps are not ported yet.
"""
