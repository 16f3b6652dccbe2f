"""Frozen scene generators, one module a generator.

Each module has ``build(b, cfg)``: it drives a builder ``b`` with the
methods of the program's ``SceneBuilder`` (``set_camera``, ``add_material``,
``add_sphere``, ``add_triangles_bulk``, ``add_point_light``, the ``accel``,
``spp`` and ``bg_color`` attributes) from the configuration ``cfg``.  The
program receives the scene through its own builder; the reference records
the same calls (``reference.scene.Recorder``).
"""
