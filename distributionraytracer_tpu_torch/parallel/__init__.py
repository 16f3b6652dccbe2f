"""Training and sharding (counterpart of ``distributionraytracer_tpu.parallel``).

:mod:`parallel.mesh`: ``accel_intersectors`` over every table type (the
differentiable route with ``differentiable=True``), ``l2_render_loss``,
``detached``, and pixel-row sharding over ``torch.distributed``
(``maybe_init_distributed``, ``RowMesh``, ``render_image_sharded``,
``make_sharded_train_step``).
"""
