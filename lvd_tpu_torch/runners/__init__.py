"""Generation runners (counterpart of lvd_tpu/runners): each module has
``version``, ``init(base_model) -> (H, W)`` and ``run(parsed_layout, seed,
**hparams)``."""
