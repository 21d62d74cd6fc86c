"""Architecture configs — one module per model, registered by name
(:func:`repro_torch.configs.base.get_config`)."""
