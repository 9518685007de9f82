from dealii_slod_tpu_torch.parallel.sweep import stack_fields, sweep_step  # noqa: F401
