"""The port's runnable studies (counterparts of ``examples/``), each run as
``python -m dealii_slod_tpu_torch.examples.<name>``."""
