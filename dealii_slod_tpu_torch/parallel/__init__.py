from dealii_slod_tpu_torch.parallel.mesh import make_mesh, shard_patches  # noqa: F401
from dealii_slod_tpu_torch.parallel.sweep import stack_fields, sweep_step  # noqa: F401
