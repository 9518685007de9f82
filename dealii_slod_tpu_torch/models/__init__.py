from dealii_slod_tpu_torch.models.lod import LODSolver  # noqa: F401
from dealii_slod_tpu_torch.models.diffusion import DiffusionProblem  # noqa: F401
from dealii_slod_tpu_torch.models.elasticity import ElasticityProblem  # noqa: F401
from dealii_slod_tpu_torch.models.reaction import ReactionDiffusionProblem  # noqa: F401
