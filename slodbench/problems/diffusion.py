"""The diffusion problem -div(alpha grad u) = f: one component, the
coefficient field "alpha"."""


def components(settings: dict) -> int:
    return 1


def port_problem(cfg):
    """The port's problem object for the ``SLODConfig`` ``cfg``."""
    from dealii_slod_tpu_torch import DiffusionProblem
    return DiffusionProblem(cfg)


def reference(settings: dict, device, dtype, tf32: bool):
    """The plain reference of the configuration's settings."""
    from reference.slod import ReferenceSLOD
    return ReferenceSLOD.of_settings(settings, 1, device, dtype, tf32)
