"""Linear elasticity -div(2 mu eps(u) + lam tr(eps(u)) I) = f: one
component per axis, the Lame fields "lam" and "mu"."""


def components(settings: dict) -> int:
    return settings["dim"]


def port_problem(cfg):
    """The port's problem object for the ``SLODConfig`` ``cfg``."""
    from dealii_slod_tpu_torch import ElasticityProblem
    return ElasticityProblem(cfg)


def reference(settings: dict, device, dtype, tf32: bool):
    """The plain reference of the configuration's settings."""
    from reference.slod import ReferenceSLOD
    return ReferenceSLOD.of_settings(settings, settings["dim"], device,
                                     dtype, tf32)
