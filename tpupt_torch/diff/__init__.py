"""Differentiation utilities.

``fit_scene`` resolves lazily: ``fit`` imports the integrator, which
imports ``tpupt_torch.diff.overlap``, so importing ``fit`` here would make
``import tpupt_torch.render`` circular.
"""

from tpupt_torch.diff.params import extract_params, params_from_numpy, with_params

__all__ = ["extract_params", "fit_scene", "params_from_numpy", "with_params"]


def __getattr__(name):
    if name == "fit_scene":
        from tpupt_torch.diff.fit import fit_scene

        return fit_scene
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
