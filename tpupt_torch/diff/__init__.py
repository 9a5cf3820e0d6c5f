from tpupt_torch.diff.params import extract_params, params_from_numpy, with_params

__all__ = ["extract_params", "params_from_numpy", "with_params"]
