from tpupt_torch.denoise.atrous import atrous_denoise, atrous_pass

__all__ = ["atrous_denoise", "atrous_pass"]
