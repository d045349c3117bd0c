from .core import bpp_from_likelihoods, mse, psnr, vi, vi_msim
from .msssim import ms_ssim

__all__ = ["bpp_from_likelihoods", "mse", "psnr", "vi", "vi_msim", "ms_ssim"]
