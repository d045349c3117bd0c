from .core import bpp_from_likelihoods, mse, mse_yuv444, psnr, rgb2yuv444, vi, vi_msim
from .msssim import ms_ssim

__all__ = ["bpp_from_likelihoods", "mse", "psnr", "vi", "vi_msim", "rgb2yuv444", "mse_yuv444",
           "ms_ssim"]
