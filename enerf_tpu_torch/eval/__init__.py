"""Evaluation of the port: PSNR, skimage-compatible SSIM, LPIPS-VGG and
depth metrics, and the three evaluators; counterpart of
``enerf_tpu/eval`` (metrics, evaluators, LPIPS), which it never imports."""
