"""Device ms a frame of the kernels launched in ``Trainer.val``'s
``val.evaluate`` span (the evaluator: LPIPS' VGG on the card; PSNR and
SSIM run on the host)."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    if not stages or "val.evaluate" not in stages or not rec.get("units"):
        return None
    return stages["val.evaluate"] / rec["units"] * 1e3
