"""The port's inference / evaluation CLI; counterpart of the repo's
``run.py`` (reference run.py), dispatched by ``--type``::

    python -m enerf_tpu_torch.run --type dataset  --cfg_file ...  # loader smoke
    python -m enerf_tpu_torch.run --type network  --cfg_file ...  # timed forwards
    python -m enerf_tpu_torch.run --type evaluate --cfg_file ...  # metrics + FPS
    python -m enerf_tpu_torch.run --type visualize --cfg_file ... # render video

followed by ``key.subkey value`` overrides, as ``run.py`` takes them. It
runs on the card unless ``--device cpu`` is given. The batches come from
``datasets.loader.make_data_loader(cfg, "test")``, the network from
``build_model(cfg)`` with the newest checkpoint under
``cfg.trained_model_dir`` (without one it warns and keeps the seeded
initialization, as ``run.py`` does), the metrics from
``factory.make_evaluator(cfg)``, the videos from
``factory.make_visualizer(cfg)``.

Frame time is the reference's method (run.py:62-76): each frame's forward
timed on its own, the first frame excluded from the mean. The frame loop
records its spans (``utils/profiling.record``): ``eval.upload`` and
``eval.forward`` give the upload's and the forward's ms, on the card by
their CUDA events, on the CPU by the host clock. Beside it: the loader's
host time a batch (decode, PFM, rays and collation, in its worker), the
time the loop waited for it, and the bytes uploaded a frame; for
``--type visualize`` the host ms of the visualizer a frame (the copy to
the host already made) and of the videos' encoding.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from enerf_tpu_torch import build_model, resolve_device
from enerf_tpu_torch.config import Config, make_cfg
from enerf_tpu_torch.datasets.loader import device_batch, make_data_loader
from enerf_tpu_torch.utils.profiling import record, span


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m enerf_tpu_torch.run",
        description="Evaluate, time or iterate the test split of a config "
                    "with the PyTorch/CUDA port.")
    parser.add_argument("--type", dest="run_type", default="evaluate",
                        choices=["dataset", "network", "evaluate",
                                 "visualize"])
    parser.add_argument("--cfg_file",
                        default="configs/enerf/dtu_pretrain.yaml")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def load_eval_model(cfg: Config, device) -> torch.nn.Module:
    """The network ``cfg.network_module`` names, in eval mode on
    ``device``, with the newest checkpoint under ``cfg.trained_model_dir``
    or, when there is none, its seeded initialization."""
    from enerf_tpu_torch.train.checkpoint import load_network

    model = build_model(cfg, device=device)
    epoch = load_network(model, cfg.trained_model_dir)
    if epoch:
        print(f"loaded checkpoint epoch {epoch - 1} from "
              f"{cfg.trained_model_dir}")
    else:
        print(f"WARNING: no checkpoint under {cfg.trained_model_dir}; "
              "using the seeded random init")
    return model.eval()


def _frames(cfg: Config, device, consume=None) -> Dict:
    """Every test batch through the model (and ``consume(outputs,
    batch)``, on the host copy of the outputs): the per-frame times (the
    spans ``eval.upload`` and ``eval.forward``), the FPS of their mean with
    the first frame excluded (as the reference's run.py excludes it), and
    the first frame's batch and outputs."""
    loader = make_data_loader(cfg, "test")
    model = load_eval_model(cfg, device)
    cuda = device.type == "cuda"
    wait_ms, n_bytes = [], []
    first_batch = first_out = None
    with record(device=cuda) as rec:
        t = time.perf_counter()
        for batch_np in loader:
            wait_ms.append(1e3 * (time.perf_counter() - t))
            rec.next_unit()
            with span("eval.upload"):
                batch = device_batch(batch_np, device)
            with span("eval.forward"), torch.inference_mode():
                out = model(batch)
            n_bytes.append(sum(v.numel() * v.element_size()
                               for v in batch.values()))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if first_batch is None:
                first_batch, first_out = batch_np, out
            if consume is not None:
                consume(out, batch_np)
            t = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(device)
    ms = rec.device_ms if cuda else rec.host_ms
    frame_ms, upload_ms = ms("eval.forward"), ms("eval.upload")
    timed = frame_ms[1:] or frame_ms
    return {"frames": len(frame_ms), "frame_ms": frame_ms,
            "fps": 1e3 / float(np.mean(timed)) if timed else float("nan"),
            "upload_ms": upload_ms, "upload_bytes": n_bytes,
            "loader_host_ms": loader.host_ms, "loader_wait_ms": wait_ms,
            "timer": "cuda events" if cuda else "host clock",
            "model": model, "first_batch": first_batch,
            "first_out": first_out}


def _report(res: Dict) -> None:
    """Print the loader's and the frames' times."""
    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    print(f"frames: {res['frames']}  loader host ms a batch (median): "
          f"{med(res['loader_host_ms']):.2f}  loader wait ms (median): "
          f"{med(res['loader_wait_ms']):.2f}")
    if not res["frame_ms"]:
        return
    print(f"upload ms (median): {med(res['upload_ms']):.3f}  bytes "
          f"uploaded a frame: {res['upload_bytes'][0]}")
    print(f"FPS: {res['fps']:.3f} ({1e3 / res['fps']:.2f} ms/frame, "
          f"{res['timer']} around each forward, first frame excluded)")


def run_dataset(cfg: Config, device=None) -> Dict:
    """Iterate the test loader end to end (reference run.py:5-12)."""
    loader = make_data_loader(cfg, "test")
    wait_ms, t = [], time.perf_counter()
    n = 0
    for _ in loader:
        wait_ms.append(1e3 * (time.perf_counter() - t))
        n += 1
        t = time.perf_counter()
    res = {"frames": 0, "batches": n, "loader_host_ms": loader.host_ms,
           "loader_wait_ms": wait_ms, "frame_ms": []}
    print(f"batches: {n}")
    _report(res)
    return res


def run_network(cfg: Config, device=None) -> Dict:
    """Timed forward passes, no metrics (reference run.py:14-37)."""
    res = _frames(cfg, resolve_device(device))
    _report(res)
    return res


def run_evaluate(cfg: Config, device=None) -> Dict:
    """Metrics + FPS (reference run.py:39-76)."""
    from enerf_tpu_torch.factory import make_evaluator

    device = resolve_device(device)
    evaluator = make_evaluator(cfg, device=device)
    res = _frames(cfg, device, evaluator.evaluate)
    res["metrics"] = evaluator.summarize()
    _report(res)
    return res


def run_visualize(cfg: Config, device=None) -> Dict:
    """Render the test path to ``color.mp4`` and ``depth.mp4`` (reference
    run.py:79-103): each frame's outputs through the visualizer, then its
    ``summarize`` (the encoding)."""
    from enerf_tpu_torch.factory import make_visualizer

    device = resolve_device(device)
    visualizer = make_visualizer(cfg)
    visualize_ms = []

    def visualize(out, batch_np):
        t0 = time.perf_counter()
        visualizer.visualize(out, batch_np)
        visualize_ms.append(1e3 * (time.perf_counter() - t0))

    res = _frames(cfg, device, visualize)
    res.update(visualize_ms=visualize_ms, **visualizer.summarize())
    _report(res)
    print(f"visualize host ms a frame (median): "
          f"{statistics.median(visualize_ms):.2f}  encode host ms: "
          f"{res['encode_ms']:.2f}")
    return res


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv`` (default: the command line), run the ``--type``
    asked for, and return its result: the frame, upload and loader times,
    the metrics (``evaluate``), the model and the first frame's batch and
    outputs; for ``visualize`` the visualizer's and the encoding's host
    ms."""
    args = parse_args(argv)
    cfg = make_cfg(args.cfg_file, args.opts)
    run = {"dataset": run_dataset, "network": run_network,
           "evaluate": run_evaluate, "visualize": run_visualize}[args.run_type]
    return run(cfg, args.device)


if __name__ == "__main__":
    main()
