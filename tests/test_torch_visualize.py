"""The port's video visualizers, the evaluators' ``save_result`` and
``python -m enerf_tpu_torch.run --type visualize`` on the CPU.

The visualizers and evaluators take the same seeded output dicts and
batches in the JAX package and in the port; no model runs. Held to JAX's:
the cropped frames and depths exactly; the ``save_result`` PNGs pixel for
pixel; the per-frame JPGs (imageio / Pillow in JAX, the port's encoder),
decoded by the port's decoder, within ``JPG_MAX_DIFF``; ``color.mp4`` and
``depth.mp4`` read back by OpenCV with JAX's frame count, size and fps,
each colour frame within ``VIDEO_PSNR`` dB of the frame that was written
and no further from it than JAX's ``mp4v`` frame (the port's samples are
JPEGs at quality 90). The CLI renders the outdoor
orbit path (``actor1_path.yaml`` on ``tests/test_datasets.py``'s outdoor
fixture, 2 frames at 64x64); its first frame equals the port's own forward
on the same batch (the composite is held against JAX in
``tests/test_torch_composite.py``)."""

from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from enerf_tpu import config as jconfig
from enerf_tpu_torch import config as pconfig
from enerf_tpu_torch.utils.image_io import imread
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
H, W, N_FRAMES = 40, 60, 3
# the port's JPEG encoder against Pillow's at quality 75: the same tables
# and 4:2:0, another forward DCT and rounding (up to 4 on whole blocks),
# and the partial last block row padded to the MCU before the chroma is
# averaged, where libjpeg pads each component after (up to 12 there)
JPG_MAX_DIFF = 12
VIDEO_PSNR = 30.0


def _smooth(rng, h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    a = rng.uniform(0.5, 2.0, (4, c))
    img = 0.5 + 0.35 * np.sin(x[..., None] / (6 * a[0]) + a[1]) * np.cos(
        y[..., None] / (5 * a[2]) - a[3])
    return (img + 0.01 * rng.randn(h, w, c)).astype(np.float32)


def _frames():
    """(outputs, batch) of N_FRAMES frames: rgb a little outside [0, 1],
    depths in [2, 5]."""
    rng = np.random.RandomState(0)
    out = []
    for k in range(N_FRAMES):
        rgb = _smooth(rng, H, W, 3) * 1.1 - 0.05
        depth = 2.0 + 3.0 * _smooth(rng, H, W, 1)[..., 0]
        out.append(({"rgb_level1": rgb.reshape(1, -1, 3),
                     "depth_level1": depth.reshape(1, -1)},
                    {"src_inps": np.zeros((1, 3, H, W, 3), np.float32),
                     "meta": {"frame_id": [10 * k + 3]}}))
    return out


def _read_video(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    return frames, cap.get(cv2.CAP_PROP_FPS)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_visualizer_matches_jax(tmp_path):
    from enerf_tpu import native as jnative
    from enerf_tpu.eval.visualizer import Visualizer as JVis
    from enerf_tpu_torch.eval.visualizer import Visualizer as PVis

    jcfg = jconfig.Config(workspace=str(tmp_path / "jax"), save_result=True)
    pcfg = pconfig.Config(workspace=str(tmp_path / "port"), save_result=True)
    jvis, pvis = JVis(jcfg), PVis(pcfg)
    for out, batch in _frames():
        jvis.visualize(out, batch)
        pvis.visualize(out, batch)
    for a, b in zip(pvis.imgs + pvis.depths, jvis.imgs + jvis.depths):
        np.testing.assert_array_equal(a, b)
    assert pvis.imgs[0].shape == (H - H // 10, W - 2 * (W // 10), 3)
    written = [jnative.f32_unit_to_u8(im) for im in jvis.imgs]
    jdir, pdir = Path(jcfg.result_dir), Path(pcfg.result_dir)
    names = sorted(p.name for p in (jdir / "imgs").iterdir())
    assert names == sorted(p.name for p in (pdir / "imgs").iterdir())
    assert len(names) == 2 * N_FRAMES and "000003_rgb.jpg" in names
    for name in names:
        got, ref = imread(str(pdir / "imgs" / name)), imread(
            str(jdir / "imgs" / name))
        assert got.shape == ref.shape
        assert np.abs(got.astype(int) - ref).max() <= JPG_MAX_DIFF, name

    jvis.summarize()
    stats = pvis.summarize()
    assert stats["frames"] == N_FRAMES and stats["encode_ms"] > 0
    for name in ("color.mp4", "depth.mp4"):
        got, got_fps = _read_video(pdir / name)
        ref, ref_fps = _read_video(jdir / name)
        assert len(got) == len(ref) == N_FRAMES and got_fps == ref_fps == 24
        assert got[0].shape == ref[0].shape == written[0].shape
        if name == "color.mp4":
            for g, r, w in zip(got, ref, written):
                assert _psnr(g, w) >= max(VIDEO_PSNR, _psnr(r, w))


def test_visualizer_interactive_matches_jax():
    from enerf_tpu.eval.visualizer_interactive import Visualizer as JVis
    from enerf_tpu_torch.eval.visualizer_interactive import Visualizer as PVis

    out, batch = _frames()[1]
    ref = JVis(jconfig.Config()).visualize(out, batch)
    got = PVis(pconfig.Config()).visualize(out, batch)
    assert set(got) == set(ref) == {"pred"}
    np.testing.assert_array_equal(got["pred"], ref["pred"])


def _eval_inputs(kind, rng):
    """(outputs, batch) at 32x48 for the evaluator ``kind``: a batch of 2,
    both levels rendered."""
    B, h, w = 2, 32, 48
    out, batch = {}, {"src_inps": np.zeros((B, 3, h, w, 3), np.float32),
                      "meta": {"scene": ["scan1", "scan8"],
                               "tar_view": [4, 7], "frame_id": [0, 12]}}
    for i, rs in enumerate((0.25, 1.0)):
        n = int(h * rs) * int(w * rs)
        out[f"rgb_level{i}"] = rng.uniform(-0.1, 1.1, (B, n, 3)).astype(
            np.float32)
        out[f"depth_level{i}"] = rng.uniform(2, 5, (B, n)).astype(np.float32)
        batch[f"rgb_{i}"] = rng.uniform(0, 1, (B, n, 3)).astype(np.float32)
        batch[f"msk_{i}"] = (rng.uniform(size=(B, n)) > 0.3).astype(
            np.float32)
    m = np.zeros((B, h, w), np.float32)
    m[:, 6:26, 10:30] = 1.0
    batch["mask_at_box"] = m.reshape(B, -1)
    return out, batch


@pytest.mark.parametrize("kind", ["evaluator", "evaluator_human",
                                  "evaluator_composite"])
def test_save_result_pngs_match_jax(kind, tmp_path):
    """Each evaluator's ``save_result`` PNGs equal the JAX evaluator's,
    pixel for pixel, with the same names."""
    import importlib

    from enerf_tpu_torch.factory import make_evaluator

    def cfg(mod, root):
        return mod.Config(workspace=str(root), save_result=True,
                          eval_lpips=False,
                          evaluator_module=f"enerf_tpu.eval.{kind}")

    jcfg, pcfg = cfg(jconfig, tmp_path / "jax"), cfg(pconfig, tmp_path / "port")
    jev = importlib.import_module(f"enerf_tpu.eval.{kind}").Evaluator(jcfg)
    pev = make_evaluator(pcfg, device="cpu")
    out, batch = _eval_inputs(kind, np.random.RandomState(1))
    jev.evaluate(out, batch)
    pev.evaluate(out, batch)
    jdir, pdir = Path(jcfg.result_dir), Path(pcfg.result_dir)
    names = sorted(p.name for p in pdir.glob("*.png"))
    assert names == sorted(p.name for p in jdir.glob("*.png"))
    assert names == ["scan1_4_0.png", "scan8_7_12.png"]
    for name in names:
        got = imread(str(pdir / name))
        np.testing.assert_array_equal(got, imageio.imread(jdir / name))
        assert got.shape[1] == {"evaluator_composite": 3}.get(kind, 2) * 48


def test_run_visualize_cpu(tmp_path):
    """``--type visualize --device cpu`` on the outdoor orbit path: both
    videos with a frame a path view, frame 0 equal to the port's own
    forward on the CLI's first batch, and to the first frame of
    ``color.mp4`` within ``VIDEO_PSNR``."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch import native
    from enerf_tpu_torch.run import main
    from enerf_tpu_torch.utils.video import read_mp4
    from tests.test_datasets import _make_outdoor_fixture

    _make_outdoor_fixture(str(tmp_path))
    cfg_file = str(REPO / "configs/enerf/enerf_outdoor/actor1_path.yaml")
    opts = ["workspace", str(tmp_path), "test_dataset.frames", "[0, -1, 1]",
            "test_dataset.num_circle_view", "4",
            "test_dataset.input_h_w", "[64, 64]",
            "enerf.fg_bbox_hw", "[32, 32]", "train.num_workers", "1"]
    res = main(["--type", "visualize", "--device", "cpu", "--cfg_file",
                cfg_file, *opts])
    assert res["frames"] == 2 == len(res["visualize_ms"])
    assert res["encode_ms"] > 0
    ref = et.render(res["model"], res["first_batch"])
    for k, v in res["first_out"].items():
        np.testing.assert_array_equal(v, ref[k].numpy(), err_msg=k)
    out_dir = Path(pconfig.make_cfg(cfg_file, opts).result_dir)
    rgb = res["first_out"]["rgb_level1"].reshape(64, 64, 3)[6:, 6:-6]
    for name in ("color.mp4", "depth.mp4"):
        frames, fps = read_mp4(str(out_dir / name))
        assert len(frames) == 2 and fps == 24
        assert frames[0].shape == (58, 52, 3)
    frames, _ = read_mp4(str(out_dir / "color.mp4"))
    assert _psnr(frames[0], native.f32_unit_to_u8(rgb)) >= VIDEO_PSNR


@pytest.mark.parametrize("case", ["mdhd_v1", "fixed_size", "two_stts_runs",
                                  "two_chunks", "not_mp4v"])
def test_read_mp4_refuses_other_layouts(case, tmp_path):
    """``read_mp4`` reads the one layout ``write_mp4`` writes: a file with
    one field of another layout raises instead of being read."""
    import struct

    from enerf_tpu_torch.utils import video

    path = tmp_path / "v.mp4"
    rng = np.random.RandomState(1)
    video.write_mp4(str(path), [(255 * _smooth(rng, 16, 24, 3)).astype(
        np.uint8) for _ in range(2)], 24)
    frames, fps = video.read_mp4(str(path))
    assert len(frames) == 2 and frames[0].shape == (16, 24, 3) and fps == 24
    data = bytearray(path.read_bytes())
    moov = video._find(bytes(data), 0, len(data), (b"moov",))
    stbl = video._find(bytes(data), *moov,
                       (b"trak", b"mdia", b"minf", b"stbl"))

    def body(*kinds):
        return video._find(bytes(data), *stbl, kinds)[0]

    if case == "mdhd_v1":
        data[video._find(bytes(data), *moov,
                         (b"trak", b"mdia", b"mdhd"))[0]] = 1
    elif case == "fixed_size":
        struct.pack_into(">I", data, body(b"stsz") + 4, 1000)
    elif case == "two_stts_runs":
        struct.pack_into(">I", data, body(b"stts") + 4, 2)
    elif case == "two_chunks":
        struct.pack_into(">I", data, body(b"stco") + 4, 2)
    else:
        data[body(b"stsd") + 12:body(b"stsd") + 16] = b"avc1"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="write_mp4 does not write"):
        video.read_mp4(str(path))
