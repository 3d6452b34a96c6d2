"""The port's host utilities against the JAX package's on the CPU: the
image helpers, the label tables, the PLY mesh writer, the projection
matrix's decomposition (against OpenCV), the camera paths, COLMAP's
formats across the two packages, ``native.u8_to_pm1_masked``, the
profiling helpers, the mesh extractor at N = 32, and the epipolar check's
keypoint picker (against OpenCV) and segments.

Tolerances: exact (or byte-equal files) for the image helpers, the
tables, the writers, ``u8_to_pm1_masked`` and marching tetrahedra; 1e-5
for the decomposition against ``cv2.decomposeProjectionMatrix``; 1e-6 for
the camera paths, ``model_to_enerf_cameras`` and the segments' end
points."""

import time

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_colmap import _assert_models_equal, _make_model
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)


def _random_projection(rng, dtype):
    """K [R | t], scaled by a factor of either sign: a well-conditioned P."""
    from enerf_tpu_torch.utils.cv import rodrigues

    K = np.array([[rng.uniform(300, 2000), rng.uniform(-5, 5),
                   rng.uniform(100, 900)],
                  [0, rng.uniform(300, 2000), rng.uniform(100, 700)],
                  [0, 0, 1]])
    Rt = np.hstack([rodrigues(rng.randn(3) * 2), rng.randn(3, 1) * 5])
    return (rng.choice([-1.0, 1.0]) * rng.uniform(0.1, 10) * K @ Rt).astype(
        dtype)


def _check_val_data(rng, tmp_path):
    from enerf_tpu.utils import val_data as jv
    from enerf_tpu_torch.config import dtu_eval_config
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
    from enerf_tpu_torch.utils import val_data as pv
    from enerf_tpu_torch.utils.image_io import imread

    # the picker against OpenCV on a seeded smooth image (bicubic noise)
    small = rng.rand(12, 16)
    gray = (np.clip(cv2.resize(small, (128, 96),
                               interpolation=cv2.INTER_CUBIC), 0, 1)
            * 255).astype(np.uint8)
    for n in (40, 400):
        want = cv2.goodFeaturesToTrack(gray, maxCorners=n, qualityLevel=0.01,
                                       minDistance=5).reshape(-1, 2)
        np.testing.assert_array_equal(pv.good_features_to_track(
            gray, n, 0.01, 5), want)
    rgb = (rng.rand(20, 24, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(pv.rgb_to_gray(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))

    batch = make_synthetic_batch(dtu_eval_config(), H=64, W=80, seed=1)
    for seed in (0, 1):
        np.testing.assert_array_equal(
            pv._keypoints(batch["tar_img"][0], 10, np.random.RandomState(seed)),
            jv._keypoints(batch["tar_img"][0], 10, np.random.RandomState(seed)))
    pts = pv._keypoints(batch["tar_img"][0], 10, np.random.RandomState(0))
    pd = np.concatenate([pts, np.full_like(pts[:, :1], 3.5)], -1)
    cams = (batch["tar_ext"][0], batch["tar_ixt"][0], batch["src_exts"][0][1],
            batch["src_ixts"][0][1])
    np.testing.assert_allclose(pv._to_src(pd, *cams), jv._to_src(pd, *cams),
                               rtol=1e-6, atol=1e-6)

    path = str(tmp_path / "val_{b}.png")
    canvases = pv.validate(batch, num_points=10, save_path=path)
    assert len(canvases) == 1 and canvases[0].shape == (64, 4 * 80, 3)
    np.testing.assert_array_equal(imread(path.format(b=0)), canvases[0])
    # the segments are drawn over the source views
    src = (np.clip(batch["src_inps"][0] * 0.5 + 0.5, 0, 1) * 255).astype(
        np.uint8)
    assert (canvases[0][:, 80:] != np.concatenate(list(src), 1)).any()
    D = 8
    prob = rng.rand(1, D, 64, 80).astype(np.float32)
    fig = pv.vis_prob(rng.rand(1, 64, 80), rng.rand(1, 64, 80) + 2, prob,
                      np.broadcast_to(np.linspace(2, 3, D)[None, :, None, None],
                                      (1, D, 64, 80)), 10, 20)
    assert fig.shape == (64, 240, 3) and fig.dtype == np.uint8


@pytest.mark.parametrize("part", ["img", "labels", "ply", "geometry", "rend",
                                  "native", "val_data"])
def test_host_utils_match_jax(part, tmp_path):
    rng = np.random.RandomState(0)
    if part == "img":
        from enerf_tpu.utils import img as j
        from enerf_tpu_torch.utils import img as p

        a = rng.rand(4, 6, 3).astype(np.float32)
        b = rng.rand(8, 2, 3).astype(np.float32)
        for f in ("horizon_concate", "vertical_concate"):
            np.testing.assert_array_equal(getattr(p, f)(a, b),
                                          getattr(j, f)(a, b))
        d = rng.rand(9, 7) * 5
        for kw in ({}, {"d_min": 1.0, "d_max": 3.0}, {"d_min": 2.0, "d_max": 2.0}):
            np.testing.assert_array_equal(p.colorize_depth(d, **kw),
                                          j.colorize_depth(d, **kw))
    elif part == "labels":
        from enerf_tpu.utils import labels as j
        from enerf_tpu_torch.utils import labels as p

        assert p.ADE20K_LABELS == j.ADE20K_LABELS and "bed " in p.ADE20K_LABELS
        assert p.HUMAN_LABELS == j.HUMAN_LABELS
        for human in (False, True):
            assert p.get_label_id_mapping(human) == j.get_label_id_mapping(human)
        names = ["bed ", "wall", "flag", "person"]
        assert p.get_class_ids_from_labels(names) == \
            j.get_class_ids_from_labels(names)
        assert p.get_class_ids_from_labels(["person"], True) == [1]
        assert p.id_label_mapping_human == j.id_label_mapping_human
    elif part == "ply":
        from enerf_tpu.utils.ply import save_ply_mesh as j_save
        from enerf_tpu_torch.utils.ply import load_ply_vertices, save_ply_mesh

        verts = rng.randn(50, 3)
        faces = rng.randint(0, 50, (70, 3))
        save_ply_mesh(str(tmp_path / "p.ply"), verts, faces)
        j_save(str(tmp_path / "j.ply"), verts, faces)
        got = (tmp_path / "p.ply").read_bytes()
        assert got == (tmp_path / "j.ply").read_bytes()
        np.testing.assert_array_equal(load_ply_vertices(str(tmp_path / "p.ply")),
                                      verts.astype(np.float32))
    elif part == "geometry":
        from enerf_tpu.utils.geometry import load_K_Rt_from_P as j_load
        from enerf_tpu_torch.utils.geometry import (
            decompose_projection,
            load_K_Rt_from_P,
        )

        for i in range(40):
            P = _random_projection(rng, np.float32 if i % 2 else np.float64)
            want = cv2.decomposeProjectionMatrix(P)[:3]
            got = decompose_projection(P)
            for g, w in zip(got[:2], want[:2]):
                assert g.dtype == w.dtype
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            assert got[2].dtype == want[2].dtype
            np.testing.assert_allclose(got[2][:3] / got[2][3],
                                       want[2][:3] / want[2][3],
                                       rtol=1e-5, atol=1e-5)
            assert got[0][0, 0] > 0 and got[0][1, 1] > 0
            for g, w in zip(load_K_Rt_from_P(P=P), j_load(P=P)):
                assert g.dtype == w.dtype
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        path = tmp_path / "cam.txt"
        path.write_text("P\n" + "\n".join(" ".join(repr(float(v)) for v in r)
                                          for r in P) + "\n")
        for g, w in zip(load_K_Rt_from_P(str(path)), j_load(str(path))):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    elif part == "rend":
        from enerf_tpu.utils import rend as j
        from enerf_tpu_torch.utils import rend as p

        c2ws = np.stack([np.hstack([cv2.Rodrigues(rng.randn(3) * 0.2)[0],
                                    rng.randn(3, 1)]) for _ in range(6)])
        np.testing.assert_allclose(p.poses_avg(c2ws), j.poses_avg(c2ws),
                                   rtol=1e-6, atol=1e-6)
        for a, b in zip(p.gen_nerf_path(c2ws, (2.0, 6.0), N_views=12),
                        j.gen_nerf_path(c2ws, (2.0, 6.0), N_views=12)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        for a, b in zip(
                p.render_path_spiral(c2ws[0], c2ws[1, :, 1], [0.3, 0.2, 0.1],
                                     4.0, N_rots=1, N=7),
                j.render_path_spiral(c2ws[0], c2ws[1, :, 1], [0.3, 0.2, 0.1],
                                     4.0, N_rots=1, N=7)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    elif part == "native":
        from enerf_tpu import native as j
        from enerf_tpu_torch import native as p

        img = rng.randint(0, 256, (33, 47, 3)).astype(np.uint8)
        mask = (rng.rand(33, 47) > 0.4).astype(np.uint8) * 7
        assert p.available()
        got = p.u8_to_pm1_masked(img, mask)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, j.u8_to_pm1_masked(img, mask))
        # the numpy path (a non-contiguous image) gives the same values
        np.testing.assert_array_equal(
            p.u8_to_pm1_masked(np.asfortranarray(img), mask), got)
    else:
        _check_val_data(rng, tmp_path)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_round_trips_across_packages(ext, tmp_path):
    """Each package reads the other's model files; the files are
    byte-equal; dense arrays and fused visibility too, and
    ``model_to_enerf_cameras`` agrees."""
    from enerf_tpu.utils import colmap as jc
    from enerf_tpu_torch.utils import colmap as pc

    cams, imgs, pts = _make_model(np.random.RandomState(3))
    pcams = {k: pc.Camera(**vars(v)) for k, v in cams.items()}
    pimgs = {k: pc.Image(**vars(v)) for k, v in imgs.items()}
    ppts = {k: pc.Point3D(**vars(v)) for k, v in pts.items()}
    jc.write_model(cams, imgs, pts, str(tmp_path / "j"), ext)
    pc.write_model(pcams, pimgs, ppts, str(tmp_path / "p"), ext)
    for name in ("cameras", "images", "points3D"):
        assert (tmp_path / "p" / (name + ext)).read_bytes() == \
            (tmp_path / "j" / (name + ext)).read_bytes(), name
    assert pc.detect_model_format(str(tmp_path / "j")) == ext
    _assert_models_equal(pc.read_model(str(tmp_path / "j")), (cams, imgs, pts))
    _assert_models_equal(jc.read_model(str(tmp_path / "p")), (cams, imgs, pts))

    rng = np.random.RandomState(4)
    arr = rng.rand(5, 7, 3).astype(np.float32)
    pc.write_array(arr, str(tmp_path / "p.bin"))
    jc.write_array(arr, str(tmp_path / "j.bin"))
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    np.testing.assert_array_equal(pc.read_array(str(tmp_path / "j.bin")), arr)
    vis = [rng.randint(0, 9, rng.randint(0, 5)).astype(np.uint32)
           for _ in range(6)]
    pc.write_fused_vis(vis, str(tmp_path / "p.vis"))
    jc.write_fused_vis(vis, str(tmp_path / "j.vis"))
    assert (tmp_path / "p.vis").read_bytes() == (tmp_path / "j.vis").read_bytes()
    for a, b in zip(jc.read_fused_vis(str(tmp_path / "p.vis")), vis):
        np.testing.assert_array_equal(a, b)

    R = cv2.Rodrigues(rng.randn(3))[0]
    np.testing.assert_allclose(pc.rotmat2qvec(R), jc.rotmat2qvec(R),
                               rtol=1e-6, atol=1e-6)
    (pn, pi, pe), (jn, ji, je) = (pc.model_to_enerf_cameras(pcams, pimgs),
                                  jc.model_to_enerf_cameras(cams, imgs))
    assert pn == jn
    np.testing.assert_allclose(pi, ji, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pe, je, rtol=1e-6, atol=1e-6)


def test_profiling_helpers_on_cpu(monkeypatch, tmp_path):
    """``perf_timer`` and ``time_fn`` take JAX's arguments and on CPU
    tensors never synchronize a card; ``trace`` writes a Chrome trace."""
    from enerf_tpu_torch.utils import profiling as pp

    def no_sync(*a, **k):
        raise AssertionError("synchronized on the CPU")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    logs = []
    x = torch.ones(64)
    t = pp.perf_timer(use_ms=True, logf=logs.append, sync_value=x)
    time.sleep(0.002)
    t.logtime("a {:.3f}")
    t.logtime("c {:.3f}", sync_value={"y": [x]})
    with pp.perf_timer(msg="b {:.3f}", logf=logs.append, sync_value=x):
        pass
    with pp.perf_timer(logf=logs.append, disabled=True):
        pass
    assert len(logs) == 3 and float(logs[0].split()[1]) >= 2.0
    assert logs[1].startswith("c ")
    calls = []
    dt = pp.time_fn(lambda v: calls.append(1) or v + 1, x, iters=3, warmup=2)
    assert dt >= 0 and len(calls) == 5
    with pp.trace(str(tmp_path / "tr")) as prof:
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    assert prof is not None and (tmp_path / "tr" / "trace.json").stat().st_size


def test_mesh_matches_jax(tmp_path):
    """The port's extract_mesh (queried with float32 tensors on the CPU)
    against JAX's at N = 32 on one seeded analytic field: vertices and
    faces equal, the PLY files byte-equal; marching tetrahedra alone on a
    random field too."""
    from enerf_tpu.utils import mesh as jm
    from enerf_tpu_torch.utils import mesh as pm
    from enerf_tpu_torch.utils.ply import load_ply_vertices

    c = np.random.RandomState(5).uniform(-0.2, 0.2, (2, 3)).astype(np.float32)

    def field(xyz):
        """Two Gaussian blobs, in numpy: both packages query one field."""
        assert xyz.dtype == np.float32 and xyz.shape[-1] == 3
        r0 = np.sum((xyz - c[0]) ** 2, -1, keepdims=True)
        r1 = np.sum((xyz - c[1]) ** 2, -1, keepdims=True)
        return np.exp(-r0 / 0.15) + 0.8 * np.exp(-r1 / 0.05)

    def port_query(p):
        assert p.dtype == torch.float32 and p.device.type == "cpu"
        return torch.from_numpy(field(p.numpy()))

    bbox = [[-1.0, -0.8, -0.9], [0.9, 1.0, 1.0]]
    got = pm.extract_mesh(port_query, 0.5, bbox, str(tmp_path / "p.ply"),
                          N=32, batch_size=5000, device="cpu")
    want = jm.extract_mesh(lambda p: jnp.asarray(field(np.asarray(p))), 0.5,
                           bbox, str(tmp_path / "j.ply"), N=32,
                           batch_size=5000)
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_allclose(load_ply_vertices(str(tmp_path / "p.ply")),
                               got[0], atol=1e-6)
    vol = np.random.RandomState(6).rand(9, 10, 11)
    for g, w in zip(pm.marching_tetrahedra(vol, 0.5, (0.1, 0.2, 0.3)),
                    jm.marching_tetrahedra(vol, 0.5, (0.1, 0.2, 0.3))):
        np.testing.assert_array_equal(g, w)
