"""The port's windowed GUI against the JAX package's on the CPU, without a
display: the on-screen panel's lines (JAX's texts captured from
``cv2.putText``), and both ``run_gui`` loops driven through one event
sequence by stand-in ``glfw`` and ``OpenGL.GL`` modules
(``chip_smoke.stub_gl_modules``) around a stand-in renderer whose frame
is a function of the camera's pose. The camera's matrices agree to 1e-12,
as ``tests/test_torch_interactive.py`` holds them."""

import types

import numpy as np
import pytest
from scipy import interpolate

import chip_smoke as cs
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

K = cs.GLFW_CONSTANTS
# frame -> events: moves, drags of the three kinds, scrolls, the toggles
# and the rail
EVENTS = {
    1: [("key", K["KEY_W"], K["PRESS"], 0), ("key", K["KEY_D"], K["REPEAT"], 0),
        ("key", K["KEY_Q"], K["PRESS"], 0), ("key", K["KEY_E"], K["RELEASE"], 0)],
    2: [("cursor", 10.0, 20.0), ("mouse", K["MOUSE_BUTTON_LEFT"], K["PRESS"], 0),
        ("cursor", 60.0, 45.0), ("cursor", 90.0, 30.0),
        ("mouse", K["MOUSE_BUTTON_LEFT"], K["RELEASE"], 0)],
    3: [("mouse", K["MOUSE_BUTTON_RIGHT"], K["PRESS"], K["MOD_CONTROL"]),
        ("cursor", 20.0, 70.0), ("mouse", K["MOUSE_BUTTON_RIGHT"],
                                 K["RELEASE"], 0)],
    4: [("mouse", K["MOUSE_BUTTON_MIDDLE"], K["PRESS"], 0),
        ("cursor", 40.0, 50.0), ("mouse", K["MOUSE_BUTTON_MIDDLE"],
                                 K["RELEASE"], 0),
        ("mouse", K["MOUSE_BUTTON_LEFT"], K["PRESS"], K["MOD_SHIFT"]),
        ("cursor", 45.0, 58.0), ("mouse", K["MOUSE_BUTTON_LEFT"],
                                 K["RELEASE"], 0)],
    5: [("scroll", 2.0), ("scroll", -1.0), ("key", K["KEY_S"], K["PRESS"], 0),
        ("key", K["KEY_A"], K["PRESS"], 0)],
    6: [("key", K["KEY_SPACE"], K["PRESS"], 0), ("key", K["KEY_T"], K["PRESS"], 0),
        ("key", K["KEY_T"], K["PRESS"], 0), ("key", K["KEY_H"], K["PRESS"], 0)],
    7: [("key", K["KEY_P"], K["PRESS"], 0), ("key", K["KEY_EQUAL"], K["PRESS"], 0),
        ("key", K["KEY_EQUAL"], K["REPEAT"], 0),
        ("key", K["KEY_MINUS"], K["PRESS"], 0)],
    8: [("key", K["KEY_H"], K["PRESS"], 0), ("key", K["KEY_SPACE"], K["PRESS"], 0)],
    9: [("key", K["KEY_P"], K["PRESS"], 0), ("key", K["KEY_T"], K["PRESS"], 0)],
    10: [("key", K["KEY_ESCAPE"], K["PRESS"], 0)],
}


def _rail():
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    ring = np.stack([2 * np.sin(ang), -2 * np.cos(ang), 0.8 + 0.1 * ang])
    tck = interpolate.splprep(ring, s=0.0, per=1)[0]
    fro = interpolate.splprep(-ring / np.linalg.norm(ring, axis=0), s=0.0,
                              per=1)[0]
    wup = interpolate.splprep(np.tile([[0.0], [0.0], [1.0]], 8) + 0.01 * ring,
                              s=0.0, per=1)[0]
    return dict(center_tck=tck, front_tck=fro, worldup_tck=wup)


class StandIn:
    """What ``run_gui`` and ``draw_hud`` read of a renderer: the camera,
    the options, the size, fps and frame; ``render_next`` gives a frame
    made from the camera's pose and records the pose."""

    def __init__(self, pkg, rail=True):
        if pkg == "jax":
            from enerf_tpu.interactive.camera import Camera
            from enerf_tpu.interactive.render_options import make_options
        else:
            from enerf_tpu_torch.interactive.camera import Camera
            from enerf_tpu_torch.interactive.render_options import make_options
        cfg = types.SimpleNamespace(
            test_dataset=types.SimpleNamespace(scene="CoreView_313"))
        self.opt = make_options(cfg)
        self.cam = Camera(**(_rail() if rail else {}))
        self.height, self.width = 40, 48
        self.fps, self.frame_start, self.frame_step, self.iter = 12.5, 3, 2, 0
        self.poses = []

    @property
    def frame_curr(self):
        return self.frame_start + self.iter * self.frame_step

    def render_next(self):
        c2w = self.cam.get_c2w()
        self.poses.append(c2w)
        if self.opt.autoplay:
            self.iter = (self.iter + 1) % 4
        y, x = np.mgrid[:self.height, :self.width] / 64.0
        v = np.abs(np.sin(c2w[:3, :3].sum() + 3 * x + 5 * y))
        return np.stack([v, 1 - v, 0.5 * v], -1).astype(np.float32)


def _state(rend):
    cam = rend.cam
    return dict(c2w=cam.get_c2w(), autoplay=rend.opt.autoplay,
                type=rend.opt.type, show_hud=rend.opt.show_hud,
                iter=rend.iter, on_cam_path=cam.on_cam_path,
                cam_path_u=cam.cam_path_u)


@pytest.mark.parametrize("state", ["playing_on_rail", "paused_off_rail",
                                   "no_rail"])
def test_hud_lines_match_jax(state, monkeypatch):
    """The port's ``hud_lines`` are the texts JAX's ``draw_hud`` draws
    (each twice: shadow, then text), and the port's ``draw_hud`` draws
    them, black and white, into the frame in place."""
    import cv2

    import gui_human as jgui
    from enerf_tpu_torch import gui_human as pgui

    rends = [StandIn(pkg, rail=state != "no_rail") for pkg in ("jax", "port")]
    for r in rends:
        r.opt.type = 1
        if state == "playing_on_rail":
            r.cam.on_cam_path, r.cam.cam_path_u = True, 0.37
            r.cam.update_from_cam_path()
        else:
            r.opt.autoplay = False
    texts = []
    monkeypatch.setattr(cv2, "putText",
                        lambda img, text, *a, **k: texts.append(text))
    jgui.draw_hud(np.zeros((40, 48, 3), np.uint8), rends[0])
    lines = pgui.hud_lines(rends[1])
    assert texts == [t for line in lines for t in (line, line)]
    assert len(lines) == 4 and ("rail n/a" in lines) == (state == "no_rail")

    img = np.full((80, 420, 3), 128, np.uint8)
    out = pgui.draw_hud(img, rends[1])
    assert out is img
    assert (img == 255).all(-1).sum() > 500 and (img == 0).all(-1).sum() > 500
    assert (img == 128).all(-1).mean() > 0.5


def test_run_gui_matches_jax():
    """Both ``run_gui`` loops through one event sequence: every frame's
    camera pose, then the camera, autoplay, render type, panel switch,
    frame index and rail state after ESC agree; the port's texture
    uploads are its frames flipped for GL, with the panel where it was
    on."""
    import gui_human as jgui
    from enerf_tpu_torch import gui_human as pgui
    from enerf_tpu_torch import native

    results = {}
    for pkg, gui in (("jax", jgui), ("port", pgui)):
        rend = StandIn(pkg)
        glfw, gl, rec = cs.stub_gl_modules(frames=50, events=EVENTS)
        with cs.stub_gl(glfw, gl):
            gui.run_gui(rend)
        assert rec["swaps"] == 11 and rec["terminated"] == 1
        results[pkg] = (rend, rec)
    (jr, jrec), (pr, prec) = results["jax"], results["port"]
    assert len(jr.poses) == len(pr.poses) == 11
    # the camera moves at the frames with camera events, and only there
    moved = [i for i in range(1, 11)
             if not np.array_equal(pr.poses[i], pr.poses[i - 1])]
    assert moved == [1, 2, 3, 4, 5, 7], moved
    for a, b in zip(jr.poses, pr.poses):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
    js, ps = _state(jr), _state(pr)
    np.testing.assert_allclose(ps.pop("c2w"), js.pop("c2w"), rtol=1e-12,
                               atol=1e-12)
    assert ps == js
    assert (ps["autoplay"], ps["type"], ps["show_hud"]) == (True, 3, True)
    assert [t.split("fps")[0] for t in prec["titles"]] == \
        [t.split("fps")[0] for t in jrec["titles"]]

    # frames 6 and 7 go without the panel (H at frames 6 and 8)
    assert len(prec["frames"]) == 11
    for i, tex in enumerate(prec["frames"]):
        pr.cam.get_c2w = lambda i=i: pr.poses[i]
        raw = native.f32_unit_to_u8(StandIn.render_next(pr))[::-1]
        assert tex.shape == (40, 48, 3)
        assert np.array_equal(tex, raw) == (i in (6, 7)), i


def test_run_gui_without_a_display_raises():
    """Where ``glfw.init()`` fails (no display) ``run_gui`` raises the JAX
    package's error; nothing is rendered."""
    from enerf_tpu_torch import gui_human as pgui

    rend = StandIn("port")
    glfw, gl, rec = cs.stub_gl_modules(frames=3, init_ok=False)
    with cs.stub_gl(glfw, gl), pytest.raises(RuntimeError,
                                             match="no display. use --headless"):
        pgui.run_gui(rend)
    assert rend.poses == [] and rec["frames"] == []
