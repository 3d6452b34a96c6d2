"""GUI render-option state (reference lib/interactive/render_options.py);
counterpart of ``enerf_tpu/interactive/render_options.py``: a dot-access
dict with the per-scene window sizes, the render-type mapping and the
on-screen panel's switch."""

from __future__ import annotations


class DotDict(dict):
    __getattr__ = dict.__getitem__
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


def make_options(cfg) -> DotDict:
    opt = DotDict()
    opt.fps_cnter_int = 1
    opt.render_level = 1
    opt.type = 0
    opt.type_mapping = ["pred", "depth", "seg", "bbox"]
    scene = cfg.test_dataset.scene or ""
    if scene in ("taekwondo", "walking"):
        opt.window_hw = [320, 640]
    elif any(k in scene for k in ("cook", "flame", "coffee")):
        opt.window_hw = [448, 640]
    else:
        opt.window_hw = [512, 512]
    opt.autoplay = True
    opt.smoothing_term = 0.1
    # the on-screen state panel (``gui_human.draw_hud``; it replaces the
    # reference's imgui widgets, gui_human.py:123-197)
    opt.show_hud = True
    return opt
