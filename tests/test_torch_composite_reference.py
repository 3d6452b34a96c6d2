"""The port's ``ENeRFComposite`` against the benchmark's plain reference of
ENeRF-Outdoor's model (``benchmark/reference/enerf_composite.py``, plain
``torch.nn.functional``, no kernel, rays gathered by pixel) on seeded
weights, and the order of the spans the composite forward and
``Trainer.val`` mark.

The batch is two ``outdoor_actor`` frames at 96×128 with 32×32 fg windows:
one inside the frame at an origin that level 0's volume scale truncates
(37 / 8), one at the frame's bottom-right corner, where the ENeRF-Outdoor
dataset clamps a window; 2 real views and a padded slot; both levels
rendered."""

import dataclasses

import torch

import enerf_tpu_torch as et
from enerf_tpu_torch.config import CascadeConfig, Config, ENeRFConfig
from enerf_tpu_torch.train import Recorder, Trainer, create_train_state
from benchmark import scene_outdoor
from benchmark.reference import enerf as ref
from benchmark.reference import enerf_composite as rc
from benchmark.weights import make_state
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

H, W = 96, 128
WIN = (32, 32)
SEED = 3141592653589
SCENE = {"kind": "outdoor_actor", "rig_cameras": 18, "arc_radius": 5.0,
         "arc_span_deg": 120.0, "camera_height": 1.5, "aim_height": 1.38,
         "target_span_deg": 40.0, "focal_of_max_side": 1.2,
         "box_half": [0.25, 0.25, 0.9], "walk": [1.0, 0.25],
         "wall_depth": [8.0, 20.0], "wall_height": 6.0}
CAS = {"num": 2, "depth_inv": [True, False], "volume_scale": [0.125, 0.5],
       "volume_planes": [32, 8], "im_feat_scale": [0.25, 0.5],
       "im_ibr_scale": [0.25, 1.0], "render_scale": [0.25, 1.0],
       "render_im_feat_level": [0, 2], "nerf_model_feat_ch": [32, 8],
       "render_if": [True, True], "num_samples": [2, 1]}
ENERF = {"num_fg_layers": 1, "bg_volume_planes": [16, 4], "fg_bbox_hw": list(WIN),
         "viewdir_agg": False}
# float32 on both sides, the same inputs and weights: the gaps are rounding
# alone (the port samples in pixel space, the reference through
# grid_sample's normalized coordinates; their orders of summation differ),
# measured 2.2e-6 on rgb in [0, 1] and 3.0e-7 of the depth range; the
# limits leave 14x and 33x, far below a wrong plane, window or weight
RGB_ATOL = 3e-5
DEPTH_RTOL = 1e-5      # of the background's far − near


def _cfg(render_if):
    cas = CascadeConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in dict(CAS, render_if=render_if).items()})
    return Config(network_module="enerf_tpu.models.enerf_composite",
                  enerf=ENeRFConfig(test_input_views=2, train_input_views=(2,),
                                    viewdir_agg=False, num_fg_layers=1,
                                    fg_bbox_hw=WIN, bg_volume_planes=(16, 4),
                                    grid_rays=True, cas_config=cas))


def _batch(render_if):
    """Two frames as a batch of 2: 2 real views and a padded slot, item 0's
    window inside the frame, item 1's at its bottom-right corner."""
    cfg = {"image_hw": [H, W], "source_views": 2, "enerf": ENERF,
           "cas_config": dict(CAS, render_if=render_if), "eval_overrides": {}}
    frames = scene_outdoor.make_frames(cfg, {"name": "outdoor_composite",
                                             "scene": SCENE}, SEED, "cpu", 2)
    b = {k: torch.cat([f[k] for f in frames]) for k in frames[0]}
    b["bbox"] = torch.tensor([[[37.0, 21.0, 32.0, 32.0]],
                              [[W - 32.0, H - 32.0, 32.0, 32.0]]])
    for k in ("src_inps", "bg_src_inps"):
        b[k] = torch.cat([b[k], torch.zeros_like(b[k][:, :1])], 1)
    b["src_exts"] = torch.cat([b["src_exts"], torch.eye(4).expand(2, 1, 4, 4)], 1)
    b["src_ixts"] = torch.cat([b["src_ixts"], b["tar_ixt"][:, None]], 1)
    b["view_mask"] = torch.tensor([[1.0, 1.0, 0.0]] * 2)
    return b


def _model_and_state(render_if):
    cas = dict(CAS, render_if=render_if)
    state = make_state(rc.param_spec(cas, 1, False), SEED, "cpu")
    model = et.build_model(_cfg(render_if), device="cpu")
    model.load_state_dict(state, strict=True)
    return model, state


def test_port_matches_the_reference():
    render_if = [True, True]
    model, state = _model_and_state(render_if)
    batch = _batch(render_if)
    got = et.render(model, batch)
    params, stats = ref.split_state(state)
    with torch.no_grad():
        want = rc.forward(params, stats, {"cas": dict(CAS, render_if=render_if),
                                          **ENERF}, batch)
    scale = (batch["near_far"][:, -1, 1] - batch["near_far"][:, -1, 0])[:, None]
    for key in ("depth_level0", "depth_level1"):
        gap = ((got[key] - want[key]).abs() / scale).max()
        assert gap <= DEPTH_RTOL, (key, float(gap))
    assert (got["rgb_level1"] - want["rgb_level1"]).abs().max() <= RGB_ATOL
    # the window's fg samples are there, and nothing of them outside it
    w = got["weights_level1"].reshape(2, H, W, 2)[..., 0]
    for b, (x0, y0) in enumerate([(37, 21), (W - 32, H - 32)]):
        assert bool((w[b, y0:y0 + 32, x0:x0 + 32] > 0).any())
        outside = w[b].clone()
        outside[y0:y0 + 32, x0:x0 + 32] = 0
        assert bool((outside == 0).all())


def test_stage_marks(tmp_path):
    render_if = [False, True]
    model, _ = _model_and_state(render_if)
    batch = _batch(render_if)
    marks = []
    et.render(model, batch, stage_hook=marks.append)
    stages = ["feature_net",
              "fg_cost_volume_0", "fg_cost_reg_0", "fg_0",
              "bg_cost_volume_0", "bg_cost_reg_0", "bg_0",
              "fg_cost_volume_1", "fg_cost_reg_1", "fg_render_1", "fg_1",
              "bg_cost_volume_1", "bg_cost_reg_1", "bg_render_1", "bg_1",
              "composite_1"]
    assert marks == stages
    # Trainer.val: the model's stages, then the readback and the evaluation
    cfg = dataclasses.replace(_cfg(render_if), workspace=str(tmp_path))
    trainer = Trainer(cfg, train_step=None, recorder=Recorder(cfg, resume=False))
    marks.clear()
    trainer.val(0, create_train_state(cfg, model), [batch, batch],
                stage_hook=marks.append)
    assert marks == (stages + ["val.readback", "val.evaluate"]) * 2
