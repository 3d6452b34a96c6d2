"""The port's human variant vs ``enerf_tpu``'s ``ENeRFHuman`` on the CPU:
each of the three ways of rendering inside ``mask_at_box`` (the mask
multiply, the capacity argsort + scatter, the static window) at
``tests/test_human.py``'s 32×32 frame with its box mask, the partial
window of ``tests/test_human.py::test_window_path_partial_window``, and
the three modes again at 64×96 on the bench's centered mask; then the
modes the port must not take (training, a level before the last).

2 source views, ``volume_planes (8, 8)``, level 1 rendered on grid rays;
seeded weights in the JAX model's variables tree carried across by the
port's converter; the JAX side on its jnp paths. Tolerance as
``tests/test_torch_enerf.py``: rtol 1e-3, atol 3e-4 on rgb and weights,
3e-3 on depths and std."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig
from enerf_tpu.datasets.synthetic import make_synthetic_batch
from enerf_tpu.models.enerf_human import ENeRFHuman as JHuman
from enerf_tpu_torch import build_model, render
from enerf_tpu_torch.config import CascadeConfig as PCas
from enerf_tpu_torch.config import Config as PConfig
from enerf_tpu_torch.config import ENeRFConfig as PENeRF
from enerf_tpu_torch.config import human_mask
from enerf_tpu_torch.models.enerf_human import ENeRFHuman
from enerf_tpu_torch.utils.convert import load_flax_variables
from tests.test_torch_modules import seeded_variables
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

ATOL = {"rgb_level1": 3e-4, "weights_level1": 3e-4, "depth_level1": 3e-3,
        "depth_mvs_level1": 3e-3, "std_level1": 3e-3}
FAST_COMPILE = {"xla_backend_optimization_level": 0}
CAS = dict(num=2, volume_planes=(8, 8), render_if=(False, True))
# (capacity, window) of each mode
MODES = {"multiply": (1.0, None), "capacity": (0.5, None),
         "window": (1.0, "frame")}


def _box_mask(H, W, y, x):
    mask = np.zeros((H, W), np.float32)
    mask[y[0]:y[1], x[0]:x[1]] = 1.0
    return mask.reshape(1, -1)


# frame (H, W), mask, the window of the "window" mode
FRAMES = {
    # tests/test_human.py's box mask; the window covers the frame, as the
    # snapped origin is (0, 0)
    "32x32": ((32, 32), _box_mask(32, 32, (8, 24), (8, 24)), (32, 32)),
    # the partial window of tests/test_human.py:99-115
    "32x32_partial": ((32, 32), _box_mask(32, 32, (16, 32), (0, 16)),
                      (16, 16)),
    # bench.py's centered 0.74H x 0.42W mask, rows 8..54 and columns
    # 28..67; the window's origin snaps to (16, 0), so (64, 64) covers it
    "64x96": ((64, 96), human_mask(64, 96), (64, 64)),
}
CASES = [("32x32", m) for m in MODES] + [("32x32_partial", "window")] + [
    ("64x96", m) for m in MODES]


def _cfgs(mode, window_hw):
    cap, win = MODES[mode]
    kw = dict(test_input_views=2, train_input_views=(2,), grid_rays=True,
              mask_ray_capacity=cap,
              mask_window_hw=window_hw if win else None)
    return (Config(enerf=ENeRFConfig(cas_config=CascadeConfig(**CAS), **kw)),
            PConfig(network_module="enerf_tpu.models.enerf_human",
                    enerf=PENeRF(cas_config=PCas(**CAS), **kw)))


@pytest.fixture(scope="module")
def variables():
    """Seeded weights in the JAX model's tree (every mode and frame shares
    them: no weight depends on the frame's size)."""
    jcfg, _ = _cfgs("multiply", None)
    batch = _batch(jcfg, "32x32")
    return seeded_variables(JHuman(cfg=jcfg.enerf, train_mode=False),
                            np.random.RandomState(0), batch)


def _batch(jcfg, frame):
    (H, W), mask, _ = FRAMES[frame]
    batch = make_synthetic_batch(jcfg, H=H, W=W)
    batch.pop("tar_img")
    batch["mask_at_box"] = mask
    return batch


@pytest.mark.parametrize("frame,mode", CASES)
def test_human_matches_jax(variables, frame, mode):
    jcfg, pcfg = _cfgs(mode, FRAMES[frame][2])
    batch = _batch(jcfg, frame)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JHuman(cfg=jcfg.enerf, train_mode=False)
    ref = jax.jit(jmodel.apply).lower(variables, jb).compile(
        compiler_options=FAST_COMPILE)(variables, jb)
    model = load_flax_variables(build_model(pcfg, device="cpu"), variables)
    assert isinstance(model, ENeRFHuman)
    out = render(model, batch)
    assert set(out) == set(ref) == set(ATOL)
    for k, atol in ATOL.items():
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-3, atol=atol, err_msg=k)
    outside = batch["mask_at_box"][0] == 0
    assert np.all(out["rgb_level1"][0].numpy()[outside] == 0.0)
    assert np.any(out["rgb_level1"][0].numpy()[~outside] != 0.0)


def test_mask_ignored_in_training_and_before_the_last_level(variables):
    """Training renders every ray, and a level before the last renders
    unmasked in eval: the port matches ``ENeRF`` there."""
    jcfg, pcfg = _cfgs("window", (16, 16))
    pcfg = dataclasses.replace(pcfg, enerf=dataclasses.replace(
        pcfg.enerf, cas_config=dataclasses.replace(
            pcfg.enerf.cas_config, render_if=(True, True))))
    batch = _batch(jcfg, "32x32")
    human = load_flax_variables(build_model(pcfg, device="cpu"), variables)
    base = build_model(dataclasses.replace(pcfg, network_module="enerf"),
                       device="cpu")
    base.load_state_dict(human.state_dict())
    out, ref = render(human, batch), render(base, batch)
    torch.testing.assert_close(out["rgb_level0"], ref["rgb_level0"])
    assert not torch.equal(out["rgb_level1"], ref["rgb_level1"])
    human.train()
    base.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.testing.assert_close(human(tb)["rgb_level1"], base(tb)["rgb_level1"])
