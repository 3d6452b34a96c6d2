"""The composite's layered render (``ops/kernels/layer_render.py``) on the
CPU: its wrapper's CPU route against the model's plain chain (each layer's
raw head, the fg paste, ``composite_layers``), and the route rule that
sends everything the kernel is not built for down that chain.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import pytest
import torch

import enerf_tpu_torch as et
from enerf_tpu_torch.config import composite_eval_config
from enerf_tpu_torch.datasets.synthetic import make_composite_batch
from enerf_tpu_torch.ops.kernels import layer_render as klr
from tests.torch_threads import torch_threads_share  # noqa: F401

H, W = 64, 96


def _cfg(**enerf):
    cfg = composite_eval_config()
    enerf.setdefault("fg_bbox_hw", (32, 32))
    return dataclasses.replace(cfg, enerf=dataclasses.replace(cfg.enerf,
                                                              **enerf))


def _spy(monkeypatch):
    """Count ``layer_render``'s calls from the model."""
    calls = []
    wrapper = klr.layer_render

    def spy(*args, **kwargs):
        calls.append(args)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(klr, "layer_render", spy)
    return calls


@pytest.mark.parametrize("xy", [(30, 20), (90, 60)],
                         ids=["inside", "bottom_right"])
def test_cpu_route_equals_plain_chain(monkeypatch, xy):
    """One fg layer, one sample a layer: the model calls ``layer_render``
    once, whose CPU route gives the plain chain's rgb, depth and weights
    bit for bit, for a window inside the frame and one clamped at its
    bottom-right corner."""
    cfg = _cfg()
    model = et.build_model(cfg, device="cpu", seed=1)
    batch = make_composite_batch(cfg, H=H, W=W)
    batch["bbox"][0, 0, :2] = xy
    calls = _spy(monkeypatch)
    out = et.render(model, batch)
    assert len(calls) == 1
    monkeypatch.setattr(klr, "takes", lambda *a: False)
    ref = et.render(model, batch)
    assert len(calls) == 1
    assert set(out) == set(ref) == {"rgb_level1", "depth_level1",
                                    "weights_level1"}
    for k in out:
        assert torch.equal(out[k], ref[k]), k


def test_route_takes_only_what_the_kernel_is_built_for(monkeypatch):
    """A tensor or a head that needs a gradient, two fg layers, or two
    samples a layer: ``takes`` refuses, and the model renders through the
    plain chain without calling ``layer_render``, as it does in training."""
    feat = torch.zeros(1, 3, 4, 4, 8)
    cfg = _cfg()
    model = et.build_model(cfg, device="cpu", seed=1)
    heads = ([model.nerf_1_layer0], model.nerf_1_bg)
    with torch.no_grad():
        assert klr.takes(*heads, 1, feat)
        assert not klr.takes(*heads, 2, feat)
        assert not klr.takes([model.nerf_1_layer0] * 2, model.nerf_1_bg, 1,
                             feat)
    assert not klr.takes(*heads, 1, feat)          # the heads' parameters
    model.requires_grad_(False)
    assert klr.takes(*heads, 1, feat)
    assert not klr.takes(*heads, 1, feat.requires_grad_())

    calls = _spy(monkeypatch)
    model.requires_grad_(True).train()              # the training forward
    model(et.device_batch(make_composite_batch(cfg, H=H, W=W), "cpu"))
    for c in (_cfg(num_fg_layers=2),
              _cfg(cas_config=dataclasses.replace(
                  cfg.enerf.cas_config, num_samples=(2, 2)))):
        out = et.render(et.build_model(c, device="cpu", seed=1),
                        make_composite_batch(c, H=H, W=W))
        n = c.enerf.num_fg_layers + 1
        assert out["weights_level1"].shape == (
            1, H * W, n * c.enerf.cas_config.num_samples[1])
    assert calls == []
