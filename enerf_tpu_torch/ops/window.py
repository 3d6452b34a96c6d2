"""Fixed-size windows at a per-batch origin held on the device: the
counterparts of ``lax.dynamic_slice`` / ``lax.dynamic_update_slice`` that
the JAX package's human and composite models use (``enerf_tpu/models/
enerf_human.py:103-146``, ``enerf_composite.py:256-329``).

A ``Window`` is a fixed (h, w) window of an (H, W) frame; its origin xy0
(B, 2) [x0, y0] is a device tensor, and nothing here reads it on the host
(no ``.item()``, no ``nonzero()``), so the forward never waits for the
card. The origin follows JAX's start rule (``clamp_origin``) once, when
the window is made; its index tensors are built on first use and kept, so
one window cuts (``crop``) and writes back (``paste``) every tensor of its
frame with the same index.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def clamp_origin(xy0: torch.Tensor, hw: Tuple[int, int],
                 frame_hw: Tuple[int, int]) -> torch.Tensor:
    """``lax.dynamic_slice``'s start rule: a negative coordinate of the
    origin xy0 (B, 2) [x0, y0] counts from the frame's end (x0 + W), then
    the origin is clamped so that the (h, w) window lies in the (H, W)
    frame; int64 on xy0's device."""
    (h, w), (H, W) = hw, frame_hw
    xy0 = xy0.long()
    x, y = xy0[:, 0], xy0[:, 1]
    x = torch.clamp(torch.where(x < 0, x + W, x), 0, W - w)
    y = torch.clamp(torch.where(y < 0, y + H, y), 0, H - h)
    return torch.stack([x, y], dim=-1)


def window_index(xy0: torch.Tensor, hw: Tuple[int, int],
                 planes: Optional[int] = None):
    """Index tensors that cut the (h, w) window at the origin ``xy0`` (B, 2)
    [x0, y0], which must lie inside the frame (see ``clamp_origin``), out of
    a (B, H, W, ...) tensor, or out of a (B, D, H, W, ...) one when
    ``planes`` = D is given: ``t[window_index(...)]`` is (B, h, w, ...) or
    (B, D, h, w, ...), and assigning to it writes the window back."""
    dev = xy0.device
    xy0 = xy0.long()
    h, w = hw
    b = torch.arange(xy0.shape[0], device=dev)
    ys = xy0[:, 1:2] + torch.arange(h, device=dev)            # (B, h)
    xs = xy0[:, 0:1] + torch.arange(w, device=dev)            # (B, w)
    if planes is None:
        return b[:, None, None], ys[:, :, None], xs[:, None, :]
    return (b[:, None, None, None],
            torch.arange(planes, device=dev)[:, None, None],
            ys[:, None, :, None], xs[:, None, None, :])


class Window:
    """The (h, w) = ``hw`` window of an (H, W) = ``frame_hw`` frame at the
    per-batch origin xy0 (B, 2) [x0, y0], clamped into the frame
    (``clamp_origin``); ``xy0`` holds the clamped origin."""

    def __init__(self, xy0: torch.Tensor, hw: Tuple[int, int],
                 frame_hw: Tuple[int, int]):
        self.hw, self.frame_hw = tuple(hw), tuple(frame_hw)
        self.xy0 = clamp_origin(xy0, self.hw, self.frame_hw)
        self._index: Dict[Optional[int], tuple] = {}

    def index(self, planes: Optional[int] = None):
        """``window_index`` of the clamped origin, built once per plane
        count."""
        if planes not in self._index:
            self._index[planes] = window_index(self.xy0, self.hw, planes)
        return self._index[planes]

    @staticmethod
    def _plane_count(t: torch.Tensor, planes: bool, hw) -> Optional[int]:
        """``t``'s plane count D with ``planes``, else None, once its
        spatial axes are checked to be ``hw``."""
        lead = 2 if planes else 1
        if tuple(t.shape[lead:lead + 2]) != hw:
            raise ValueError(f"expected spatial axes {hw}, got a tensor of "
                             f"shape {tuple(t.shape)}")
        return t.shape[1] if planes else None

    def crop(self, frame: torch.Tensor, planes: bool = False) -> torch.Tensor:
        """``lax.dynamic_slice`` of the window out of ``frame`` (B, H, W,
        ...), or with ``planes`` out of (B, D, H, W, ...). Returns (B, h,
        w, ...) or (B, D, h, w, ...)."""
        d = self._plane_count(frame, planes, self.frame_hw)
        return frame[self.index(d)]

    def paste(self, window: torch.Tensor, planes: bool = False
              ) -> torch.Tensor:
        """``lax.dynamic_update_slice`` of ``window`` (B, h, w, ...) into
        zeros of (B, H, W, ...); with ``planes``, window and frame carry a
        plane axis first: (B, D, h, w, ...) into (B, D, H, W, ...)."""
        d = self._plane_count(window, planes, self.hw)
        lead = 2 if planes else 1
        out = window.new_zeros(window.shape[:lead] + self.frame_hw
                               + window.shape[lead + 2:])
        out[self.index(d)] = window
        return out
