"""The copied roofline arithmetic gives the port's bounds at the headline
(16,384 frames of 128^2, one mode, 512^2 object)."""

import pytest
import torch

from h100bench import roofline


def test_headline_bounds():
    frames, ndet = 16384, 128
    psi = torch.empty((1, 512, 512), dtype=torch.complex64, device="meta")
    prb = torch.empty((1, 1, 128, 128), dtype=torch.complex64, device="meta")
    data = torch.empty((1, frames, ndet, ndet), device="meta")
    corners = torch.empty((1, frames, 2), dtype=torch.int32, device="meta")
    far = torch.empty((1, frames, 1, ndet, ndet), dtype=torch.complex64,
                      device="meta")
    ms, by = roofline.bound(roofline.fft_flops(frames, 1, ndet, 2),
                            roofline.nbytes(psi, prb, data, corners, psi) + 4)
    assert (round(ms, 3), by) == (0.561, "operations")
    ms, by = roofline.bound(roofline.fft_flops(frames, 1, ndet, 1),
                            roofline.nbytes(psi, prb, corners, far))
    assert (round(ms, 3), by) == (0.642, "bytes")
    assert ms == pytest.approx(2 * 2**30 / 3.35e12 * 1e3, rel=0.01)
