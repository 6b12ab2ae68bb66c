"""Operator layer: patch gather/scatter, batched FFT, diffraction fwd/adj,
and the fused gradient kernel."""

from tikejax_torch.ops.diffraction import (Ptycho, adj_probe_raw, adj_raw,
                                           fwd, fwd_raw)
from tikejax_torch.ops.fft import crop_from_det, fft2o, ifft2o, pad_to_det
from tikejax_torch.ops.fused import grad_fused, grad_fused_reference
from tikejax_torch.ops.patches import (check_scan_in_bounds, gather_patches,
                                       overlap_counts, scan_to_int,
                                       scatter_patches_add)

__all__ = [
    "Ptycho", "fwd", "fwd_raw", "adj_raw", "adj_probe_raw",
    "fft2o", "ifft2o", "pad_to_det", "crop_from_det",
    "gather_patches", "scatter_patches_add", "scan_to_int",
    "check_scan_in_bounds", "overlap_counts",
    "grad_fused", "grad_fused_reference",
]
