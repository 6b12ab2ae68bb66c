"""Operator layer: patch gather/scatter, batched FFT, diffraction fwd/adj,
the fused kernels (``ops.fused``: grad_fused, minf_fused, fwd,
grad_prb_fused, adj, adj_probe, adj_residual, fwd_quad_stats), the fused
line search (``ops.linesearch``: ls_objectives) and the hybrid tier's patch
kernels (``ops.kernels``: gather_probe_mul, scatter_conj_probe,
adj_probe_reduce)."""

from tikejax_torch.ops.diffraction import (Ptycho, adj_probe_raw, adj_raw,
                                           fwd, fwd_raw)
from tikejax_torch.ops.fft import crop_from_det, fft2o, ifft2o, pad_to_det
from tikejax_torch.ops.fused import (grad_fused, grad_fused_reference,
                                     grad_prb_fused,
                                     grad_prb_fused_reference, minf_fused,
                                     minf_fused_reference)
from tikejax_torch.ops.patches import (check_scan_in_bounds, gather_patches,
                                       overlap_counts, patch_power_map,
                                       scan_to_int, scatter_patches_add)

__all__ = [
    "Ptycho", "fwd", "fwd_raw", "adj_raw", "adj_probe_raw",
    "fft2o", "ifft2o", "pad_to_det", "crop_from_det",
    "gather_patches", "scatter_patches_add", "scan_to_int",
    "check_scan_in_bounds", "overlap_counts", "patch_power_map",
    "grad_fused", "grad_fused_reference", "minf_fused",
    "minf_fused_reference", "grad_prb_fused", "grad_prb_fused_reference",
]
