"""Utilities: the numpy bridge, profiling hooks and the CUDA kernel build
helper."""

from tikejax_torch.utils.bridge import (geometry_from, to_numpy,
                                        to_numpy_tree, to_torch)
from tikejax_torch.utils.profiling import (Timer, device_sync,
                                           summarize_metrics,
                                           sync_overhead_seconds, trace)

__all__ = ["to_torch", "to_numpy", "to_numpy_tree", "geometry_from",
           "Timer", "trace", "summarize_metrics", "device_sync",
           "sync_overhead_seconds"]
