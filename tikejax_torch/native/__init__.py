"""Native (C++) host-side components, with numpy fallbacks.

The port's own copy of the JAX package's ``native`` layer (it imports
nothing of that package): host-side scan conditioning -- ingestion
validation and coverage maps, used by ``tikejax_torch.compat`` and
``tikejax_torch.models.diagnostics`` before anything touches the device --
is C++ behind a plain C interface, loaded with ``ctypes``. The library is
compiled at first use into ``build/native/`` at the root of the checkout;
without a C++ compiler the numpy fallbacks take over.
"""

from tikejax_torch.native.scanprep import (have_native, overlap_counts_host,
                                           validate_scan)

__all__ = ["validate_scan", "overlap_counts_host", "have_native"]
