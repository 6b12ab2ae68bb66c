"""Runs over several ranks on ``torch.distributed``: position (P1) and angle
(P2) sharding (:mod:`tikejax_torch.parallel.sharding`) and the pool of gloo
ranks that runs them (:class:`RankPool`). Object tiling (P3,
``tikejax.parallel.tiling``) is not ported yet (ROADMAP.md queue 1
item 5)."""

from tikejax_torch.parallel._ranks import RankPool
from tikejax_torch.parallel.sharding import (fwd_sharded, make_mesh,
                                             pad_scan_problem, run_sharded,
                                             shard_problem)

__all__ = ["RankPool", "make_mesh", "run_sharded", "shard_problem",
           "pad_scan_problem", "fwd_sharded"]
