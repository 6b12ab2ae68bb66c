"""Runs over several ranks on ``torch.distributed``: position (P1) and angle
(P2) sharding (:mod:`tikejax_torch.parallel.sharding`), object tiling (P3,
:mod:`tikejax_torch.parallel.tiling`), how a rank joins the process group
(:func:`join_group`: NCCL where every rank has a card of its own, gloo
otherwise) and the pool of ranks that runs them (:class:`RankPool`)."""

from tikejax_torch.parallel._ranks import RankPool, backend_for, join_group
from tikejax_torch.parallel.sharding import (fwd_sharded, make_mesh,
                                             pad_scan_problem, run_sharded,
                                             shard_problem)
from tikejax_torch.parallel.tiling import (make_full_mesh, make_obj_mesh,
                                           make_obj_scan_mesh,
                                           partition_problem, run_tiled,
                                           stitch)

__all__ = ["RankPool", "backend_for", "join_group", "make_mesh",
           "run_sharded", "shard_problem", "pad_scan_problem", "fwd_sharded",
           "make_obj_mesh", "make_obj_scan_mesh", "make_full_mesh",
           "partition_problem", "stitch", "run_tiled"]
