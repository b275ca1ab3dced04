"""The mesh of exchange positions (`spark_rapids_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` over its devices, and its tests
get eight positions on one host from virtual CPU devices. torch has no
virtual devices, so here a mesh is a tuple of `torch.device` positions:
position i lives on `cuda:(i % torch.cuda.device_count())` in a CUDA
session and on the CPU in a CPU session. On one card every position shares
`cuda:0`; the exchange (`parallel/collective.py`) runs the same steps
either way, and only its copy between positions becomes a no-op.

Moving rows between two or more cards is not in this engine yet: the plan
above the exchange concatenates batches of every position, so a mesh whose
positions span more than one card raises at plan time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["Mesh", "make_mesh", "mesh_from_conf"]

Mesh = Tuple[torch.device, ...]


def make_mesh(n_positions: int, device: torch.device) -> Mesh:
    """`n_positions` positions over the cards of `device`'s type."""
    device = torch.device(device)
    if device.type == "cuda":
        ndev = torch.cuda.device_count()
        return tuple(torch.device("cuda", i % ndev)
                     for i in range(n_positions))
    return tuple(device for _ in range(n_positions))


def mesh_from_conf(conf, device: torch.device) -> Optional[Mesh]:
    """The session's mesh from `spark.rapids.tpu.mesh.shape` ('shuffle=4'
    or just '4'; empty or 1 = no mesh), over `device`'s type."""
    shape = (conf.get("spark.rapids.tpu.mesh.shape") or "").strip()
    if not shape:
        return None
    n = int(shape.split(",")[0].strip().split("=")[-1])
    if n <= 1:
        return None
    mesh = make_mesh(n, device)
    if len(set(mesh)) > 1:
        raise NotImplementedError(
            f"a mesh of {n} positions over {len(set(mesh))} cards: moving "
            "rows between cards is not supported by spark_rapids_tpu_torch "
            "yet (every position must share one card)")
    return mesh
