# Copyright (c) 2026 touchnet_tpu authors.
# ParallelDims: the validated parallel degrees and their DeviceMesh.
#
# Port of touchnet_tpu/parallel/dims.py:29-118. The degrees, their
# validation and the -1 autofill of dp_shard are JAX's; build_mesh is
# init_device_mesh over (pp, dp_replicate, dp_shard, cp, tp) with the JAX
# axis names. Both lay the ranks out row-major: JAX reshapes
# jax.devices()[:world] to the mesh shape (:61-68), init_device_mesh
# arranges range(world) the same way, so global rank r sits at JAX's mesh
# position r. dp_rank is dp_replicate_coord * dp_shard + dp_shard_coord
# (:108-118): rank r loads the loader stream that JAX's mesh position r
# loads. A degree that does not fit the world raises a ValueError naming
# the trainer's flags (JAX asserts).

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

MESH_AXES = ("pp", "dp_replicate", "dp_shard", "cp", "tp")
# the trainer's flag of each degree, for the messages
FLAGS = {
    "pp": "training_pipeline_parallel_degree",
    "dp_replicate": "training_data_parallel_replicate_degree",
    "dp_shard": "training_data_parallel_shard_degree",
    "cp": "training_context_parallel_degree",
    "tp": "training_tensor_parallel_degree",
}


@dataclass
class ParallelDims:
    dp_replicate: int = 1
    dp_shard: int = -1  # -1 => the devices the other degrees leave
    cp: int = 1
    tp: int = 1
    pp: int = 1
    world_size: int = field(default=-1)  # -1 => the process group's
    enable_loss_parallel: bool = False

    def __post_init__(self):
        if self.world_size == -1:
            from touchnet_tpu_torch.utils.distributed import rank_and_world

            self.world_size = rank_and_world()[1]
        self._validate()

    def _validate(self):
        for name in ("dp_replicate", "cp", "tp", "pp"):
            if getattr(self, name) < 1:
                raise ValueError(f"{FLAGS[name]}={getattr(self, name)}: must be >= 1")
        if self.dp_shard != -1 and self.dp_shard < 1:
            raise ValueError(f"{FLAGS['dp_shard']}={self.dp_shard}: must be -1 or >= 1")
        if self.dp_shard == -1:
            denom = self.dp_replicate * self.cp * self.tp * self.pp
            if self.world_size % denom:
                raise ValueError(
                    f"world size {self.world_size} is not divisible by "
                    + " * ".join(f"{FLAGS[n]}={getattr(self, n)}"
                                 for n in ("dp_replicate", "cp", "tp", "pp"))
                    + f" = {denom}")
            self.dp_shard = self.world_size // denom
        total = self.dp_replicate * self.dp_shard * self.cp * self.tp * self.pp
        if total != self.world_size:
            raise ValueError(
                " * ".join(f"{FLAGS[n]}={getattr(self, n)}" for n in
                           ("dp_replicate", "dp_shard", "cp", "tp", "pp"))
                + f" = {total} != world size {self.world_size}")

    @property
    def shape(self) -> tuple:
        return (self.pp, self.dp_replicate, self.dp_shard, self.cp, self.tp)

    def build_mesh(self, device_type: str):
        """The DeviceMesh over every rank of the process group, row-major."""
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, self.shape, mesh_dim_names=MESH_AXES)

    def coords(self, rank: int) -> Dict[str, int]:
        """Global rank -> its mesh coordinates (the row-major layout of
        build_mesh and of JAX's reshape)."""
        return dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(rank, self.shape))))

    def dp_rank(self, rank: Optional[int] = None) -> int:
        """The data-parallel rank of global ``rank`` (this process's by
        default): the loader stream it builds."""
        if rank is None:
            from touchnet_tpu_torch.utils.distributed import rank_and_world

            rank = rank_and_world()[0]
        c = self.coords(rank)
        return c["dp_replicate"] * self.dp_shard + c["dp_shard"]

    # -- the degrees the trainer reads (of the JAX ParallelDims API) --
    @property
    def loss_parallel_enabled(self) -> bool:
        return self.tp > 1 and self.enable_loss_parallel

    @property
    def dp_degree(self) -> int:
        """The data-loading world size (the loader streams)."""
        return self.dp_replicate * self.dp_shard

    @property
    def non_data_parallel_size(self) -> int:
        return self.cp * self.tp * self.pp
