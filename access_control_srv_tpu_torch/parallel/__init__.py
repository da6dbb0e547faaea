"""Multi-device kernels over ``torch.distributed``: the process mesh and
the data-parallel dense kernel (K6, ``mesh.py``), the rule-sharded kernel
(K7, ``rule_shard.py``), the pod-sharded kernel (K8, ``pod_shard.py``)
and the process-group bring-up (``cluster.py``).  The shard kernels'
wrappers are in ``ops/kernel.py``, their plain versions in
``ops/shard_ref.py``."""

from .cluster import launch_local, maybe_initialize_distributed
from .mesh import (
    Mesh,
    ShardedDecisionKernel,
    make_mesh,
    make_mesh2,
    pad_batch,
)
from .pod_shard import PodShardedKernel
from .rule_shard import RuleShardedKernel

__all__ = [
    "Mesh",
    "PodShardedKernel",
    "RuleShardedKernel",
    "ShardedDecisionKernel",
    "launch_local",
    "make_mesh",
    "make_mesh2",
    "maybe_initialize_distributed",
    "pad_batch",
]
