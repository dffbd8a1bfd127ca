"""Multi-device Jindo and Buckler on ``torch.distributed``: one process
per device, explicit SPMD over a dp x tp x sp ``DeviceMesh``.  The port's
counterpart of ``ringo_tpu.parallel``; every sharded program gives the
single-device program's bytes."""

from .mesh import make_mesh, mesh_shape
from .commit import build_sharded_commit, build_sharded_evaluate, commit_batch
from .buckler import build_sharded_buckler_round
from .bigntt import ShardedBigNTT
from .prove import (shard_buckler_prover, shard_jindo_prover,
                    shard_jindo_verifier)
from .multihost import bcast_bytes, init_multihost, sync_global_devices

__all__ = ["make_mesh", "build_sharded_commit", "build_sharded_evaluate",
           "commit_batch", "build_sharded_buckler_round", "ShardedBigNTT",
           "shard_buckler_prover", "shard_jindo_prover",
           "shard_jindo_verifier", "init_multihost", "bcast_bytes",
           "sync_global_devices", "mesh_shape"]
