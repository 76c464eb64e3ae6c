"""Core library of the PyTorch port: pre/post/hybrid counts caching for
scalable statistical-relational model discovery, layered as planner
(:mod:`.plan`) / executors (:mod:`.executors`) / cache (:mod:`.cache`)
under thin strategy policies (:mod:`.strategies`).

Entry points take ``device=None``, which means the CUDA card; pass
``device="cpu"`` to count on the host.
"""

from .schema import Attribute, EntityType, Relationship, Schema
from .database import (RelationalDB, FactDelta, db_from_arrays, synth_db,
                       paper_benchmark_db, PAPER_DATASETS, NotRoutableError,
                       ShardedDatabase, fanout_view, shard_database)
from .device import resolve_device
from .variables import (Var, Atom, CtVar, LatticePoint, attr_var, edge_var,
                        rind_var, build_lattice, point_from_rels)
from .ct import CtTable
from .contract import CostStats, positive_ct, entity_hist
from .plan import ContractionPlan, compile_plan, group_by_signature
from .executors import (DenseExecutor, Executor, SparseExecutor, EXECUTORS,
                        make_executor, plan_stack_key)
from .distributed import (ShardedSparseExecutor, sharded_positive_ct,
                          sharded_sparse_positive_ct)  # registers the
                          # "sparse_sharded" backend in EXECUTORS on import
from .cache import DEFAULT_TENANT, CtCache, TenantCache
from .engine import (CountingEngine, CachedFullPositives, DeltaReport,
                     OnDemandPositives, TupleIdPositives, key_deps)
from .mobius import (butterfly_batch, complete_ct, complete_ct_many,
                     positive_queries, superset_mobius)
from .strategies import (Strategy, Precount, OnDemand, Hybrid, TupleId,
                         make_strategy, STRATEGIES)
from .bdeu import bdeu_score_2d, bdeu_score_batch, family_score
from .search import StructureSearch, discover_model, BNModel

__all__ = [
    "Attribute", "EntityType", "Relationship", "Schema",
    "RelationalDB", "FactDelta", "db_from_arrays", "synth_db",
    "paper_benchmark_db", "PAPER_DATASETS", "resolve_device",
    "NotRoutableError", "ShardedDatabase", "fanout_view", "shard_database",
    "Var", "Atom", "CtVar", "LatticePoint", "attr_var", "edge_var", "rind_var",
    "build_lattice", "point_from_rels", "CtTable",
    "CostStats", "positive_ct", "entity_hist",
    "ContractionPlan", "compile_plan", "group_by_signature",
    "Executor", "DenseExecutor", "SparseExecutor", "ShardedSparseExecutor",
    "EXECUTORS", "make_executor", "plan_stack_key",
    "sharded_positive_ct", "sharded_sparse_positive_ct",
    "CtCache", "TenantCache", "DEFAULT_TENANT", "CountingEngine", "DeltaReport", "key_deps",
    "CachedFullPositives", "OnDemandPositives", "TupleIdPositives",
    "butterfly_batch", "complete_ct", "complete_ct_many",
    "positive_queries", "superset_mobius",
    "Strategy", "Precount", "OnDemand", "Hybrid", "TupleId",
    "make_strategy", "STRATEGIES",
    "bdeu_score_2d", "bdeu_score_batch", "family_score",
    "StructureSearch", "discover_model", "BNModel",
]
