"""Sharded serving fleet: partition a store's segments across N
shards with fleet-wide cache accounting (DESIGN.md §13).  Host code:
the engine over ``ServingFleet.store`` runs the same kernels on the card
as over an unsharded store."""
from .fleet import (FleetCache, FleetDevice, FleetShard, FleetStats,
                    ServingFleet, split_budget)
from .partition import REPLICATED_SEGMENTS, StorePartition

__all__ = ["FleetCache", "FleetDevice", "FleetShard", "FleetStats",
           "ServingFleet", "split_budget", "StorePartition",
           "REPLICATED_SEGMENTS"]
