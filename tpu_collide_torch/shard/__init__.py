"""Spatial sharding of the fleet (the port of tpu_collide/shard/): the
device mesh and its collectives, halo exchange and migration, the sharded
step and its detect, ingest and scenario variants, load balancing by
moving the slab walls, and trajectory prediction over the mesh."""
from tpu_collide_torch.shard.collective import Mesh, pmax, ppermute, psum
from tpu_collide_torch.shard.halo import (extend_with_halo, halo_exchange,
                                          halo_exchange_hops, migrate,
                                          slab_bounds)
from tpu_collide_torch.shard.step import (check_boundaries, collect_state,
                                          distribute_state, equal_boundaries,
                                          make_mesh, make_sharded_detect,
                                          make_sharded_ingest,
                                          make_sharded_scenario_step,
                                          make_sharded_step, shard_generators,
                                          shard_slots)
from tpu_collide_torch.shard.balance import (LoadBalancer, imbalance,
                                             quantile_boundaries,
                                             shard_occupancy)
from tpu_collide_torch.shard.predict import (distribute_history,
                                             make_sharded_predict,
                                             predict_band, predict_hops,
                                             predict_reach)
