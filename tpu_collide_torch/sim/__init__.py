from tpu_collide_torch.sim.integrator import integrate
from tpu_collide_torch.sim.generator import generate_fleet, default_cities
from tpu_collide_torch.sim.traffic import (TrafficMap, RoadSegment, City,
                                           VehicleSimulator, scene_sink)
