from tpu_collide_torch.sim.integrator import integrate
from tpu_collide_torch.sim.generator import generate_fleet, default_cities
from tpu_collide_torch.sim.traffic import (TrafficMap, RoadSegment, City,
                                           VehicleSimulator, scene_sink)
from tpu_collide_torch.sim.scenario import (RoadTable, CityTable,
                                            ScenarioState, build_road_table,
                                            build_city_table, init_scenario,
                                            scenario_integrate,
                                            scenario_from_simulator,
                                            make_scenario_step)
