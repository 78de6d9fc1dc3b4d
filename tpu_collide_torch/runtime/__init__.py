from tpu_collide_torch.runtime.messaging import (Message, MessageBroker,
                                           MessageProducer, MessageConsumer,
                                           LocationDataProducer, TaskProducer,
                                           TaskResultProducer)
from tpu_collide_torch.runtime.storage import (StorageInterface, InMemoryStorage,
                                         VehicleLocationStorage,
                                         CollisionRiskStorage,
                                         GridVehicleStorage, StorageFactory)
from tpu_collide_torch.runtime.scheduler import Scheduler, SchedulerClient, TaskWorker
from tpu_collide_torch.runtime.reliability import (HeartbeatMonitor, LeaderElection,
                                             ReplicationManager,
                                             FailoverManager,
                                             ThrottlingManager,
                                             ThrottlingPolicy,
                                             AdaptiveThrottling,
                                             StateTransferManager,
                                             RecoveryCoordinator)
