from tpu_collide_torch.api.scene import Scene
from tpu_collide_torch.api.sharded_scene import ShardedScene
