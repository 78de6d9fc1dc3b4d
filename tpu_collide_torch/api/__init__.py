from tpu_collide_torch.api.scene import Scene
