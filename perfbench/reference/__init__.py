"""The plain reference that decides `correct`: the fleet's physics, the
4-stage detection with its scene alert list, the location ingest and the
alert manager's upserts, in plain PyTorch and Python. It imports nothing of
tpu_collide_torch and nothing of the JAX package; states are dicts of
tensors ({"pos", "vel", "acc", "heading", "size", "otype", "alive",
"oid"}), handed over by the drivers."""
