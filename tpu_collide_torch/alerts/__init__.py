from tpu_collide_torch.alerts.extract import AlertBatch, compute_priority
