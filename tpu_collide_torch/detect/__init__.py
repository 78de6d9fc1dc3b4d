from tpu_collide_torch.detect.predict import (TrajectoryHistory,
                                              empty_history, update_history,
                                              classify_trajectories,
                                              needs_fallback,
                                              predict_collisions)
