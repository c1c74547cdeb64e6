from .adamw import (AdamWConfig, accumulate_gradients, apply_updates,
                    clip_by_global_norm, cosine_schedule, global_norm,
                    init_state)
